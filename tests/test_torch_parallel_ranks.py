"""Rank bodies of the data-parallel CPU tests (tests/test_torch_parallel.py).

`cnc_torch.parallel.sharding.run_ranks` spawns them, one process a rank.
They import torch and cnc_torch only (no JAX), so a child starts in a few
seconds.  Each rank takes one thread, joins a gloo group over a file://
rendezvous in the test's directory with a timeout of GROUP_TIMEOUT_S, reads
its inputs from a torch file there and writes its results beside them
(`<name>_out<rank>.pt`).
"""

import dataclasses
import os
import time

import torch

from cnc_torch import config as tconfig
from cnc_torch.data import scenes as tscenes
from cnc_torch.models import context_models as tcm
from cnc_torch.ops import context_ops as cops
from cnc_torch.parallel import sharding
from cnc_torch.train import driver
from cnc_torch.train import trainer as ttrainer
from cnc_torch.utils import checkpoint as ckpt

GROUP_TIMEOUT_S = 60

# tests/test_torch_context_tables.py's tiny entropy model (EKW) and its
# sampled variant (SAMPLED)
EKW = dict(n_features=2, sample_num=500, max_context_layer_num=2, Pg_level=4, Pg_level_2D=2,
           skip_levels_3d=(0, 1), skip_levels_2d=(0,), Rb=16, pn_coords_cap=1 << 17,
           pn_frac_sample_cap=None, sample_num_2d=None, v_ctx_cap=1 << 15)
SAMPLED = dict(pn_frac_sample_cap=1 << 10, sample_num_2d=100, v_ctx_cap_2d=256,
               v_ctx_cap=1 << 11)
# the data-parallel tests' whole budgets, which build_entropy(cfg, W) splits
# into per-rank quotas: at W = 2 none of its floors bites (sample_num 500 ->
# 250, v_ctx_cap 2^15 -> 2^14, sample_num_2d 200 -> 100 over its floor of 64,
# pn_frac_sample_cap 2^12 -> 2^11 over its floor of 1024)
DP_ENTROPY = dict(sample_num_2d=200, pn_frac_sample_cap=1 << 12)


def tiny_config(ns=tconfig, entropy=None, **train):
    """tests/test_torch_train_rate.py's tiny trainer (the context tests' grids,
    Rb = occupancy resolution = 16) with DP_ENTROPY's budgets, in either
    package's config classes."""
    return ns.CNCConfig(
        model=ns.ModelConfig(n_features_per_level=2, n_neurons=32,
                             resolutions_3d=(10, 18, 34, 66), resolutions_2d=(18, 34),
                             log2_hashmap_size=10, log2_hashmap_size_2D=8, pe_num_freqs=4),
        render=dataclasses.replace(ns.RenderConfig(), render_step_size=0.02, occ_resolution=16,
                                   sample_budget=1 << 13, march_block=32),
        train=dataclasses.replace(ns.TrainConfig(), **{
            **dict(init_batch_size=256, min_ray_bucket=256, max_ray_bucket=2048,
                   target_sample_batch_size=1 << 13, lmbda=2e-3, warmup_iters=20,
                   lr_milestones=(60, 80), lr=6e-3), **train}),
        entropy=ns.EntropyConfig(**{**EKW, **SAMPLED, "v_ctx_cap": 1 << 15, **DP_ENTROPY,
                                    **(entropy or {})}))


def sphere_dataset():
    return tscenes.ProceduralDataset("sphere", n_images=4, width=32, height=32, n_steps_gt=128,
                                     device="cpu")


def join(rank, world_size, tmp):
    torch.set_num_threads(1)
    return sharding.make_group(world_size, rank, device="cpu",
                               init_method="file://" + os.path.join(tmp, "rendezvous"),
                               timeout_s=GROUP_TIMEOUT_S)


def make_trainer(cfg, world_size, group=None, dataset=None):
    """A CPU trainer with the per-rank quotas of a group of `world_size`."""
    entropy = (driver.build_entropy(cfg, world_size, device="cpu") if cfg.train.lmbda > 0
               else None)
    return ttrainer.Trainer(cfg, dataset, entropy=entropy, device="cpu", group=group)


def load_state(tr, state):
    """The field, the context MLPs and the occupancy grid of `state`."""
    tr.field.load_state_dict(state["field"])
    if state.get("ent") is not None:
        tr.ent_params.load_state_dict(state["ent"])
    if state.get("binaries") is not None:
        tr.occ_state = tr.occ_state._replace(binaries=state["binaries"].clone())


def grads(tr):
    out = {f"field.{k}": p.grad.clone() for k, p in tr.field.named_parameters()
           if p.grad is not None}
    if tr.ent_params is not None:
        out.update({f"ent.{k}": p.grad.clone() for k, p in tr.ent_params.named_parameters()
                    if p.grad is not None})
    return out


def _save(tmp, name, rank, obj):
    torch.save(obj, os.path.join(tmp, f"{name}_out{rank}.pt"))


# ------------------------------------------------------------- rank bodies
def plane_rank(rank, world_size, tmp):
    """The row-sharded frac planes of plane_in.pt's cases: each case's
    table, pn coord list and sample cap through `pn_frac_plane(group=)`,
    and this rank's partial (`pn_hist_part` over its rows)."""
    group = join(rank, world_size, tmp)
    try:
        inp = torch.load(os.path.join(tmp, "plane_in.pt"))
        ctx = tcm.ContextModels(tconfig.EntropyConfig(**inp["ekw"]),
                                tconfig.GridSpec(**inp["kw3"]), tconfig.GridSpec(**inp["kw2"]),
                                device="cpu")
        out = {}
        for key, (table, pn_ax, cap) in inp["cases"].items():
            out[key] = ctx.pn_frac_plane(table, pn_ax, sample_cap=cap, group=group)
        _save(tmp, "plane", rank, out)
    finally:
        sharding.destroy_group(group)


def step_rank(rank, world_size, tmp):
    """One data-parallel `_train_step` on step_in.pt's state, global batch
    and this rank's injected jitter and starts: the reduced gradients (in
    .grad after the step), the aux and the rank's frac-plane launches."""
    group = join(rank, world_size, tmp)
    try:
        inp = torch.load(os.path.join(tmp, "step_in.pt"), weights_only=False)
        tr = make_trainer(inp["cfg"], world_size, group)
        load_state(tr, inp)
        cache = tr.entropy.refresh_cache(tr.occ_state.binaries) if tr.entropy else None
        o, d, pix = inp["rays"]
        aux = tr._train_step(o, d, pix, torch.ones(3), jitter=inp["jitters"][rank],
                             ent_cache=cache,
                             starts=inp["starts"][rank] if inp.get("starts") else None)
        _save(tmp, "step", rank, {"grads": grads(tr), "aux": {k: torch.as_tensor(v) for k, v
                                                             in aux.items()}})
    finally:
        sharding.destroy_group(group)


def fit_rank(rank, world_size, tmp):
    """`fit` on the sphere scene to fit_in.pt's last step, the ranks'
    replicas checked after every step; each step's aux and gradients, and
    the state at the end.  With `save_at`, rank 0 saves a checkpoint once
    `fit` has returned at that step and training goes on; a run whose
    config names an existing checkpoint resumes from it."""
    group = join(rank, world_size, tmp)
    try:
        inp = torch.load(os.path.join(tmp, "fit_in.pt"), weights_only=False)
        tr = make_trainer(inp["cfg"], world_size, group, sphere_dataset())
        hist = []

        def on_step(step, aux):
            sharding.check_replicated(group, sharding.trainer_state(tr), f"after step {step}")
            hist.append({"step": step, "mse": float(aux["mse"]),
                         "bits": float(aux.get("bits_per_param", float("nan"))),
                         "n_marched": int(aux["n_marched"]), "grads": grads(tr)})

        start = tr.step
        save_at = inp.get("save_at")
        if save_at is not None:
            tr.fit(max_steps=save_at - 1, log_every=0, step_callback=on_step)
            if rank == 0:
                ckpt.save_checkpoint(inp["save_path"], tr)
        tr.fit(max_steps=inp["last"], log_every=0, step_callback=on_step)
        _save(tmp, "fit", rank, {"start": start, "hist": hist,
                                 "state": {k: v.detach().clone()
                                           for k, v in sharding.trainer_state(tr).items()},
                                 "generator": tr.generator.get_state(),
                                 "num_rays": tr.num_rays})
    finally:
        sharding.destroy_group(group)


def rank_objective(plane, weights):
    """A rank's nonlinear function of the plane (the all-reduce test's f_r)."""
    return (weights * plane * plane).sum()


def reduce_grad_rank(rank, world_size, tmp):
    """This rank's partial through `all_reduce_sum` and the finish, its own
    objective over W, one backward: the partial's gradient (float64)."""
    group = join(rank, world_size, tmp)
    try:
        inp = torch.load(os.path.join(tmp, "reduce_in.pt"))
        part = inp["parts"][rank].clone().requires_grad_()
        plane = cops.pn_frac_finish(sharding.all_reduce_sum(part, group), inp["den"],
                                    inp["pn_res"])
        (rank_objective(plane, inp["weights"][rank]) / world_size).backward()
        _save(tmp, "reduce", rank, {"grad": part.grad})
    finally:
        sharding.destroy_group(group)


def plain_rank(rank, world_size, tmp):
    """Three lambda > 0 steps on the sphere scene, each also run first by
    rank 0 through `dp_step_plain` from the same state and generator (the
    generator is then put back, so the collective step draws alike): both
    steps' gradients and aux; the replicas checked after every step."""
    from cnc_torch.grids import occupancy as occ
    group = join(rank, world_size, tmp)
    try:
        inp = torch.load(os.path.join(tmp, "plain_in.pt"), weights_only=False)
        cfg = inp["cfg"]
        tr = make_trainer(cfg, world_size, group, sphere_dataset())
        tr.occ_state = occ.update_occ_grid(tr.occ_state, tr.generator, tr._occ_eval_fn, True,
                                           cfg.render)
        cache = tr.entropy.refresh_cache(tr.occ_state.binaries)
        bkgd = torch.ones(3)
        scalars = lambda aux: {k: float(aux[k]) for k in ("mse", "n_samples", "n_marched",
                                                          "bits_per_param", "ctx_util")}
        steps = []
        for s in range(inp["steps"]):
            rays, pixels = tr.dataset.fetch_rays(tr.generator, inp["rays"])
            rec = {}
            if rank == 0:
                state = tr.generator.get_state()
                rec["plain_aux"] = scalars(sharding.dp_step_plain(
                    tr, world_size, rays.origins, rays.viewdirs, pixels, bkgd, ent_cache=cache,
                    apply=False))
                rec["plain"] = grads(tr)
                tr.generator.set_state(state)
            rec["aux"] = scalars(tr._train_step(rays.origins, rays.viewdirs, pixels, bkgd,
                                                ent_cache=cache))
            rec["dp"] = grads(tr)
            tr.step += 1
            sharding.check_replicated(group, sharding.trainer_state(tr), f"after step {s}")
            steps.append(rec)
        _save(tmp, "plain", rank, {"steps": steps, "state": {
            k: v.detach().clone() for k, v in sharding.trainer_state(tr).items()}})
    finally:
        sharding.destroy_group(group)


def pipeline_rank(rank, world_size, tmp):
    """`run_pipeline(group=)` at the tiny configuration to pipeline_in.pt's
    step: rank 0's result columns (its TSV row written), None elsewhere."""
    group = join(rank, world_size, tmp)
    try:
        inp = torch.load(os.path.join(tmp, "pipeline_in.pt"), weights_only=False)
        ds = sphere_dataset()
        res = driver.run_pipeline(inp["cfg"], ds, ds, "sphere", out_root=inp["out_root"],
                                  max_steps=inp["last"], max_eval_images=1, log_fn=lambda m: None,
                                  device="cpu", group=group)
        cols = (driver.append_result_row(res, "sphere", "Procedural", inp["out_root"])
                if res is not None else None)
        _save(tmp, "pipeline", rank, {"cols": cols})
    finally:
        sharding.destroy_group(group)


def barrier_rank(rank, world_size, tmp):
    """`rank0_barrier` over a tcp:// rendezvous, whose store rank 0 hosts:
    rank 0 arrives at once and then leaves, destroying its group; the other
    ranks arrive three seconds later.  Then rank 0 arrives as failed, which
    the other ranks raise.  Each rank records what the second barrier raised."""
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "port")) as fh:
        port = int(fh.read())
    group = sharding.make_group(world_size, rank, device="cpu",
                                init_method=f"tcp://127.0.0.1:{port}", timeout_s=GROUP_TIMEOUT_S)
    try:
        if rank:
            time.sleep(3.0)
        sharding.rank0_barrier(group, "done", timeout_s=GROUP_TIMEOUT_S)
        raised = None
        try:
            if rank:
                time.sleep(3.0)
            sharding.rank0_barrier(group, "failed", ok=False, timeout_s=GROUP_TIMEOUT_S)
        except RuntimeError as e:
            raised = str(e)
        _save(tmp, "barrier", rank, {"raised": raised})
    finally:
        sharding.destroy_group(group)
