"""The reference of the training cells: the first steps of a training run,
in plain torch (the frozen twins), from the benchmark's own inputs.

It follows `Trainer.fit` as the port states it, one process, no group: at
the run's first step (and every `occ_update_interval` steps) the occupancy
update and the rate's cache refresh; then the ray batch in a power-of-two
bucket, the entry windows' starts, the jittered march, the render, the rate
terms of the four tables, one backward over `mse + lmbda * K * bits /
params`, one Adam step of the field and one of the context MLPs, and the
dynamic ray batch.  Every draw comes from one generator on the device,
seeded as the program's is, and is made in the same order, so both sides
see the same rays, jitter and windows.  What it reports (per-step loss, the
first gradient as Adam holds it, the change of every leaf) is what
`compare.train` holds the program's against.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..harness import weights
from .twins import config as tconfig
from .twins import context_models as cm
from .twins import occupancy as occ
from .twins import optim
from .twins import radiance_field as rf
from .twins import renderer

BETA1 = 0.9


def next_bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def first_grads(opt: torch.optim.Adam, named: Dict[str, torch.nn.Parameter]) -> Dict[str, float]:
    """Each leaf's first gradient as the optimizer got it (weight decay
    included), worked out from Adam's first moment after one step; 0 where
    the optimizer holds none (it took no step)."""
    return {n: (float(opt.state[p]["exp_avg"].double().norm()) / (1.0 - BETA1)
                if "exp_avg" in opt.state.get(p, {}) else 0.0) for n, p in named.items()}


def changes(named: Dict[str, torch.nn.Parameter], start: Dict[str, torch.Tensor]):
    return {n: float((p.detach().double() - start[n].double()).norm()) for n, p in named.items()}


def steps(cnc: dict, dataset, seed: int, start_step: int, num_rays: int, occs: torch.Tensor,
          binaries: torch.Tensor, n_steps: int, device, tf32: bool = False) -> dict:
    """Run the first `n_steps` steps; returns {"loss": [per step], "grad":
    {leaf: norm}, "change": {leaf: norm}} with leaves named "field.<name>"
    and "context.<name>".  `tf32` computes the float32 matmuls in TF32 (the
    control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _steps(cnc, dataset, seed, start_step, num_rays, occs, binaries, n_steps,
                      torch.device(device))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _steps(cnc, dataset, seed, start_step, num_rays, occs, binaries, n_steps, dev):
    cfg = tconfig.CNCConfig.from_dict(cnc)
    tr, rc = cfg.train, cfg.render
    field = rf.RadianceField(cfg.model, torch.Generator(device=dev).manual_seed(0), device=dev)
    weights.load(field, seed, "field")
    entropy = cm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d, device=dev)
    ent = entropy.init_params(torch.Generator(device=dev).manual_seed(0))
    weights.load(ent, seed, "context")
    named = {**{"field." + n: p for n, p in field.named_parameters()},
             **{"context." + n: p for n, p in ent.named_parameters()}}
    start = {n: p.detach().clone() for n, p in named.items()}
    opt, sched = optim.make_optimizer(field.parameters(), tr, tr.weight_decay)
    opt_e, sched_e = optim.make_optimizer(ent.parameters(), tr)
    gen = torch.Generator(device=dev).manual_seed(seed)
    aabb = torch.tensor(rc.aabb, dtype=torch.float32, device=dev)
    state = occ.OccGridState(occs.clone(), binaries.clone(), aabb)
    bkgd = torch.ones(3, device=dev)
    eval_fn = lambda x: rf.query_density(field, cfg.model, aabb, x) * rc.render_step_size
    scale = tr.lmbda * tr.rate_update_interval / entropy.total_param_count
    losses: List[float] = []
    grads = None
    cache = None
    for local in range(n_steps):
        s = start_step + local
        if s % rc.occ_update_interval == 0 or local == 0:
            state = occ.update_occ_grid(state, gen, eval_fn, s < rc.occ_warmup_steps, rc)
            cache = entropy.refresh_cache(state.binaries)
        bucket = next_bucket(num_rays, tr.min_ray_bucket, tr.max_ray_bucket)
        rays, pixels = dataset.fetch_rays(gen, bucket)
        use_rate = tr.lmbda > 0 and s % tr.rate_update_interval == 0
        starts = entropy.draw_starts(gen) if use_rate else None
        opt.zero_grad(set_to_none=True)
        if use_rate:
            opt_e.zero_grad(set_to_none=True)
        out = renderer.render_rays_train(field, cfg.model, rc, aabb, state.binaries,
                                         rays.origins, rays.viewdirs, gen, bkgd,
                                         capacity=rc.sample_capacity)
        if out.resume_ray is not None:
            raise NotImplementedError("the reference takes no visibility-pruned march")
        sq = ((out.rgb - pixels) ** 2).sum()
        stats = [sq, float(pixels.numel()), out.n_rendering_samples, out.n_marched_samples]
        if use_rate:
            tables = rf.quantized_tables(field, cfg.model)
            bits2d = entropy.rate_bits_2d(ent, tables, starts["2d"], cache)
            bits3d = entropy.rate_bits_3d(ent, tables["xyz"], starts["3d"], cache)
            ttl = bits2d + bits3d
            stats.append(ttl)
        tot = torch.stack([torch.as_tensor(x, device=dev).detach().to(torch.float64).reshape(())
                           for x in stats])
        loss = sq / tot[1].to(torch.float32)
        mse = float((tot[0] / tot[1]).to(torch.float32))
        bpp = 0.0
        if use_rate:
            loss = loss + scale * ttl
            bpp = float(tot[4].to(torch.float32) / entropy.total_param_count)
        loss.backward()
        opt.step()
        sched.step()
        if use_rate:
            opt_e.step()
            sched_e.step()
        n_marched = int(tot[3])
        if tr.target_sample_batch_size > 0 and n_marched > 0:
            num_rays = int(bucket * (tr.target_sample_batch_size / float(n_marched)))
        losses.append(mse + tr.lmbda * tr.rate_update_interval * bpp)
        if local == 0:
            grads = {**{"field." + n: g for n, g in first_grads(
                opt, dict(field.named_parameters())).items()},
                **{"context." + n: g for n, g in first_grads(
                    opt_e, dict(ent.named_parameters())).items()}}
    return {"loss": losses, "grad": grads, "change": changes(named, start)}
