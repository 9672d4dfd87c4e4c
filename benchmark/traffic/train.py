"""Traffic kind `train`: a closed training loop through `Trainer.fit`.

Set-up builds one `Trainer` with its `ContextModels` (the rate's tables
built on the card), gives it the benchmark's weights drawn from the seed,
the occupancy grid of the cell's scene (the grid a converged estimator
holds) and the step and ray count past the occupancy warm-up the workload
file names, then drives it through its first steps (`check_steps`, read for
the comparison) and the warm steps, through the same `fit` the window
calls.  The window is one `fit` over as many steps as the seconds hold: one
step at a time, each ending in the step's own host sync.  A traced run
profiles `trace_steps` steps instead, with the benchmark's ranges around
the program's layers.  After the window the program is freed and the plain
reference replays the first steps from the seed.
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import torch

from benchmark.costs import flops, peaks as costs
from benchmark.costs import kernels as kcosts
from benchmark.harness import scenes, trace, weights
from benchmark.reference import compare, train_ref


class _WindowClosed(Exception):
    pass


def train_views(wl, seed, device):
    c = wl["cfg"]
    return scenes.TrainViews(c["scene"], c["cnc_config"]["render"]["aabb"],
                             c["train_images"], c["train_width"], c["train_height"], seed, device)


def grid(wl, device):
    r = wl["cfg"]["cnc_config"]["render"]
    return scenes.occupancy(wl["cfg"]["scene"], r["aabb"], r["occ_resolution"],
                            r["render_step_size"], r["occ_thre"], device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _named(trainer):
    return {**{"field." + n: p for n, p in trainer.field.named_parameters()},
            **{"context." + n: p for n, p in trainer.ent_params.named_parameters()}}


def build(wl, seed, device):
    """The program's trainer at the cell's starting point, and the inputs
    the reference gets too."""
    from cnc_torch import kernels
    from cnc_torch.config import CNCConfig
    from cnc_torch.grids import occupancy as occ
    from cnc_torch.models.context_models import ContextModels
    from cnc_torch.train.trainer import Trainer
    t = [time.perf_counter()]
    if device.type == "cuda":
        kernels.lib()                       # built on a checkout's first run, loaded after
    t.append(time.perf_counter())
    cfg = CNCConfig.from_dict(wl["cfg"]["cnc_config"])
    views = train_views(wl, seed, device)
    _sync(device)
    t.append(time.perf_counter())
    entropy = ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d, device=device)
    _sync(device)
    t.append(time.perf_counter())
    trainer = Trainer(cfg, views, entropy=entropy, seed=seed, device=device)
    t.append(time.perf_counter())
    print("build: " + ", ".join(f"{n} {b - a:.2f} s" for n, a, b in zip(
        ("library", "views", "context tables", "trainer"), t, t[1:])), file=sys.stderr)
    weights.load(trainer.field, seed, "field")
    weights.load(trainer.ent_params, seed, "context")
    occs, binaries = grid(wl, device)
    trainer.occ_state = occ.OccGridState(occs, binaries, trainer.aabb)
    trainer.step = wl["params"]["start_step"]
    trainer.num_rays = wl["params"]["rays"]
    return trainer, views


def first_steps(trainer, n: int) -> dict:
    """Drive the trainer through its first n steps through `fit`; the
    per-step loss, each leaf's first gradient as Adam holds it after the
    first step, and each leaf's change over the n steps."""
    tr = trainer.cfg.train
    named = _named(trainer)
    start = {k: p.detach().clone() for k, p in named.items()}
    losses, grads = [], {}

    def cb(step, aux):
        bpp = float(aux["bits_per_param"]) if "bits_per_param" in aux else 0.0
        losses.append(float(aux["mse"]) + tr.lmbda * tr.rate_update_interval * bpp)
        if not grads:
            for opt, prefix, mod in ((trainer.optimizer, "field.", trainer.field),
                                     (trainer.opt_ent, "context.", trainer.ent_params)):
                grads.update({prefix + k: g for k, g in train_ref.first_grads(
                    opt, dict(mod.named_parameters())).items()})

    trainer.fit(max_steps=trainer.step + n - 1, log_every=0, step_callback=cb)
    return {"loss": losses, "grad": grads, "change": train_ref.changes(named, start)}


def _install_ranges(ranges, trainer, captured):
    from cnc_torch.grids import occupancy as occ
    from cnc_torch.render import renderer
    ranges.capture_encodes(renderer, "render_rays_train", captured)
    ranges.wrap(renderer, "render_rays_train", "render")
    ranges.wrap(occ, "update_occ_grid", "occupancy")
    for attr in ("rate_bits_2d", "rate_bits_3d"):
        ranges.wrap(trainer.entropy, attr, "rate")
    ranges.wrap(trainer.entropy, "refresh_cache", "cache")


def _least_seconds(cfg, captured, marched) -> float:
    """The least time of the training render's K1, K2, K5 and K5b calls of
    the traced window (`benchmark/costs/kernels.py`)."""
    least = 0.0
    for x01 in captured:
        for call in kcosts.field_query(cfg.model, x01):
            for backward in (False, True):
                least += costs.least_seconds(*kcosts.encode(*call, backward=backward))
    cap = cfg.render.sample_capacity
    for n_marched, rays in marched:
        for backward in (False, True):
            least += costs.least_seconds(*kcosts.composite(min(n_marched, cap), rays, False,
                                                           backward))
    return least


def _window_rows_2d(entropy) -> dict:
    return {l: entropy.tables2d[l].max_win_pts for l in entropy.ctx_levels_2d}


def _counts(trainer, record) -> dict:
    """What the window's steps did, for the FLOP count."""
    cfg, steps = trainer.cfg, record["steps"]
    util = [u for u in record["util"] if u is not None]
    ctx_rows = (float(torch.stack(util).clamp(max=1.0).sum()) * cfg.entropy.v_ctx_cap
                if util else 0.0)
    return {"samples": record["samples"], "ctx_rows": ctx_rows, "rate_steps": len(util),
            "occ_updates": sum(1 for i, s in enumerate(steps)
                               if i == 0 or s % cfg.render.occ_update_interval == 0)}


def run(wl, seed: int, seconds: float, traced: bool, device, t0: float) -> SimpleNamespace:
    p = wl["params"]
    marks = [("start", t0), ("imports", time.perf_counter())]
    trainer, views = build(wl, seed, device)
    _sync(device)
    marks.append(("build", time.perf_counter()))
    prog = first_steps(trainer, p["check_steps"])
    marks.append(("checked steps", time.perf_counter()))
    trainer.fit(max_steps=trainer.step + p["warm_steps"] - 1, log_every=0)
    _sync(device)
    marks.append(("warm steps", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    print("set-up: " + ", ".join(f"{n} {b - a:.2f} s" for (_, a), (n, b) in zip(marks, marks[1:])),
          file=sys.stderr)

    record = {"steps": [], "times": [], "samples": 0, "util": [], "mse": [], "buckets": set(),
              "marched": []}

    def cb(step, aux):
        record["steps"].append(step)
        record["times"].append(time.perf_counter())
        record["samples"] += aux["n_samples"]
        record["util"].append(aux.get("ctx_util"))
        record["mse"].append(aux["mse"])
        record["buckets"].add(aux["num_rays"])
        record["marched"].append((aux["n_marched"], aux["num_rays"]))
        if not traced and record["times"][-1] >= deadline:
            raise _WindowClosed

    tr, captured, least_s = None, [], None
    if traced:
        with trace.Ranges() as ranges, trace.profiler() as prof:
            _install_ranges(ranges, trainer, captured)
            w0 = time.perf_counter()
            trainer.fit(max_steps=trainer.step + p["trace_steps"] - 1, log_every=0,
                        step_callback=cb)
            _sync(device)
            window_s = time.perf_counter() - w0
        tr = trace.Trace(trace.events(prof), window_s)
        least_s = _least_seconds(trainer.cfg, captured, record["marched"])
        captured.clear()
    else:
        w0 = time.perf_counter()
        deadline = w0 + seconds
        try:
            trainer.fit(max_steps=1 << 40, log_every=0, step_callback=cb)
        except _WindowClosed:
            pass
        _sync(device)
        window_s = time.perf_counter() - w0
    n = len(record["steps"])
    failed = int(sum(not bool(torch.isfinite(m)) for m in record["mse"]))
    model_flops = flops.train_window(wl["cfg"]["cnc_config"], _window_rows_2d(trainer.entropy),
                                     _counts(trainer, record))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cnc = wl["cfg"]["cnc_config"]
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    occs, binaries = grid(wl, device)
    r0 = time.perf_counter()
    ref = train_ref.steps(cnc, views, seed, p["start_step"], p["rays"], occs, binaries,
                          p["check_steps"], device)
    print(f"window: {n} steps in {window_s:.3f} s, ray buckets {sorted(record['buckets'])};"
          f" reference {time.perf_counter() - r0:.1f} s", file=sys.stderr)
    numbers = compare.train(prog, ref, wl["check"]["limits"])
    return SimpleNamespace(kind="train", device=device, setup_s=setup_s, window_s=window_s,
                           steps=n, attempted=n, failed=failed, step_times=record["times"],
                           flops=model_flops, trace=tr, memory_peak_bytes=peak,
                           least_s=least_s,
                           numbers=numbers, correct=compare.correct(numbers))
