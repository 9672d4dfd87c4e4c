#!/usr/bin/env python3
"""A/B of cnc_torch's hash-grid encode kernels (K1/K1v, K2/K2v) between trees,
on one NVIDIA GPU, at the shapes `chip_smoke.py` checks them at.

    python3 tools/torch_encode_ab.py prepare WORK
    python3 tools/torch_encode_ab.py time WORK TREE LABEL >> LOG
    python3 tools/torch_encode_ab.py summary LOG
    python3 tools/torch_encode_ab.py sat prepare WORK
    python3 tools/torch_encode_ab.py sat time WORK TREE LABEL >> LOG
    python3 tools/torch_encode_ab.py sat summary LOG

`prepare` makes the inputs with this tree's cnc_torch and saves them to
WORK/inputs.pt: K1 at the first round of the smoke's 800x800 view (random
field, seed 0), K1 and K2 at a training march after 16 lambda = 0 steps, and
K1v/K2v at the largest call of each call site of one rate estimate after 16
lambda = 2e-3 steps (the 3D mixed-level context encode, a 2D window, a
frac-plane lookup), with each site's calls per step.  For each backward it
prints how many atomics the adds need when aggregated per warp and corner
slot, per warp across the slots of a level pass, and per warp (`adds`).

`time` imports cnc_torch from TREE (a directory holding another version's
`cnc_torch/`, e.g. a commit unpacked with `git archive`) and builds its
kernels into TREE/cnc_torch/_build.  First (the process's first profile:
torch.profiler may miss kernel launches in a process that has profiled
before) it trains a full-width lambda = 2e-3 trainer for 16 steps and times
its step: ms per step over 20 steps, and one step under torch.profiler
(wall and device-busy ms, the encode launches made against those
recorded).  Then it runs chip_smoke.py's own checks of the encode kernels
on the inputs (the forward bit-equal to its twin, the backward within
K2_REL_TOL; the wrapper's ms by CUDA events, the device ms by CUDA events
behind a spin kernel, the bound, the plain and library ms), and prints one JSON
line.  A tree whose encoding module has `pack_mask_bits` gets the packed
masks (packed once, as the rate's cache does), an older one the bools.

Times vary between calls by up to 1.5x: compare trees only within one call,
in turns (a, b, b, a), e.g.

    for t in v0 v1 v1 v0; do python3 tools/torch_encode_ab.py time WORK trees/$t $t; done

`sat` does the same for the SAT-masked encodes (K1s/K2s) at chip_smoke.py's
[breadth] sites.  `sat prepare` trains the smoke's lambda = 0 run
(TRAIN_STEPS steps) and saves its 128^3 occupancy grid, its quantized xyz
and xy tables and 327,680 uniform points (seed SAT_SEED).  `sat time` runs,
per site (grid_3d on the points, the xy plane on their first two
coordinates with the grid projected along z), the smoke's checks of the
tree's K1s (bit-equal to its twin) and K2s (within K2_REL_TOL) through
`_encode_cuda(occ_sat=)` / `_encode_backward_cuda(occ_sat=)`: a whole
forward call, whatever it launches; the backward as the autograd path
runs it (in a tree with `sat_mask_sources`, on the forward's sources).
In such a tree it also times the sources launch alone and K1s on given
sources, and in every tree K1 and K2 with no mask on the same points and
table (the floor under the mask, one kernel in both trees).  `sat summary`
gives each tree's mean ms and device ms per item.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
import types
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SAT_SEED = 16                # the points of `sat prepare`


def _smoke():
    sys.path.insert(1, str(REPO))
    import chip_smoke
    return chip_smoke


def prepare(work: Path) -> None:
    import torch
    sys.path.insert(0, str(REPO))
    cs = _smoke()
    from cnc_torch.config import CNCConfig, ModelConfig, RenderConfig, TrainConfig
    from cnc_torch.data import cameras, scenes
    from cnc_torch.models import context_models as cm
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.ops import context_ops as cops
    from cnc_torch.ops import encoding as enc
    from cnc_torch.render import marching
    from cnc_torch.train.trainer import Trainer, _next_bucket

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    inputs = {}

    def static(label, pts, table, spec, bwd):
        inputs[label] = dict(points=pts.contiguous(), table=table.detach().contiguous(),
                             resolutions=tuple(spec.resolutions), offsets=tuple(spec.offsets),
                             kw={}, bwd=bwd, per_step=None)

    # the smoke's view: the first round's samples of 8,192 strided rays
    mcfg, rcfg = ModelConfig(), RenderConfig()
    field = rf.RadianceField(mcfg, torch.Generator().manual_seed(0), device=dev)
    aabb = torch.tensor(rcfg.aabb, dtype=torch.float32, device=dev)
    binaries = scenes.occupancy_from_scene(scenes.make_scene("blocks"), rcfg.occ_resolution,
                                           rcfg.render_step_size, device=dev)
    view = cs.VIEW
    K = torch.tensor([[0.8 * view, 0, view / 2.0], [0, 0.8 * view, view / 2.0], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    c2w = torch.from_numpy(cameras.look_at_poses(1, radius=3.2, seed=1000,
                                                 full_sphere=True)[0]).to(dev)
    rays = cameras.image_rays(K, c2w, view, view)
    chunk = rcfg.eval_chunk_rays
    o = rays.origins.reshape(-1, 3)[::view * view // chunk][:chunk].contiguous()
    d = rays.viewdirs.reshape(-1, 3)[::view * view // chunk][:chunk].contiguous()
    with torch.no_grad():
        smp = marching._march_cuda(o, d, binaries, aabb, rcfg,
                                   chunk * rcfg.eval_samples_per_iter,
                                   torch.ones(chunk, dtype=torch.bool, device=dev),
                                   torch.zeros(chunk, device=dev), None,
                                   marching.build_march_mip(binaries))
        pos, _ = marching.sample_positions(smp, o, d)
        x01 = (pos - aabb[:3]) / (aabb[3:] - aabb[:3])
        tables = rf.quantized_tables(field, mcfg)
    static("xyz view", x01, tables["xyz"], mcfg.grid_3d, False)
    static("xy view", x01[:, [0, 1]], tables["xy"], mcfg.grid_2d, False)

    # a training march after 16 lambda = 0 steps (chip_smoke's [K2])
    train_set = scenes.ProceduralDataset("blocks", device=dev)
    tr = Trainer(CNCConfig(train=dataclasses.replace(TrainConfig(), lmbda=0.0)), train_set)
    tr.fit(cs.TRAIN_WARM_STEPS - 1, log_every=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = tr.cfg
    bucket = _next_bucket(tr.num_rays, cfg.train.min_ray_bucket, cfg.train.max_ray_bucket)
    batch, _ = train_set.fetch_rays(gen, bucket)
    o, d = batch.origins.contiguous(), batch.viewdirs.contiguous()
    with torch.no_grad():
        smp = marching._march_cuda(o, d, tr.occ_state.binaries, tr.aabb, cfg.render,
                                   cfg.render.sample_capacity, None, None, None,
                                   marching.build_march_mip(tr.occ_state.binaries),
                                   torch.rand(bucket, generator=gen, device=dev))
        pos, _ = marching.sample_positions(smp, o, d)
        x01 = (pos - tr.aabb[:3]) / (tr.aabb[3:] - tr.aabb[:3])
        tables = rf.quantized_tables(tr.field, cfg.model)
    static("xyz train", x01, tables["xyz"], cfg.model.grid_3d, True)
    static("xy train", x01[:, [0, 1]], tables["xy"], cfg.model.grid_2d, True)
    del tr

    # one rate estimate after 16 lambda = 2e-3 steps (chip_smoke's [K1v], [K2v])
    rate_cfg = CNCConfig()
    entropy = cm.ContextModels(rate_cfg.entropy, rate_cfg.model.grid_3d, rate_cfg.model.grid_2d)
    trr = Trainer(rate_cfg, train_set, entropy=entropy)
    trr.fit(cs.RATE_WARM_STEPS - 1, log_every=0)
    sites = cs.encode_sites(trr, enc, cs.capture_rate_calls(torch, trr, rf, cops, enc))
    for label, calls in sites.items():
        a = max(calls, key=lambda a: a["points"].shape[0])
        pts, table, levels, kw = cs.encode_args(torch, a)
        kw.pop("occ_bits")            # each tree packs the bools itself
        inputs[label] = dict(points=pts, table=table, resolutions=levels.resolutions,
                             offsets=levels.offsets, kw=kw, bwd=True,
                             per_step=[len(calls), sum(c["table"].requires_grad for c in calls)])
    for label, rec in inputs.items():
        if rec["bwd"]:
            rec["adds"] = add_groups(torch, enc, rec)
    work.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, work / "inputs.pt")
    print(json.dumps({"prepared": {k: [tuple(v["points"].shape), v["per_step"], v.get("adds")]
                                   for k, v in inputs.items()}}))


def add_groups(torch, enc, rec) -> dict:
    """How many float atomics K2 issues on these inputs with its adds
    aggregated per warp and corner slot (this tree's kernel), and how many
    it would issue aggregated per warp across the slots of one level pass
    or across all its levels: the live updates counted by distinct (warp,
    level pass, slot, row), (warp, level pass, row) and (warp, row).  A warp
    holds 32 consecutive points; its level passes are the n_out levels."""
    kw = {k: v for k, v in rec["kw"].items()}
    pts, n_out = rec["points"], _n_out(rec)
    gs, ws = enc._corner_sets(pts, rec["resolutions"], rec["offsets"], **kw)
    rows = int(rec["table"].shape[0])
    inside = ~((pts < 0.0) | (pts > 1.0)).any(dim=-1)
    warp = torch.arange(pts.shape[0], device=pts.device) // 32
    keys = {"updates": 0, "per_slot": [], "per_pass": [], "per_warp": []}
    for j, (g, w) in enumerate(zip(gs, ws)):
        live = (w > 0) & inside[:, None]
        slot = torch.arange(g.shape[1], device=pts.device).expand_as(g)
        wl, gl, sl = warp[:, None].expand_as(g)[live], g[live], slot[live]
        keys["updates"] += int(live.sum())
        keys["per_slot"].append(((wl * n_out + j) * g.shape[1] + sl) * rows + gl)
        keys["per_pass"].append((wl * n_out + j) * rows + gl)
        keys["per_warp"].append(wl * rows + gl)
    out = {"updates": keys.pop("updates")}
    for k, v in keys.items():
        out[k] = int(torch.unique(torch.cat(v)).numel())
    return out


def time_tree(work: Path, tree: Path, label: str) -> None:
    import torch
    sys.path.insert(0, str(tree.resolve()))
    import cnc_torch
    from cnc_torch import kernels
    from cnc_torch.ops import encoding as enc
    if Path(cnc_torch.__file__).resolve().parent != (tree / "cnc_torch").resolve():
        raise RuntimeError(f"cnc_torch was not imported from {tree}")
    cs = _smoke()
    kernels.lib()
    step = rate_step(torch, cs, kernels)    # first: the process's first profile
    inputs = torch.load(work / "inputs.pt")
    packed = hasattr(enc, "pack_mask_bits")
    bits = {}
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for site, rec in inputs.items():
        kw = dict(rec["kw"])
        if packed and "occ_mask" in kw:
            mask = kw["occ_mask"]
            if mask.data_ptr() not in bits:
                bits[mask.data_ptr()] = enc.pack_mask_bits(mask)
            kw["occ_bits"] = bits[mask.data_ptr()]
        levels = types.SimpleNamespace(resolutions=rec["resolutions"], offsets=rec["offsets"])
        args = (torch, enc, levels, rec["table"], rec["points"])
        # the smoke's own checks: the forward bit-equal to its twin, the
        # backward within K2_REL_TOL; ms, device ms, bound, plain and library ms
        out[site] = {"per_step": rec["per_step"],
                     "fwd": cs.check_grid_encode(*args, site, perturb=False, **kw)}
        if rec["bwd"]:
            out[site]["bwd"] = cs.check_grid_encode_bwd(*args, gen, site, **kw)
    print(json.dumps({"tree": label, "card": cs.card_line(),
                      "device": torch.cuda.get_device_name(0), "sites": out,
                      "rate_step": step}))


def rate_step(torch, cs, kernels) -> dict:
    """A lambda = 2e-3 trainer at full width after 16 steps: ms per step
    over 20 steps (host clock, synchronized), and one step under
    torch.profiler (wall and device-busy ms), with the encode kernels'
    launches the wrappers counted in that step beside those the profiler
    recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cnc_torch.config import CNCConfig
    from cnc_torch.data import scenes
    from cnc_torch.models import context_models as cm
    from cnc_torch.train.trainer import Trainer
    cfg = CNCConfig()
    ds = scenes.ProceduralDataset("blocks", device="cuda")
    tr = Trainer(cfg, ds, entropy=cm.ContextModels(cfg.entropy, cfg.model.grid_3d,
                                                   cfg.model.grid_2d))
    tr.fit(cs.RATE_WARM_STEPS - 1, log_every=0)
    bkgd = torch.ones(3, device="cuda")

    def step():
        batch, pixels = ds.fetch_rays(tr.generator, tr.num_rays)
        tr._train_step(batch.origins, batch.viewdirs, pixels, bkgd, ent_cache=tr._last_ent_cache)

    step()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / 20 * 1e3
    counted = dict(kernels.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    made = sum(kernels.launches[k] - counted[k] for k in
               ("grid_encode", "grid_encode_v", "grid_encode_bwd", "grid_encode_v_bwd"))
    recorded = sum(e.count for e in events if "grid_encode_" in e.key)
    return {"step_ms": step_ms, "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "encode_launches_made": made, "encode_launches_recorded": recorded}


def summary(path: Path) -> None:
    """A markdown table of the `time` lines in `path`: per site and
    direction, each tree's mean ms / device ms over its runs, and the bound;
    then each tree's rate step."""
    runs = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith('{"tree"')]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    mean = lambda xs: sum(xs) / len(xs)
    print(f"{runs[0]['card']}; {len(runs)} runs")
    print("| site | " + " | ".join(f"{t} ms / device ms" for t in trees) + " | bound ms |")
    print("| --- |" + " --- |" * (len(trees) + 1))
    for site, rec in runs[0]["sites"].items():
        for way in ("fwd", "bwd"):
            if way not in rec:
                continue
            cells = []
            for t in trees:
                got = [r["sites"][site][way] for r in runs if r["tree"] == t]
                cells.append(f"{mean([g['ms'] for g in got]):.4f} / "
                             f"{mean([g['device_ms'] for g in got]):.4f}")
            print(f"| {site} {way} | " + " | ".join(cells) + f" | {rec[way]['bound_ms']:.4f} |")
    for t in trees:
        got = [r["rate_step"] for r in runs if r["tree"] == t]
        print(f"{t}: rate step " + ", ".join(f"{k} {[round(g[k], 2) for g in got]}"
                                               for k in got[0]))


def sat_prepare(work: Path) -> None:
    import torch
    sys.path.insert(0, str(REPO))
    cs = _smoke()
    from cnc_torch import kernels
    from cnc_torch.config import CNCConfig, TrainConfig
    from cnc_torch.data import scenes
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.train.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.lib()
    dev = torch.device("cuda")
    train_set = scenes.ProceduralDataset("blocks", device=dev)
    tr = Trainer(CNCConfig(train=dataclasses.replace(TrainConfig(), lmbda=0.0)), train_set)
    tr.fit(cs.TRAIN_STEPS - 1, log_every=0)
    cfg = tr.cfg
    gen = torch.Generator(device=dev).manual_seed(SAT_SEED)
    pts = torch.rand(cfg.render.sample_capacity, 3, generator=gen, device=dev)
    with torch.no_grad():
        tables = {k: v.detach() for k, v in rf.quantized_tables(tr.field, cfg.model).items()}
    occ = tr.occ_state.binaries
    inputs = {"occ": occ, "points": pts, "xyz": tables["xyz"], "xy": tables["xy"]}
    work.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, work / "sat_inputs.pt")
    print(json.dumps({"prepared": {"points": list(pts.shape), "occupied": int(occ.sum()),
                                   "cells": occ.numel()}, "card": cs.card_line()}))


def sat_time(work: Path, tree: Path, label: str) -> None:
    import torch
    sys.path.insert(0, str(tree.resolve()))
    import cnc_torch
    from cnc_torch import kernels
    from cnc_torch.config import CNCConfig
    from cnc_torch.ops import encoding as enc
    from cnc_torch.ops import sat as sat_ops
    if Path(cnc_torch.__file__).resolve().parent != (tree / "cnc_torch").resolve():
        raise RuntimeError(f"cnc_torch was not imported from {tree}")
    cs = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.lib()
    inp = torch.load(work / "sat_inputs.pt")
    model = CNCConfig().model
    occ, pts = inp["occ"], inp["points"]
    sites = (("xyz", model.grid_3d, pts, occ),
             ("xy", model.grid_2d, pts[:, [0, 1]].contiguous(), occ.any(dim=2).contiguous()))
    sourced = hasattr(enc, "sat_mask_sources")
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for key, spec, p, grid in sites:
        sat = sat_ops.build_sat(grid)
        table = inp[key]
        src = enc.sat_mask_sources(sat, spec.resolutions) if sourced else None
        rec = {"K1s": cs.check_grid_encode(torch, enc, spec, table, p, key, perturb=False,
                                           name="K1s", occ_sat=sat)}
        bwd_kw = {"sat_src": src} if sourced else {}
        rec["K2s"] = cs.check_grid_encode_bwd(torch, enc, spec, table, p, gen, key, name="K2s",
                                              occ_sat=sat, **bwd_kw)
        if sourced:
            rec["sources"] = cs.check_sat_sources(torch, enc, sat, spec.resolutions, key)[1]
            rec["K1s alone"] = cs.check_grid_encode(torch, enc, spec, table, p, key,
                                                    perturb=False, name="K1s", occ_sat=sat,
                                                    sat_src=src)
        rec["K1 no mask"] = cs.check_grid_encode(torch, enc, spec, table, p, key + ", no mask",
                                                 perturb=False)
        rec["K2 no mask"] = cs.check_grid_encode_bwd(torch, enc, spec, table, p, gen,
                                                     key + ", no mask")
        out[key] = rec
    print(json.dumps({"tree": label, "card": cs.card_line(),
                      "device": torch.cuda.get_device_name(0), "sat_sites": out}))


def sat_summary(path: Path) -> None:
    runs = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith('{"tree"') and "sat_sites" in line]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    mean = lambda xs: sum(xs) / len(xs)
    print(f"{runs[0]['card']}; {len(runs)} runs")
    print("| site, item | " + " | ".join(f"{t} ms / device ms" for t in trees) + " | bound ms |")
    print("| --- |" + " --- |" * (len(trees) + 1))
    items = list(dict.fromkeys(i for r in runs for site in r["sat_sites"].values() for i in site))
    for site in runs[0]["sat_sites"]:
        for item in items:
            cells, bounds = [], []
            for t in trees:
                got = [r["sat_sites"][site][item] for r in runs
                       if r["tree"] == t and item in r["sat_sites"][site]]
                cells.append(f"{mean([g['ms'] for g in got]):.4f} / "
                             f"{mean([g['device_ms'] for g in got]):.4f}" if got else "—")
                bounds.append(f"{got[0]['bound_ms']:.4f}" if got else "—")
            # a tree's K2s on its own sources reads them, not the table
            seen = set(bounds) - {"—"}
            bound = seen.pop() if len(seen) == 1 else " / ".join(bounds)
            print(f"| {site}, {item} | " + " | ".join(cells) + f" | {bound} |")


def _n_out(rec) -> int:
    kw = rec["kw"]
    return kw["n_levels_calc"] if "min_level_ids" in kw else len(rec["resolutions"])


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "summary":
        summary(Path(sys.argv[2]))
        return 0
    if len(sys.argv) == 4 and sys.argv[1:3] == ["sat", "summary"]:
        sat_summary(Path(sys.argv[3]))
        return 0
    if not torch.cuda.is_available():
        print("torch_encode_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "prepare":
        prepare(Path(sys.argv[2]))
    elif len(sys.argv) == 5 and sys.argv[1] == "time":
        time_tree(Path(sys.argv[2]), Path(sys.argv[3]), sys.argv[4])
    elif len(sys.argv) == 4 and sys.argv[1:3] == ["sat", "prepare"]:
        sat_prepare(Path(sys.argv[3]))
    elif len(sys.argv) == 6 and sys.argv[1:3] == ["sat", "time"]:
        sat_time(Path(sys.argv[3]), Path(sys.argv[4]), sys.argv[5])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
