#!/usr/bin/env python3
"""A/B of cnc_torch's footprint-grid kernel (K8) and frac-plane kernels (K7
and its backward, K7b) between trees, on one NVIDIA GPU, at the shapes of
the lambda = 2e-3 training step.

    python3 tools/torch_refresh_pn_ab.py prepare WORK
    python3 tools/torch_refresh_pn_ab.py time WORK TREE LABEL >> LOG
    python3 tools/torch_refresh_pn_ab.py summary LOG

`prepare` trains a full-width lambda = 2e-3 run (CNCConfig(), `blocks`) for
PREP_STEPS steps with this tree's cnc_torch and saves its occupancy grid and
quantized 3D table to WORK/inputs.pt: the inputs every tree's refresh and
frac planes are timed on.

`time` imports cnc_torch from TREE (a directory holding another version's
`cnc_torch/`, e.g. a commit unpacked with `git archive`), builds its kernels
into TREE/cnc_torch/_build and prints one JSON line:
  * `step`: a lambda = 2e-3 trainer after STEP_AT steps: ms per step, the
    median of STEP_WINDOWS windows of 20 steps of `fit` (occupancy updates
    and cache refreshes included);
  * `profile`: the process's first torch.profiler window: one frac plane
    (the xy axis), one whole autograd backward of that plane and, after a
    sync each, one rate estimate's forward and backward on that trainer:
    the device operations each ran (kernels, memsets, copies) and the
    wrappers' launch counts of the estimate;
  * `refresh`: `refresh_cache` on the saved grid (ms, the median of five),
    and each of its footprint launches by its device work alone (device ms,
    CUDA events behind a spin kernel, chip_smoke.device_ms), with its
    bound, each mask equal to the tree's plain twin and each overlap within
    chip_smoke.K8_REL_TOL of the float64 twin;
  * `planes`: per axis, the whole `pn_frac_plane` at the step's sample cap
    (ms with the wrapper, device ms, host us over HOST_CALLS unsynced calls,
    allocations, the wrappers' launches), the tree's K7 kernel alone (the
    parent's histogram kernel on the rows its composition forms; the one
    launch otherwise), and a digest of the plane, which must be the same
    in every tree;
  * `backward`: the xy plane's backward (K7b, as with pn_frac_grad) for a
    seeded cotangent: the whole autograd backward from the cotangent to
    d_table (ms, device ms), the tree's backward kernel alone into a zeroed
    table (device ms; the fill left out), the zero fill alone, and the
    result against the twin run in float64 (chip_smoke.K7B_REL_TOL).

Times vary between calls by up to 1.5x: compare trees only within one call,
in turns (parent, new, new, parent).  `summary` gives each tree's mean over
its runs, each run's reading for the wrapper-bound items and the step, and
whether the trees' ranges of readings overlap.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PREP_STEPS = 300
STEP_AT = 300
STEP_WINDOWS = 5
HOST_CALLS = 100
AXES = ("xy", "xz", "yz")


def _smoke():
    sys.path.insert(1, str(REPO))
    import chip_smoke
    return chip_smoke


def _trainer(torch):
    from cnc_torch.config import CNCConfig
    from cnc_torch.data import scenes
    from cnc_torch.models import context_models as cm
    from cnc_torch.train.trainer import Trainer
    cfg = CNCConfig()
    ds = scenes.ProceduralDataset("blocks", device="cuda")
    entropy = cm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d)
    return Trainer(cfg, ds, entropy=entropy), ds


def prepare(work: Path) -> None:
    import torch
    sys.path.insert(0, str(REPO))
    from cnc_torch.models import radiance_field as rf
    tr, _ = _trainer(torch)
    tr.fit(PREP_STEPS - 1, log_every=0)
    with torch.no_grad():
        table = rf.quantized_tables(tr.field, tr.cfg.model)["xyz"].contiguous()
    occ = tr.occ_state.binaries.clone()
    work.mkdir(parents=True, exist_ok=True)
    torch.save({"occ": occ, "table": table}, work / "inputs.pt")
    print(json.dumps({"prepared": {"steps": PREP_STEPS, "occupied_cells": int(occ.sum()),
                                   "table_rows": int(table.shape[0])}}))


def _allocations(torch, fn) -> int:
    key = "allocation.all.allocated"
    before = torch.cuda.memory_stats()[key]
    fn()
    return torch.cuda.memory_stats()[key] - before


def _launched(kernels, fn) -> dict:
    before = dict(kernels.launches)
    fn()
    return {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}


def time_tree(work: Path, tree: Path, label: str) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    sys.path.insert(0, str(tree.resolve()))
    import cnc_torch
    from cnc_torch import kernels
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.ops import context_ops as cops
    if Path(cnc_torch.__file__).resolve().parent != (tree / "cnc_torch").resolve():
        raise RuntimeError(f"cnc_torch was not imported from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _smoke()
    sys.path.insert(1, str(REPO / "tools"))
    from torch_volrend_ab import host_us
    kernels.lib()
    out = {"tree": label, "card": cs.card_line(), "device": torch.cuda.get_device_name(0)}
    inputs = torch.load(work / "inputs.pt")
    occ, table = inputs["occ"].cuda(), inputs["table"].cuda()

    # ---- the step, after STEP_AT steps
    tr, ds = _trainer(torch)
    entropy = tr.entropy
    tr.fit(STEP_AT - 1, log_every=0)
    torch.cuda.synchronize()
    windows = []
    kernels.reset_launches()
    for _ in range(STEP_WINDOWS):
        t0 = time.time()
        tr.fit(tr.step + 19, log_every=0)
        torch.cuda.synchronize()
        windows.append((time.time() - t0) / 20 * 1e3)
    n_steps = 20 * STEP_WINDOWS
    out["step"] = {"ms": statistics.median(windows), "ms_windows": windows,
                   "launches_per_step": {k: v / n_steps for k, v in kernels.launches.items()
                                         if v}}

    # ---- the process's first profile: one plane, then one rate estimate
    cache = entropy.refresh_cache(occ)
    sample_cap = entropy.cfg.pn_frac_sample_cap
    plane_of = {ax: (lambda ax=ax: entropy.pn_frac_plane(table, cache["pn"][ax], sample_cap))
                for ax in AXES}
    starts = entropy.draw_starts(tr.generator)
    est_cache = tr._last_ent_cache

    def estimate():
        tables = rf.quantized_tables(tr.field, tr.cfg.model)
        wrt = [tr.field.tables[k] for k in rf.TABLES] + list(tr.ent_params.parameters())
        bits = (entropy.rate_bits_2d(tr.ent_params, tables, starts["2d"], est_cache)
                + entropy.rate_bits_3d(tr.ent_params, tables["xyz"], starts["3d"], est_cache))
        torch.autograd.grad(bits, wrt, allow_unused=True)

    pn = cache["pn"]["xy"]
    pn_args = (entropy.fine_offset, pn["entry_idx"], pn["bounds"], pn["n"], entropy.pn_res,
               sample_cap)
    leaf = table.clone().requires_grad_()
    plane_out = cops.pn_frac_plane(leaf, *pn_args)
    cot = torch.randn(plane_out.shape, generator=torch.Generator(device="cuda").manual_seed(5),
                      device="cuda")
    backward = lambda: torch.autograd.grad(plane_out, leaf, cot, retain_graph=True)
    plane_of["xy"]()
    backward()
    estimate()
    torch.cuda.synchronize()
    regions = ("ab_plane", "ab_backward", "ab_estimate")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("ab_plane"):
            plane_of["xy"]()
            torch.cuda.synchronize()
        with record_function("ab_backward"):
            backward()
            torch.cuda.synchronize()
        before = dict(kernels.launches)
        with record_function("ab_estimate"):
            estimate()
            torch.cuda.synchronize()
    events = prof.events()
    starts = [min(e.time_range.start for e in events if e.name == name) for name in regions]
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("ab_")]
    owner = lambda e: max(i for i, t in enumerate(starts) if t <= e.time_range.start)
    in_region = [[e for e in device if owner(e) == i] for i in range(len(regions))]
    out["profile"] = {
        "plane_device_ops": len(in_region[0]),
        "plane_ops_by_name": sorted({e.name[:80] for e in in_region[0]}),
        "backward_device_ops": len(in_region[1]),
        "backward_ops_by_name": sorted({e.name[:80] for e in in_region[1]}),
        "estimate_device_ops": len(in_region[2]),
        "estimate_wrapper_launches": {k: v - before[k] for k, v in kernels.launches.items()
                                      if v != before[k]}}

    # ---- K8: the refresh's footprint launches
    calls, footprint = [], cops._footprint_cuda

    def recording(*args, **kw):
        calls.append((args, kw))
        return footprint(*args, **kw)

    cops._footprint_cuda = recording
    try:
        entropy.refresh_cache(occ)
    finally:
        cops._footprint_cuda = footprint
    launches = []
    for args, kw in calls:
        grid, r, with_overlap = args[:3]
        mask, ovl = footprint(grid, r, with_overlap)
        want_mask, _ = cops._footprint_plain(grid, r, with_overlap)
        if not torch.equal(mask, want_mask):
            raise AssertionError(f"{label}: K8 r={r} D={grid.dim()}: the mask differs")
        rec = dict(d=grid.dim(), r=r, overlap=bool(with_overlap),
                   device_ms=cs.device_ms(lambda a=args, k=kw: footprint(*a, **k), iters=5),
                   bound_ms=cs.footprint_bound(cops, grid, r, with_overlap))
        if with_overlap:
            rec["rel_err_f64"] = cs.rel_err(ovl, cs.overlap_float64(torch, cops, grid, r))
            if not rec["rel_err_f64"] <= cs.K8_REL_TOL:
                raise AssertionError(f"{label}: K8 r={r}: overlap rel err {rec['rel_err_f64']}")
        launches.append(rec)
        del mask, ovl, want_mask
    out["refresh"] = {"ms": cs.time_ms(lambda: entropy.refresh_cache(occ), iters=5, warmup=1),
                      "launches": launches,
                      "device_ms": sum(x["device_ms"] for x in launches),
                      "bound_ms": sum(x["bound_ms"] for x in launches)}

    # ---- K7: each plane whole, and the tree's kernel alone
    out["planes"] = {}
    for ax in AXES:
        plane = plane_of[ax]
        got = plane()
        rec = dict(digest=hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16],
                   ms=cs.time_ms(plane), device_ms=cs.device_ms(plane),
                   host_us=host_us(torch, plane), allocations=_allocations(torch, plane),
                   launches=_launched(kernels, plane))
        if hasattr(cops, "_pn_frac_plane_plain"):      # one launch: the kernel is the call
            pn = cache["pn"][ax]
            want = cops._pn_frac_plane_plain(table, entropy.fine_offset, pn["entry_idx"],
                                             pn["bounds"], pn["n"], entropy.pn_res, sample_cap)
            if not torch.equal(got, want):
                raise AssertionError(f"{label} {ax}: the plane differs from the twin's")
            kernel = lambda: cops._pn_frac_plane_cuda(table, entropy.fine_offset,
                                                      pn["entry_idx"], pn["bounds"], pn["n"],
                                                      entropy.pn_res, sample_cap)
        else:                                          # the histogram kernel on its rows
            seen = []
            hist = cops.pn_hist
            cops.pn_hist = lambda *a: seen.append(a) or hist(*a)
            try:
                plane()
            finally:
                cops.pn_hist = hist
            kargs = seen[0]
            kernel = lambda: cops._pn_hist_cuda(*kargs)
        rec.update(kernel_ms=cs.time_ms(kernel), kernel_device_ms=cs.device_ms(kernel))
        out["planes"][ax] = rec

    # ---- K7b: the xy plane's backward, whole and the tree's kernel alone
    (got,) = backward()
    leaf64 = table.double().requires_grad_()
    (exact,) = torch.autograd.grad(cops._pn_frac_plane_plain(leaf64, *pn_args), leaf64,
                                   cot.double())
    err = cs.rel_err(got, exact.float())
    if not err <= cs.K7B_REL_TOL:
        raise AssertionError(f"{label}: the backward's rel err {err} > {cs.K7B_REL_TOL}")
    del leaf64, exact
    d_table = torch.zeros_like(table)
    if hasattr(cops, "_pn_hist_backward_launch"):     # K7b on the forward's inputs
        kernel = lambda: cops._pn_hist_backward_launch(table, *pn_args, cot, d_table)
    else:                                             # the kernel on the rows _pn_rows forms
        seen = []
        bwd = cops._pn_hist_backward_cuda
        cops._pn_hist_backward_cuda = lambda *a: seen.append(a) or bwd(*a)
        try:
            backward()
        finally:
            cops._pn_hist_backward_cuda = bwd
        t, off, sel, row_valid, bnd, g = seen[0]
        p = kernels.ptr
        kernel = lambda: kernels.call("cnc_pn_hist_backward", p(t), off, t.shape[0], p(sel),
                                      p(row_valid), p(bnd), p(g), p(d_table), bnd.shape[0] - 1,
                                      sel.shape[0], t.shape[1])
    out["backward"] = {"rel_err_f64": err, "ms": cs.time_ms(backward),
                       "device_ms": cs.device_ms(backward),
                       "kernel_device_ms": cs.device_ms(kernel),
                       "fill_device_ms": cs.device_ms(lambda: torch.zeros_like(table)),
                       "launches": _launched(kernels, backward)}
    print(json.dumps(out))


def summary(path: Path) -> None:
    """Markdown tables of the `time` lines in `path`: each tree's mean over
    its runs, and each run's reading of the host-bound items."""
    runs = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith('{"tree"')]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    by = lambda t: [r for r in runs if r["tree"] == t]
    mean = lambda xs: sum(xs) / len(xs)
    print(f"{runs[0]['card']}; {len(runs)} runs ({', '.join(r['tree'] for r in runs)})")
    for t in trees:
        digests = {json.dumps({ax: r["planes"][ax]["digest"] for ax in AXES}) for r in by(t)}
        print(f"{t}: plane digests {sorted(digests)}")
    print("| item | " + " | ".join(trees) + " |")
    print("| --- |" + " --- |" * len(trees))
    first = by(trees[0])[0]["refresh"]["launches"]
    for i, x in enumerate(first):
        cells = [f"{mean([r['refresh']['launches'][i]['device_ms'] for r in by(t)]):.4f}"
                 if len(by(t)[0]["refresh"]["launches"]) == len(first) else "n/a"
                 for t in trees]
        print(f"| K8 {x['d']}D r={x['r']}{' with overlap' if x['overlap'] else ''}, device ms"
              f" (bound {x['bound_ms']:.4f}) | " + " | ".join(cells) + " |")
    for key, name in (("device_ms", "K8, a refresh's launches, device ms in all"),
                      ("ms", "refresh_cache ms")):
        cells = [f"{mean([r['refresh'][key] for r in by(t)]):.4f}" for t in trees]
        print(f"| {name} | " + " | ".join(cells) + " |")
    cells = [str(len(by(t)[0]["refresh"]["launches"])) for t in trees]
    print("| K8 launches per refresh | " + " | ".join(cells) + " |")
    for ax in AXES:
        for key, name in (("kernel_device_ms", "K7 kernel alone, device ms"),
                          ("kernel_ms", "K7 kernel alone, ms"),
                          ("device_ms", "pn_frac_plane, device ms"),
                          ("ms", "pn_frac_plane, ms"), ("host_us", "pn_frac_plane, host us")):
            cells = [f"{mean([r['planes'][ax][key] for r in by(t)]):.4f}" for t in trees]
            print(f"| {ax}: {name} | " + " | ".join(cells) + " |")
        cells = [f"{by(t)[0]['planes'][ax]['allocations']} allocations,"
                 f" launches {json.dumps(by(t)[0]['planes'][ax]['launches'])}" for t in trees]
        print(f"| {ax}: pn_frac_plane, allocations and wrapper launches | " + " | ".join(cells)
              + " |")
    cells = [f"{by(t)[0]['profile']['plane_device_ops']}" for t in trees]
    print("| one plane (xy): device operations in the first profile | " + " | ".join(cells)
          + " |")
    for key, name in (("device_ms", "xy backward (K7b), whole autograd, device ms"),
                      ("ms", "xy backward (K7b), whole autograd, ms"),
                      ("kernel_device_ms", "xy backward kernel alone, device ms"),
                      ("fill_device_ms", "xy backward's zero fill alone, device ms"),
                      ("rel_err_f64", "xy backward rel err against float64")):
        cells = [f"{mean([r['backward'][key] for r in by(t)]):.4g}" for t in trees]
        print(f"| {name} | " + " | ".join(cells) + " |")
    cells = [f"{by(t)[0]['profile']['backward_device_ops']}: "
             + ", ".join(by(t)[0]["profile"]["backward_ops_by_name"]) for t in trees]
    print("| one xy backward: device operations in the first profile | " + " | ".join(cells)
          + " |")
    cells = [", ".join(str(r["profile"]["estimate_device_ops"]) for r in by(t)) for t in trees]
    print("| one rate estimate (fwd + bwd): device operations, each run | " + " | ".join(cells)
          + " |")

    def spread(item, get):
        spans = {t: (min(map(get, by(t))), statistics.median(map(get, by(t))),
                     max(map(get, by(t)))) for t in trees}
        text = "; ".join(f"{t} {lo:.4f} / {mid:.4f} / {hi:.4f}" for t, (lo, mid, hi)
                         in spans.items())
        if len(trees) == 2:
            (lo_a, mid_a, hi_a), (lo_b, mid_b, hi_b) = spans.values()
            apart = hi_a < lo_b or hi_b < lo_a
            text += (f"; {trees[1]} - {trees[0]} = {mid_b - mid_a:+.4f} between medians, "
                     + ("resolved (the ranges do not overlap)" if apart else
                        "not resolved (the ranges overlap)"))
        print(f"{item}, runs (least / median / most): {text}")
        print(f"{item}, each run: " + "; ".join(
            f"{t} " + ", ".join(f"{get(r):.4f}" for r in by(t)) for t in trees))

    spread("lambda = 2e-3 step ms", lambda r: r["step"]["ms"])
    spread("refresh_cache ms", lambda r: r["refresh"]["ms"])
    spread("xy pn_frac_plane host us", lambda r: r["planes"]["xy"]["host_us"])


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "summary":
        summary(Path(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("torch_refresh_pn_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "prepare":
        prepare(Path(sys.argv[2]))
    elif len(sys.argv) == 5 and sys.argv[1] == "time":
        time_tree(Path(sys.argv[2]), Path(sys.argv[3]), sys.argv[4])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
