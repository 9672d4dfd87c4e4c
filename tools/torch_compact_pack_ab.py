#!/usr/bin/env python3
"""A/B of cnc_torch's stream compaction (K3) and mask packing kernels between
trees, on one NVIDIA GPU, at the shapes of the lambda = 2e-3 training run.

    python3 tools/torch_compact_pack_ab.py prepare WORK
    python3 tools/torch_compact_pack_ab.py time WORK TREE LABEL >> LOG
    python3 tools/torch_compact_pack_ab.py summary LOG

`prepare` trains a full-width lambda = 2e-3 run (CNCConfig(), `blocks`) for
PREP_STEPS steps with this tree's cnc_torch and saves to WORK/inputs.pt the
inputs every tree's compactions are timed on: the occupancy grid, the mask
and cap of one rate estimate's 3D context compaction after EARLY_STEPS (the
step chip_smoke.py checks it at; most of the mask set, in long runs) and
after PREP_STEPS, and the largest compaction of the table build (a level's
entry heads), where the build compacts (it does not since its counting sort
by entry).

`time` imports cnc_torch from TREE (a directory holding another version's
`cnc_torch/`, e.g. a commit unpacked with `git archive`), builds its kernels
into TREE/cnc_torch/_build and prints one JSON line:
  * `device_ops`: the process's first torch.profiler window: the device
    operations (kernels, memsets, copies) of one compaction at each site and
    one packing at each refresh site;
  * `k3`: K3 at each of its call sites (chip_smoke.K3_SITES: the 3D context,
    at both steps, the pn coord lists of a refresh on the saved grid, the occupancy update's
    compaction of the grid, the build's entry heads): equal to the tree's
    twin (torch.equal, the count equal), ms with the wrapper, device ms (CUDA
    events behind a spin kernel, chip_smoke.device_ms), the bound, and
    `torch.nonzero(mask)[:cap]`;
  * `pack`: the packing of the refreshed cache's 3D mask and planes, equal
    to the twin and to the cache's copy: ms, device ms, bound;
  * `refresh`: `refresh_cache` on the saved grid, ms, the median of five;
  * `step`: a lambda = 2e-3 trainer after STEP_AT steps: ms per step, the
    median of STEP_WINDOWS windows of 20 steps of `fit` (occupancy updates
    and cache refreshes included);
  * `codec`: that trainer's tables through `CNCCodec.encode` and `decode`,
    each with its own `refresh_cache_int` (one pn-list compaction each):
    seconds, the median of CODEC_RUNS.

Times vary between calls by up to 1.5x: compare trees only within one call,
in turns (parent, new, new, parent).  `summary` gives each tree's mean over
its runs and, for the refresh, the step, encode and decode, each run's
reading and whether the trees' ranges of readings overlap.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
EARLY_STEPS, PREP_STEPS = 16, 300
STEP_AT = 300
STEP_WINDOWS = 5
CODEC_RUNS = 3


def _smoke():
    sys.path.insert(1, str(REPO))
    import chip_smoke
    return chip_smoke


def _trainer():
    """A full-width lambda = 2e-3 trainer."""
    from cnc_torch.config import CNCConfig
    from cnc_torch.data import scenes
    from cnc_torch.models import context_models as cm
    from cnc_torch.train.trainer import Trainer
    cfg = CNCConfig()
    ds = scenes.ProceduralDataset("blocks", device="cuda")
    entropy = cm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d)
    return Trainer(cfg, ds, entropy=entropy)


def _recorded_compactions(scatter_ops, fn):
    """The (mask, cap) of every compaction fn() makes."""
    calls, compact = [], scatter_ops.compact_mask_indices

    def recording(mask, cap):
        calls.append((mask, cap))
        return compact(mask, cap)

    scatter_ops.compact_mask_indices = recording
    try:
        fn()
    finally:
        scatter_ops.compact_mask_indices = compact
    return calls


def prepare(work: Path) -> None:
    import torch
    sys.path.insert(0, str(REPO))
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.ops import scatter_ops
    built = []
    in_build = _recorded_compactions(scatter_ops, lambda: built.append(_trainer()))
    heads_mask, heads_cap = (max(in_build, key=lambda c: c[0].numel()) if in_build
                             else (None, None))
    tr = built[0]

    def estimate():
        with torch.no_grad():
            tables = rf.quantized_tables(tr.field, tr.cfg.model)
            starts = tr.entropy.draw_starts(tr.generator)
            tr.entropy.rate_estimate(tr.ent_params, tables, starts, tr._last_ent_cache)

    # the 3D context's compaction after EARLY_STEPS (most vertices still in
    # the context, more than its cap) and after PREP_STEPS
    ctx = {}
    for steps in (EARLY_STEPS, PREP_STEPS):
        tr.fit(steps - 1, log_every=0)
        mask, cap = max(_recorded_compactions(scatter_ops, estimate), key=lambda c: c[0].numel())
        ctx[steps] = (mask.clone(), cap)
    work.mkdir(parents=True, exist_ok=True)
    torch.save({"occ": tr.occ_state.binaries.clone(), "ctx": ctx,
                "heads_mask": None if heads_mask is None else heads_mask.clone(),
                "heads_cap": heads_cap}, work / "inputs.pt")
    print(json.dumps({"prepared": {"steps": PREP_STEPS,
                                   "occupied_cells": int(tr.occ_state.binaries.sum()),
                                   "ctx": {k: [int(m.sum()), m.numel(), c]
                                           for k, (m, c) in ctx.items()},
                                   "heads": None if heads_mask is None else
                                   [heads_mask.numel(), heads_cap]}}))


def time_tree(work: Path, tree: Path, label: str) -> None:
    import torch
    sys.path.insert(0, str(tree.resolve()))
    import cnc_torch
    from cnc_torch import kernels
    from cnc_torch.codec import codec as codec_mod
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.ops import encoding as enc
    from cnc_torch.ops import scatter_ops
    if Path(cnc_torch.__file__).resolve().parent != (tree / "cnc_torch").resolve():
        raise RuntimeError(f"cnc_torch was not imported from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _smoke()
    kernels.lib()
    out = {"tree": label, "card": cs.card_line(), "device": torch.cuda.get_device_name(0)}
    inputs = torch.load(work / "inputs.pt")
    occ = inputs["occ"].cuda()
    tr = _trainer()
    entropy = tr.entropy
    cache = {}
    pn_calls = _recorded_compactions(scatter_ops,
                                     lambda: cache.update(entropy.refresh_cache(occ)))
    if len(pn_calls) != 1:
        raise AssertionError(f"{label}: a refresh made {len(pn_calls)} compactions")
    (early, early_cap), (late, late_cap) = (inputs["ctx"][k] for k in (EARLY_STEPS, PREP_STEPS))
    sites = {"3D context": (late.cuda(), late_cap),
             f"3D context, step {EARLY_STEPS}": (early.cuda(), early_cap),
             "pn coord lists": pn_calls[0],
             "occupancy": (occ.reshape(-1), occ.numel())}
    if inputs["heads_mask"] is not None:
        sites["build entry heads"] = (inputs["heads_mask"].cuda(), inputs["heads_cap"])
    masks = {"mask3d": cache["mask3d"], "mask2d": cache["mask2d"]}

    # ---- the process's first profile: one call at each site
    calls = {f"K3 {site}": (lambda m=m, c=c: scatter_ops._compact_cuda(m, c))
             for site, (m, c) in sites.items()}
    calls.update({f"pack {key}": (lambda m=m: enc.pack_mask_bits(m))
                  for key, m in masks.items()})
    out["device_ops"] = {k: len(v) for k, v in cs.count_device_ops(torch, calls).items()}

    # ---- K3 at each site
    out["k3"] = {}
    for site, (mask, cap) in sites.items():
        kernel = lambda m=mask, c=cap: scatter_ops._compact_cuda(m, c)
        src, count = kernel()
        want_src, want_count = scatter_ops._compact_plain(mask, cap)
        if not (torch.equal(src, want_src) and int(count) == int(want_count)):
            raise AssertionError(f"{label}: K3 at {site} differs from the twin")
        b, _ = cs.bound_ms(mask.numel() + cap * 4 + 4, mask.numel())
        out["k3"][site] = dict(n=mask.numel(), cap=cap, count=int(count), ms=cs.time_ms(kernel),
                               device_ms=cs.device_ms(kernel), bound_ms=b,
                               library_ms=cs.time_ms(lambda m=mask, c=cap:
                                                     torch.nonzero(m)[:c]))

    # ---- the packing at both refresh sites
    out["pack"] = {}
    for key, mask in masks.items():
        kernel = lambda m=mask: enc.pack_mask_bits(m)
        got = kernel()
        if not (torch.equal(got, enc._pack_bits_plain(mask))
                and torch.equal(got, cache[key + "_bits"])):
            raise AssertionError(f"{label}: the packing of {key} differs from the twin")
        b, _ = cs.bound_ms(mask.numel() + got.numel() * 4, 0)
        out["pack"][key] = dict(shape=list(mask.shape), ms=cs.time_ms(kernel),
                                device_ms=cs.device_ms(kernel), bound_ms=b)
    del sites, masks, pn_calls, cache
    out["refresh"] = {"ms": cs.time_ms(lambda: entropy.refresh_cache(occ), iters=5, warmup=1)}

    # ---- the step, after STEP_AT steps
    tr.fit(STEP_AT - 1, log_every=0)
    torch.cuda.synchronize()
    windows = []
    for _ in range(STEP_WINDOWS):
        t0 = time.time()
        tr.fit(tr.step + 19, log_every=0)
        torch.cuda.synchronize()
        windows.append((time.time() - t0) / 20 * 1e3)
    out["step"] = {"ms": statistics.median(windows), "ms_windows": windows}

    # ---- encode and decode of that trainer's tables
    codec = codec_mod.CNCCodec(entropy)
    with torch.no_grad():
        tables = {k: v.detach().clone() for k, v in rf.quantized_tables(tr.field,
                                                                         tr.cfg.model).items()}
    binaries = tr.occ_state.binaries
    bundle = work / f"bundle_{label}"
    enc_s, dec_s = [], []
    for _ in range(CODEC_RUNS):
        torch.cuda.synchronize()
        t0 = time.time()
        pgs, _, coded_mb = codec.encode(tr.ent_params, tables, binaries, str(bundle))
        torch.cuda.synchronize()
        enc_s.append(time.time() - t0)
        t0 = time.time()
        codec.decode(tr.ent_params, binaries, pgs, str(bundle))
        torch.cuda.synchronize()
        dec_s.append(time.time() - t0)
    out["codec"] = {"encode_s": statistics.median(enc_s), "encode_runs": enc_s,
                    "decode_s": statistics.median(dec_s), "decode_runs": dec_s,
                    "coded_mb": coded_mb}
    print(json.dumps(out))


def summary(path: Path) -> None:
    """Markdown tables of the `time` lines in `path`: each tree's mean over
    its runs, and each run's reading of the host-clock items."""
    runs = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith('{"tree"')]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    by = lambda t: [r for r in runs if r["tree"] == t]
    mean = lambda xs: sum(xs) / len(xs)
    print(f"{runs[0]['card']}; {len(runs)} runs ({', '.join(r['tree'] for r in runs)})")
    print("| item | " + " | ".join(trees) + " |")
    print("| --- |" + " --- |" * len(trees))
    for site, x in by(trees[0])[0]["k3"].items():
        for key, name in (("device_ms", "device ms"), ("ms", "ms"),
                          ("library_ms", "nonzero ms")):
            cells = [f"{mean([r['k3'][site][key] for r in by(t)]):.4f}" for t in trees]
            print(f"| K3 {site} (n {x['n']}, cap {x['cap']}, count {x['count']}), {name}"
                  f" (bound {x['bound_ms']:.4f}) | " + " | ".join(cells) + " |")
    for key, x in by(trees[0])[0]["pack"].items():
        for k, name in (("device_ms", "device ms"), ("ms", "ms")):
            cells = [f"{mean([r['pack'][key][k] for r in by(t)]):.4f}" for t in trees]
            print(f"| packing {key} {tuple(x['shape'])}, {name} (bound {x['bound_ms']:.4f}) | "
                  + " | ".join(cells) + " |")
    for name in by(trees[0])[0]["device_ops"]:
        cells = [", ".join(str(r["device_ops"][name]) for r in by(t)) for t in trees]
        print(f"| {name}: device operations per call, each run | " + " | ".join(cells) + " |")
    for key, name in (("refresh", "refresh_cache ms"), ("step", "lambda = 2e-3 step ms")):
        cells = [f"{mean([r[key]['ms'] for r in by(t)]):.4f}" for t in trees]
        print(f"| {name} | " + " | ".join(cells) + " |")
    for key, name in (("encode_s", "encode s"), ("decode_s", "decode s")):
        cells = [f"{mean([r['codec'][key] for r in by(t)]):.4f}" for t in trees]
        print(f"| {name} | " + " | ".join(cells) + " |")

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
    spread("encode s", lambda r: r["codec"]["encode_s"])
    spread("decode s", lambda r: r["codec"]["decode_s"])


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "summary":
        summary(Path(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("torch_compact_pack_ab: no CUDA device", file=sys.stderr)
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
