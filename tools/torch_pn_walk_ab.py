#!/usr/bin/env python3
"""A/B of the frac-plane kernels of csrc/pn_hist.cu (K7, K7i, K7b) alone
between trees, on one NVIDIA GPU, at the shapes of the lambda = 2e-3 step and
of the codec: no training, no encode.

    python3 tools/torch_pn_walk_ab.py prepare WORK
    python3 tools/torch_pn_walk_ab.py time WORK TREE LABEL >> LOG
    python3 tools/torch_pn_walk_ab.py summary LOG
    python3 tools/torch_pn_walk_ab.py inputs WORK

`prepare` runs tools/torch_refresh_pn_ab.py's and tools/torch_codec_ab.py's
`prepare` into WORK: a lambda = 2e-3 run's quantized 3D table and occupancy
grid after 300 steps, and the signs of runs_20k's decoded tables.

`time` imports cnc_torch from TREE (a directory holding a version's
`cnc_torch/` with the one-launch backward, `_pn_hist_backward_launch`),
builds its kernels into TREE/cnc_torch/_build and prints one JSON line,
every time by chip_smoke.device_ms (CUDA events behind a spin kernel):
  * `k7`: each axis's frac plane at the step's sample cap (the saved grid's
    refreshed pn lists), the kernel alone, equal to its twin;
  * `k7b`: the xy plane's backward kernel alone into a zeroed table, and
    the whole autograd backward, within chip_smoke.K7B_REL_TOL of the
    twin run in float64;
  * `k7i`: each axis's integer plane on the 20k bundle's pn lists and 3D
    signs, equal to its twin.
`inputs` times this tree's kernels on the same lists changed to isolate
what bounds them, every result held to its twin: each codec plane's rows
a warp's run and a tile hold (mean over the runs that hold any, the most,
the 99th percentile); K7i on the real list, on the same rows spread evenly
over the bins (bounds[b] = b * m // bins: no long run), and on both with
every row's entry set to 0 (a warp's sign loads then read one row: no
random gather); K7 (the step's xy plane) on its list and with every entry
0; K7b's kernel alone on its table and on a table of -1 (no value above
0.9: no atomic).

Times vary between calls: compare trees only within one call, in turns.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
AXES = ("xy", "xz", "yz")


def _tools():
    sys.path.insert(1, str(REPO))
    sys.path.insert(1, str(REPO / "tools"))
    import chip_smoke
    import torch_codec_ab
    import torch_refresh_pn_ab
    return chip_smoke, torch_codec_ab, torch_refresh_pn_ab


def prepare(work: Path) -> None:
    sys.path.insert(0, str(REPO))
    _, codec_ab, refresh_ab = _tools()
    refresh_ab.prepare(work)
    codec_ab.prepare(work)


def time_tree(work: Path, tree: Path, label: str) -> None:
    import torch
    sys.path.insert(0, str(tree.resolve()))
    import cnc_torch
    from cnc_torch import kernels
    from cnc_torch.codec import intctx
    from cnc_torch.config import CNCConfig
    from cnc_torch.models import context_models as cm
    from cnc_torch.ops import context_ops as cops
    if Path(cnc_torch.__file__).resolve().parent != (tree / "cnc_torch").resolve():
        raise RuntimeError(f"cnc_torch was not imported from {tree}")
    cs, codec_ab, _ = _tools()
    kernels.lib()
    dev = torch.device("cuda")
    out = {"tree": label, "card": cs.card_line(), "device": torch.cuda.get_device_name(0)}

    def check(name, ok, detail=""):
        if not ok:
            raise AssertionError(f"{label}: {name} differs from its twin {detail}")

    # ---- the step's planes (K7) and the xy plane's backward (K7b)
    inputs = torch.load(work / "inputs.pt")
    occ, table = inputs["occ"].to(dev), inputs["table"].to(dev)
    cfg = CNCConfig()
    entropy = cm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d)
    cache = entropy.refresh_cache(occ)
    sample_cap = entropy.cfg.pn_frac_sample_cap
    args = {ax: (table, entropy.fine_offset, cache["pn"][ax]["entry_idx"],
                 cache["pn"][ax]["bounds"], cache["pn"][ax]["n"], entropy.pn_res, sample_cap)
            for ax in AXES}
    out["k7"] = {}
    for ax in AXES:
        a = args[ax]
        check(f"K7 {ax}", torch.equal(cops._pn_frac_plane_cuda(*a),
                                      cops._pn_frac_plane_plain(*a)))
        out["k7"][ax] = cs.device_ms(lambda a=a: cops._pn_frac_plane_cuda(*a))
    a = args["xy"]
    leaf = table.clone().requires_grad_()
    plane = cops.pn_frac_plane(leaf, *a[1:])
    cot = torch.randn(plane.shape, generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)
    whole = lambda: torch.autograd.grad(plane, leaf, cot, retain_graph=True)
    (got,) = whole()
    leaf64 = table.double().requires_grad_()
    (exact,) = torch.autograd.grad(cops._pn_frac_plane_plain(leaf64, *a[1:]), leaf64,
                                   cot.double())
    err = cs.rel_err(got, exact.float())
    check("K7b xy", err <= cs.K7B_REL_TOL, f"(rel err {err})")
    del leaf64, exact, got
    d_table = torch.zeros_like(table)
    out["k7b"] = {"rel_err": err, "whole": cs.device_ms(whole),
                  "kernel": cs.device_ms(lambda: cops._pn_hist_backward_launch(
                      *a, cot, d_table))}
    del entropy, cache, args, plane, leaf, d_table, table, occ
    torch.cuda.empty_cache()

    # ---- the codec's planes (K7i) on the 20k bundle's lists and signs
    entropy, _, _, _, binaries = codec_ab._model(dev)
    cache = entropy.refresh_cache_int(binaries)
    saved = torch.load(work / "tables.pt")
    sign3 = intctx.sign_table(torch.where(saved["signs"]["xyz"], 1.0, -1.0).to(dev))
    out["k7i"] = {}
    for ax in AXES:
        a = (sign3, cache["pn"][ax], entropy.fine_offset, entropy.pn_res,
             entropy.cfg.n_features)
        check(f"K7i {ax}", torch.equal(intctx._frac_plane_cuda(*a), intctx.int_frac_plane(*a)))
        out["k7i"][ax] = cs.device_ms(lambda a=a: intctx._frac_plane_cuda(*a))
    print(json.dumps(out))


def inputs(work: Path) -> None:
    import torch
    sys.path.insert(0, str(REPO))
    from cnc_torch import kernels
    from cnc_torch.codec import intctx
    from cnc_torch.config import CNCConfig
    from cnc_torch.models import context_models as cm
    from cnc_torch.ops import context_ops as cops
    cs, codec_ab, _ = _tools()
    kernels.lib()
    dev = torch.device("cuda")
    out = {"card": cs.card_line(), "device": torch.cuda.get_device_name(0)}

    def held(name, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its twin")

    # ---- the codec's planes
    entropy, _, _, _, binaries = codec_ab._model(dev)
    cache = entropy.refresh_cache_int(binaries)
    sign3 = intctx.sign_table(torch.where(torch.load(work / "tables.pt")["signs"]["xyz"], 1.0,
                                          -1.0).to(dev))
    scale, f = entropy.pn_res - 2, entropy.cfg.n_features
    out["k7i"] = {}
    for ax in AXES:
        pn = cache["pn"][ax]
        cap = pn["entry_idx"].shape[0]
        m = min(int(pn["n"]), cap)
        lens = (pn["bounds"][1:] - pn["bounds"][:-1]).long().reshape(scale, scale)   # [x, y]
        runs = lens.reshape(scale, scale // 8, 8).sum(2).reshape(-1).float()
        tiles = lens.reshape(scale // 8, 8, scale // 8, 8).sum((1, 3)).reshape(-1).float()
        rec = {"listed": m, "bins_with_rows": int((lens > 0).sum()),
               "run_rows": {"mean": float(runs[runs > 0].mean()), "max": float(runs.max()),
                            "p99": float(torch.quantile(runs[runs > 0], 0.99))},
               "tile_rows": {"mean": float(tiles[tiles > 0].mean()), "max": float(tiles.max())}}
        even = (torch.arange(scale * scale + 1, device=dev, dtype=torch.int64) * m
                // (scale * scale)).to(torch.int32)
        zero = torch.zeros_like(pn["entry_idx"])
        for name, lists in (("real", pn), ("even", {**pn, "bounds": even}),
                            ("real, entries 0", {**pn, "entry_idx": zero}),
                            ("even, entries 0", {**pn, "bounds": even, "entry_idx": zero})):
            a = (sign3, lists, entropy.fine_offset, entropy.pn_res, f)
            held(f"K7i {ax} {name}", intctx._frac_plane_cuda(*a), intctx.int_frac_plane(*a))
            rec[name] = cs.device_ms(lambda a=a: intctx._frac_plane_cuda(*a))
        out["k7i"][ax] = rec
    del entropy, cache, sign3, binaries
    torch.cuda.empty_cache()

    # ---- the step's xy plane: K7 and K7b's kernel alone
    saved = torch.load(work / "inputs.pt")
    table = saved["table"].to(dev)
    cfg = CNCConfig()
    entropy = cm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d)
    pn = entropy.refresh_cache(saved["occ"].to(dev))["pn"]["xy"]
    a = (table, entropy.fine_offset, pn["entry_idx"], pn["bounds"], pn["n"], entropy.pn_res,
         entropy.cfg.pn_frac_sample_cap)
    a0 = a[:2] + (torch.zeros_like(pn["entry_idx"]),) + a[3:]
    out["k7"] = {}
    for name, args in (("real", a), ("entries 0", a0)):
        held(f"K7 {name}", cops._pn_frac_plane_cuda(*args), cops._pn_frac_plane_plain(*args))
        out["k7"][name] = cs.device_ms(lambda args=args: cops._pn_frac_plane_cuda(*args))
    g = torch.randn(entropy.pn_res ** 2, table.shape[1],
                    generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    out["k7b"] = {}
    for name, t in (("real", table), ("table -1, no atomic", torch.full_like(table, -1.0))):
        want = cops.pn_hist_backward_plain(t.double(), *a[1:], g.double())
        err = cs.rel_err(cops._pn_hist_backward_cuda(t, *a[1:], g), want.float())
        if not err <= cs.K7B_REL_TOL or (name != "real" and float(want.abs().max()) != 0.0):
            raise AssertionError(f"K7b {name}: rel err {err}")
        d_table = torch.zeros_like(t)
        out["k7b"][name] = cs.device_ms(lambda t=t, d=d_table: cops._pn_hist_backward_launch(
            t, *a[1:], g, d))
    print(json.dumps(out))


def summary(path: Path) -> None:
    """A markdown table of each tree's mean over its runs."""
    runs = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith('{"tree"')]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    by = lambda t: [r for r in runs if r["tree"] == t]
    mean = lambda xs: sum(xs) / len(xs)
    print(f"{runs[0]['card']}; {len(runs)} runs ({', '.join(r['tree'] for r in runs)})")
    print("| device ms | " + " | ".join(trees) + " |")
    print("| --- |" + " --- |" * len(trees))
    rows = [(f"K7 {ax}", lambda r, ax=ax: r["k7"][ax]) for ax in AXES]
    rows += [("K7b kernel alone (xy)", lambda r: r["k7b"]["kernel"]),
             ("K7b whole autograd backward (xy)", lambda r: r["k7b"]["whole"])]
    rows += [(f"K7i {ax}", lambda r, ax=ax: r["k7i"][ax]) for ax in AXES]
    for name, get in rows:
        print(f"| {name} | " + " | ".join(f"{mean([get(r) for r in by(t)]):.4f}"
                                          for t in trees) + " |")


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "summary":
        summary(Path(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("torch_pn_walk_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "prepare":
        prepare(Path(sys.argv[2]))
    elif len(sys.argv) == 3 and sys.argv[1] == "inputs":
        inputs(Path(sys.argv[2]))
    elif len(sys.argv) == 5 and sys.argv[1] == "time":
        time_tree(Path(sys.argv[2]), Path(sys.argv[3]), sys.argv[4])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
