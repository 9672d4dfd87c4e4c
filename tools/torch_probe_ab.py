#!/usr/bin/env python3
"""A/B of cnc_torch's two probe kernels (`lane_gather`, csrc/probe.cu, and
`scatter_add`, csrc/scatter_add.cu) between trees, on one NVIDIA GPU, at the
shapes and data `chip_smoke.py` [probe] drives them at (tools/pallas_probe.py's:
an [8, 2^18] table, 2^23 indices, numpy seed 0).

    python3 tools/torch_probe_ab.py prepare WORK
    python3 tools/torch_probe_ab.py time WORK TREE LABEL >> LOG
    python3 tools/torch_probe_ab.py summary LOG

`prepare` makes the inputs with `chip_smoke.probe_inputs` and saves them to
WORK/inputs.pt (about 310 MB).

`time` imports cnc_torch from TREE (a directory holding another version's
`cnc_torch/`, e.g. a commit unpacked with `git archive`) and builds its
kernels into TREE/cnc_torch/_build.  It drives each kernel once through the
tree's public wrapper with the counts at 0 (one launch each), holds the
results to the tree's twins (lane_gather equal, scatter_add within
chip_smoke's SCATTER_REL_TOL of the largest entry), then times both with
`chip_smoke.probe_times`: ms with the wrapper (CUDA events), device ms
(behind a spin kernel), the plain twin's ms, the library call's ms and device
ms (`index_select`, `zeros` + `index_add_`) and the bound, and prints one
JSON line.

Times vary between calls by up to 1.5x: compare trees only within one call,
in turns (a, b, b, a), e.g.

    for t in parent new new parent; do
        python3 tools/torch_probe_ab.py time WORK trees/$t $t >> LOG; done

`summary` gives, per kernel and tree, the mean over its runs and each run's
ms and device ms, the library's in the same runs, and whether the two trees'
ranges of device ms overlap (then the difference is not resolved by the
runs).
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
KERNELS = ("lane_gather", "scatter_add")


def _smoke():
    sys.path.insert(1, str(REPO))
    import chip_smoke
    return chip_smoke


def prepare(work: Path) -> None:
    import torch
    cs = _smoke()
    work.mkdir(parents=True, exist_ok=True)
    idx, tbl_t, vals = cs.probe_inputs(torch, torch.device("cpu"))
    torch.save({"idx": idx, "tbl_t": tbl_t, "vals": vals}, work / "inputs.pt")
    print(f"[prepare] idx {tuple(idx.shape)}, table {tuple(tbl_t.shape)}, vals"
          f" {tuple(vals.shape)} into {work / 'inputs.pt'}")


def time_tree(work: Path, tree: Path, label: str) -> None:
    import torch
    sys.path.insert(0, str(tree.resolve()))
    import cnc_torch
    from cnc_torch import kernels
    from cnc_torch.ops import scatter_ops
    if Path(cnc_torch.__file__).resolve().parent != (tree / "cnc_torch").resolve():
        raise RuntimeError(f"cnc_torch was not imported from {tree}")
    cs = _smoke()
    kernels.lib()
    dev = torch.device("cuda")
    inputs = {k: v.to(dev) for k, v in torch.load(work / "inputs.pt").items()}
    idx, tbl_t, vals = inputs["idx"], inputs["tbl_t"], inputs["vals"]
    t = tbl_t.shape[1]
    torch.cuda.synchronize()
    kernels.reset_launches()
    gathered = scatter_ops.lane_gather(tbl_t, idx)
    summed = scatter_ops.scatter_add(vals, idx, t)
    torch.cuda.synchronize()
    launches = {k: kernels.launches[k] for k in KERNELS}
    if launches != {k: 1 for k in KERNELS}:
        raise AssertionError(f"{label}: launches {launches}, not one each")
    if not torch.equal(gathered, scatter_ops._lane_gather_plain(tbl_t, idx)):
        raise AssertionError(f"{label}: lane_gather differs from its twin")
    err = cs.rel_err(summed, scatter_ops._scatter_add_plain(vals, idx, t))
    if not err <= cs.SCATTER_REL_TOL:
        raise AssertionError(f"{label}: scatter_add rel err {err} > {cs.SCATTER_REL_TOL}")
    del gathered, summed
    recs = cs.probe_times(torch, scatter_ops, idx, tbl_t, vals)
    recs["scatter_add"]["rel_err"] = err
    print(json.dumps({"tree": label, "card": cs.card_line(),
                      "device": torch.cuda.get_device_name(0), "launches": launches,
                      "kernels": recs}), flush=True)


def summary(path: Path) -> None:
    runs = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith('{"tree"')]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    print(f"{runs[0]['card']}; {len(runs)} runs")
    for name in KERNELS:
        spans = {}
        for t in trees:
            got = [r["kernels"][name] for r in runs if r["tree"] == t]
            dev = [g["device_ms"] for g in got]
            spans[t] = (min(dev), max(dev))
            lib_dev = [g["other"]["library_device_ms"] for g in got]
            print(f"{name} {t}: ms {statistics.mean(g['ms'] for g in got):.4f}"
                  f" {[round(g['ms'], 4) for g in got]}, device ms {statistics.mean(dev):.4f}"
                  f" {[round(x, 4) for x in dev]}; library ms"
                  f" {statistics.mean(g['library_ms'] for g in got):.4f}, library device ms"
                  f" {statistics.mean(lib_dev):.4f} {[round(x, 4) for x in lib_dev]};"
                  f" plain ms {statistics.mean(g['plain_ms'] for g in got):.4f};"
                  f" bound {got[0]['bound_ms']:.4f} ({got[0]['bound_by']})")
        if len(trees) == 2:
            (lo_a, hi_a), (lo_b, hi_b) = spans.values()
            print(f"{name}: device ms ranges "
                  + ("do not overlap (resolved)" if hi_a < lo_b or hi_b < lo_a
                     else "overlap (not resolved)"))


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "summary":
        summary(Path(sys.argv[2]))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "prepare":
        prepare(Path(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("torch_probe_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 5 and sys.argv[1] == "time":
        time_tree(Path(sys.argv[2]), Path(sys.argv[3]), sys.argv[4])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
