#!/usr/bin/env python3
"""A/B of K7p and K7pb (csrc/pn_hist.cu `pn_hist_part`, `pn_hist_part_bwd`),
a data-parallel rank's share of a frac plane, alone between trees on one
NVIDIA GPU, on the rate step's real plane: no training, no collective.

    python3 tools/torch_pn_part_ab.py prepare WORK
    python3 tools/torch_pn_part_ab.py time WORK TREE LABEL [--unchecked] >> LOG
    python3 tools/torch_pn_part_ab.py summary LOG

`prepare` runs tools/torch_refresh_pn_ab.py's `prepare` into WORK: a
lambda = 2e-3 run's quantized 3D table and occupancy grid after 300 steps.

`time` imports cnc_torch from TREE (a directory holding a version's
`cnc_torch/`), builds its kernels into TREE/cnc_torch/_build, refreshes the
full-width ContextModels' cache on the saved grid and prints one JSON line
for the xy plane, as chip_smoke.py [dp] takes it, in the sampled mode
(the step's sample cap, 2^21 rows) and the unsampled one (the 2^24 list):
  * `k7p`: for W = 2, 4, 8 the shares of rank 0 and rank W - 1 (chunks of
    ceil(rows / W) rows), each equal to its twin (partial and divisors),
    every rank's partial summed and finished equal to the one-launch K7
    plane; device ms (CUDA events behind a spin kernel,
    chip_smoke.device_ms), ms with the host (CUDA events around
    `pn_hist_part`, chip_smoke.time_ms) and the bound (bytes: the share's
    row ids, a table row a distinct entry, the bounds, the partial and the
    divisors; chip_smoke.bound_ms);
  * `size0`: a launch with no rows (lo = 0, size = 0), the fixed part: the
    divisors and the partial's zeros, equal to the twin;
  * `k7pb`: the same shares' backward kernel alone into a zeroed table
    (chip_smoke.device_ms), its bound, and the whole autograd backward's
    largest error against the twin run in float64 over the largest entry,
    within chip_smoke.K7B_REL_TOL;
  * `k7`: the whole plane's kernel (K7), for scale; `floor`: the device ms
    of zeroing one float, what a launch that does nothing costs here.
`--unchecked` times a tree without holding it to the twins (and without
K7pb's float64 backward): for a variant with a part of its work cut out, to
see what that part costs.  `summary` gives each figure's mean over a tree's
runs with their range, and whether the trees' ranges overlap.

Times vary between calls: compare trees only within one call, in turns
(parent, new, new, parent).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WORLD_SIZES = (2, 4, 8)


def _tools():
    sys.path.insert(1, str(REPO))
    sys.path.insert(1, str(REPO / "tools"))
    import chip_smoke
    import torch_refresh_pn_ab
    return chip_smoke, torch_refresh_pn_ab


def prepare(work: Path) -> None:
    sys.path.insert(0, str(REPO))
    _, refresh_ab = _tools()
    refresh_ab.prepare(work)


def time_tree(work: Path, tree: Path, label: str, checked: bool = True) -> None:
    import torch
    sys.path.insert(0, str(tree.resolve()))
    import cnc_torch
    from cnc_torch import kernels
    from cnc_torch.config import CNCConfig
    from cnc_torch.models import context_models as cm
    from cnc_torch.ops import context_ops as cops
    if Path(cnc_torch.__file__).resolve().parent != (tree / "cnc_torch").resolve():
        raise RuntimeError(f"cnc_torch was not imported from {tree}")
    cs, _ = _tools()
    kernels.lib()
    dev = torch.device("cuda")
    out = {"tree": label, "card": cs.card_line(), "device": torch.cuda.get_device_name(0)}

    inputs = torch.load(work / "inputs.pt")
    cfg = CNCConfig()
    entropy = cm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d)
    pn = entropy.refresh_cache(inputs["occ"].to(dev))["pn"]["xy"]
    out.update(measure(torch, cs, cops, inputs["table"].to(dev), entropy.fine_offset, pn,
                       entropy.pn_res, entropy.cfg.pn_frac_sample_cap, label, checked))
    print(json.dumps(out))


def measure(torch, cs, cops, table, off, pn, res, sample_cap, label, checked=True) -> dict:
    """The `time` command's figures on one plane's inputs; `checked`: each
    result held to its twin."""
    eidx, bounds, n = pn["entry_idx"], pn["bounds"], pn["n"]
    args = (table, off, eidx, bounds, n, res)
    bins, f = (res - 2) ** 2, table.shape[1]
    gen = torch.Generator(device=table.device).manual_seed(7)
    one = torch.zeros(1, device=table.device)
    out = dict(k7={}, k7p={}, size0={}, k7pb={}, floor=cs.device_ms(one.zero_))

    def check(name, ok, detail=""):
        if checked and not ok:
            raise AssertionError(f"{label}: {name} differs from its twin {detail}")

    for mode, cap in (("sampled", sample_cap), ("unsampled", None)):
        whole = cops._pn_frac_plane_cuda(*args, cap)
        check(f"K7 {mode}", torch.equal(whole, cops._pn_frac_plane_plain(*args, cap)))
        out["k7"][mode] = cs.device_ms(lambda cap=cap: cops._pn_frac_plane_cuda(*args, cap))
        rows = cops.pn_row_count(eidx, cap)

        part, den = cops._pn_part_cuda(*args, cap, 0, 0)
        want, want_den = cops._pn_part_plain(table, off, eidx, bounds, n, cap, 0, 0)
        check(f"K7p {mode} size 0", torch.equal(part, want) and torch.equal(den, want_den))
        b, by = cs.bound_ms((bins + 1) * 4 + 4 + bins * 4 * f + bins * 4, bins * f)
        out["size0"][mode] = dict(
            device_ms=cs.device_ms(lambda cap=cap: cops._pn_part_cuda(*args, cap, 0, 0)),
            ms=cs.time_ms(lambda cap=cap: cops.pn_hist_part(*args, cap, 0, 0)),
            bound_ms=b, bound_by=by)

        for w in WORLD_SIZES:
            chunk = -(-rows // w)
            total = None
            for r in range(w):
                part, den = cops._pn_part_cuda(*args, cap, r * chunk, chunk)
                total = part if total is None else total + part
                if r not in (0, w - 1):
                    continue
                want, want_den = cops._pn_part_plain(table, off, eidx, bounds, n, cap,
                                                     r * chunk, chunk)
                check(f"K7p {mode} W={w} rank {r}",
                      torch.equal(part, want) and torch.equal(den, want_den))
                lo = r * chunk
                sel, row_valid, _ = cops._pn_rows(eidx, bounds, n, cap, lo, chunk)
                n_valid = int(row_valid.sum())
                n_entries = torch.unique(sel[row_valid]).numel()
                b, by = cs.bound_ms(n_valid * 4 + n_entries * 4 * f + (bins + 1) * 4 + 4
                                    + bins * 4 * f + bins * 4, (n_valid + bins) * f)
                key = f"{mode} W={w} rank {r}"
                out["k7p"][key] = dict(
                    rows=chunk, counted=n_valid, distinct_entries=n_entries,
                    device_ms=cs.device_ms(lambda lo=lo: cops._pn_part_cuda(*args, cap, lo,
                                                                              chunk)),
                    ms=cs.time_ms(lambda lo=lo: cops.pn_hist_part(*args, cap, lo, chunk)),
                    bound_ms=b, bound_by=by)

                # K7pb: the whole autograd backward against float64, then the kernel alone
                cot = torch.randn(bins, f, generator=gen, device=table.device)
                err = None
                if checked:
                    err = _k7pb_err(torch, cs, cops, table, off, eidx, bounds, n, res, cap, lo,
                                    chunk, cot)
                    check(f"K7pb {mode} W={w} rank {r}", err <= cs.K7B_REL_TOL,
                          f"(rel err {err})")
                ind = row_valid[:, None] & (table[off + sel.long()] > 0.9)
                n_set = torch.unique(sel[ind.any(1)]).numel()
                kb, kby = cs.bound_ms(n_valid * 4 + n_entries * 4 * f + (bins + 1) * 4 + 4
                                      + bins * 4 * f + n_set * 4 * f,
                                      (n_valid + bins) * f + int(ind.sum()))
                d_table = torch.zeros_like(table)
                out["k7pb"][key] = dict(
                    rel_err=err, kernel_bound_ms=kb, kernel_bound_by=kby,
                    kernel_device_ms=cs.device_ms(
                        lambda lo=lo, cot=cot, d=d_table: cops._pn_part_backward_launch(
                            *args, cap, lo, chunk, cot, d)))
                del d_table
            check(f"K7p {mode} W={w} sum", torch.equal(cops.pn_frac_finish(total, den, res),
                                                       whole))
    return out


def _k7pb_err(torch, cs, cops, table, off, eidx, bounds, n, res, cap, lo, size, cot) -> float:
    """The whole autograd backward of a share against its twin in float64:
    the largest error over the largest entry."""
    leaf = table.clone().requires_grad_()
    (got,) = torch.autograd.grad(cops.pn_hist_part(leaf, off, eidx, bounds, n, res, cap, lo,
                                                   size)[0], leaf, cot)
    leaf64 = table.double().requires_grad_()
    (exact,) = torch.autograd.grad(cops._pn_part_plain(leaf64, off, eidx, bounds, n, cap, lo,
                                                       size)[0], leaf64, cot.double())
    return (cs.rel_err(got, exact.float()) if exact.abs().max() > 0
            else float(got.abs().max()))


def summary(path: Path) -> None:
    """A markdown table: each figure's mean over a tree's runs (min-max), and
    whether the two trees' ranges overlap."""
    runs = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith('{"tree"')]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    by = lambda t: [r for r in runs if r["tree"] == t]
    print(f"{runs[0]['card']}; {len(runs)} runs ({', '.join(r['tree'] for r in runs)})")
    print("| ms | " + " | ".join(trees) + " | bound | ranges overlap |")
    print("| --- |" + " --- |" * (len(trees) + 2))
    rows = [(f"K7 {m}, device", lambda r, m=m: r["k7"][m], None) for m in runs[0]["k7"]]
    if all("floor" in r for r in runs):
        rows.insert(0, ("a launch that zeroes one float, device", lambda r: r["floor"], None))
    rows += [(f"K7p size 0 {m}, {k}", lambda r, m=m, k=k: r["size0"][m][k],
              lambda r, m=m: r["size0"][m]["bound_ms"])
             for m in runs[0]["size0"] for k in ("device_ms", "ms")]
    rows += [(f"K7p {s}, {k}", lambda r, s=s, k=k: r["k7p"][s][k],
              lambda r, s=s: r["k7p"][s]["bound_ms"])
             for s in runs[0]["k7p"] for k in ("device_ms", "ms")]
    rows += [(f"K7pb {s}, kernel device", lambda r, s=s: r["k7pb"][s]["kernel_device_ms"],
              lambda r, s=s: r["k7pb"][s]["kernel_bound_ms"]) for s in runs[0]["k7pb"]]
    for name, get, bound in rows:
        spans = []
        cells = []
        for t in trees:
            xs = [get(r) for r in by(t)]
            spans.append((min(xs), max(xs)))
            cells.append(f"{sum(xs) / len(xs):.4f} ({min(xs):.4f}-{max(xs):.4f})")
        overlap = (len(spans) == 2 and spans[0][0] <= spans[1][1] and spans[1][0] <= spans[0][1])
        b = f"{bound(runs[0]):.5f}" if bound else ""
        print(f"| {name} | " + " | ".join(cells) + f" | {b} | "
              + ("yes" if overlap else "no" if len(spans) == 2 else "") + " |")


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "summary":
        summary(Path(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("torch_pn_part_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "prepare":
        prepare(Path(sys.argv[2]))
    elif len(sys.argv) in (5, 6) and sys.argv[1] == "time" and sys.argv[5:] in ([],
                                                                             ["--unchecked"]):
        time_tree(Path(sys.argv[2]), Path(sys.argv[3]), sys.argv[4], len(sys.argv) == 5)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
