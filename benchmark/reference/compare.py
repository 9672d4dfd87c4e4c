"""The comparison that decides `correct`: the numbers compared, each with its
limit.  The limits live in the cell's workload file (`check.limits`), set
from the readings that `PERF.md` gives."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

Number = Tuple[str, float, float]       # (name, value, limit)


def _max(values) -> float:
    """The largest value; infinite where any is not a finite number."""
    values = list(values)
    return max(values) if values and all(math.isfinite(v) for v in values) else math.inf


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """Leaves whose first gradient in the reference is at least a thousandth
    of the median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(ref_grad.values())
    return sorted(n for n, g in ref_grad.items() if g >= 1e-3 * med)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """Each leaf's gap between the program's and the reference's norm, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    med = statistics.median(ref.values())
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves}


def loss_gaps(prog: dict, ref: dict) -> List[float]:
    """Each step's relative loss gap."""
    if len(prog["loss"]) != len(ref["loss"]):
        return [math.inf]
    return [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"])]


def train(prog: dict, ref: dict, limits: Dict[str, float]) -> List[Number]:
    """The first step's loss (relative), the first gradient by the worst
    leaf, and the change over the checked steps by the median leaf.  The
    later steps' losses and the worst leaf's change are left out: an
    entry that a step moves across 0 flips its binarized value, and the
    rate's small context MLPs carry that round-off from step to step
    (PERF.md gives the readings)."""
    loss = _max(loss_gaps(prog, ref)[:1])
    grad = _max(leaf_gaps(prog["grad"], ref["grad"], sorted(ref["grad"])).values())
    gaps = leaf_gaps(prog["change"], ref["change"], moved_leaves(ref["grad"]))
    change = (statistics.median(gaps.values())
              if gaps and all(math.isfinite(v) for v in gaps.values()) else math.inf)
    return [("loss_gap", loss, limits["loss_gap"]), ("grad_gap", grad, limits["grad_gap"]),
            ("change_gap", change, limits["change_gap"])]


def serve(prog_views, ref_views, limits: Dict[str, float]) -> List[Number]:
    """Widest gaps over the checked views' pixels: rgb, opacity, and the
    depth times the opacity (the expected-depth integral; depth alone is
    divided by an opacity that may be near 0)."""
    g = {"rgb_gap": 0.0, "opacity_gap": 0.0, "depth_gap": 0.0}
    for (rgb, op, dep), (rgb_r, op_r, dep_r) in zip(prog_views, ref_views):
        g["rgb_gap"] = max(g["rgb_gap"], float((rgb.double() - rgb_r.double()).abs().max()))
        g["opacity_gap"] = max(g["opacity_gap"], float((op.double() - op_r.double()).abs().max()))
        g["depth_gap"] = max(g["depth_gap"], float(
            (dep.double() * op.double() - dep_r.double() * op_r.double()).abs().max()))
    return [(k, v, limits[k]) for k, v in g.items()]


def correct(numbers: List[Number]) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in numbers)
