"""The program's own spans in a traced window: `cnc/<name>` ranges that
`cnc_torch/utils/profiling.span` records at the port's layer boundaries,
on the profiler's clock, the clock of the card's operations.

The device's idle time is the gaps between its merged operations (the gaps
`Trace.breakdown` finds).  Here it is laid over the spans: the idle time
inside the union of some spans less the union of others, and each gap's
share by the innermost span the host was in.  The program also counts the
spans it records (`profiling.recorded`): the sync counter.
"""

from __future__ import annotations

import bisect
import fnmatch
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PREFIX = "cnc/"
ROOTS = ("cnc/train/step", "cnc/serve/view", "cnc/serve/chunk")
OUTSIDE = "outside the spans"

# device-idle ms a step or a view inside the union of spans `include` less
# the union of `exclude` (fnmatch patterns), by the traffic kind that has them
IDLE_MS = {
    "rate_idle_ms.train": ("train", ("cnc/train/rate",), ()),
    "backward_idle_ms.train": ("train", ("cnc/train/backward",), ()),
    "update_idle_ms.train": ("train", ("cnc/train/update",), ()),
    "field_idle_ms.serve": ("serve", ("cnc/render/field",), ()),
    "round_idle_ms.serve": ("serve", ("cnc/serve/round",), ("cnc/render/field",)),
}

Segment = Tuple[float, float, Tuple[dict, ...]]


def spans(evs: Iterable[dict]) -> List[dict]:
    """The trace's complete events that are the program's spans."""
    return [e for e in evs if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PREFIX)]


def idle_gaps(device_ops: Iterable[dict]) -> List[Tuple[float, float]]:
    """The gaps between the merged intervals of the device operations (us)."""
    gaps, end = [], None
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device_ops):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def segments(sp: Sequence[dict]) -> List[Segment]:
    """The time the spans cover, cut at every span's start and end: (start,
    end, the spans open there, the outermost first).  Spans of one thread
    nest, so the last open span is the innermost."""
    bounds = sorted({s["ts"] for s in sp} | {s["ts"] + s["dur"] for s in sp})
    by_start = sorted(sp, key=lambda s: (s["ts"], -s["dur"]))
    live, k, out = [], 0, []
    for t, nxt in zip(bounds, bounds[1:]):
        live = [s for s in live if s["ts"] + s["dur"] > t]
        while k < len(by_start) and by_start[k]["ts"] <= t:
            if by_start[k]["ts"] + by_start[k]["dur"] > t:
                live.append(by_start[k])
            k += 1
        if live:
            out.append((t, nxt, tuple(live)))
    return out


def _overlap(gaps, segs, label) -> Dict[str, float]:
    """Seconds of the gaps inside each label's segments; label(open spans)
    names a segment's label, or None to leave it out."""
    out, i, j = defaultdict(float), 0, 0
    while i < len(gaps) and j < len(segs):
        a, b = max(gaps[i][0], segs[j][0]), min(gaps[i][1], segs[j][1])
        if b > a:
            lab = label(segs[j][2])
            if lab is not None:
                out[lab] += (b - a) * 1e-6
        if gaps[i][1] < segs[j][1]:
            i += 1
        else:
            j += 1
    return dict(out)


def _matches(name: str, patterns: Sequence[str]) -> bool:
    return any(fnmatch.fnmatchcase(name, p) for p in patterns)


def idle_seconds(device_ops, sp, include: Sequence[str], exclude: Sequence[str] = ()) -> float:
    """Device-idle seconds while the host is inside a span `include` and
    inside no span `exclude`."""
    def label(live):
        names = [s["name"] for s in live]
        inside = any(_matches(n, include) for n in names)
        return "in" if inside and not any(_matches(n, exclude) for n in names) else None
    return _overlap(idle_gaps(device_ops), segments(sp), label).get("in", 0.0)


def idle_by_innermost(device_ops, sp) -> Dict[str, float]:
    """Device-idle seconds by the innermost span open on the host, the rest
    under OUTSIDE."""
    gaps = idle_gaps(device_ops)
    out = _overlap(gaps, segments(sp), lambda live: live[-1]["name"])
    rest = sum(b - a for a, b in gaps) * 1e-6 - sum(out.values())
    if rest > 0:
        out[OUTSIDE] = rest
    return out


def covered_share(device_ops, sp) -> Optional[float]:
    """The share of device-idle time inside a span other than ROOTS."""
    gaps = idle_gaps(device_ops)
    total = sum(b - a for a, b in gaps) * 1e-6
    if total <= 0:
        return None
    inner = _overlap(gaps, segments(sp),
                     lambda live: "in" if any(s["name"] not in ROOTS for s in live) else None)
    return inner.get("in", 0.0) / total


def early_ops(evs: Sequence[dict]) -> List[float]:
    """For each device operation that starts before the innermost span its
    launch call lies in (on the launching thread) started, by how many us:
    none where the spans and the device share one clock."""
    dev = {}
    for e in evs:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.setdefault(e.get("args", {}).get("correlation"), []).append(e)
    sp = spans(evs)
    segs = {tid: segments([s for s in sp if s["tid"] == tid]) for tid in {s["tid"] for s in sp}}
    starts = {tid: [g[0] for g in v] for tid, v in segs.items()}
    early = []
    for e in evs:
        ops = dev.get(e.get("args", {}).get("correlation"))
        if e.get("cat") != "cuda_runtime" or not ops or e["tid"] not in segs:
            continue
        i = bisect.bisect_right(starts[e["tid"]], e["ts"]) - 1
        if i >= 0 and e["ts"] < segs[e["tid"]][i][1]:
            start = segs[e["tid"]][i][2][-1]["ts"]
            early += [start - op["ts"] for op in ops if op["ts"] < start]
    return early


def recorded_syncs(steps: int) -> Optional[int]:
    """The `sync/` spans the program counted while the profiler ran, where
    that count covers exactly `steps` training steps and no view (a process
    that ran one traced training window); None otherwise, and where the
    program keeps no count."""
    try:
        from cnc_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "recorded", None)
    if rec is None or rec.get("train/step", 0) != steps or rec.get("serve/view", 0):
        return None
    return sum(n for k, n in rec.items() if k.startswith("sync/"))


def summary(evs: Sequence[dict], kind: str, per: int) -> dict:
    """What the spans say of one traced window of `per` steps or views."""
    dev = [e for e in evs if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    sp = spans(evs)
    counts = defaultdict(int)
    for s in sp:
        counts[s["name"]] += 1
    idle = {name: 1e3 * idle_seconds(dev, sp, inc, exc) / per
            for name, (k, inc, exc) in IDLE_MS.items() if k == kind}
    syncs = {n: c for n, c in counts.items() if n.startswith(PREFIX + "sync/")}
    by_span = sorted(idle_by_innermost(dev, sp).items(), key=lambda x: -x[1])
    early = early_ops(evs)
    return {"per": per, "idle_ms": idle, "syncs": syncs,
            "syncs_per": sum(syncs.values()) / per, "covered_share": covered_share(dev, sp),
            "idle_s_by_span": [[n, s] for n, s in by_span], "spans": dict(counts),
            "early_ops": len(early), "early_us_max": max(early, default=0.0)}
