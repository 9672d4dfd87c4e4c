"""The traced run: torch.profiler over a window, and the reduction of its
trace to what the per-layer metrics read.

The profiler records CPU and CUDA activities; the benchmark's own files add
`record_function` ranges ("bench/<layer>") around the program's entry
points.  The trace is exported once, as Chrome JSON, into a temporary file
under TMPDIR (removed at once) and reduced here:

  * device operations: kernels, copies and sets, with their device time;
  * busy seconds: the union of their intervals;
  * launches: the host's kernel-launch calls;
  * each range's device ms: the kernels its host thread launched inside it,
    and the kernels autograd launched for the backward of the operations
    recorded inside it (matched by autograd's sequence numbers);
  * a breakdown: the device operations that took most time, and the longest
    idle gaps of the device by the benchmark range the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench/"


@contextlib.contextmanager
def layer(name: str):
    """A benchmark range around one call into a layer of the program."""
    with torch.profiler.record_function(PREFIX + name):
        yield


class Ranges:
    """The benchmark's ranges around the program's entry points, for one
    traced window: each `wrap` replaces a function the program calls
    through its module or object, and leaving the `with` block puts every
    original back."""

    def __init__(self):
        self._saved = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def _replace(self, owner, attr: str, fn) -> None:
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    def wrap(self, owner, attr: str, name: str) -> None:
        """Put `owner.attr` inside the range `bench/<name>`."""
        fn = getattr(owner, attr)

        def wrapped(*a, **kw):
            with layer(name):
                return fn(*a, **kw)

        self._replace(owner, attr, wrapped)

    def capture_encodes(self, owner, attr: str, captured: list) -> None:
        """While `owner.attr` runs, keep a copy of the positions every field
        query encodes (`radiance_field.encode_position`'s x01), for the
        encode kernels' least bytes (`benchmark/costs/kernels.py`)."""
        from cnc_torch.models import radiance_field as rf
        fn, encode_position = getattr(owner, attr), rf.encode_position
        on = [False]

        def encode(field, cfg, x01, tables=None):
            if on[0]:
                captured.append(x01.detach().clone())
            return encode_position(field, cfg, x01, tables)

        def wrapped(*a, **kw):
            on[0] = True
            try:
                return fn(*a, **kw)
            finally:
                on[0] = False

        self._replace(rf, "encode_position", encode)
        self._replace(owner, attr, wrapped)


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def events(prof) -> List[dict]:
    """The trace's complete events (ph "X")."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return [e for e in data["traceEvents"] if e.get("ph") == "X" and "dur" in e]


def _union_seconds(iv: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, None
    for a, b in sorted(iv):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-6


class Trace:
    """What the per-layer metrics read from one traced window."""

    def __init__(self, evs: List[dict], window_s: float):
        self.window_s = window_s
        dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
        self.device_ops = dev
        self.busy_s = _union_seconds([(e["ts"], e["ts"] + e["dur"]) for e in dev])
        runtime = [e for e in evs if e.get("cat") == "cuda_runtime"]
        self.launch_calls = [e for e in runtime if "Launch" in e["name"]]
        by_corr = {}
        for e in dev:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                by_corr.setdefault(c, []).append(e)
        # per host thread, the launch calls sorted by time with their device ops
        self._launch = defaultdict(list)
        for e in runtime:
            ops = by_corr.get(e.get("args", {}).get("correlation"))
            if ops:
                self._launch[e["tid"]].append((e["ts"], ops))
        for v in self._launch.values():
            v.sort(key=lambda x: x[0])
        self._launch_ts = {t: [x[0] for x in v] for t, v in self._launch.items()}
        cpu_ops = [e for e in evs if e.get("cat") == "cpu_op"
                   and e.get("args", {}).get("Sequence number") is not None]
        self._backward = [e for e in cpu_ops
                          if e["name"].startswith("autograd::engine::evaluate_function")]
        self._seq_ops = defaultdict(list)
        for e in cpu_ops:
            self._seq_ops[e["tid"]].append(e)
        self.ranges = [e for e in evs if e.get("cat") == "user_annotation"
                       and e["name"].startswith(PREFIX)]

    def _ops_between(self, tid, a: float, b: float):
        ts = self._launch_ts.get(tid, [])
        lo, hi = bisect.bisect_left(ts, a), bisect.bisect_right(ts, b)
        for _, ops in self._launch[tid][lo:hi]:
            yield from ops

    def range_ops(self, name: str):
        """The device ops launched inside the ranges `name`, and those
        autograd launched for the backward of the operations recorded inside
        them; None where the trace has no such range."""
        spans = [r for r in self.ranges if r["name"] == PREFIX + name]
        if not spans:
            return None
        seqs, seen, ops = set(), set(), []

        def take(found):
            for op in found:
                if id(op) not in seen:
                    seen.add(id(op))
                    ops.append(op)

        for r in spans:
            a, b, tid = r["ts"], r["ts"] + r["dur"], r["tid"]
            take(self._ops_between(tid, a, b))
            for e in self._seq_ops.get(tid, []):
                if a <= e["ts"] <= b:
                    seqs.add(e["args"]["Sequence number"])
        for e in self._backward:
            if e["args"]["Sequence number"] in seqs:
                take(self._ops_between(e["tid"], e["ts"], e["ts"] + e["dur"]))
        return ops

    def range_device_ms(self, name: str, steps: int) -> float | None:
        """Device ms a step of `range_ops(name)`."""
        ops = self.range_ops(name)
        return None if ops is None else sum(op["dur"] for op in ops) * 1e-3 / steps

    def breakdown(self) -> Dict[str, list]:
        by_name = defaultdict(float)
        for e in self.device_ops:
            by_name[e["name"]] += e["dur"] * 1e-6
        top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
        gaps = defaultdict(float)
        iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device_ops)
        ranges = sorted(self.ranges, key=lambda r: r["ts"])
        end = None
        for a, b in iv:
            if end is not None and a > end:
                gaps[self._host_state(end, ranges)] += (a - end) * 1e-6
            end = b if end is None else max(end, b)
        idle = sorted(gaps.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in idle]}

    @staticmethod
    def _host_state(t: float, ranges) -> str:
        """The innermost benchmark range open on the host at time t."""
        best = None
        for r in ranges:
            if r["ts"] > t:
                break
            if r["ts"] + r["dur"] >= t and (best is None or r["dur"] < best["dur"]):
                best = r
        return best["name"][len(PREFIX):] if best is not None else "outside the ranges"
