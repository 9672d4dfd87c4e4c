"""Tracing and section timing.

Port of `cnc_tpu/utils/profiling.py`: section timers that wait for the
device before they read the clock, and a trace capture.  `force` waits for
the card with `torch.cuda.synchronize` on the device of the tensors it is
given (nothing to wait for on the CPU); `trace` records a `torch.profiler`
trace of the CPU and, where there is one, the card, written to `log_dir`
as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def force(x):
    """Wait until the device work behind the tensors in x (a tensor or a
    nest of dicts, lists and tuples) is done; returns x."""
    for t in _tensors(x):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            break
    return x


class SectionTimers:
    """Accumulating named wall-clock sections.

    with timers.section("render"):
        out = step(...)
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = force(fn(*args, **kw))
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def summary(self) -> str:
        rows = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            n = self.counts[k]
            rows.append(f"{k}: {self.totals[k]:.3f}s total, "
                        f"{self.totals[k] / max(n, 1) * 1e3:.1f} ms/call x{n}")
        return "\n".join(rows)


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "cnc_torch_trace")):
    """Record a torch.profiler trace of the block; on exit it is written to
    `log_dir`/trace.json (Chrome trace format, for Perfetto or
    chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
