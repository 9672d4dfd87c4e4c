"""Spans, section timing and tracing.

Port of `cnc_tpu/utils/profiling.py` (section timers that wait for the
device before they read the clock, and a trace capture), with the port's
own spans at its layer boundaries.

`span(name)` is a `torch.profiler.record_function` range named
"cnc/<name>" while a torch profiler records, and one shared do-nothing
context otherwise: with tracing off a span costs one check of the
profiler's state, creates no range and reads nothing from the device.  The
profiler stamps the ranges on the clock of the card's kernels, copies and
sets, so a trace says what the host was doing while the card sat idle.
`recorded` counts the spans recorded, by name.  The spans:

  training (`train/trainer.py`)
    train/step (arg: the step)    one iteration of `Trainer.fit`'s loop
    train/occupancy, train/cache  the occupancy update, the rate's cache refresh
    train/fetch                   the ray batch
    train/render                  the training render and its squared error
    train/rate                    the quantized tables and the rate terms
    train/backward                `loss.backward()` (and the data-parallel all-reduce)
    train/update                  both optimizers and their schedules
  the rate (`models/context_models.py`)
    rate/pg_bits                  each level's global-probability bits
    rate/frac_plane               each axis's frac plane
    rate/window_2d (axis, level)  each 2D context level's window
    rate/sampled_3d               the 3D context levels' windows
  serving (`render/renderer.py`)
    serve/view                    `render_image`
    serve/chunk (arg: the chunk)  each chunk's `render_rays_eval`
    serve/round (arg: the round)  one round of the eval loop, its alive test included
  both paths
    render/march, render/field, render/composite
                                  `marching.march_rays`, `radiance_field.forward`,
                                  `volrend.composite`
  host-device syncs (each around a read or copy the program makes anyway)
    sync/draw_starts              the entry windows' uniforms (once a rate step)
    sync/level_resolutions        the 3D levels' resolutions copied to the card (once)
    sync/host_scalar              the render's pixel count copied to the card (once)
    sync/step_end                 the step's sample counts (once a step)
    sync/plane_index              each plane's list index, copied (3 a field query
                                  that composes its row: under autograd, or on the
                                  CPU; K1f's queries make none)
    sync/rank_seed                a data-parallel rank's seed draw
    sync/log, sync/checkpoint     `fit`'s log line and checkpoint
    sync/alive                    the eval loop's alive test (once a round)
    sync/progress                 `render_image`'s wait before `progress_fn`

`force` waits for the card with `torch.cuda.synchronize` on the device of
the tensors it is given (nothing to wait for on the CPU); `trace` records a
`torch.profiler` trace of the CPU and, where there is one, the card,
written to the directory it is given as a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

PREFIX = "cnc/"
_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled

# spans recorded while a profiler ran, by name (without the prefix)
recorded: collections.Counter = collections.Counter()


def span(name: str, args: Optional[Dict] = None):
    """A range "cnc/<name>" in the profiler's trace while one records, with
    `args` ({key: value}) written beside it; a shared null context
    otherwise."""
    if not _recording():
        return _OFF
    recorded[name] += 1
    text = None if args is None else ", ".join(f"{k}={v}" for k, v in args.items())
    return torch.profiler.record_function(PREFIX + name, text)


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
def trace(log_dir: str):
    """Record a torch.profiler trace of the block, the spans above
    included; on exit it is written to `log_dir`/trace.json (Chrome trace
    format, for Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
