"""Share of the traced window in which no kernel, copy or set runs on the
card (the profiler's device timeline), in the serve cells."""

from benchmark.metrics import _common


def read(run):
    return _common.idle_pct(run) if run.kind == "serve" else None
