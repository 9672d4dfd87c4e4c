"""Host-device syncs a training step: the `cnc/sync/*` spans the program
recorded in the traced window (`cnc_torch.utils.profiling.recorded`, which
counts the spans recorded while a profiler runs) over its steps; nothing
where the program keeps no such count."""

from benchmark.metrics import _spans


def read(run):
    if run.kind != "train" or run.trace is None or not run.steps:
        return None
    n = _spans.recorded_syncs(run.steps)
    return None if n is None else n / run.steps
