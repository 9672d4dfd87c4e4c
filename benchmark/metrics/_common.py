"""Shared by the per-layer readers: the traced window's numbers."""

from benchmark.costs import peaks


def idle_pct(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run):
    if run.trace is None or run.flops <= 0:
        return None
    return 100.0 * run.flops / run.trace.window_s / peaks.F32_FLOPS


ENCODE = ("grid_encode_forward_kernel", "grid_encode_backward_kernel")
COMPOSITE = ("walk_ranges_kernel", "volrend_forward_kernel", "volrend_backward_kernel")


def device_seconds(run, ranges, names):
    """Device seconds of the ops named `names` among the ranges' ops."""
    total, found = 0.0, False
    for r in ranges:
        ops = run.trace.range_ops(r)
        if ops is None:
            continue
        found = True
        total += sum(op["dur"] for op in ops if any(n in op["name"] for n in names)) * 1e-6
    return total if found else None


def roofline_pct(run, ranges, names):
    """Least time over device time of the named kernels in the ranges."""
    if run.trace is None or not run.least_s:
        return None
    dev = device_seconds(run, ranges, names)
    return None if not dev else 100.0 * run.least_s / dev
