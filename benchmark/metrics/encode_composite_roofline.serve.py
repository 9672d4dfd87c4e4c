"""The eval loop's K1 and K5 against their roofline: their least time
(`benchmark/costs/kernels.py`, the encodes' table rows counted from the
captured positions) over their device time (K1 launched in the `field`
ranges, K5's two kernels in the `composite` ranges)."""

from benchmark.metrics import _common


def read(run):
    if run.kind != "serve" or run.trace is None or not run.least_s:
        return None
    dev = (_common.device_seconds(run, ["field"], _common.ENCODE[:1])
           + _common.device_seconds(run, ["composite"], _common.COMPOSITE[:2]))
    return 100.0 * run.least_s / dev if dev else None
