"""Model FLOPs of the traced window (`benchmark/costs/flops.py`) over its
length and the H100's float32 peak (67 TFLOP/s; the card's power limit is
printed on standard error), in the serve cells."""

from benchmark.metrics import _common


def read(run):
    return _common.mfu_pct(run) if run.kind == "serve" else None
