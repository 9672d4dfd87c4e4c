"""The training render's kernels against their roofline: the least time of
its K1, K2, K5 and K5b calls (bytes over 3.35 TB/s or operations over
67 TFLOP/s, whichever is larger; `benchmark/costs/kernels.py`, the encodes'
table rows counted from the captured positions) over their device time
(the kernels of those names launched in the `render` ranges and in
autograd's backward of them)."""

from benchmark.metrics import _common


def read(run):
    if run.kind != "train":
        return None
    return _common.roofline_pct(run, ["render"], _common.ENCODE + _common.COMPOSITE)
