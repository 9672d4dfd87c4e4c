"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit).  The port computes in float32 with TF32 off, outside the
tensor cores."""

F32_FLOPS = 67e12          # FLOP/s, float32 outside the tensor cores
HBM_BYTES = 3.35e12        # bytes/s


def least_seconds(io_bytes: float, ops: float) -> float:
    """The least time of a kernel call: the larger of its bytes over the
    HBM's bandwidth and its operations over the float32 peak."""
    return max(io_bytes / HBM_BYTES, ops / F32_FLOPS)
