"""Device ms a step of the rate: the kernels launched inside the
benchmark's ranges around `rate_bits_2d` / `rate_bits_3d`, and those
autograd launched for the backward of the operations recorded there."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.steps:
        return None
    return run.trace.range_device_ms("rate", run.steps)
