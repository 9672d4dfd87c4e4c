"""Device ms a step of the training render (march, field, composite): the
kernels launched inside the benchmark's ranges around `render_rays_train`,
and those autograd launched for the backward of the operations recorded
there."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.steps:
        return None
    return run.trace.range_device_ms("render", run.steps)
