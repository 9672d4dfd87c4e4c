"""Kernel launches a training step: the host's launch calls
(`cudaLaunchKernel` and the like) in the traced window over its steps."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.steps:
        return None
    return len(run.trace.launch_calls) / run.steps
