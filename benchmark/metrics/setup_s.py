"""Set-up seconds: process start to the first timed step or view (imports,
the kernels' library loaded from the checkout's build cache or built on a
checkout's first run, the inputs, the program's state, the warm-up)."""


def read(run):
    return run.setup_s
