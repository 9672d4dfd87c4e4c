"""Milliseconds a training step: the window's wall time over the steps it
completed (a closed loop through `Trainer.fit`, each step ending in its own
host sync)."""


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return run.window_s / run.steps * 1e3
