"""Milliseconds a view: the window's wall time over the views it completed
(one client calling `render_image` back to back, each view ending in a
synchronise)."""


def read(run):
    if run.kind != "serve" or not run.views:
        return None
    return run.window_s / run.views * 1e3
