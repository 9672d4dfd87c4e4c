"""Rounds of the eval loop a view (`render_rays_eval`'s `stats["rounds"]`)
over the traced window's views."""


def read(run):
    if run.kind != "serve" or run.trace is None or not run.views:
        return None
    return run.rounds / run.views
