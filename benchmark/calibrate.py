#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, for one cell, in one
process on the card.

    python3 benchmark/calibrate.py --workload CELL --seeds S1,S2,... \
        [--controls K] [--out FILE]

For every seed: the program driven as a run drives it, at the cell's own
sizes, against the plain reference (`sound`).  For the first K seeds also:
the reference computed in TF32 against the reference in float32
(`control`, the nearest precision below the configuration's), and the
planted faults against the reference (`fault:<name>`): for a training cell
half of each ray batch left out of the loss, the mean taken over the rest.
(A step that leaves the state unchanged reads 1 on the change by its
measure and needs no run; a serving cell's altered answer is the CPU
test's, `benchmark/tests/test_faults.py`.)  The training readings also
name the leaf that gave the widest gap.  One JSON line a reading, on
standard output and in FILE.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark.harness import cells, report  # noqa: E402
from benchmark.reference import compare, train_ref  # noqa: E402


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _half_batch(fetch):
    """A dataset's fetch whose second half of rays repeats the first: the
    loss is the mean over half of the batch."""
    def fetch_half(generator, n):
        rays, pixels = fetch(generator, n)
        h = n // 2
        pick = torch.cat([torch.arange(h), torch.arange(n - h) % max(h, 1)]).to(pixels.device)
        return type(rays)(rays.origins[pick], rays.viewdirs[pick]), pixels[pick]
    return fetch_half


def _train_reading(what, prog, ref, limits):
    """The compared numbers, and what they leave out: each step's loss gap,
    and the worst leaf's gap of the first gradient and of the change."""
    grad = compare.leaf_gaps(prog["grad"], ref["grad"], sorted(ref["grad"]))
    change = compare.leaf_gaps(prog["change"], ref["change"],
                               compare.moved_leaves(ref["grad"]))
    worst = lambda g: max(g, key=lambda n: g[n]) if g else None
    look = {"loss_gaps": compare.loss_gaps(prog, ref),
            "grad_leaf": worst(grad), "change_worst": max(change.values(), default=None),
            "change_leaf": worst(change)}
    return what, compare.train(prog, ref, limits), look


def train_cell(wl, seed, controls: bool, device):
    tr = cells.traffic("train")
    p = wl["params"]
    trainer, views = tr.build(wl, seed, device)
    prog = tr.first_steps(trainer, p["check_steps"])
    del trainer
    _free()
    occs, binaries = tr.grid(wl, device)
    args = (wl["cfg"]["cnc_config"], views, seed, p["start_step"], p["rays"], occs, binaries,
            p["check_steps"], device)
    ref = train_ref.steps(*args)
    lim = wl["check"]["limits"]
    out = [_train_reading("sound", prog, ref, lim)]
    if controls:
        out.append(_train_reading("control", train_ref.steps(*args, tf32=True), ref, lim))
        fetch = views.fetch_rays
        views.fetch_rays = _half_batch(fetch)
        try:
            fault = train_ref.steps(*args)
        finally:
            views.fetch_rays = fetch
        out.append(_train_reading("fault:half_batch", fault, ref, lim))
    return out


def serve_cell(wl, seed, controls: bool, device):
    sv = cells.traffic("serve")
    p = wl["params"]
    cfg, field = sv.build(wl, seed, device)
    binaries = sv.grid(wl, device)
    rays = sv.view_rays(wl, seed, device)
    from cnc_torch.render import renderer
    aabb = torch.tensor(cfg.render.aabb, dtype=torch.float32, device=device)
    view, chunks = sv.check_sample(wl, seed, range(p["views"]))
    out = renderer.render_image(field, cfg.model, cfg.render, aabb, binaries,
                                rays[view].origins, rays[view].viewdirs,
                                torch.ones(3, device=device), chunk=p["chunk"], device=device)
    prog = [tuple(t.reshape(-1, t.shape[-1])[a:b] for t in out) for a, b in chunks]
    del field, out
    _free()
    cnc, lim = wl["cfg"]["cnc_config"], wl["check"]["limits"]
    ref = sv.reference_chunks(cnc, seed, binaries, rays[view], p["chunk"], chunks, device)
    res = [("sound", compare.serve(prog, ref, lim), {})]
    if controls:
        ctl = sv.reference_chunks(cnc, seed, binaries, rays[view], p["chunk"], chunks, device,
                                  tf32=True)
        res.append(("control", compare.serve(ctl, ref, lim), {}))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    wl = cells.workload(a.workload)
    device = report.require_cards(1)
    seeds = [int(s) for s in a.seeds.split(",")]
    fn = train_cell if wl["traffic"] == "train" else serve_cell
    sink = open(a.out, "a") if a.out else None
    try:
        for k, seed in enumerate(seeds):
            t0 = time.perf_counter()
            for what, numbers, extra in fn(wl, seed, k < a.controls, device):
                line = json.dumps({"workload": a.workload, "seed": seed, "reading": what,
                                   "numbers": {n: v for n, v, _ in numbers}, **extra,
                                   "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
            _free()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
