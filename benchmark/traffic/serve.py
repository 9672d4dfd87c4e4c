"""Traffic kind `serve`: one client rendering views back to back.

Set-up builds the port's field with the benchmark's weights drawn from the
seed (binarized tables, two MLPs), the occupancy grid of the cell's scene
and the rays of `views` poses drawn from the seed, and renders the first
poses through `render_image` `warm_views` times (the warm-up: every chunk of a
view has the same shapes, so one view warms every round this traffic
runs).  The window replays the poses in order, one `render_image` call a
view in chunks of `chunk` rays, each view ending in a synchronise, for as
long as the seconds hold.  A traced run profiles `trace_views` views
instead, with the benchmark's ranges around the program's layers.  The
answers compared are `check_chunks` chunks of rays of one view drawn from
the seed among those the window rendered; after the window the program is
freed and the plain reference renders those chunks again.
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.costs import flops, peaks as costs
from benchmark.costs import kernels as kcosts
from benchmark.harness import scenes, trace, weights
from benchmark.reference import compare, serve_ref


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def view_rays(wl, seed, device):
    """The rays of every pose, [H, W, 3] each."""
    c, p = wl["cfg"], wl["params"]
    K = scenes.intrinsics(p["width"], p["height"], device)
    c2w = torch.from_numpy(scenes.poses(c["scene"], p["views"], seed)).to(device)
    return [scenes.image_rays(K, c2w[i], p["width"], p["height"], scenes.opengl(c["scene"]))
            for i in range(p["views"])]


def grid(wl, device):
    r = wl["cfg"]["cnc_config"]["render"]
    return scenes.occupancy(wl["cfg"]["scene"], r["aabb"], r["occ_resolution"],
                            r["render_step_size"], r["occ_thre"], device)[1]


def build(wl, seed, device):
    from cnc_torch import kernels
    from cnc_torch.config import CNCConfig
    from cnc_torch.models import radiance_field as rf
    if device.type == "cuda":
        kernels.lib()                       # built on a checkout's first run, loaded after
    cfg = CNCConfig.from_dict(wl["cfg"]["cnc_config"])
    field = rf.RadianceField(cfg.model, torch.Generator(device=device).manual_seed(0),
                             device=device)
    weights.load(field, seed, "field")
    return cfg, field


def _least_seconds(cfg, captured, samples: int, ray_rounds: int) -> float:
    """The least time of the eval loop's K1 and K5 calls of the traced window
    (`benchmark/costs/kernels.py`): every round composites its chunk's rays
    with their carried transmittance."""
    least = sum(costs.least_seconds(*kcosts.encode(*call))
                for x01 in captured for call in kcosts.field_query(cfg.model, x01))
    return least + costs.least_seconds(*kcosts.composite(samples, ray_rounds, True))


def check_sample(wl, seed, rendered):
    """The answers compared, drawn from the seed: one view among those the
    window rendered, and `check_chunks` of its chunks of rays (each chunk's
    rays are rendered by `render_rays_eval` alone, so a chunk is an answer
    of its own).  Returns (view, [(first ray, end ray)])."""
    p = wl["params"]
    rng = np.random.default_rng(seed)
    view = [int(i) for i in rng.permutation(p["views"]) if int(i) in rendered][0]
    n = p["width"] * p["height"]
    picks = sorted(rng.permutation(-(-n // p["chunk"]))[:p["check_chunks"]])
    return view, [(int(c) * p["chunk"], min((int(c) + 1) * p["chunk"], n)) for c in picks]


def reference_chunks(cnc, seed, binaries, rays, chunk, chunks, device, tf32=False):
    """The reference's (rgb, opacity, depth) rows of the sampled chunks."""
    cfg, field = serve_ref.field(cnc, seed, device)
    o, d = rays.origins.reshape(-1, 3), rays.viewdirs.reshape(-1, 3)
    pad = (-o.shape[0]) % chunk
    if pad:                     # the last chunk padded as render_image pads it
        o = torch.cat([o, o[-1:].expand(pad, 3)])
        d = torch.cat([d, d[-1:].expand(pad, 3)])
    out = []
    for a, b in chunks:
        s = a - a % chunk
        part = serve_ref.chunk(cfg, field, binaries, o[s:s + chunk].contiguous(),
                               d[s:s + chunk].contiguous(), tf32)
        out.append(tuple(x[a - s:b - s] for x in part))
    return out


def _install_ranges(ranges, captured):
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.render import marching, renderer, volrend
    ranges.capture_encodes(rf, "forward", captured)
    ranges.wrap(renderer, "render_rays_eval", "eval_chunk")
    ranges.wrap(marching, "march_rays", "march")
    ranges.wrap(rf, "forward", "field")
    ranges.wrap(volrend, "composite", "composite")


def run(wl, seed: int, seconds: float, traced: bool, device, t0: float) -> SimpleNamespace:
    from cnc_torch.render import renderer
    p = wl["params"]
    t1 = time.perf_counter()
    cfg, field = build(wl, seed, device)
    binaries = grid(wl, device)
    rays = view_rays(wl, seed, device)
    _sync(device)
    t2 = time.perf_counter()
    aabb = torch.tensor(cfg.render.aabb, dtype=torch.float32, device=device)
    bkgd = torch.ones(3, device=device)

    def render(i, stats=None):
        r = rays[i % len(rays)]
        out = renderer.render_image(field, cfg.model, cfg.render, aabb, binaries, r.origins,
                                    r.viewdirs, bkgd, chunk=p["chunk"], device=device,
                                    stats=stats)
        _sync(device)
        return out

    for i in range(p["warm_views"]):
        render(i)
    t3 = time.perf_counter()
    setup_s = t3 - t0
    print(f"set-up: imports {t1 - t0:.2f} s, field, grid and rays {t2 - t1:.2f} s,"
          f" warm views {t3 - t2:.2f} s", file=sys.stderr)

    stats, outs, times = {}, {}, []
    n_views = p["trace_views"] if traced else None
    tr, captured, least_s = None, [], None

    def window():
        w0 = time.perf_counter()
        end = w0 + seconds
        i = 0
        while (i < n_views) if traced else (i == 0 or time.perf_counter() < end):
            a = time.perf_counter()
            out = render(i, stats)
            times.append(time.perf_counter() - a)
            if i < len(rays):
                outs[i] = out
            i += 1
        return i, time.perf_counter() - w0

    if traced:
        with trace.Ranges() as ranges, trace.profiler() as prof:
            _install_ranges(ranges, captured)
            with trace.layer("view"):
                views, window_s = window()
        tr = trace.Trace(trace.events(prof), window_s)
    else:
        views, window_s = window()
    samples = int(stats["samples"]) if "samples" in stats else 0
    if traced:
        least_s = _least_seconds(cfg, captured, samples, stats.get("rounds", 0) * p["chunk"])
        captured.clear()
    failed = sum(not bool(torch.isfinite(o[0]).all()) for o in outs.values())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    view, chunks = check_sample(wl, seed, sorted(outs))
    prog = [tuple(t.reshape(-1, t.shape[-1])[a:b] for t in outs[view]) for a, b in chunks]
    cnc = wl["cfg"]["cnc_config"]
    del field, outs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    ref = reference_chunks(cnc, seed, binaries, rays[view], p["chunk"], chunks, device)
    print(f"window: {views} views in {window_s:.3f} s, rounds {stats.get('rounds', 0)};"
          f" reference {time.perf_counter() - r0:.1f} s for view {view}, rays {chunks}",
          file=sys.stderr)
    numbers = compare.serve(prog, ref, wl["check"]["limits"])
    return SimpleNamespace(kind="serve", device=device, setup_s=setup_s, window_s=window_s,
                           views=views, attempted=views, failed=failed, view_times=times,
                           rounds=stats.get("rounds", 0), samples=samples,
                           flops=flops.view(cnc, samples), trace=tr, memory_peak_bytes=peak,
                           least_s=least_s,
                           numbers=numbers, correct=compare.correct(numbers))
