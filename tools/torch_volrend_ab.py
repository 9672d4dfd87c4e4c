#!/usr/bin/env python3
"""A/B of cnc_torch's volume-render kernels (K5 forward, K5b backward)
between trees, on one NVIDIA GPU, at the shapes of the serving and training
paths.

    python3 tools/torch_volrend_ab.py prepare WORK
    python3 tools/torch_volrend_ab.py time WORK TREE LABEL >> LOG
    python3 tools/torch_volrend_ab.py summary LOG
    python3 tools/torch_volrend_ab.py alloc

`prepare` makes the inputs with this tree's cnc_torch and saves them to
WORK/inputs.pt, each a march's sample buffer with densities, colours and
output gradients drawn from a seed:
  * the smoke's 800x800 view's 8,192 strided rays at the first round (every
    ray alive, 65,536 slots) and a late one (10% alive), with a carried
    transmittance, as the eval loop composites them;
  * the training march after 16 lambda = 0 steps (the trainer's ray bucket,
    2,048 rays, 327,680 slots, with jitter) and after TRAIN_LATE_STEPS steps,
    when the bucket has grown.

`time` imports cnc_torch from TREE (a directory holding another version's
`cnc_torch/`, e.g. a commit unpacked with `git archive`), builds its kernels
into TREE/cnc_torch/_build and prints one JSON line:
  * `profile`: the process's first torch.profiler window over one forward at
    the view's first round and one forward and backward through autograd at
    the late training march (the loss on rgb with a white background, as the
    trainer's): the kernels and memsets the card ran, by name, with their
    count and device microseconds;
  * `floor`: device ms (below) of one and of two empty kernel launches;
  * `sites`: per site, K5 (and at the training marches K5b, given all three
    output gradients) with its wrapper (ms) and its device work alone
    (device ms, CUDA events behind a spin kernel), each held to the tree's
    own plain twin; the wrapper's host work alone (host us: the host clock
    over HOST_CALLS calls enqueued without a sync, which the card keeps up
    with); the allocations per call (the caching allocator's count); and the
    forward and backward through autograd as the trainer runs them (ms and
    host us: its host work outlasts the spin, so CUDA events cannot isolate
    its device time);
  * `view`: one 800x800 view through `render_image` (random weights, seed
    0): the median of five renders after a first one, its rounds and the
    wrappers' launch counts;
  * `step`: a lambda = 0 trainer after TRAIN_LATE_STEPS steps: ms per step,
    the median of five windows of 20 steps of `fit` (occupancy updates and
    the per-step host sync included), and the launch counts per step.

`alloc` times, in one process and in turns, the host work of K5's outputs
at a view round's 8,192 rays: four allocations (rgb, opacity, depth, the
count) against one allocation with four strided views, and the stream
lookup every wrapper makes; host microseconds per call, the median of
ALLOC_ROUNDS rounds of ALLOC_CALLS calls each, and each round's readings.

Times vary between calls by up to 1.5x: compare trees only within one call,
in turns (a, b, b, a, a, b, b, a).  `summary` gives each tree's mean over its
runs and, for the wrappers' host work, the forward and backward through
autograd, the view and the step, each run's reading and whether the two
trees' ranges of readings overlap.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TRAIN_LATE_STEPS = 300
SITES = ("view, first round", "view, late round", "training march, step 16",
         f"training march, step {TRAIN_LATE_STEPS}")
TRAIN_SITES = SITES[2:]
VIEW_RENDERS = 5
STEP_WINDOWS = 5
HOST_CALLS = 100
ALLOC_ROUNDS, ALLOC_CALLS = 20, 2000


def _smoke():
    sys.path.insert(1, str(REPO))
    import chip_smoke
    return chip_smoke


def _buffer(torch, smp, n_rays, gen, prefix: bool):
    """The site's inputs: the march's samples and seeded densities, colours,
    carried transmittance and output gradients."""
    n, dev = smp.ray_id.shape[0], smp.ray_id.device
    return dict(ray_id=smp.ray_id, t_mid=smp.t_mid, valid=smp.valid, dt=smp.dt,
                n_rays=n_rays,
                sig=torch.empty(n, device=dev).exponential_(1 / 40.0, generator=gen),
                rgb=torch.rand(n, 3, generator=gen, device=dev),
                pt=(torch.rand(n_rays, generator=gen, device=dev) * 0.9 + 0.1) if prefix
                else None,
                cots=(torch.randn(n_rays, 3, generator=gen, device=dev),
                      torch.randn(n_rays, generator=gen, device=dev),
                      torch.randn(n_rays, generator=gen, device=dev)))


def prepare(work: Path) -> None:
    import torch
    sys.path.insert(0, str(REPO))
    cs = _smoke()
    from cnc_torch.config import CNCConfig, RenderConfig, TrainConfig
    from cnc_torch.data import scenes
    from cnc_torch.render import marching
    from cnc_torch.train.trainer import Trainer, _next_bucket
    from torch_march_pool_ab import _view_rays

    dev = torch.device("cuda")
    rcfg, rays = _view_rays(torch, cs, dev)
    binaries = scenes.occupancy_from_scene(scenes.make_scene("blocks"), rcfg.occ_resolution,
                                           rcfg.render_step_size, device=dev)
    aabb = torch.tensor(rcfg.aabb, dtype=torch.float32, device=dev)
    chunk, view = rcfg.eval_chunk_rays, cs.VIEW
    o = rays.origins.reshape(-1, 3)[::view * view // chunk][:chunk].contiguous()
    d = rays.viewdirs.reshape(-1, 3)[::view * view // chunk][:chunk].contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    alive_late = torch.rand(chunk, generator=gen, device=dev) < 0.1
    capacity = chunk * rcfg.eval_samples_per_iter
    sites = {}
    with torch.no_grad():
        for site, mask in ((SITES[0], None), (SITES[1], alive_late)):
            smp = marching.march_rays(o, d, binaries, aabb, rcfg, capacity, ray_mask=mask)
            sites[site] = _buffer(torch, smp, chunk, gen, prefix=True)

    train_set = scenes.ProceduralDataset("blocks", device=dev)
    tr = Trainer(CNCConfig(train=dataclasses.replace(TrainConfig(), lmbda=0.0)), train_set)
    for site, steps in zip(TRAIN_SITES, (cs.TRAIN_WARM_STEPS, TRAIN_LATE_STEPS)):
        tr.fit(steps - 1, log_every=0)
        cfg = tr.cfg
        bucket = _next_bucket(tr.num_rays, cfg.train.min_ray_bucket, cfg.train.max_ray_bucket)
        batch, _ = train_set.fetch_rays(gen, bucket)
        with torch.no_grad():
            smp = marching.march_rays(batch.origins.contiguous(), batch.viewdirs.contiguous(),
                                      tr.occ_state.binaries, tr.aabb, cfg.render,
                                      cfg.render.sample_capacity,
                                      jitter=torch.rand(bucket, generator=gen, device=dev))
        sites[site] = _buffer(torch, smp, bucket, gen, prefix=False)
    sites = {k: dict(v, rcfg=dataclasses.asdict(RenderConfig())) for k, v in sites.items()}
    work.mkdir(parents=True, exist_ok=True)
    torch.save({"sites": sites}, work / "inputs.pt")
    print(json.dumps({"prepared": {k: dict(slots=int(v["ray_id"].shape[0]),
                                           valid=int(v["valid"].sum()), rays=v["n_rays"])
                                   for k, v in sites.items()}}))


def _samples(marching, a):
    return marching.RaySamples(ray_id=a["ray_id"], t_mid=a["t_mid"], dt=a["dt"],
                               valid=a["valid"], num_samples=None)


def _allocations(torch, fn) -> int:
    """Allocation requests the caching allocator served during fn()."""
    key = "allocation.all.allocated"
    before = torch.cuda.memory_stats()[key]
    fn()
    return torch.cuda.memory_stats()[key] - before


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per fn() call: the host clock over `calls` calls
    enqueued back to back, after a warm-up and a sync, before the closing
    sync."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def time_tree(work: Path, tree: Path, label: str) -> None:
    import torch
    sys.path.insert(0, str(tree.resolve()))
    import cnc_torch
    from cnc_torch import kernels
    from cnc_torch.config import RenderConfig
    from cnc_torch.render import marching, volrend
    if Path(cnc_torch.__file__).resolve().parent != (tree / "cnc_torch").resolve():
        raise RuntimeError(f"cnc_torch was not imported from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _smoke()
    kernels.lib()
    out = {"tree": label, "card": cs.card_line(), "device": torch.cuda.get_device_name(0)}
    inputs = torch.load(work / "inputs.pt")["sites"]
    bkgd = torch.ones(3, device="cuda")

    def through_autograd(a):
        """The trainer's use: composite with a white background, the loss on
        rgb, backward to rgbs and sigmas."""
        smp, rcfg = _samples(marching, a), RenderConfig(**a["rcfg"])
        r_leaf, s_leaf = a["rgb"].clone().requires_grad_(), a["sig"].clone().requires_grad_()
        return lambda: volrend.composite(r_leaf, s_leaf, smp, a["n_rays"], bkgd,
                                         rcfg.early_stop_eps, None,
                                         rcfg.alpha_thre).rgb.square().sum().backward()

    # the process's first profile: one view round's forward, one training
    # march's forward and backward through autograd
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    view_a, train_a = inputs[SITES[0]], inputs[TRAIN_SITES[-1]]
    view_rcfg = RenderConfig(**view_a["rcfg"])
    view_fwd = lambda: volrend._composite_cuda(
        view_a["rgb"], view_a["sig"], _samples(marching, view_a), view_a["n_rays"],
        view_rcfg.early_stop_eps, view_a["pt"], view_rcfg.alpha_thre)
    train_step = through_autograd(train_a)
    view_fwd()
    train_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        view_fwd()
        train_step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out["profile"] = {"device_events": sum(e.count for e in events),
                      "by_name": {e.key: [e.count, e.self_device_time_total] for e in events}}

    # device ms's own floor: one and two empty launches behind the spin
    out["floor"] = {"one_launch_device_ms": cs.device_ms(lambda: torch.cuda._sleep(1)),
                    "two_launches_device_ms": cs.device_ms(
                        lambda: (torch.cuda._sleep(1), torch.cuda._sleep(1)))}
    out["sites"] = {}
    for site in SITES:
        a = inputs[site]
        smp, rcfg = _samples(marching, a), RenderConfig(**a["rcfg"])
        args = (a["rgb"], a["sig"], smp, a["n_rays"], rcfg.early_stop_eps, a["pt"],
                rcfg.alpha_thre)
        fwd = lambda: volrend._composite_cuda(*args)
        with torch.no_grad():
            got, want = fwd(), volrend._composite_plain(*args)
            rel = max(float(((x - y).abs() / y.abs().clamp(min=1e-3)).max())
                      for x, y in zip(got[:3], want[:3]))
            if not (rel <= 1e-4 and int(got[3]) == int(want[3])):
                raise AssertionError(f"{label} {site}: K5 rel err {rel} or visible counts differ")
            kernels.reset_launches()
            fwd()
            launched = kernels.launches["volrend"]
            per_ray = torch.bincount(smp.ray_id[smp.valid].long(), minlength=a["n_rays"])
            rec = dict(fwd_ms=cs.time_ms(fwd), fwd_device_ms=cs.device_ms(fwd),
                       fwd_host_us=host_us(torch, fwd),
                       fwd_launches=launched, rays_with_samples=int((per_ray > 0).sum()),
                       most_samples_a_ray=int(per_ray.max()),
                       fwd_allocations=_allocations(torch, fwd), rel_err=rel,
                       slots=int(smp.ray_id.shape[0]), valid=int(smp.valid.sum()),
                       rays=a["n_rays"], visible=int(got[3]))
        if site in TRAIN_SITES:
            bwd = lambda: volrend._composite_backward_cuda(*args, *a["cots"])
            r_leaf = a["rgb"].clone().requires_grad_()
            s_leaf = a["sig"].clone().requires_grad_()
            outs = volrend._composite_plain(r_leaf, s_leaf, *args[2:])[:3]
            want = torch.autograd.grad(outs, (r_leaf, s_leaf), a["cots"])
            got = bwd()
            err = max(cs.rel_err(g, w) for g, w in zip(got, want))
            if not err <= cs.K5B_REL_TOL:
                raise AssertionError(f"{label} {site}: K5b rel err {err}")
            kernels.reset_launches()
            bwd()
            launched = kernels.launches["volrend_bwd"]
            both = through_autograd(a)
            rec.update(bwd_ms=cs.time_ms(bwd), bwd_device_ms=cs.device_ms(bwd),
                       bwd_host_us=host_us(torch, bwd), bwd_launches=launched,
                       bwd_allocations=_allocations(torch, bwd), bwd_rel_err=err,
                       autograd_ms=cs.time_ms(both), autograd_host_us=host_us(torch, both),
                       autograd_allocations=_allocations(torch, both))
        out["sites"][site] = rec

    from torch_march_pool_ab import view_phase
    out["view"] = view_phase(torch, cs, kernels)
    out["step"] = step_phase(torch, cs, kernels)
    print(json.dumps(out))


def step_phase(torch, cs, kernels) -> dict:
    """A lambda = 0 trainer at full width after TRAIN_LATE_STEPS steps: ms per
    step, the median of STEP_WINDOWS windows of 20 steps of `fit`."""
    from cnc_torch.config import CNCConfig, TrainConfig
    from cnc_torch.data import scenes
    from cnc_torch.train.trainer import Trainer
    ds = scenes.ProceduralDataset("blocks", device="cuda")
    tr = Trainer(CNCConfig(train=dataclasses.replace(TrainConfig(), lmbda=0.0)), ds)
    tr.fit(TRAIN_LATE_STEPS - 1, log_every=0)
    torch.cuda.synchronize()
    windows, rays = [], []
    kernels.reset_launches()
    for _ in range(STEP_WINDOWS):
        t0 = time.time()
        tr.fit(tr.step + 19, log_every=0,
               step_callback=lambda step, aux: rays.append(aux["num_rays"]))
        torch.cuda.synchronize()
        windows.append((time.time() - t0) / 20 * 1e3)
    n = 20 * STEP_WINDOWS
    return {"ms": statistics.median(windows), "ms_windows": windows,
            "rays_mean": statistics.mean(rays),
            "launches_per_step": {k: v / n for k, v in kernels.launches.items() if v}}


def alloc_host_us() -> None:
    """K5's output allocation schemes and the stream lookup, host us per
    call, timed in turns in one process."""
    import torch
    dev, n = torch.device("cuda", 0), 8192
    f32 = dict(dtype=torch.float32, device=dev)

    def four():
        rgb, opacity = torch.empty(n, 3, **f32), torch.empty(n, **f32)
        depth, count = torch.empty(n, **f32), torch.empty(1, dtype=torch.int32, device=dev)
        return rgb, opacity, depth, count[0]

    def one_and_views():
        out = torch.empty(5 * n + 1, **f32)
        return (out.as_strided((n, 3), (3, 1)), out.as_strided((n,), (1,), 3 * n),
                out.as_strided((n,), (1,), 4 * n), out.view(torch.int32)[5 * n])

    ways = {"four allocations": four, "one allocation, four views": one_and_views,
            "stream lookup": lambda: torch.cuda.current_stream(dev).cuda_stream}
    rounds = {k: [] for k in ways}
    for _ in range(ALLOC_ROUNDS):
        for name, fn in ways.items():
            fn()
            t0 = time.perf_counter()
            for _ in range(ALLOC_CALLS):
                fn()
            rounds[name].append((time.perf_counter() - t0) / ALLOC_CALLS * 1e6)
    torch.cuda.synchronize()
    print(json.dumps({"alloc": {k: {"median_us": statistics.median(v), "rounds_us": v}
                                for k, v in rounds.items()}, "card": _smoke().card_line()}))


def summary(path: Path) -> None:
    """Markdown tables of the `time` lines in `path`: each tree's mean over
    its runs."""
    runs = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith('{"tree"')]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    mean = lambda xs: sum(xs) / len(xs)
    by = lambda t: [r for r in runs if r["tree"] == t]
    print(f"{runs[0]['card']}; {len(runs)} runs ({', '.join(r['tree'] for r in runs)})")
    print("| item | " + " | ".join(trees) + " |")
    print("| --- |" + " --- |" * len(trees))
    cs = _smoke()

    def spread(item, get):
        """Each run's reading of `item` per tree, least / median / most, and
        whether the two trees' ranges overlap."""
        spans = {t: (min(map(get, by(t))), statistics.median(map(get, by(t))),
                     max(map(get, by(t)))) for t in trees}
        text = "; ".join(f"{t} {lo:.4f} / {mid:.4f} / {hi:.4f}" for t, (lo, mid, hi)
                         in spans.items())
        if len(trees) == 2:
            (lo_a, mid_a, hi_a), (lo_b, mid_b, hi_b) = spans.values()
            apart = hi_a < lo_b or hi_b < lo_a
            text += (f"; {trees[1]} - {trees[0]} = {mid_b - mid_a:+.4f} between medians, "
                     + ("resolved (the ranges do not overlap)" if apart else
                        "not resolved (the ranges overlap)"))
        print(f"{item}, runs (least / median / most): {text}")
        print(f"{item}, each run: " + "; ".join(
            f"{t} " + ", ".join(f"{get(r):.4f}" for r in by(t)) for t in trees))

    for site in SITES:
        s0 = by(trees[0])[0]["sites"][site]
        bounds = [cs.volrend_bound(s0["valid"], s0["rays"], site not in TRAIN_SITES,
                                   backward)[0] for backward in (False, True)]
        print(f"| {site}: {s0['slots']} slots, {s0['valid']} valid, {s0['rays']} rays, of"
              f" which {s0['rays_with_samples']} have samples, {s0['most_samples_a_ray']} at"
              f" most; bound ms K5 {bounds[0]:.5f}"
              + (f", K5b {bounds[1]:.5f}" if site in TRAIN_SITES else "") + " |"
              + " |" * len(trees))
        ways = [("fwd", "K5: ms / device ms"), ("bwd", "K5b: ms / device ms"),
                ("autograd", "fwd + bwd through autograd: ms")][:3 if site in TRAIN_SITES else 1]
        for way, name in ways:
            cells = []
            for t in trees:
                rs = [r["sites"][site] for r in by(t)]
                cell = f"{mean([x[way + '_ms'] for x in rs]):.4f}"
                if way + "_device_ms" in rs[0]:
                    cell += f" / {mean([x[way + '_device_ms'] for x in rs]):.4f}"
                if way + "_launches" in rs[0]:
                    cell += f" ({rs[0][way + '_launches']} launches"
                    cell += f", {rs[0][way + '_allocations']} allocations)"
                else:
                    cell += f" ({rs[0][way + '_allocations']} allocations)"
                cells.append(cell)
            print(f"| {name} | " + " | ".join(cells) + " |")
    for site in SITES:
        ways = [("fwd_host_us", "K5's host us"), ("bwd_host_us", "K5b's host us"),
                ("autograd_ms", "fwd + bwd through autograd ms"),
                ("autograd_host_us", "fwd + bwd through autograd host us")]
        for key, name in ways:
            if key in by(trees[0])[0]["sites"][site]:
                spread(f"{site}: {name}", lambda r: r["sites"][site][key])
    cells = [f"{by(t)[0]['profile']['device_events']}: " + "; ".join(
        f"{name[:60]} x{n}, {us:.1f} us" for name, (n, us) in by(t)[0]["profile"]["by_name"].items())
        for t in trees]
    print("| profiled view forward + training fwd/bwd: device events | " + " | ".join(cells)
          + " |")
    if "floor" in runs[0]:
        cells = [f"{mean([r['floor']['one_launch_device_ms'] for r in by(t)]):.4f} /"
                 f" {mean([r['floor']['two_launches_device_ms'] for r in by(t)]):.4f}"
                 for t in trees]
        print("| device ms of one / two empty launches | " + " | ".join(cells) + " |")
    cells = [json.dumps(by(t)[0]["view"]["launches"]) + f" ({by(t)[0]['view']['rounds']} rounds)"
             for t in trees]
    print("| 800x800 view: wrapper launch counts | " + " | ".join(cells) + " |")
    cells = [json.dumps({k: round(v, 2) for k, v in by(t)[0]["step"]["launches_per_step"].items()})
             for t in trees]
    print("| lambda = 0 step: wrapper launch counts per step | " + " | ".join(cells) + " |")
    spread("800x800 view ms", lambda r: r["view"]["ms"])
    spread("lambda = 0 step ms", lambda r: r["step"]["ms"])


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "summary":
        summary(Path(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("torch_volrend_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 2 and sys.argv[1] == "alloc":
        alloc_host_us()
    elif len(sys.argv) == 3 and sys.argv[1] == "prepare":
        prepare(Path(sys.argv[2]))
    elif len(sys.argv) == 5 and sys.argv[1] == "time":
        time_tree(Path(sys.argv[2]), Path(sys.argv[3]), sys.argv[4])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
