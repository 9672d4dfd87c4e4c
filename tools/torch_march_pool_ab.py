#!/usr/bin/env python3
"""A/B of cnc_torch's ray march (K4) and context pooling (K6 / K6m) between
trees, on one NVIDIA GPU, at the shapes `chip_smoke.py` drives them at.

    python3 tools/torch_march_pool_ab.py prepare WORK
    python3 tools/torch_march_pool_ab.py time WORK TREE LABEL >> LOG
    python3 tools/torch_march_pool_ab.py summary LOG
    python3 tools/torch_march_pool_ab.py jumps SEEDS [FORMS]   (e.g. 0,1,2,3 as_is,roomy_buffer)
    python3 tools/torch_march_pool_ab.py spikes DIR            (e.g. chiprun_out/jumps)

`prepare` makes the inputs with this tree's cnc_torch and saves them to
WORK/inputs.pt: the smoke's 800x800 view's 8,192 strided rays at the first
round (every ray alive) and a late one (10% alive), a training march after
16 lambda = 0 steps (the trainer's ray bucket, occupancy grid and jitter),
and the arguments of each pooling call site of one rate estimate after 16
lambda = 2e-3 steps (the 3D context, the largest 2D window), with each
site's calls per step.

`time` imports cnc_torch from TREE (a directory holding another version's
`cnc_torch/`, e.g. a commit unpacked with `git archive`) and builds its
kernels into TREE/cnc_torch/_build.  It then measures, printing one JSON
line:
  * `rate`: a full-width lambda = 2e-3 trainer after 16 steps: one rate
    estimate's forward and backward (the 2D and 3D rate terms, gradients to
    the tables and the context MLPs) under torch.profiler, the process's
    first profile (wall ms, device-busy ms, kernel launches recorded) with
    the port's kernel launches counted by the wrappers; the same estimate's
    ms without the profiler; and ms per step, the median of five windows of
    20 steps;
  * `march`: the tree's march at the view's first and late rounds and at the
    training march (ms with the wrapper, device ms by CUDA events behind a
    spin kernel, launches), each checked against the tree's own twin;
  * `pool`: each pooling site's forward and backward as the tree computes
    it (its `segment_mean` where it has one, else the pair of
    `segment_pool` sums, the clamp and the divide that sites used before),
    ms, device ms and launches, the forward held to the twin;
  * `view`: one 800x800 view through `render_image` (random weights, seed
    0): the median of five renders after a first one, its rounds and
    launches.

Times vary between calls by up to 1.5x: compare trees only within one call,
in turns (a, b, b, a, a, b, b, a), e.g.

    for t in parent new new parent parent new new parent; do
        python3 tools/torch_march_pool_ab.py time WORK trees/$t $t >> LOG; done

`summary` gives each tree's mean over its runs and, for the view and the
step, every run's median, and whether the two trees' ranges of run medians
overlap (then the difference is not resolved by the runs).

`jumps` runs chip_smoke.py's lambda = 0 training phase (full width, the
`blocks` scene, 1,000 steps, the test views read five times 50 steps apart)
once per seed in each of the forms named (all of them by default): `as_is`;
`visible_frac`, with `render.visible_frac` = JUMP_VISIBLE_FRAC, which masks
the rays a truncated march cut out of the loss; `pinned_bucket`, with
`train.max_ray_bucket` = JUMP_PINNED_BUCKET, so the march (about 25 samples
a ray) fits its 327,680 slots; and `roomy_buffer`, with
`render.sample_budget_slack` = JUMP_ROOMY_SLACK, which sizes the buffer at
425,984 slots (1.3x), above the largest overshoot recorded (413,921), and
changes nothing else: the ray count still follows the marched count.  The
first run of that form (the H100, 2026-10) marched up to 551,561 samples a
step and still overflowed in 267-335 of 1,000 steps, so `no_truncation`
sizes the buffer at JUMP_NO_TRUNCATION_SLACK (589,824 slots, 1.8x), above
that, and changes nothing else either.  `no_truncation_eps` and
`no_truncation_half_lr` are `no_truncation` with one optimizer setting
changed: `adam_eps` JUMP_EPS (torch's and optax's default, against the
reference's 1e-15) or `lr` JUMP_HALF_LR (half the reference's 6e-3).  Per
run it prints one JSON line, with the run's `adam_eps` and `lr`: the test
PSNR readings and the dips among them (readings JUMP_DB or
more under the run's best), and how often and how far the march overflowed
its buffer; each run's per-step history goes to chiprun_out/jumps/.  It
uses this tree's cnc_torch.

`spikes` reads those histories (no card needed) and prints one line a run:
the training batch's PSNR spikes from step SPIKE_FROM on (steps whose
batch PSNR lies SPIKE_DB or more under the median of the SPIKE_WINDOW steps
before), how many fell on steps whose march overflowed its buffer, the
overflowing steps, the largest marched count and the batch's median PSNR
over the last 100 steps.  With the as-is buffer the cut rays stay in the
loss, so its batch PSNR sits near 19 dB and a spike there says little.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import asdict
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SITES = ("3D context", "2D window")
JUMP_VISIBLE_FRAC = 0.75     # the pruned buffer holds the ~60% of samples that are visible
JUMP_PINNED_BUCKET = 8192    # 8,192 rays x ~25 samples fit 327,680 slots
JUMP_ROOMY_SLACK = 1.625     # 262,144 x 1.625 = 425,984 slots, 1.3x the default 327,680
JUMP_NO_TRUNCATION_SLACK = 2.25   # 589,824 slots, above the 551,561 marched at most
JUMP_EPS = 1e-8              # `no_truncation_eps`: torch's and optax's default Adam eps
JUMP_HALF_LR = 3e-3          # `no_truncation_half_lr`: half the reference's 6e-3
JUMP_FORMS = ("as_is", "visible_frac", "pinned_bucket", "roomy_buffer", "no_truncation",
              "no_truncation_eps", "no_truncation_half_lr")
JUMP_DB = 5.0                # a reading this far under the run's best is a dip
SPIKE_DB, SPIKE_WINDOW, SPIKE_FROM = 5.0, 20, 300   # `spikes`: a batch this far under the
                                                    # median of the window before it
MARCHES = ("view, first round", "view, late round", "training march")
VIEW_RENDERS = 5             # timed renders of the view per run
STEP_WINDOWS = 5             # timed windows of 20 lambda > 0 steps per run


def _smoke():
    sys.path.insert(1, str(REPO))
    import chip_smoke
    return chip_smoke


def _view_rays(torch, cs, dev):
    from cnc_torch.config import RenderConfig
    from cnc_torch.data import cameras
    view = cs.VIEW
    K = torch.tensor([[0.8 * view, 0, view / 2.0], [0, 0.8 * view, view / 2.0], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    c2w = torch.from_numpy(cameras.look_at_poses(1, radius=3.2, seed=1000,
                                                 full_sphere=True)[0]).to(dev)
    return RenderConfig(), cameras.image_rays(K, c2w, view, view)


def prepare(work: Path) -> None:
    import torch
    sys.path.insert(0, str(REPO))
    cs = _smoke()
    from cnc_torch.config import CNCConfig, TrainConfig
    from cnc_torch.data import scenes
    from cnc_torch.models import context_models as cm
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.ops import context_ops as cops
    from cnc_torch.ops import encoding as enc
    from cnc_torch.train.trainer import Trainer, _next_bucket

    dev = torch.device("cuda")
    rcfg, rays = _view_rays(torch, cs, dev)
    binaries = scenes.occupancy_from_scene(scenes.make_scene("blocks"), rcfg.occ_resolution,
                                           rcfg.render_step_size, device=dev)
    chunk, view = rcfg.eval_chunk_rays, cs.VIEW
    o = rays.origins.reshape(-1, 3)[::view * view // chunk][:chunk].contiguous()
    d = rays.viewdirs.reshape(-1, 3)[::view * view // chunk][:chunk].contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    alive_late = torch.rand(chunk, generator=gen, device=dev) < 0.1
    capacity = chunk * rcfg.eval_samples_per_iter
    cursor = torch.zeros(chunk, device=dev)
    march = {
        "view, first round": dict(o=o, d=d, binaries=binaries, rcfg=asdict(rcfg),
                                  capacity=capacity,
                                  mask=torch.ones(chunk, dtype=torch.bool, device=dev),
                                  t_start=cursor, jitter=None),
        "view, late round": dict(o=o, d=d, binaries=binaries, rcfg=asdict(rcfg),
                                 capacity=capacity,
                                 mask=alive_late, t_start=cursor, jitter=None)}

    # a training march after 16 lambda = 0 steps (chip_smoke's [K4 march, jittered])
    train_set = scenes.ProceduralDataset("blocks", device=dev)
    tr = Trainer(CNCConfig(train=dataclasses.replace(TrainConfig(), lmbda=0.0)), train_set)
    tr.fit(cs.TRAIN_WARM_STEPS - 1, log_every=0)
    cfg = tr.cfg
    bucket = _next_bucket(tr.num_rays, cfg.train.min_ray_bucket, cfg.train.max_ray_bucket)
    batch, _ = train_set.fetch_rays(gen, bucket)
    march["training march"] = dict(o=batch.origins.contiguous(), d=batch.viewdirs.contiguous(),
                                   binaries=tr.occ_state.binaries.clone(),
                                   rcfg=asdict(cfg.render),
                                   capacity=cfg.render.sample_capacity, mask=None, t_start=None,
                                   jitter=torch.rand(bucket, generator=gen, device=dev))
    del tr

    # one rate estimate after 16 lambda = 2e-3 steps (chip_smoke's [K6m])
    rate_cfg = CNCConfig()
    entropy = cm.ContextModels(rate_cfg.entropy, rate_cfg.model.grid_3d, rate_cfg.model.grid_2d)
    trr = Trainer(rate_cfg, train_set, entropy=entropy)
    trr.fit(cs.RATE_WARM_STEPS - 1, log_every=0)
    calls = cs.capture_rate_calls(torch, trr, rf, cops, enc)["segment_mean"]
    biggest = max(calls, key=lambda c: c[0][0].shape[0])
    others = [c for c in calls if c is not biggest]
    pool = {}
    for label, site in zip(SITES, ([biggest], others)):
        a = cs.mean_args(torch, max(site, key=lambda c: c[0][0].shape[0]))
        pool[label] = dict(a, per_step=len(site))
    work.mkdir(parents=True, exist_ok=True)
    torch.save({"march": march, "pool": pool}, work / "inputs.pt")
    print(json.dumps({"prepared": {
        "march": {k: [tuple(v["o"].shape), v["capacity"]] for k, v in march.items()},
        "pool": {k: [tuple(v["x"].shape), v["num"], v["weighted"], v["per_step"]]
                 for k, v in pool.items()}}}))


def _pool_fn(torch, cops, a):
    """The site's pooling as this tree computes it: (pooled, covered)."""
    den, seg, valid, num = a["den"], a["seg"], a["valid"], a["num"]
    if hasattr(cops, "segment_mean"):
        return lambda xx: cops.segment_mean(xx, den, seg, valid, num, a["min_den"],
                                            weighted=a["weighted"])

    def pair(xx):
        dsum = cops.segment_pool(den, seg, valid, num)
        num_x = xx * den[:, None] if a["weighted"] else xx
        pooled = cops.segment_pool(num_x, seg, valid, num)
        return pooled / torch.clamp(dsum, min=a["min_den"])[:, None], dsum > 0
    return pair


def time_tree(work: Path, tree: Path, label: str) -> None:
    import torch
    sys.path.insert(0, str(tree.resolve()))
    import cnc_torch
    from cnc_torch import kernels
    from cnc_torch.config import RenderConfig
    from cnc_torch.ops import context_ops as cops
    from cnc_torch.render import marching
    if Path(cnc_torch.__file__).resolve().parent != (tree / "cnc_torch").resolve():
        raise RuntimeError(f"cnc_torch was not imported from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _smoke()
    kernels.lib()
    out = {"tree": label, "card": cs.card_line(), "device": torch.cuda.get_device_name(0)}
    out["rate"] = rate_phase(torch, cs, kernels)     # first: the process's first profile
    inputs = torch.load(work / "inputs.pt")

    out["march"] = {}
    for site, a in inputs["march"].items():
        mip = marching.build_march_mip(a["binaries"])
        rcfg = RenderConfig(**a["rcfg"])
        args = (a["o"], a["d"], a["binaries"], torch.tensor(rcfg.aabb, device="cuda"), rcfg,
                a["capacity"], a["mask"], a["t_start"], None, mip, a["jitter"])
        with torch.no_grad():
            got, want = marching._march_cuda(*args), marching._march_plain(*args)
            for name in ("ray_id", "t_mid", "valid", "truncated", "resume_ray", "num_samples"):
                x, y = getattr(got, name), getattr(want, name)
                if not torch.equal(x.to(y.dtype), y):
                    raise AssertionError(f"{label} {site}: {name} differs from the twin")
            kernels.reset_launches()
            marching._march_cuda(*args)
            launched = {k: v for k, v in kernels.launches.items() if v}
            fn = lambda: marching._march_cuda(*args)
            out["march"][site] = dict(ms=cs.time_ms(fn), device_ms=cs.device_ms(fn),
                                      launches=launched, samples=int(got.valid.sum()))

    out["pool"] = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for site, a in inputs["pool"].items():
        fn = _pool_fn(torch, cops, a)
        leaf = a["x"].clone().requires_grad_()
        pooled, covered = fn(leaf)
        dsum = cops._segment_pool_plain(a["den"], a["seg"], a["valid"], a["num"])
        want = cops._segment_pool_plain(a["x"] * a["den"][:, None] if a["weighted"] else a["x"],
                                        a["seg"], a["valid"], a["num"])
        want = want / torch.clamp(dsum, min=a["min_den"])[:, None]
        err = cs.rel_err(pooled.detach(), want)
        if not (err <= cs.K6_REL_TOL and torch.equal(covered, dsum > 0)):
            raise AssertionError(f"{label} {site}: pooling rel err {err} or covered differs")
        cot = torch.randn(pooled.shape, generator=gen, device="cuda")
        kernels.reset_launches()
        p, _ = fn(leaf)
        fwd_launches = {k: v for k, v in kernels.launches.items() if v}
        kernels.reset_launches()
        p.backward(cot)
        bwd_launches = {k: v for k, v in kernels.launches.items() if v}
        forward = lambda: fn(leaf)
        with_grad = lambda: fn(leaf)[0].backward(cot)
        out["pool"][site] = dict(
            fwd_ms=cs.time_ms(forward), fwd_device_ms=cs.device_ms(forward),
            fwd_bwd_ms=cs.time_ms(with_grad), fwd_bwd_device_ms=cs.device_ms(with_grad),
            fwd_launches=fwd_launches, bwd_launches=bwd_launches, rel_err=err,
            rows=int(a["x"].shape[0]), per_step=a["per_step"])
        del leaf

    out["view"] = view_phase(torch, cs, kernels)
    print(json.dumps(out))


def rate_phase(torch, cs, kernels) -> dict:
    """A lambda = 2e-3 trainer at full width after 16 steps: one rate
    estimate's forward and backward, profiled (the process's first profile)
    and timed, then ms per step: the median of STEP_WINDOWS windows of 20
    steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cnc_torch.config import CNCConfig
    from cnc_torch.data import scenes
    from cnc_torch.models import context_models as cm
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.train.trainer import Trainer
    cfg = CNCConfig()
    ds = scenes.ProceduralDataset("blocks", device="cuda")
    entropy = cm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d)
    tr = Trainer(cfg, ds, entropy=entropy)
    tr.fit(cs.RATE_WARM_STEPS - 1, log_every=0)
    starts = entropy.draw_starts(tr.generator)
    cache = tr._last_ent_cache

    def estimate():
        tables = rf.quantized_tables(tr.field, cfg.model)
        wrt = [tr.field.tables[k] for k in rf.TABLES] + list(tr.ent_params.parameters())
        bits = (entropy.rate_bits_2d(tr.ent_params, tables, starts["2d"], cache)
                + entropy.rate_bits_3d(tr.ent_params, tables["xyz"], starts["3d"], cache))
        torch.autograd.grad(bits, wrt, allow_unused=True)

    estimate()
    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        estimate()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    launched = {k: v for k, v in kernels.launches.items() if v}
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    recorded = sum(e.count for e in events)
    est_ms = cs.time_ms(estimate, iters=10, warmup=2)
    bkgd = torch.ones(3, device="cuda")

    def step():
        batch, pixels = ds.fetch_rays(tr.generator, tr.num_rays)
        tr._train_step(batch.origins, batch.viewdirs, pixels, bkgd, ent_cache=tr._last_ent_cache)

    step()
    torch.cuda.synchronize()
    windows = []
    for _ in range(STEP_WINDOWS):
        t0 = time.time()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        windows.append((time.time() - t0) / 20 * 1e3)
    return {"estimate_profiled_wall_ms": wall_ms, "estimate_device_busy_ms": busy_ms,
            "estimate_device_launches_recorded": recorded, "estimate_kernel_launches": launched,
            "estimate_ms": est_ms, "step_ms": statistics.median(windows),
            "step_ms_windows": windows}


def view_phase(torch, cs, kernels) -> dict:
    """The smoke's 800x800 view with random weights (seed 0): the median of
    VIEW_RENDERS renders after a first one."""
    from cnc_torch.data import scenes
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.render import renderer
    from cnc_torch.config import ModelConfig
    dev = torch.device("cuda")
    rcfg, rays = _view_rays(torch, cs, dev)
    mcfg = ModelConfig()
    field = rf.RadianceField(mcfg, torch.Generator().manual_seed(0), device=dev)
    aabb = torch.tensor(rcfg.aabb, dtype=torch.float32, device=dev)
    binaries = scenes.occupancy_from_scene(scenes.make_scene("blocks"), rcfg.occ_resolution,
                                           rcfg.render_step_size, device=dev)
    render = lambda **kw: renderer.render_image(field, mcfg, rcfg, aabb, binaries, rays.origins,
                                                rays.viewdirs, torch.ones(3, device=dev),
                                                device=dev, **kw)
    render()
    torch.cuda.synchronize()
    times = []
    for _ in range(VIEW_RENDERS):
        kernels.reset_launches()
        stats = {}
        t0 = time.time()
        render(stats=stats)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return {"ms": statistics.median(times), "ms_renders": times, "rounds": stats["rounds"],
            "samples": int(stats["samples"]),
            "launches": {k: v for k, v in kernels.launches.items() if v}}


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
    for site in MARCHES:
        cells = [f"{mean([r['march'][site]['ms'] for r in by(t)]):.4f} / "
                 f"{mean([r['march'][site]['device_ms'] for r in by(t)]):.4f}"
                 f" ({sum(by(t)[0]['march'][site]['launches'].values())} launches)"
                 for t in trees]
        print(f"| march, {site}: ms / device ms | " + " | ".join(cells) + " |")
    for site in SITES:
        for way in ("fwd", "fwd_bwd"):
            cells = [f"{mean([r['pool'][site][way + '_ms'] for r in by(t)]):.4f} / "
                     f"{mean([r['pool'][site][way + '_device_ms'] for r in by(t)]):.4f}"
                     for t in trees]
            print(f"| pooling, {site}, {way}: ms / device ms | " + " | ".join(cells) + " |")
        cells = [json.dumps(by(t)[0]["pool"][site]["fwd_launches"]) + " + "
                 + json.dumps(by(t)[0]["pool"][site]["bwd_launches"]) for t in trees]
        print(f"| pooling, {site}: launches fwd + bwd | " + " | ".join(cells) + " |")
    for key in ("estimate_ms", "estimate_profiled_wall_ms", "estimate_device_busy_ms",
                "estimate_device_launches_recorded", "step_ms"):
        cells = [", ".join(f"{r['rate'][key]:.2f}" for r in by(t)) for t in trees]
        print(f"| rate: {key} | " + " | ".join(cells) + " |")
    cells = [", ".join(f"{r['view']['ms']:.1f}" for r in by(t))
             + f" ({by(t)[0]['view']['rounds']} rounds,"
             f" {json.dumps(by(t)[0]['view']['launches'])})" for t in trees]
    print("| 800x800 view ms | " + " | ".join(cells) + " |")
    for item, get in (("800x800 view ms", lambda r: r["view"]["ms"]),
                      ("lambda > 0 step ms", lambda r: r["rate"]["step_ms"])):
        spans = {t: (min(map(get, by(t))), statistics.median(map(get, by(t))),
                     max(map(get, by(t)))) for t in trees}
        text = "; ".join(f"{t} {lo:.2f} / {mid:.2f} / {hi:.2f}" for t, (lo, mid, hi)
                         in spans.items())
        if len(trees) == 2:
            (lo_a, mid_a, hi_a), (lo_b, mid_b, hi_b) = spans.values()
            apart = hi_a < lo_b or hi_b < lo_a
            text += (f"; {trees[1]} - {trees[0]} = {mid_b - mid_a:+.2f} ms between medians, "
                     + ("resolved (the ranges do not overlap)" if apart else
                        "not resolved (the ranges overlap)"))
        print(f"{item}, run medians (least / median / most): {text}")


def jumps(seeds, forms=JUMP_FORMS) -> None:
    import statistics
    import torch
    sys.path.insert(0, str(REPO))
    cs = _smoke()
    from cnc_torch import kernels
    from cnc_torch.config import CNCConfig, TrainConfig
    from cnc_torch.data import scenes
    from cnc_torch.train.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.lib()
    dev = torch.device("cuda")
    out_dir = Path("chiprun_out") / "jumps"
    out_dir.mkdir(parents=True, exist_ok=True)
    train_set = scenes.ProceduralDataset("blocks", device=dev)
    test_set = scenes.ProceduralDataset("blocks", n_images=2, split="test", device=dev)
    for seed in seeds:
        for form in forms:
            cfg = CNCConfig(train=dataclasses.replace(TrainConfig(), lmbda=0.0, seed=seed))
            if form == "visible_frac":
                cfg = dataclasses.replace(cfg, render=dataclasses.replace(
                    cfg.render, visible_frac=JUMP_VISIBLE_FRAC))
            elif form == "pinned_bucket":
                cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                    cfg.train, max_ray_bucket=JUMP_PINNED_BUCKET))
            elif form == "roomy_buffer" or form.startswith("no_truncation"):
                slack = JUMP_ROOMY_SLACK if form == "roomy_buffer" else JUMP_NO_TRUNCATION_SLACK
                cfg = dataclasses.replace(cfg, render=dataclasses.replace(
                    cfg.render, sample_budget_slack=slack))
            if form == "no_truncation_eps":
                cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                    cfg.train, adam_eps=JUMP_EPS))
            elif form == "no_truncation_half_lr":
                cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                    cfg.train, lr=JUMP_HALF_LR))
            tr = Trainer(cfg, train_set)
            hist = []

            def on_step(step, aux):
                hist.append((float(aux["mse"]), aux["n_marched"], aux["n_samples"],
                             aux["num_rays"]))

            seconds, scores = cs.fit_and_read(kernels, tr, cs.TRAIN_STEPS, test_set, on_step,
                                              f"[jumps {seed} {form}] ")
            readings = scores["readings"]
            read_at = [cs.TRAIN_STEPS - 1 - back * cs.PSNR_READ_EVERY
                       for back in reversed(range(cs.PSNR_READINGS))]
            dips = [(step, psnr) for step, psnr in zip(read_at, readings)
                    if psnr <= max(readings) - JUMP_DB]
            cap = cfg.render.sample_capacity
            over = [h[1] / cap for h in hist if h[1] > cap]
            (out_dir / f"seed{seed}_{form}.json").write_text(json.dumps(
                {"columns": ["mse", "n_marched", "n_visible", "num_rays"], "capacity": cap,
                 "adam_eps": cfg.train.adam_eps, "lr": cfg.train.lr, "steps": hist}))
            print(json.dumps({"seed": seed, "form": form, "capacity": cap,
                              "adam_eps": cfg.train.adam_eps, "lr": cfg.train.lr, "dips": dips,
                              "psnr_readings": readings, "psnr_median": scores["psnr"],
                              "overflow_steps": len(over), "steps": len(hist),
                              "overflow_mean": statistics.mean(over) if over else 0.0,
                              "marched_mean_last_100": statistics.mean(h[1] for h in hist[-100:]),
                              "rays_last_100": statistics.mean(h[3] for h in hist[-100:]),
                              "seconds": seconds, "card": cs.card_line()}), flush=True)
            del tr


def spikes(dirname: Path) -> None:
    import numpy as np
    from cnc_torch.config import RenderConfig
    slack = {"roomy_buffer": JUMP_ROOMY_SLACK, "no_truncation": JUMP_NO_TRUNCATION_SLACK,
             "no_truncation_eps": JUMP_NO_TRUNCATION_SLACK,
             "no_truncation_half_lr": JUMP_NO_TRUNCATION_SLACK}
    for path in sorted(dirname.glob("seed*_*.json")):
        seed, form = path.stem[4:].split("_", 1)
        rec = json.loads(path.read_text())
        cap = rec.get("capacity") or dataclasses.replace(
            RenderConfig(), sample_budget_slack=slack.get(form, 1.25)).sample_capacity
        steps = np.array(rec["steps"], dtype=np.float64)
        psnr, marched = -10.0 * np.log10(steps[:, 0]), steps[:, 1]
        over = marched > cap
        found = [i for i in range(max(SPIKE_FROM, SPIKE_WINDOW), len(psnr))
                 if psnr[i] <= np.median(psnr[i - SPIKE_WINDOW:i]) - SPIKE_DB]
        print(json.dumps({"seed": int(seed), "form": form, "capacity": cap,
                          "adam_eps": rec.get("adam_eps"), "lr": rec.get("lr"),
                          "spikes": len(found), "spikes_on_overflow": int(over[found].sum()),
                          "spike_steps": found, "overflow_steps": int(over.sum()),
                          "marched_max": int(marched.max()),
                          "batch_psnr_median_last_100": float(np.median(psnr[-100:]))}))


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "summary":
        summary(Path(sys.argv[2]))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "spikes":
        sys.path.insert(0, str(REPO))
        spikes(Path(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("torch_march_pool_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "prepare":
        prepare(Path(sys.argv[2]))
    elif len(sys.argv) == 5 and sys.argv[1] == "time":
        time_tree(Path(sys.argv[2]), Path(sys.argv[3]), sys.argv[4])
    elif len(sys.argv) in (3, 4) and sys.argv[1] == "jumps":
        forms = tuple(sys.argv[3].split(",")) if len(sys.argv) == 4 else JUMP_FORMS
        if not set(forms) <= set(JUMP_FORMS):
            print(f"torch_march_pool_ab: jumps takes forms among {JUMP_FORMS}", file=sys.stderr)
            return 2
        jumps([int(x) for x in sys.argv[2].split(",")], forms)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
