#!/usr/bin/env python3
"""Smoke run of cnc_torch's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card (name, power limit), torch and CUDA versions;
  2. build the kernels from cnc_torch/csrc (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch twin on the card, at the
     shapes the main path gives it, and time both with CUDA events;
  4. the main path: render one 800x800 view of a full-width field
     (ModelConfig(), RenderConfig(), random weights from seed 0) through
     `render_image`, over the procedural `blocks` scene's 128^3 occupancy,
     with every kernel's launch count read just after; then render it once
     more under torch.profiler for the device's busy share and the time by
     operator (also written to chiprun_out/profile.txt);
  5. render a 64x64 crop of the view on the card and with device="cpu" (the
     plain twins) and require them to agree;
  6. print the kernels line, the card line and the final JSON line.

It exits non-zero without a result when no CUDA device is present, or when
run outside the repository (cnc_torch missing).
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
VIEW = 800
CROP = 64
CROP_RGB_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card (CUDA events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_grid_encode(torch, enc, spec, table, pts, label):
    """K1 against its twin on one table at the main path's points (128 of
    them moved onto the border and partly outside [0,1]); returns the kernel
    record fields."""
    n = pts.shape[0]
    pts = pts.clone()
    pts[:64] = torch.round(pts[:64])
    pts[64:128] = pts[64:128] * 1.4 - 0.2
    res, offs = spec.resolutions, spec.offsets
    got = enc._encode_cuda(pts, table, res, offs)
    want = enc._encode_plain(pts, table, res, offs)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not (got.isfinite().all() and err <= 1e-5):
        raise AssertionError(f"K1 {label}: max abs err {err} > 1e-5")
    # bytes the function needs: points and output once, each distinct table
    # row it reads once (data dependent: the rows these points touch)
    rows = []
    for li, r in enumerate(res):
        frac, pg = enc._level_setup(pts, r)
        gi, wi = enc._corner_setup(frac, pg, offs[li], offs[li + 1] - offs[li], int(r))
        rows.append(gi[wi > 0])
    n_rows = torch.unique(torch.cat(rows)).numel()
    f = table.shape[1]
    n_bytes = pts.numel() * 4 + got.numel() * 4 + n_rows * f * 4
    n_flops = n * spec.n_levels * (2 ** spec.num_dim) * (spec.num_dim + 2 * f + 1)
    b, by = bound_ms(n_bytes, n_flops)
    rec = dict(max_abs_err=err, ms=time_ms(lambda: enc._encode_cuda(pts, table, res, offs)),
               plain_ms=time_ms(lambda: enc._encode_plain(pts, table, res, offs), iters=20),
               bound_ms=b, bound_by=by, library_ms=None)
    log(f"[K1 grid_encode {label}] N={n} L={spec.n_levels} D={spec.num_dim} rows={table.shape[0]}"
        f" distinct_rows={n_rows} err={err:.3g} ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f}"
        f" bound_ms={b:.4f}")
    return rec


def check_compact(torch, scatter_ops, n, cap, p, gen, dev):
    mask = torch.rand(n, generator=gen, device=dev) < p
    src, count = scatter_ops._compact_cuda(mask, cap)
    want_src, want_count = scatter_ops._compact_plain(mask, cap)
    torch.cuda.synchronize()
    if not (torch.equal(src, want_src) and int(count) == int(want_count)):
        raise AssertionError(f"K3 n={n} cap={cap}: kernel and twin differ")
    n_bytes = n + cap * 4 + 4
    b, by = bound_ms(n_bytes, n)
    rec = dict(max_abs_err=0.0, ms=time_ms(lambda: scatter_ops._compact_cuda(mask, cap)),
               plain_ms=time_ms(lambda: scatter_ops._compact_plain(mask, cap)),
               bound_ms=b, bound_by=by,
               library_ms=time_ms(lambda: torch.nonzero(mask)[:cap]))
    log(f"[K3 compact] n={n} cap={cap} count={int(count)} exact ms={rec['ms']:.4f}"
        f" plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} bound_ms={b:.5f}")
    return rec


def march_work(torch, marching, scatter_ops, o, d, binaries, aabb, rcfg, capacity, alive,
               cursor, mip):
    """What the march needs on these rays, with the twin's formulas: the
    (ray, block) and (candidate, step) tests whose result is not masked, and
    the distinct mip cells and grid voxels they read.  Returns (coarse tests,
    mip cells, fine tests, voxels)."""
    pl = marching._plan(rcfg, capacity, mip.shape[0], None)
    mres, res = mip.shape[0], binaries.shape[0]
    lo, hi = aabb[:3], aabb[3:]
    tmin, tmax = marching.ray_aabb_intersect(o, d, aabb)
    tmin = torch.maximum(torch.clamp(tmin, min=pl.near), cursor)
    tmax = torch.clamp(tmax, max=pl.far)
    blk = torch.arange(pl.nb, dtype=torch.float32, device=o.device)
    tc = tmin[:, None] + (blk[None, :] + 0.5) * pl.bdt
    x01 = torch.clamp((o[:, None] + d[:, None] * tc[..., None] - lo) / (hi - lo), 0.0,
                      pl.clip_hi)
    vox = (x01 * float(mres)).to(torch.int64)
    flat = (vox[..., 0] * mres + vox[..., 1]) * mres + vox[..., 2]
    need = ((tmin < tmax) & alive)[:, None] & (tmin[:, None] + blk[None, :] * pl.bdt
                                                < tmax[:, None])
    n_coarse, n_mip = int(need.sum()), torch.unique(flat[need]).numel()
    cand = mip.reshape(-1)[flat] & need
    src_c, total_c = scatter_ops._compact_plain(cand.reshape(-1), pl.cap_c)
    c_ray, c_blk = src_c.long() // pl.nb, src_c.long() % pl.nb
    cvalid = torch.arange(pl.cap_c, device=o.device) < min(int(total_c), pl.cap_c)
    step = c_blk[:, None].float() * float(pl.b) + torch.arange(pl.b, device=o.device)[None, :]
    tf = tmin[c_ray][:, None] + (step + 0.5) * pl.dt
    x01 = (o[c_ray][:, None] + d[c_ray][:, None] * tf[..., None] - lo) / (hi - lo)
    inside = ((x01 >= 0.0) & (x01 < 1.0)).all(dim=-1)
    vox = (x01 * float(res)).to(torch.int64).clamp(0, res - 1)
    flat = (vox[..., 0] * res + vox[..., 1]) * res + vox[..., 2]
    need = cvalid[:, None] & (tf < tmax[c_ray][:, None]) & (step < float(pl.s))
    return n_coarse, n_mip, int(need.sum()), torch.unique(flat[need & inside]).numel()


def profile_view(torch, render) -> None:
    """Device busy share and time by operator over one render of the view."""
    from pathlib import Path
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA) / 1e3
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    host = events.table(sort_by="self_cpu_time_total", row_limit=15)
    log(f"[profile] wall {wall_ms:.1f} ms under the profiler, device busy {dev_ms:.1f} ms"
        f" ({100 * dev_ms / wall_ms:.1f}%)")
    log(table)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "profile.txt").write_text(f"wall_ms {wall_ms}\ndevice_ms {dev_ms}\n{table}\n{host}\n")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    try:
        from cnc_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    from cnc_torch.config import ModelConfig, RenderConfig
    from cnc_torch.data import cameras, scenes
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.ops import encoding as enc
    from cnc_torch.ops import scatter_ops
    from cnc_torch.render import marching, renderer, volrend
    from cnc_torch.utils import metrics

    t_start = time.time()
    # the reference runs in full float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
        f" cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.time()
    kernels.lib()
    log(f"[build] {time.time() - t0:.1f} s ({', '.join(p.name for p in kernels.sources())})")

    # ---- shared inputs: the main path's config, field, occupancy and view
    mcfg, rcfg = ModelConfig(), RenderConfig()
    field = rf.RadianceField(mcfg, torch.Generator().manual_seed(0), device=dev)
    aabb = torch.tensor(rcfg.aabb, dtype=torch.float32, device=dev)
    scene = scenes.make_scene("blocks")
    binaries = scenes.occupancy_from_scene(scene, rcfg.occ_resolution, rcfg.render_step_size,
                                           device=dev)
    focal = 0.8 * VIEW
    K = torch.tensor([[focal, 0, VIEW / 2.0], [0, focal, VIEW / 2.0], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    c2w = torch.from_numpy(cameras.look_at_poses(1, radius=3.2, seed=1000,
                                                 full_sphere=True)[0]).to(dev)
    rays = cameras.image_rays(K, c2w, VIEW, VIEW)
    bkgd = torch.ones(3, device=dev)
    log(f"[setup] field {sum(p.numel() for p in field.parameters())} params;"
        f" occupancy {int(binaries.sum())}/{binaries.numel()} cells")

    # ---- 3. each kernel against its plain twin, at main-path shapes
    gen = torch.Generator(device=dev).manual_seed(1)
    tables = rf.quantized_tables(field, mcfg)
    records = {}
    with torch.no_grad():
        chunk = rcfg.eval_chunk_rays
        capacity = chunk * rcfg.eval_samples_per_iter
        # coarse mask 8192 x 17 -> 16,384 and fine mask 16,384 x 64 -> 65,536;
        # densities put the counts near the caps, the last one past it
        k3 = [check_compact(torch, scatter_ops, chunk * 17, max(256, capacity // 4), 0.1, gen,
                            dev),
              check_compact(torch, scatter_ops, (capacity // 4) * 64, capacity, 0.05, gen, dev),
              check_compact(torch, scatter_ops, (capacity // 4) * 64, capacity, 0.08, gen, dev)]
        records["compact"] = k3[1]

        # K4: 8,192 rays of the view, strided over the image so most hit the object
        o = rays.origins.reshape(-1, 3)[::VIEW * VIEW // chunk][:chunk].contiguous()
        d = rays.viewdirs.reshape(-1, 3)[::VIEW * VIEW // chunk][:chunk].contiguous()
        alive = torch.ones(chunk, dtype=torch.bool, device=dev)
        cursor = torch.zeros(chunk, device=dev)
        mip = marching.build_march_mip(binaries)
        march = lambda: marching._march_cuda(o, d, binaries, aabb, rcfg, capacity, alive,
                                             cursor, None, mip)
        plain = lambda: marching._march_plain(o, d, binaries, aabb, rcfg, capacity, alive,
                                              cursor, None, mip)
        # the first round (all rays alive) and a late one (10% alive)
        alive_late = torch.rand(chunk, generator=gen, device=dev) < 0.1
        got, want = march(), plain()
        late = marching._march_cuda(o, d, binaries, aabb, rcfg, capacity, alive_late, cursor,
                                    None, mip)
        late_want = marching._march_plain(o, d, binaries, aabb, rcfg, capacity, alive_late,
                                          cursor, None, mip)
        torch.cuda.synchronize()
        for name in ("ray_id", "t_mid", "valid", "truncated", "resume_ray", "num_samples"):
            for x, y in ((got, want), (late, late_want)):
                a, b = getattr(x, name), getattr(y, name)
                if not torch.equal(a.to(b.dtype), b):
                    raise AssertionError(f"K4: {name} differs between kernel and twin")
        n_valid = int(got.valid.sum())
        if n_valid < 1000:
            raise AssertionError(f"K4: only {n_valid} samples marched; the view misses the scene")
        # bytes: rays, cursor and mask once, each distinct mip cell and grid
        # voxel the passes need once (data dependent), the samples written once
        # and a few dozen flops for each of those tests
        n_coarse, n_mip, n_fine, n_vox = march_work(torch, marching, scatter_ops, o, d,
                                                    binaries, aabb, rcfg, capacity, alive,
                                                    cursor, mip)
        n_bytes = (o.numel() + d.numel() + cursor.numel()) * 4 + alive.numel() + n_mip \
            + n_vox + 6 * 4 + capacity * 9 + 12
        n_flops = (n_coarse + n_fine) * 40
        b, by = bound_ms(n_bytes, n_flops)
        records["march"] = dict(max_abs_err=0.0, ms=time_ms(march), plain_ms=time_ms(plain),
                                bound_ms=b, bound_by=by, library_ms=None)
        log(f"[K4 march] rays={chunk} capacity={capacity} samples={n_valid}"
            f" truncated={bool(got.truncated)} coarse_tests={n_coarse} mip_cells={n_mip}"
            f" fine_tests={n_fine} voxels={n_vox} exact ms={records['march']['ms']:.4f}"
            f" plain_ms={records['march']['plain_ms']:.4f} bound_ms={b:.5f}")

        # K1 at the first round's sample positions, normalized to [0,1]^3
        pos, _ = marching.sample_positions(got, o, d)
        x01 = ((pos - aabb[:3]) / (aabb[3:] - aabb[:3])).contiguous()
        k1_xyz = check_grid_encode(torch, enc, mcfg.grid_3d, tables["xyz"], x01, "xyz")
        k1_xy = check_grid_encode(torch, enc, mcfg.grid_2d, tables["xy"],
                                  x01[:, [0, 1]].contiguous(), "xy")
        records["grid_encode"] = dict(k1_xyz, max_abs_err=max(k1_xyz["max_abs_err"],
                                                               k1_xy["max_abs_err"]))

        # K5 on the first round's buffer (full, truncated) and the late
        # round's (mostly padding)
        sig = torch.empty(capacity, device=dev).exponential_(1 / 40.0, generator=gen)
        rgb = torch.rand(capacity, 3, generator=gen, device=dev)
        pt = torch.rand(chunk, generator=gen, device=dev) * 0.9 + 0.1
        k5 = {}
        for label, smp in (("full", got), ("late", late)):
            comp = lambda: volrend._composite_cuda(rgb, sig, smp, chunk, rcfg.early_stop_eps,
                                                   pt, rcfg.alpha_thre)
            comp_plain = lambda: volrend._composite_plain(rgb, sig, smp, chunk,
                                                          rcfg.early_stop_eps, pt,
                                                          rcfg.alpha_thre)
            a, b_ = comp(), comp_plain()
            torch.cuda.synchronize()
            err, rel = 0.0, 0.0
            for x, y in zip(a[:3], b_[:3]):
                diff = (x - y).abs()
                err = max(err, diff.max().item())
                rel = max(rel, (diff / y.abs().clamp(min=1e-3)).max().item())
            if not (rel <= 1e-4 and int(a[3]) == int(b_[3])):
                raise AssertionError(f"K5 {label}: max rel err {rel} > 1e-4 or visible counts"
                                     " differ")
            n_valid = int(smp.valid.sum())
            # bytes: each valid sample read once (padding needs only its
            # segment bounds), each ray written once
            n_bytes = n_valid * (4 + 12 + 4 + 1 + 4) + chunk * 4 + chunk * 20 + 4
            b, by = bound_ms(n_bytes, n_valid * 16)
            k5[label] = dict(max_abs_err=err, ms=time_ms(comp), plain_ms=time_ms(comp_plain),
                             bound_ms=b, bound_by=by, library_ms=None)
            log(f"[K5 volrend {label}] slots={capacity} valid={n_valid} rays={chunk}"
                f" max_abs_err={err:.3g} max_rel_err={rel:.3g} ms={k5[label]['ms']:.4f}"
                f" plain_ms={k5[label]['plain_ms']:.4f} bound_ms={b:.5f}")
        records["volrend"] = dict(k5["late"], max_abs_err=max(v["max_abs_err"]
                                                              for v in k5.values()))

    # ---- 4. the main path: one full 800x800 view through render_image,
    # timed on its second render (the first warms cuBLAS and the allocator)
    render_view = lambda **kw: renderer.render_image(field, mcfg, rcfg, aabb, binaries,
                                                     rays.origins, rays.viewdirs, bkgd,
                                                     device=dev, **kw)
    t0 = time.time()
    render_view()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    kernels.reset_launches()
    stats = {}
    t0 = time.time()
    rgb, opacity, depth = render_view(stats=stats)
    torch.cuda.synchronize()
    view_s = time.time() - t0
    launches = dict(kernels.launches)
    n_samples = int(stats["samples"])
    if rgb.shape != (VIEW, VIEW, 3) or not all(bool(x.isfinite().all()) for x in
                                               (rgb, opacity, depth)):
        raise AssertionError("main path: output has the wrong shape or is not finite")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"main path: a kernel was not launched: {launches}")
    with torch.no_grad():
        gt = torch.cat([scenes.render_gt_rays(scene, oo, dd, 512)[0] for oo, dd in zip(
            rays.origins.reshape(-1, 3).split(16384), rays.viewdirs.reshape(-1, 3).split(16384))])
        gt = gt.reshape(VIEW, VIEW, 3)
        psnr, ssim = float(metrics.psnr(rgb, gt)), float(metrics.ssim(rgb, gt))
    log(f"[main] {VIEW}x{VIEW} view: {view_s * 1e3:.1f} ms (first render {first_s * 1e3:.1f} ms),"
        f" {VIEW * VIEW / view_s:.0f} rays/s, {stats['rounds']} rounds"
        f" ({view_s * 1e3 / stats['rounds']:.3f} ms each), {n_samples} samples marched,"
        f" opacity mean {float(opacity.mean()):.4f}, psnr {psnr:.3f} ssim {ssim:.4f}"
        f" (random weights), launches {json.dumps(launches)}")

    profile_view(torch, render_view)

    # ---- 5. a 64x64 crop on the card and through the plain twins on the CPU
    lo = (VIEW - CROP) // 2
    co = rays.origins[lo:lo + CROP, lo:lo + CROP].contiguous()
    cd = rays.viewdirs[lo:lo + CROP, lo:lo + CROP].contiguous()
    t0 = time.time()
    gpu = renderer.render_image(field, mcfg, rcfg, aabb, binaries, co, cd, bkgd, device=dev)
    torch.cuda.synchronize()
    t_gpu = time.time() - t0
    field_cpu = copy.deepcopy(field).to("cpu")
    t0 = time.time()
    cpu = renderer.render_image(field_cpu, mcfg, rcfg, aabb.cpu(), binaries.cpu(), co.cpu(),
                                cd.cpu(), bkgd.cpu(), device="cpu")
    t_cpu = time.time() - t0
    errs = [float((g.cpu() - c).abs().max()) for g, c in zip(gpu[:2], cpu[:2])]
    log(f"[crop] {CROP}x{CROP}: card {t_gpu:.2f} s, cpu {t_cpu:.2f} s, max abs rgb err"
        f" {errs[0]:.3g}, opacity err {errs[1]:.3g} (tolerance {CROP_RGB_TOL})")
    if not max(errs) <= CROP_RGB_TOL:
        raise AssertionError("crop: the card and the plain CPU path disagree")

    # ---- 6. report
    meta = {
        "grid_encode": ("cnc_torch/csrc/grid_encode.cu", "cnc_tpu/ops/encoding.py:104"),
        "compact": ("cnc_torch/csrc/compact.cu", "cnc_tpu/ops/scatter_ops.py:146"),
        "march": ("cnc_torch/csrc/march.cu", "cnc_tpu/render/marching.py:112"),
        "volrend": ("cnc_torch/csrc/volrend.cu", "cnc_tpu/render/volrend.py:71"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        r = records[name]
        out.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                        launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["library_ms"]))
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
