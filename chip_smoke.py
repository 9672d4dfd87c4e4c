#!/usr/bin/env python3
"""Smoke run of cnc_torch's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card (name, power limit), torch and CUDA versions;
  2. build the kernels from cnc_torch/csrc (nvcc, sm_90a);
  3. hold each serving kernel (K1, K4, K5; K3 at random masks) against its
     plain PyTorch twin on the card, at the shapes the serving path gives it,
     and time both with CUDA events (the encode kernels and the march also by
     their device work alone, without the wrapper's host time: `device_ms`;
     the encode's forward must equal the twin bit for bit, and every field of
     the march, its padding slots and its per-ray hit counts and last t_mid
     included, at the view's first and a late round);
  4. the serving path: render one 800x800 view of a full-width field
     (ModelConfig(), RenderConfig(), random weights from seed 0) through
     `render_image`, over the procedural `blocks` scene's 128^3 occupancy,
     with every kernel's launch count read just after (the march three a
     round, no K3); then render it once
     more under torch.profiler for the device's busy share and the time by
     operator (also written to chiprun_out/profile.txt);
  5. render a 64x64 crop of the view on the card and with device="cpu" (the
     plain twins) and require them to agree;
  6. [probe] the scatter-add and lane-gather kernels at the TPU probe's
     shapes (table [8, 2^18], 2^23 indices from a numpy seed), driven once
     through their public wrappers with the counts read just after, held
     against their twins and timed;
  7. [train] the training path at full width: `Trainer(CNCConfig() with
     lmbda=0, ProceduralDataset("blocks")).fit`.  After the first 16 steps
     the training kernels are held against their twins at one real training
     march's buffer: K4 with jitter (exact, timed), K1 on the xyz table, [K2] the
     encode backward on the xyz table and one plane, [K5b] the composite
     backward at the full and
     at a half-padded buffer.  Then the counts are set to 0, `fit` runs on
     to TRAIN_STEPS, and the counts are read: every training kernel must
     have launched, the loss must have fallen, and the test views' PSNR must
     exceed TRAIN_PSNR_MIN (each phase reads the test views five times from
     `fit`'s step callback; those renders' launches are taken out of the
     counts).  One more step runs under torch.profiler
     (chiprun_out/profile_train.txt);
  8. render the 800x800 view once more with the trained field and grid;
  9. [rate] the rate path at full width, with the counts set to 0 just
     before it: build `ContextModels(EntropyConfig(), grid_3d, grid_2d)`
     ([K10]: seconds, peak memory, entries per level; the table kernels
     against their twins), then `Trainer(CNCConfig(), ProceduralDataset(
     "blocks"), entropy=...)` with the default lmbda = 2e-3.  After 16 steps
     the rate kernels are held against their twins at that step's real
     shapes ([K8] and [pack], the packing of the masks, on the lambda = 0
     run's trained occupancy grid; [K6] segment_gather's gather and its
     backward's sums at the 3D context, [K6m] segment_mean at each pooling site (the 3D context, the 2D windows:
     within K6_REL_TOL, covered exact, two runs bit-equal, its backward), [K3]
     at the 3D context compaction, [K7], and [K1v], [K2v] at each call site
     (the 3D mixed-level context, the 2D windows, the frac planes) with its
     launches per step, on the arguments one rate estimate gives them);
     those launches are taken out of the counts again.  `fit` then runs on to RATE_STEPS and
     the counts are read: every rate kernel must have launched (the step's
     kernels in every step), bits_per_param must be finite and lower than at
     step 16, and the test views' PSNR must exceed RATE_PSNR_MIN.  At step 16
     and at the end, one whole rate estimate's gradients (the four tables, the
     context MLPs) through the kernels are held against the same estimate
     through the twins on the card in float64, beside the float32 twins' own
     distance from it (check_rate_gradient).  One more step runs under
     torch.profiler (chiprun_out/profile_rate.txt).  A three-step run with
     `pn_frac_grad=True` drives the sign histogram's backward kernel, which
     the default configuration does not reach.  After each of these rate
     phases the word segment_mean sets when live ids decrease must be clear;
 10. [codec] the lambda = 2e-3 run's binarized tables through the codec, with
     the counts set to 0 just before it: `refresh_cache_int`; the codec
     kernels held to their twins with torch.equal ([K9a] int_encode, [K9b]
     int_mlp_pool, [K9c] int_pq on the middle chunk of the last 3D context
     level and on the last 2D context level with its plane, [K7i] pn_hist_int
     on one plane; their launches taken out of the counts); `CNCCodec.encode`
     into chiprun_out/bundle/ and `decode` in the same process, with every
     codec kernel launched in each; the decoded tables must equal the trained
     ones on every covered entry and be +1 elsewhere, the coded MB must lie
     within 15% of the analytic MB, and the test views' PSNR must move by at
     most 1e-3 dB; then `save_bundle` and `decode_bundle` in a fresh python3
     process, whose tables and render of test view 0 must equal this
     process's;
 11. print the kernels line, the card line and the final JSON line.

It exits non-zero without a result when no CUDA device is present, or when
run outside the repository (cnc_torch missing).
"""

from __future__ import annotations

import contextlib
import copy
import inspect
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
# int32 outside the tensor cores: the data sheet gives no figure; an SM issues
# 64 int32 lanes per clock against 128 float32 ones, so half the f32 rate,
# with a multiply-add counted as two operations as an FMA is
INT32_OPS = F32_FLOPS / 2
VIEW = 800
CROP = 64
CROP_RGB_TOL = 1e-3
PROBE_LOG2_TABLE, PROBE_N = 18, 1 << 23   # tools/pallas_probe.py's default shapes
# device_ms's spin before each timed call: about 1 ms at the H100's clocks,
# far above a wrapper's host time
SPIN_CYCLES = 2_000_000
TRAIN_WARM_STEPS = 16       # steps before the training kernels are checked
# total steps, the whole lr warm-up; the driven run is TRAIN_STEPS - TRAIN_WARM_STEPS
TRAIN_STEPS = 1000
K2_REL_TOL = 1e-4           # max |kernel - twin| over max |d_table| (float atomics)
K5B_REL_TOL = 1e-5          # the same for d_sigmas and d_rgbs (serial sums, other order)
SCATTER_REL_TOL = 1e-5      # scatter_add against index_add_, over max |out|
# the first H100 run of this phase reached 37.36 dB on the two test views after
# 1,000 steps (35.87 dB after 400); the floor leaves 5.36 dB for run-to-run
# spread (the draws are seeded, but K2's float atomics make no two runs bit-equal)
TRAIN_PSNR_MIN = 32.0
# A single reading of the test views can dip by 10 dB and more for some
# dozens of steps: near the top of the lr warm-up the training loss jumps (in
# one run's chiprun_out/train_history.json from 0.014 to 0.026 at step 957,
# the visible samples from 190,000 to 290,000 within three steps) and takes
# about a hundred steps to come back; the test views read 21.2, 31.8 and
# 34.2 dB at steps 959, 979 and 999 of that run, 37 to 38 dB in runs without
# a jump.  Seen with and without the rate term, and on the tree before it.  So
# each training phase reads the test views at PSNR_READINGS steps, this far
# apart, the last at its end, and holds the median to its floor.
PSNR_READ_EVERY, PSNR_READINGS = 50, 5
RATE_WARM_STEPS = 16        # rate steps before the rate kernels are checked
RATE_STEPS = 1000           # total steps of the lambda > 0 run
K6_REL_TOL = 1e-5           # pooling against the twin, over max |out| (f32 adds reordered)
K7B_REL_TOL = 1e-5          # the histogram's backward against the float64 twin, over max |d_table|
# K8's overlap over the level's largest overlap: against the twin with its sums
# in float64, and against the twin as cnc_tpu rounds it (float32 cumulative
# sums up to 10^3 differenced into values near 0.1: the twin's own rounding)
K8_REL_TOL, K8_F32_TOL = 1e-5, 1e-4
# the first H100 runs of the [rate] phase read medians of 35.8 to 37.8 dB after
# 1,000 steps; the floor is the lambda = 0 phase's, 3.8 dB under the lowest
RATE_PSNR_MIN = 32.0
# the rate gradient (check_rate_gradient): the bands of p left out, the one
# that is held, and how far the kernels' gradient may then lie from the float64
# yardstick, as the norm of the difference over the gradient's norm:
# RATE_GRAD_TOL more than twice the float32 twins' own distance.  With p within
# 1e-3 of 0 and 1 left out, the first H100 runs (eight states between steps 16
# and 1,000) put the float32 twins 3e-7 to 4e-4 from the yardstick, the kernels
# at most 4e-5 further than the twins, and two kernel runs 3e-7 apart.  Single
# entries move by
# up to 1e-3 of the largest one on either float32 side (a value near the clamp,
# or a ReLU of the context MLPs, switches with the last bit of its input), and
# with nothing left out the values at the clamp decide (at step 16 of one run
# the kernels' largest entry error was 1.9e-2, the float32 twins' 6.8e-3, on
# one table and 5.3e-2 both on another): those figures are printed, not held.
RATE_GRAD_BANDS = (0.0, 4e-6, 1e-3)
# every field of the march's output, the padding slots and the per-ray
# outputs included, is held to the twin with torch.equal
MARCH_FIELDS = ("ray_id", "t_mid", "valid", "truncated", "resume_ray", "num_samples", "ray_hits",
                "ray_last_t")
RATE_GRAD_BAND, RATE_GRAD_TOL = 1e-3, 1e-4


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


def device_ms(fn, iters: int = 10) -> float:
    """Median milliseconds of the device work of one fn() call, the
    wrapper's host time left out: CUDA events around the call, recorded
    behind a spin kernel (torch.cuda._sleep, about a millisecond) that keeps
    the card busy until the call has enqueued its work, so the start event
    fires just before it.  (torch.profiler's kernel times cannot serve: in a
    process that has profiled before, it records only some launches, at
    times none.)"""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_grid_encode(torch, enc, spec, table, pts, label, perturb=True, name="K1", **kw):
    """K1 against its twin on one table at the main path's points (with
    `perturb`, 128 of them moved onto the border and partly outside [0,1]);
    `kw` are the masked / mixed-level arguments of the variant (K1v), for
    which `spec`'s levels are those of the call.  Returns the kernel record
    fields."""
    n = pts.shape[0]
    if perturb:
        pts = pts.clone()
        pts[:64] = torch.round(pts[:64])
        pts[64:128] = pts[64:128] * 1.4 - 0.2
    res, offs = spec.resolutions, spec.offsets
    n_out = kw.get("n_levels_calc") or len(res)
    got = enc._encode_cuda(pts, table, res, offs, **kw)
    plain_kw = {k: v for k, v in kw.items() if k != "occ_bits"}   # the twin reads the bools
    want = enc._encode_plain(pts, table, res, offs, **plain_kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not (got.isfinite().all() and err <= 1e-5):
        raise AssertionError(f"{name} {label}: max abs err {err} > 1e-5")
    # built without FMA and summing the corners in the twin's order, the
    # forward equals its twin bit for bit (see csrc/grid_encode.cu)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {label}: the forward is not bit-equal to its twin")
    del want
    # bytes the function needs: points and output once, each distinct table
    # row it reads once (data dependent: the rows these points touch), and
    # for a variant its level ids and one mask byte per distinct corner read
    gs, ws = enc._corner_sets(pts, res, offs, **plain_kw)
    live = torch.cat([g[w > 0] for g, w in zip(gs, ws)])
    n_rows, n_corners = torch.unique(live).numel(), live.numel()
    del gs, ws, live
    f, d = table.shape[1], pts.shape[1]
    n_bytes = pts.numel() * 4 + got.numel() * 4 + n_rows * f * 4
    if kw.get("min_level_ids") is not None:
        n_bytes += n * 4
    if kw.get("occ_mask") is not None:
        n_bytes += n_rows        # at least one mask byte per distinct row read
    n_flops = n * n_out * (2 ** d) * (d + 2 * f + 1)
    b, by = bound_ms(n_bytes, n_flops)
    kernel = lambda: enc._encode_cuda(pts, table, res, offs, **kw)
    rec = dict(max_abs_err=err, ms=time_ms(kernel),
               device_ms=device_ms(kernel),
               plain_ms=time_ms(lambda: enc._encode_plain(pts, table, res, offs, **plain_kw),
                                iters=5 if kw else 20, warmup=1 if kw else 3),
               bound_ms=b, bound_by=by, library_ms=None)
    log(f"[{name} grid_encode {label}] N={n} L={n_out} D={d} rows={table.shape[0]}"
        f" live_corners={n_corners} distinct_rows={n_rows} err={err:.3g} (bit-equal)"
        f" ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f}"
        f" plain_ms={rec['plain_ms']:.4f} bound_ms={b:.4f}")
    return rec


def bound_ms_int(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_codec_kernels(torch, intctx, entropy, codec, ip, sign3, sign2, cache, pg3, pg2):
    """K9a, K9b, K9c and K7i against their twins on the card, torch.equal:
    one chunk of the last 3D context level (its middle chunk), the last 2D
    context level of the xy plane with its frac plane, and that plane (K7i)."""
    import numpy as np
    records, log_parts = {}, {}
    k = entropy.cfg.max_context_layer_num
    f = entropy.cfg.n_features
    per = {name: [] for name in ("int_encode", "int_mlp_pool", "int_pq", "pn_hist_int")}

    def same(name, label, got, want):
        got, want = (got if isinstance(got, tuple) else (got,)), \
            (want if isinstance(want, tuple) else (want,))
        for a, b in zip(got, want):
            if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                raise AssertionError(f"[{name}] {label}: the kernel differs from its twin")

    # ---- K7i on the xy plane (full coverage: every listed row)
    pn = cache["pn"]["xy"]
    args = (sign3, pn, entropy.fine_offset, entropy.pn_res, f)
    plane = intctx._frac_plane_cuda(*args)
    same("K7i", "xy", plane, intctx.int_frac_plane(*args))
    rows = pn["entry_idx"].shape[0]
    n_valid = int(torch.clamp(pn["n"], max=rows))
    sel = pn["entry_idx"][:n_valid]
    n_entries = torch.unique(sel).numel()
    bins = pn["bounds"].shape[0] - 1
    b, by = bound_ms_int(n_valid * 4 + n_entries * 4 * f + (bins + 1) * 4 + plane.numel() * 4,
                         n_valid * f * 2)
    bounds_l = pn["bounds"].long()
    bin_of_row = (torch.searchsorted(pn["bounds"], torch.arange(n_valid, device=sign3.device,
                                                                dtype=torch.int32), right=True)
                  - 1).clamp(0, bins - 1).long()
    ind = (sign3[entropy.fine_offset + sel.long()] > 0).to(torch.int32)
    library = lambda: torch.zeros(bins, f, dtype=torch.int32, device=sign3.device).index_add_(
        0, bin_of_row, ind)
    if not torch.equal(library(), torch.stack([
            torch.cumsum(torch.cat([ind.new_zeros(1, f), ind]), 0)[bounds_l[1:]][:, i]
            - torch.cumsum(torch.cat([ind.new_zeros(1, f), ind]), 0)[bounds_l[:-1]][:, i]
            for i in range(f)], -1)):
        raise AssertionError("[K7i] index_add_ of the sign rows differs from the twin's counts")
    records["pn_hist_int"] = dict(max_abs_err=0.0, ms=time_ms(lambda: intctx._frac_plane_cuda(
        *args)), plain_ms=time_ms(lambda: intctx.int_frac_plane(*args), iters=5, warmup=1),
        bound_ms=b, bound_by=by, library_ms=time_ms(library))
    log_parts["pn_hist_int"] = (f"rows={rows} listed={n_valid} distinct_entries={n_entries}"
                                f" bins={bins} plane={entropy.pn_res}^2")
    del ind, bin_of_row

    # ---- one 3D chunk and one 2D level through K9a -> K9b -> K9c
    l3 = entropy.ctx_levels_3d[-1]
    chunk_e, n_chunks, w3 = codec.chunks3d[l3]
    start = codec._chunk_bounds(l3)[n_chunks // 2][2]
    (pos,), valid, slots, evals = entropy._entry_window("3d", l3, start, chunk_e, w3,
                                                        ("pos_flat",))
    mask = cache["mask3d"][entropy.mask3d_offsets[l3] + pos.long()] & valid
    r3 = entropy.tables3d[l3].resolution
    lv3 = entropy._ctx_levels_meta(entropy.spec3, entropy.mask3d_offsets, l3 - k, l3)
    ovl = cache["ovl_int"][str(l3)]
    l2 = entropy.ctx_levels_2d[-1]
    t2 = entropy.tables2d[l2]
    (coords,), valid2, slots2, evals2 = entropy._entry_window("2d", l2, 0, t2.n_entries,
                                                              t2.n_points, ("coords",))
    mask2 = cache["mask2d"][0][entropy.mask2d_offsets[l2] + (coords >> 16).long() * t2.resolution
                               + (coords & 0xFFFF).long()] & valid2
    lv2 = entropy._ctx_levels_meta(entropy.spec2, entropy.mask2d_offsets,
                                   l2 - min(l2, k), l2)
    cases = {
        "3D": dict(enc=(pos, 3, r3, sign3, lv3, cache["mask3d"], None), level=None,
                   mlp=(pg3, codec.m_shift3[l3], mask, slots, chunk_e, ovl, pos),
                   pq=(codec.m_scale3[l3], sign3, entropy.tables3d[l3].offset, evals),
                   label=f"level {l3} chunk {n_chunks // 2} of {n_chunks}", sign=sign3),
        "2D": dict(enc=(coords, 2, t2.resolution, sign2, lv2, cache["mask2d"][0],
                        (plane, entropy.pn_res, entropy.pn_mask_offset)), level=l2,
                   mlp=(pg2, codec.m_shift2[l2], mask2, slots2, t2.n_entries, None, None),
                   pq=(codec.m_scale2[l2], sign2, t2.offset, evals2),
                   label=f"xy level {l2} with its plane", sign=sign2),
    }
    mlp_ops = lambda lv: sum(2 * ly["w"].shape[0] * ly["w"].shape[1] + ly["w"].shape[1] * 3
                             for ly in intctx._mlp_layers(ip, lv))
    for key, c in cases.items():
        # K9a
        feats = intctx._int_encode_cuda(*c["enc"])
        touched = {}
        want = intctx._int_encode_plain(*c["enc"], touched=touched)
        same("K9a", c["label"], feats, want)
        del want
        n_rows = c["enc"][0].shape[0]
        n_mask = torch.unique(torch.cat(touched["mask"])).numel()
        live = torch.cat(touched["rows"])
        n_tbl = torch.unique(live).numel()
        n_plane = torch.unique(torch.cat(touched["plane_rows"])).numel() \
            if "plane_rows" in touched else 0
        n_corners = sum(t.numel() for t in touched["mask"])
        del touched
        fa = c["sign"].shape[1]
        b, by = bound_ms_int(n_rows * 4 + n_mask + (n_tbl + n_plane) * 4 * fa + feats.numel() * 4,
                             n_rows * len(c["enc"][4]) * (2 ** c["enc"][1]) * 16
                             + live.numel() * 2 * fa)
        per["int_encode"].append(dict(
            max_abs_err=0.0, ms=time_ms(lambda: intctx._int_encode_cuda(*c["enc"])),
            plain_ms=time_ms(lambda: intctx._int_encode_plain(*c["enc"]), iters=3, warmup=1),
            bound_ms=b, bound_by=by, library_ms=None))
        log_parts.setdefault("int_encode", "")
        log_parts["int_encode"] += (f" {key} ({c['label']}): rows={n_rows} cols={feats.shape[1]}"
                                    f" corners={n_corners} live={live.numel()}"
                                    f" distinct_rows={n_tbl + n_plane} mask_bytes={n_mask};")
        del live
        # K9b
        mlp_args = (ip, c["level"], feats) + c["mlp"]
        got = intctx._int_mlp_pool_cuda(*mlp_args)
        same("K9b", c["label"], got, intctx._int_mlp_pool_plain(*mlp_args))
        kept = int(c["mlp"][2].sum())
        n_e = c["mlp"][4]
        pos_k = c["mlp"][6]
        n_ovl = torch.unique(pos_k[c["mlp"][2]]).numel() if pos_k is not None else 0
        b, by = bound_ms_int(n_rows + kept * (feats.shape[1] * 4 + 4 + (4 if pos_k is not None
                                                                         else 0))
                             + n_ovl * 4 + n_e * (fa + 1) * 4,
                             kept * (mlp_ops(c["level"]) + 4 * fa))
        per["int_mlp_pool"].append(dict(
            max_abs_err=0.0, ms=time_ms(lambda: intctx._int_mlp_pool_cuda(*mlp_args)),
            plain_ms=time_ms(lambda: intctx._int_mlp_pool_plain(*mlp_args), iters=3, warmup=1),
            bound_ms=b, bound_by=by, library_ms=None))
        log_parts.setdefault("int_mlp_pool", "")
        log_parts["int_mlp_pool"] += f" {key}: rows={n_rows} kept={kept} entries={n_e};"
        # K9c
        msum, wsum = got
        pq_args = (msum, wsum) + c["pq"]
        got_pq = intctx._int_pq_cuda(*pq_args)
        same("K9c", c["label"], got_pq, intctx._int_pq_plain(*pq_args))
        np.testing.assert_array_equal(got_pq[0].cpu().numpy(), intctx.host_pq(
            msum.cpu().numpy(), wsum.cpu().numpy(), c["pq"][0]))
        lib = lambda: intctx.pq_int64(msum, wsum, c["pq"][0])
        if not torch.equal(lib(), got_pq[0]):
            raise AssertionError("[K9c] the int64 formula differs from the kernel")
        b, by = bound_ms_int(n_e * (4 * fa + 4 + 4 + 4 * fa + 2 * fa + 1 + fa), n_e * fa * 8)
        per["int_pq"].append(dict(
            max_abs_err=0.0, ms=time_ms(lambda: intctx._int_pq_cuda(*pq_args)),
            plain_ms=time_ms(lambda: intctx._int_pq_plain(*pq_args)), bound_ms=b, bound_by=by,
            library_ms=time_ms(lib)))
        sat = int((got_pq[0] == 65535).sum())
        one = int((got_pq[0] == 1).sum())
        log_parts.setdefault("int_pq", "")
        log_parts["int_pq"] += (f" {key}: entries={n_e} covered={int(got_pq[1].sum())}"
                                f" pq at 65535: {sat}, at 1: {one};")
        del feats, got, got_pq, msum, wsum
    for name, recs in per.items():
        if recs:
            records[name] = dict(recs[0], other={k: recs[1][k] for k in ("ms", "plain_ms",
                                                                         "bound_ms")})
    for name, r in records.items():
        o = r.get("other")
        log(f"[{name}] exact; {log_parts[name].strip()} ms={r['ms']:.4f}"
            f" plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
            f" library_ms={r['library_ms']}"
            + (f"; 2D ms={o['ms']:.4f} plain_ms={o['plain_ms']:.4f}"
               f" bound_ms={o['bound_ms']:.4f}" if o else ""))
    return records


def covered_rows(torch, intctx, entropy, codec, ip, signs, cache, pgs):
    """Per table a bool over its rows: the entries the codec codes (every row
    of a globally coded level; a context level's covered entries)."""
    out = {}
    for key, sign in signs.items():
        spec = entropy.spec3 if key == "xyz" else entropy.spec2
        cov = torch.ones(spec.total_entries, dtype=torch.bool, device=sign.device)
        if key == "xyz":
            for l in entropy.ctx_levels_3d:
                t = entropy.tables3d[l]
                cov[t.offset:t.offset + spec.level_sizes[l]] = False
                pg_q = intctx.quantize_pg(pgs[f"3D{l}"])
                evals = entropy.table_arrays["3d"]["entry_values"][t.e_off:t.e_off + t.n_entries]
                for (lo, hi, st) in codec._chunk_bounds(l):
                    _, c, _ = codec._pool3d(l, ip, sign, cache, pg_q, st, with_bits=False)
                    rows = t.offset + evals[lo:hi].long()
                    cov[rows] = c[lo - st:hi - st]
        else:
            ai = ("xy", "xz", "yz").index(key)
            plane = codec._frac(signs["xyz"], cache, key)
            for l in entropy.ctx_levels_2d:
                t = entropy.tables2d[l]
                cov[t.offset:t.offset + spec.level_sizes[l]] = False
                _, c, _ = codec._pool2d(l, ip, sign, intctx.quantize_pg(pgs[f"{key}{l}"]), plane,
                                        cache["mask2d"][ai], with_bits=False)
                evals = entropy.table_arrays["2d"]["entry_values"][t.e_off:t.e_off + t.n_entries]
                cov[t.offset + evals.long()] = c
        out[key] = cov
    return out


def check_compact(torch, scatter_ops, n, cap, p, gen, dev):
    mask = torch.rand(n, generator=gen, device=dev) < p
    return check_compact_mask(torch, scatter_ops, mask, cap, f"random, p={p}")


def check_compact_mask(torch, scatter_ops, mask, cap, label):
    n = mask.numel()
    src, count = scatter_ops._compact_cuda(mask, cap)
    want_src, want_count = scatter_ops._compact_plain(mask, cap)
    torch.cuda.synchronize()
    if not (torch.equal(src, want_src) and int(count) == int(want_count)):
        raise AssertionError(f"K3 {label} n={n} cap={cap}: kernel and twin differ")
    n_bytes = n + cap * 4 + 4
    b, by = bound_ms(n_bytes, n)
    rec = dict(max_abs_err=0.0, ms=time_ms(lambda: scatter_ops._compact_cuda(mask, cap)),
               device_ms=device_ms(lambda: scatter_ops._compact_cuda(mask, cap)),
               plain_ms=time_ms(lambda: scatter_ops._compact_plain(mask, cap)),
               bound_ms=b, bound_by=by,
               library_ms=time_ms(lambda: torch.nonzero(mask)[:cap]))
    log(f"[K3 compact, {label}] n={n} cap={cap} count={int(count)} exact ms={rec['ms']:.4f}"
        f" device_ms={rec['device_ms']:.4f} plain_ms={rec['plain_ms']:.4f}"
        f" library_ms={rec['library_ms']:.4f} bound_ms={b:.5f}")
    return rec


def mean_args(torch, call) -> dict:
    """The bound arguments of one recorded segment_mean call, as its
    kernel's wrapper takes them."""
    from cnc_torch.ops import context_ops as cops
    import numpy as np
    a = inspect.signature(cops.segment_mean).bind(*call[0], **call[1])
    a.apply_defaults()
    a = a.arguments
    return dict(x=a["x"].detach().contiguous(), den=a["den"].contiguous(),
                seg=a["seg"].to(torch.int32).contiguous(), valid=a["valid"].contiguous(),
                num=a["num_segments"], min_den=float(np.float32(a["min_den"])),
                weighted=bool(a["weighted"]))


def check_segment_mean(torch, cops, calls, gen, dev) -> dict:
    """K6m against its twin at each pooling call site of one rate step (the
    3D context, the call with the most rows, and the 2D windows, the largest
    of them): pooled within K6_REL_TOL of max |pooled|, covered exact, two
    runs bit-equal, the backward within K6_REL_TOL of the twin's autograd,
    no order fault; ms, device ms, plain and library ms, bound and launches
    per step.  Returns the forward's and the backward's records, the 3D
    site's numbers on top and every site's under "sites"."""
    biggest = max(calls["segment_mean"], key=lambda c: c[0][0].shape[0])
    sites = {"3D context": [biggest],
             "2D window": [c for c in calls["segment_mean"] if c is not biggest]}
    fwd, bwd = {}, {}
    for label, site_calls in sites.items():
        if not site_calls:
            continue
        a = mean_args(torch, max(site_calls, key=lambda c: c[0][0].shape[0]))
        x, den, seg, valid, num = a["x"], a["den"], a["seg"], a["valid"], a["num"]
        opts = (a["min_den"], a["weighted"])
        kernel = lambda: cops._segment_mean_cuda(x, den, seg, valid, num, *opts)
        plain = lambda: cops._segment_mean_plain(x, den, seg, valid, num, *opts)
        (got, cov, den_sum), (want, want_cov) = kernel(), plain()
        again = kernel()
        err = rel_err(got, want)
        if not (err <= K6_REL_TOL and torch.equal(cov, want_cov)):
            raise AssertionError(f"[K6m {label}] rel err {err} > {K6_REL_TOL} or covered differs")
        if not (torch.equal(again[0], got) and torch.equal(again[1], cov)):
            raise AssertionError(f"[K6m {label}] two runs differ")
        cot = torch.randn(num, x.shape[1], generator=gen, device=dev)
        leaf = x.clone().requires_grad_()
        (want_dx,) = torch.autograd.grad(
            cops._segment_mean_plain(leaf, den, seg, valid, num, *opts)[0], leaf, cot)
        bwd_kernel = lambda: cops._segment_mean_backward_cuda(cot, den, seg, valid, den_sum,
                                                              *opts)
        got_dx = bwd_kernel()
        bwd_err = rel_err(got_dx, want_dx)
        if not bwd_err <= K6_REL_TOL:
            raise AssertionError(f"[K6m {label}] backward rel err {bwd_err} > {K6_REL_TOL}")
        n, f = x.shape
        n_live = int(cops._live_rows(seg, valid, num).sum())
        # the library yardstick: both sums in one index_add_ (no divide)
        seg_safe = torch.where(valid, seg.long(), num).clamp(max=num)
        rows = torch.cat([x * den[:, None] if opts[1] else x, den[:, None]], dim=1)
        library = lambda: torch.zeros(num + 1, f + 1, device=dev).index_add_(0, seg_safe, rows)
        b, by = bound_ms(n * (4 * f + 9) + num * (4 * f + 5),
                         n_live * (2 * f + 1) + num * f)
        fwd[label] = dict(max_abs_err=float((got - want).abs().max()), rel_err=err,
                          ms=time_ms(kernel), device_ms=device_ms(kernel),
                          plain_ms=time_ms(plain), bound_ms=b, bound_by=by,
                          library_ms=time_ms(library), launches_per_step=len(site_calls),
                          rows=n, live_rows=n_live, segments=num, features=f,
                          weighted=opts[1])
        bb, bby = bound_ms(n * (4 * f + 9) + num * (4 * f + 4), n_live * 2 * f)
        bwd_plain = lambda: torch.autograd.grad(
            cops._segment_mean_plain(leaf, den, seg, valid, num, *opts)[0], leaf, cot)
        gather = lambda: torch.index_select(cot, 0, seg.long().clamp(0, num - 1))
        bwd[label] = dict(max_abs_err=float((got_dx - want_dx).abs().max()), rel_err=bwd_err,
                          ms=time_ms(bwd_kernel), device_ms=device_ms(bwd_kernel),
                          plain_ms=time_ms(bwd_plain), bound_ms=bb, bound_by=bby,
                          library_ms=time_ms(gather), launches_per_step=len(site_calls))
        r, rb = fwd[label], bwd[label]
        log(f"[K6m segment_mean, {label}] rows={n} live={n_live} F={f} segments={num}"
            f" weighted={opts[1]} ({len(site_calls)} calls in the step) rel_err {err:.3g}"
            f" (limit {K6_REL_TOL}) covered exact, two runs bit-equal; ms={r['ms']:.4f}"
            f" device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f}"
            f" library_ms={r['library_ms']:.4f} bound_ms={b:.4f}; backward rel_err"
            f" {bwd_err:.3g} ms={rb['ms']:.4f} device_ms={rb['device_ms']:.4f}"
            f" bound_ms={bb:.4f}")
        del leaf
    check_order_faults(cops, dev, "[K6m]")
    first = "3D context"
    return {"segment_mean": dict(fwd[first], max_abs_err=max(v["max_abs_err"]
                                                             for v in fwd.values()),
                                 sites=fwd),
            "segment_mean_bwd": dict(bwd[first], max_abs_err=max(v["max_abs_err"]
                                                                 for v in bwd.values()),
                                     sites=bwd)}


def check_order_faults(cops, dev, where: str) -> None:
    """The word K6m sets when live ids decrease must be clear."""
    if cops.segment_order_faults(dev):
        raise AssertionError(f"{where} a segment_mean launch met live ids that decrease")
    log(f"{where} segment_mean's order-fault word is clear")


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


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def check_probe(torch, kernels, scatter_ops, dev):
    """The two probe kernels at the probe's shapes and data (numpy seed 0, as
    tools/pallas_probe.py draws them).  Each is driven once through its public
    wrapper with the counts at 0, and that output is held against the twin's.
    Returns (records, launch counts of the drive)."""
    import numpy as np
    t, n = 1 << PROBE_LOG2_TABLE, PROBE_N
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, t, n, dtype=np.int32)).to(dev)
    tbl_t = torch.from_numpy(np.ascontiguousarray(
        rng.standard_normal((t, 8), np.float32).T)).to(dev)            # [8, T]
    vals = torch.from_numpy(np.ascontiguousarray(
        rng.standard_normal((8, n), np.float32).T)).to(dev)            # [N, 8]
    torch.cuda.synchronize()
    kernels.reset_launches()
    gathered = scatter_ops.lane_gather(tbl_t, idx)
    summed = scatter_ops.scatter_add(vals, idx, t)
    torch.cuda.synchronize()
    counts = {k: kernels.launches[k] for k in ("lane_gather", "scatter_add")}

    want = scatter_ops._lane_gather_plain(tbl_t, idx)
    if not torch.equal(gathered, want):
        raise AssertionError("[probe] lane_gather differs from its twin")
    rows = torch.unique(idx).numel()
    b, by = bound_ms(n * 4 + 8 * n * 4 + rows * 8 * 4, 0)
    recs = {"lane_gather": dict(
        max_abs_err=0.0, ms=time_ms(lambda: scatter_ops._lane_gather_cuda(tbl_t, idx), iters=10),
        plain_ms=time_ms(lambda: scatter_ops._lane_gather_plain(tbl_t, idx), iters=10),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: torch.index_select(tbl_t, 1, idx), iters=10))}
    del gathered, want

    want = scatter_ops._scatter_add_plain(vals, idx, t)
    err = rel_err(summed, want)
    if not err <= SCATTER_REL_TOL:
        raise AssertionError(f"[probe] scatter_add: rel err {err} > {SCATTER_REL_TOL}")
    # every update adds 8 floats; the table is written once
    b, by = bound_ms(n * 4 + 8 * n * 4 + t * 8 * 4, 8 * n)
    idx64 = idx.long()
    recs["scatter_add"] = dict(
        max_abs_err=float((summed - want).abs().max()),
        ms=time_ms(lambda: scatter_ops._scatter_add_cuda(vals, idx, t), iters=10),
        plain_ms=time_ms(lambda: scatter_ops._scatter_add_plain(vals, idx, t), iters=10),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: torch.zeros(t, 8, device=dev).index_add_(0, idx64, vals),
                           iters=10))
    for name, r in recs.items():
        log(f"[probe {name}] table [8, {t}] idx {n} distinct {rows} launches {counts[name]}"
            f" max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f}"
            f" library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f}")
    return recs, counts


def check_grid_encode_bwd(torch, enc, spec, table, pts, gen, label, name="K2", **kw):
    """K2 against its twin (autograd of `_encode_plain`) on one table at a
    training march's sample points; `kw` are the masked / mixed-level
    arguments of the variant (K2v).  Returns the kernel record fields."""
    n, f, rows = pts.shape[0], table.shape[1], table.shape[0]
    res, offs = spec.resolutions, spec.offsets
    n_out, d = kw.get("n_levels_calc") or len(res), pts.shape[1]
    cot = torch.randn(n, n_out * f, generator=gen, device=pts.device)
    got = enc._encode_backward_cuda(pts, cot, rows, res, offs, **kw)
    plain_kw = {k: v for k, v in kw.items() if k != "occ_bits"}   # the twin reads the bools
    leaf = table.detach().clone().requires_grad_()
    out = enc._encode_plain(pts, leaf, res, offs, **plain_kw)
    twin = lambda: torch.autograd.grad(out, leaf, cot, retain_graph=True)[0]
    want = twin()
    torch.cuda.synchronize()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if not (got.isfinite().all() and err <= K2_REL_TOL * scale):
        raise AssertionError(f"[{name}] {label}: max abs err {err} > {K2_REL_TOL} * {scale}")
    plain_ms = time_ms(twin, iters=5, warmup=1)
    del out, leaf
    # the updates the function makes: (row, g*w/wn) per surviving corner, as
    # one index_add_ would take them (the library yardstick), and the
    # distinct rows they touch (read-modify-write in the bound)
    gs, ws = enc._corner_sets(pts, res, offs, **plain_kw)
    vs = []
    oob = ((pts < 0.0) | (pts > 1.0)).any(dim=-1)
    for li, wi in enumerate(ws):
        wn = wi.sum(dim=-1, keepdim=True)
        wi = torch.where(oob[:, None], 0.0, wi / torch.where(wn == 0.0, 1e-9, wn))
        vs.append(wi[..., None] * cot[:, None, li * f:(li + 1) * f])
    del ws
    gidx = torch.cat(gs, dim=1).reshape(-1)
    vals = torch.cat(vs, dim=1).reshape(-1, f)
    del gs, vs
    live = (vals != 0).any(dim=-1)
    n_updates = int(live.sum())
    touched, per_row = torch.unique(gidx[live], return_counts=True)
    n_rows, worst = touched.numel(), int(per_row.max())
    del live, touched, per_row
    library = lambda: torch.zeros(rows, f, device=pts.device).index_add_(0, gidx, vals)
    lib_err = rel_err(library(), want)
    n_bytes = pts.numel() * 4 + cot.numel() * 4 + 2 * n_rows * f * 4
    n_flops = n * n_out * (2 ** d) * (d + 2 * f + 1)
    b, by = bound_ms(n_bytes, n_flops)
    kernel = lambda: enc._encode_backward_cuda(pts, cot, rows, res, offs, **kw)
    rec = dict(max_abs_err=err, rel_err=err / scale, ms=time_ms(kernel, iters=10),
               device_ms=device_ms(kernel),
               plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=time_ms(library, iters=5, warmup=1))
    log(f"[{name} grid_encode_bwd {label}] N={n} L={n_out} D={d} rows={rows}"
        f" updates={n_updates} distinct_rows={n_rows} most_updates_on_one_row={worst}"
        f" rel_err={err / scale:.3g}"
        f" (limit {K2_REL_TOL}; index_add_ against the twin {lib_err:.3g}) ms={rec['ms']:.4f}"
        f" device_ms={rec['device_ms']:.4f} plain_ms={rec['plain_ms']:.4f}"
        f" library_ms={rec['library_ms']:.4f} bound_ms={b:.4f}")
    return rec


def check_volrend_bwd(torch, volrend, smp, n_rays, rcfg, gen, label):
    """K5b against its twin (autograd of `_composite_plain`) on one sample
    buffer; returns the kernel record fields."""
    dev = smp.ray_id.device
    n = smp.ray_id.shape[0]
    sig = torch.empty(n, device=dev).exponential_(1 / 40.0, generator=gen)
    rgb = torch.rand(n, 3, generator=gen, device=dev)
    cots = (torch.randn(n_rays, 3, generator=gen, device=dev),
            torch.randn(n_rays, generator=gen, device=dev),
            torch.randn(n_rays, generator=gen, device=dev))
    args = (smp, n_rays, rcfg.early_stop_eps, None, rcfg.alpha_thre)
    kernel = lambda: volrend._composite_backward_cuda(rgb, sig, *args, *cots)
    r_leaf, s_leaf = rgb.clone().requires_grad_(), sig.clone().requires_grad_()
    outs = volrend._composite_plain(r_leaf, s_leaf, *args)[:3]
    twin = lambda: torch.autograd.grad(outs, (r_leaf, s_leaf), cots, retain_graph=True)
    got, want = kernel(), twin()
    torch.cuda.synchronize()
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    if not max(errs) <= K5B_REL_TOL:
        raise AssertionError(f"[K5b] {label}: rel err {errs} > {K5B_REL_TOL}")
    n_valid = int(smp.valid.sum())
    # bytes: each valid sample read once, its gradients written once; each
    # ray's output gradients read once
    n_bytes = n_valid * (4 + 12 + 4 + 1 + 4 + 16) + n_rays * 20
    b, by = bound_ms(n_bytes, n_valid * 40)
    rec = dict(max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
               ms=time_ms(kernel), plain_ms=time_ms(twin, iters=10), bound_ms=b, bound_by=by,
               library_ms=None)
    log(f"[K5b volrend_bwd {label}] slots={n} valid={n_valid} rays={n_rays}"
        f" rel_err d_rgbs={errs[0]:.3g} d_sigmas={errs[1]:.3g} (limit {K5B_REL_TOL})"
        f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} bound_ms={b:.5f}")
    return rec


def check_training_kernels(torch, tr, enc, marching, volrend, rf, gen):
    """K4 with jitter, K2 and K5b against their twins at one real training
    march: the trainer's current ray bucket, occupancy grid and tables."""
    from cnc_torch.train.trainer import _next_bucket
    cfg, dev = tr.cfg, tr.device
    bucket = _next_bucket(tr.num_rays, cfg.train.min_ray_bucket, cfg.train.max_ray_bucket)
    rays, _ = tr.dataset.fetch_rays(gen, bucket)
    o, d = rays.origins.contiguous(), rays.viewdirs.contiguous()
    binaries, cap = tr.occ_state.binaries, cfg.render.sample_capacity
    mip = marching.build_march_mip(binaries)
    u = torch.rand(bucket, generator=gen, device=dev)
    half = torch.rand(bucket, generator=gen, device=dev) < 0.5
    records = {}
    with torch.no_grad():
        got = marching._march_cuda(o, d, binaries, tr.aabb, cfg.render, cap, None, None, None,
                                   mip, u)
        want = marching._march_plain(o, d, binaries, tr.aabb, cfg.render, cap, None, None, None,
                                     mip, u)
        padded = marching._march_cuda(o, d, binaries, tr.aabb, cfg.render, cap, half, None, None,
                                      mip, u)
        padded_want = marching._march_plain(o, d, binaries, tr.aabb, cfg.render, cap, half, None,
                                            None, mip, u)
        again = marching._march_cuda(o, d, binaries, tr.aabb, cfg.render, cap, None, None, None,
                                     mip, u)
        torch.cuda.synchronize()
        for x, y, what in ((got, want, "full"), (padded, padded_want, "half the rays"),
                           (again, got, "a second run")):
            for name in MARCH_FIELDS:
                a, b = getattr(x, name), getattr(y, name)
                if not torch.equal(a.to(b.dtype), b):
                    raise AssertionError(f"K4 with jitter ({what}): {name} differs")
        n_valid = int(got.valid.sum())
        march = lambda: marching._march_cuda(o, d, binaries, tr.aabb, cfg.render, cap, None, None,
                                             None, mip, u)
        records["march_train"] = dict(
            ms=time_ms(march), device_ms=device_ms(march),
            plain_ms=time_ms(lambda: marching._march_plain(o, d, binaries, tr.aabb, cfg.render,
                                                           cap, None, None, None, mip, u)),
            rays=bucket, capacity=cap, samples=n_valid, truncated=bool(got.truncated))
        r = records["march_train"]
        log(f"[K4 march, jittered] rays={bucket} capacity={cap} samples={n_valid}"
            f" truncated={bool(got.truncated)} resume_ray={int(got.resume_ray)}: every field,"
            f" the per-ray outputs and the padding exact against the twin (also with half the"
            f" rays masked), two runs equal; ms={r['ms']:.4f} device_ms={r['device_ms']:.4f}"
            f" plain_ms={r['plain_ms']:.4f}")
        if n_valid < cap // 2:
            raise AssertionError(f"[train] the march filled only {n_valid} of {cap} slots")
        pos, _ = marching.sample_positions(got, o, d)
        x01 = ((pos - tr.aabb[:3]) / (tr.aabb[3:] - tr.aabb[:3])).contiguous()
        tables = rf.quantized_tables(tr.field, cfg.model)
        # K1 at the training march's points too (the step's forward)
        records["grid_encode_train"] = check_grid_encode(
            torch, enc, cfg.model.grid_3d, tables["xyz"], x01, "xyz, training march",
            perturb=False)
    k2_xyz = check_grid_encode_bwd(torch, enc, cfg.model.grid_3d, tables["xyz"], x01, gen, "xyz")
    k2_xy = check_grid_encode_bwd(torch, enc, cfg.model.grid_2d, tables["xy"],
                                  x01[:, [0, 1]].contiguous(), gen, "xy")
    records["grid_encode_bwd"] = dict(k2_xyz, max_abs_err=max(k2_xyz["max_abs_err"],
                                                               k2_xy["max_abs_err"]),
                                      sites={"xyz": k2_xyz, "xy": k2_xy})
    k5b = {label: check_volrend_bwd(torch, volrend, smp, bucket, cfg.render, gen, label)
           for label, smp in (("full", got), ("padded", padded))}
    records["volrend_bwd"] = dict(k5b["full"], max_abs_err=max(v["max_abs_err"]
                                                               for v in k5b.values()))
    return records


def check_vertex_tables(torch, cops, entropy, dev):
    """K10 against its twins, exactly, on the hashed 108^3 level and on one
    2D level (keys, then the fill over the kernel's sorted keys), and on the
    dense 80^3 level; then the kernels and the twins timed on the finest
    level (514^3), the largest the build runs."""
    plans = {(p["kind"], p["r"]): p for p in entropy._level_plans()}
    p3, p2 = plans[("3d", 108)], [p for p in plans.values() if p["kind"] == "2d"][0]
    import numpy as np
    from cnc_torch.utils import threefry
    for p in (p3, p2):
        d, tile = (3, 0) if p["kind"] == "3d" else (2, p["tile"])
        perm = inv = None
        if d == 2:
            perm_np = threefry.permutation(4321 + p["level"], p["tbl"])
            inv_np = np.empty_like(perm_np)
            inv_np[perm_np] = np.arange(p["tbl"])
            perm, inv = (torch.from_numpy(a.astype(np.int32)) for a in (perm_np, inv_np))
        on = lambda t: None if t is None else t.to(dev)
        keys = cops.vertex_keys(p["v"], d, p["r"], p["tbl"], dev, tile, entropy.rb, on(perm))
        want = cops._vertex_keys_plain(p["v"], d, p["r"], p["tbl"], tile, entropy.rb, on(perm), dev)
        if not torch.equal(keys, want):
            raise AssertionError(f"[K10] keys differ from the twin on {p['kind']} r={p['r']}")
        skey, loc = torch.sort(keys, stable=True)
        got = cops.entry_fill(skey, loc, p["e_max"], d, tile, entropy.rb, on(inv))
        twin = cops._entry_fill_plain(skey, loc, p["e_max"], d, tile, entropy.rb, on(inv))
        for k, v in twin.items():
            if not torch.equal(got[k].reshape(-1), v.reshape(-1)):
                raise AssertionError(f"[K10] {k} differs from the twin on {p['kind']} r={p['r']}")
        log(f"[K10] {p['kind']} level {p['level']} (r={p['r']}, {p['v']} vertices,"
            f" {int(got['n_entries'])} entries): keys and tables exact against the twins")
    pd = plans[("3d", 80)]
    perm = torch.from_numpy(threefry.permutation(1234 + pd["level"], pd["v"]).astype(np.int32))
    got, twin = cops.dense_level(perm.to(dev), pd["r"]), cops._dense_level_plain(perm, pd["r"])
    for k, v in twin.items():
        if not torch.equal(got[k].cpu(), v):
            raise AssertionError(f"[K10] dense level: {k} differs from the twin")
    del got, twin
    # timing at the finest level: keys, and the fill over sorted keys
    pf = plans[("3d", entropy.fine_res)]
    v, r, tbl, e_max = pf["v"], pf["r"], pf["tbl"], pf["e_max"]
    skey, loc = torch.sort(cops.vertex_keys(v, 3, r, tbl, dev), stable=True)
    kernel = lambda: (cops.vertex_keys(v, 3, r, tbl, dev), cops.entry_fill(skey, loc, e_max, 3))
    plain = lambda: (cops._vertex_keys_plain(v, 3, r, tbl, 0, 0, None, dev),
                     cops._entry_fill_plain(skey, loc, e_max, 3, 0, 0, None))
    sort_ms = time_ms(lambda: torch.sort(skey, stable=True), iters=2, warmup=1)
    # bytes: keys written; sorted keys and indices read; ordinals, vertex
    # ids and the two per-entry arrays written
    b, by = bound_ms(4 * v + 12 * v + 8 * v + 8 * e_max, 20 * v)
    rec = dict(max_abs_err=0.0, ms=time_ms(kernel, iters=3, warmup=1),
               plain_ms=time_ms(plain, iters=2, warmup=1), bound_ms=b, bound_by=by,
               library_ms=None)
    log(f"[K10 vertex_tables] finest level r={r}, {v} vertices: keys + fill ms={rec['ms']:.3f}"
        f" plain_ms={rec['plain_ms']:.3f} bound_ms={b:.3f}; the stable sort between them"
        f" (torch.sort) {sort_ms:.3f} ms")
    return rec


def overlap_float64(torch, cops, occ, resolution):
    """K8's overlap volume summed in float64: per axis a cumulative sum of the
    occupancy, read at the corner's continuous bounds and differenced, as the
    twin does it in float32.  The yardstick for how far float32 rounding
    moves the twin and the kernel."""
    bd = cops.footprint_bounds(resolution, occ.shape[0])
    o = occ.double()
    for _ in range(occ.dim()):
        s = torch.cumsum(o, dim=0)
        s = torch.cat([torch.zeros_like(s[:1]), s], dim=0)

        def lerp(i0, fr):
            i0 = torch.from_numpy(i0).long().to(occ.device)
            fr = torch.from_numpy(fr).double().to(occ.device).reshape((-1,) + (1,) * (o.dim() - 1))
            return s[i0] * (1.0 - fr) + s[i0 + 1] * fr

        o = torch.movedim(lerp(bd.b_i, bd.b_fr) - lerp(bd.a_i, bd.a_fr), 0, -1)
    return o.reshape(-1).float()


def check_footprint(torch, cops, entropy, binaries):
    """K8 against its twin: the mask exactly and the overlap within
    K8_REL_TOL of the level's largest value against the twin summed in
    float64 (K8_F32_TOL against the float32 twin, whose differences of
    cumulative sums round more coarsely than the kernel's cell-by-cell sum),
    on 3D levels 3 and 7, the finest 3D level and the 1026^2 plane level; the
    finest level is the one timed."""
    spec3, spec2 = entropy.spec3, entropy.spec2
    worst = 0.0
    for l in (3, 7, spec3.n_levels - 1):
        r = spec3.resolutions[l]
        mask, ovl = cops._footprint_cuda(binaries, r, True)
        want_mask, want_ovl = cops._footprint_plain(binaries, r, True)
        exact = overlap_float64(torch, cops, binaries, r)
        torch.cuda.synchronize()
        if not torch.equal(mask, want_mask):
            raise AssertionError(f"[K8] level {l}: the mask differs from the twin")
        err, err32, twin_err = rel_err(ovl, exact), rel_err(ovl, want_ovl), \
            rel_err(want_ovl, exact)
        worst = max(worst, float((ovl - want_ovl).abs().max()))
        wgt = lambda o: torch.clamp(torch.floor(o * 1000.0), min=1.0)
        share = float((wgt(ovl) != wgt(want_ovl))[want_mask].float().mean())
        log(f"[K8 footprint] 3D level {l} (r={r}): mask exact ({int(mask.sum())} of {mask.numel()}"
            f" corners set), ovl max {float(want_ovl.max()):.4f}; rel err against the twin in"
            f" float64 {err:.3g} (limit {K8_REL_TOL}), against the twin in float32 {err32:.3g}"
            f" (limit {K8_F32_TOL}; that twin against its float64 self {twin_err:.3g});"
            f" floor(ovl*1000) differs from the float32 twin's on {100 * share:.4f}% of the"
            f" masked corners")
        if not (err <= K8_REL_TOL and err32 <= K8_F32_TOL):
            raise AssertionError(f"[K8] level {l}: ovl rel err {err} > {K8_REL_TOL} or"
                                 f" {err32} > {K8_F32_TOL}")
        del mask, ovl, want_mask, want_ovl, exact
    bin2d = binaries.any(dim=2)
    r2 = spec2.resolutions[-1]
    if not torch.equal(cops._footprint_cuda(bin2d, r2, False)[0],
                       cops._footprint_plain(bin2d, r2, False)[0]):
        raise AssertionError("[K8] the 2D mask differs from the twin")
    log(f"[K8 footprint] 2D level r={r2}: mask exact against the twin")
    r = spec3.resolutions[-1]
    n = r ** 3
    # bytes: the occupancy read once, one bool and one float written per
    # corner; operations: per occupied cell of each corner's box one
    # multiply-add per axis (counted from the overlap itself: about 10 per cell)
    lo, hi = (torch.from_numpy(a).long() for a in cops.footprint_bounds(r, entropy.rb)[:2])
    cells = float((hi - lo + 1).sum()) ** 3
    b, by = bound_ms(binaries.numel() + 5 * n, 10 * cells)
    rec = dict(max_abs_err=worst, ms=time_ms(lambda: cops._footprint_cuda(binaries, r, True),
                                              iters=5, warmup=1),
               plain_ms=time_ms(lambda: cops._footprint_plain(binaries, r, True), iters=3,
                                warmup=1), bound_ms=b, bound_by=by, library_ms=None)
    log(f"[K8 footprint] finest level r={r}: {n} corners, {cells:.0f} cells walked,"
        f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} bound_ms={b:.4f} ({by})")
    return rec


def capture_rate_calls(torch, tr, rf, cops, enc):
    """The arguments one real rate step gives the rate kernels (the pooled
    means, the level-probability gather, the sign histograms, the encodes and
    the compactions): the wrappers
    are swapped for recorders while one rate estimate runs on the trainer's
    current tables, cache and freshly drawn windows.  The tables are made
    with their gradient, as a step makes them, so a recorded encode's table
    requires one where the step's backward runs K2v on it."""
    from cnc_torch.ops import scatter_ops
    calls = {"segment_mean": [], "segment_gather": [], "pn_hist": [], "encode": [],
             "compact": []}
    originals = (cops.segment_mean, cops.segment_gather, cops.pn_hist, enc._encode,
                 scatter_ops.compact_mask_indices)

    def recorder(key, fn):
        def wrapped(*args, **kw):
            calls[key].append((args, kw))
            return fn(*args, **kw)
        return wrapped

    cops.segment_mean = recorder("segment_mean", originals[0])
    cops.segment_gather = recorder("segment_gather", originals[1])
    cops.pn_hist = recorder("pn_hist", originals[2])
    enc._encode = recorder("encode", originals[3])
    scatter_ops.compact_mask_indices = recorder("compact", originals[4])
    try:
        tables = rf.quantized_tables(tr.field, tr.cfg.model)
        with torch.no_grad():
            starts = tr.entropy.draw_starts(tr.generator)
            tr.entropy.rate_estimate(tr.ent_params, tables, starts, tr._last_ent_cache)
    finally:
        (cops.segment_mean, cops.segment_gather, cops.pn_hist, enc._encode,
         scatter_ops.compact_mask_indices) = originals
    return calls


ENCODE_SITES = ("3D mixed levels", "2D window", "frac plane")


def encode_sites(tr, enc, calls):
    """The encode calls one rate step made (`capture_rate_calls`), each as
    its bound arguments, by call site: the mixed-level 3D context encode, the
    masked plane windows (three axes by the 2D context levels) and the
    frac-plane lookups (one dense level over a [pn_res^2, F] table).  A
    site's K1v launches per step are its calls, its K2v launches the calls
    whose table takes a gradient."""
    sig = inspect.signature(enc._encode)
    sites = {label: [] for label in ENCODE_SITES}
    for args, kw in calls["encode"]:
        a = sig.bind(*args, **kw)
        a.apply_defaults()
        a = a.arguments
        given = len(a["resolutions"]) == 1 and a["table"].shape[0] == tr.entropy.pn_res ** 2
        label = (ENCODE_SITES[0] if a["min_level_ids"] is not None
                 else ENCODE_SITES[2] if given else ENCODE_SITES[1])
        sites[label].append(a)
    return sites


def encode_args(torch, a):
    """(points, table, levels, kw) of one recorded encode call, as the
    wrappers and the twin take them."""
    kw = dict(occ_mask=a["occ_mask"].contiguous(),
              mask_offsets=tuple(int(m) for m in a["mask_offsets"]), occ_bits=a["occ_bits"])
    if a["min_level_ids"] is not None:
        kw.update(min_level_ids=a["min_level_ids"].to(torch.int32).contiguous(),
                  n_levels_calc=a["n_levels_calc"])
    levels = types.SimpleNamespace(resolutions=tuple(a["resolutions"]),
                                   offsets=tuple(a["offsets"]))
    return a["points"].detach().contiguous(), a["table"].detach().contiguous(), levels, kw


def check_rate_kernels(torch, tr, rf, cops, enc, gen):
    """K6, K6m, K3, K7, K1v and K2v against their twins at the shapes of one
    real rate step of the trainer."""
    from cnc_torch.ops import scatter_ops
    calls = capture_rate_calls(torch, tr, rf, cops, enc)
    dev = tr.device
    records = {}

    # ---- K6: segment_gather at the 3D context, its only call (each row's
    # level probability, [2^21] rows from [n_levels] values): the forward is
    # K6's gather kernel (record segment_pool_bwd), the backward K6's per-run
    # sums into the level segments (record segment_pool)
    (values, clev, gvalid), _ = calls["segment_gather"][0]
    values = values.detach().contiguous()
    seg, valid = clev.to(torch.int32).contiguous(), gvalid.contiguous()
    num, n = values.shape[0], seg.shape[0]
    gather = lambda: cops._segment_pool_backward_cuda(values, seg, valid)
    if not torch.equal(gather(), cops._segment_gather_plain(values, seg, valid)):
        raise AssertionError("[K6 gather] the gather kernel differs from its twin")
    # the sums are held against the twin summed in float64: in float32 the
    # twin's index_add_ adds a level's ~10^6 rows one at a time onto one word
    # and lands further off itself (logged beside the kernel's error)
    cot = torch.randn(n, generator=gen, device=dev)
    sums = lambda: cops._segment_pool_cuda(cot, seg, valid, num)
    sums_plain = lambda: cops._segment_pool_plain(cot, seg, valid, num)
    got, want = sums(), cops._segment_pool_plain(cot.double(), seg, valid, num)
    err, twin_err = rel_err(got.double(), want), rel_err(sums_plain().double(), want)
    if not err <= K6_REL_TOL:
        raise AssertionError(f"[K6] rel err {err} > {K6_REL_TOL}")
    live = cops._live_rows(seg, valid, num)
    n_live = int(live.sum())
    safe = torch.where(live, seg.long(), 0)
    cot_live = torch.where(live, cot, 0.0)
    # both read seg and valid (5 B a row); the gather writes 4 B a row and
    # reads the values, the sums read 4 B a row and add each live one
    b, by = bound_ms(n * 9 + num * 4, 0)
    records["segment_pool_bwd"] = dict(
        max_abs_err=0.0, ms=time_ms(gather), device_ms=device_ms(gather),
        plain_ms=time_ms(lambda: cops._segment_gather_plain(values, seg, valid)),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: torch.index_select(values, 0, safe)),
        launches_per_step=len(calls["segment_gather"]), rows=n, segments=num)
    bb, bby = bound_ms(n * 9 + num * 4, n_live)
    records["segment_pool"] = dict(
        max_abs_err=float((got.double() - want).abs().max()), rel_err=err, ms=time_ms(sums),
        device_ms=device_ms(sums), plain_ms=time_ms(sums_plain), bound_ms=bb, bound_by=bby,
        library_ms=time_ms(lambda: torch.zeros(num, device=dev).index_add_(0, safe, cot_live)),
        launches_per_step=len(calls["segment_gather"]), rows=n, segments=num)
    r, rg = records["segment_pool"], records["segment_pool_bwd"]
    runs = int((seg[1:] != seg[:-1]).sum()) + 1
    log(f"[K6 segment_gather, 3D context] rows={n} live={n_live} segments={num} runs={runs}"
        f" ({len(calls['segment_gather'])} call in the step); gather exact ms={rg['ms']:.4f}"
        f" device_ms={rg['device_ms']:.4f} plain_ms={rg['plain_ms']:.4f}"
        f" library_ms={rg['library_ms']:.4f} bound_ms={b:.4f}; its backward (K6) rel_err"
        f" {err:.3g} against float64 (limit {K6_REL_TOL}; the float32 twin's {twin_err:.3g})"
        f" ms={r['ms']:.4f} device_ms={r['device_ms']:.4f}"
        f" plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} bound_ms={bb:.4f}")
    records.update(check_segment_mean(torch, cops, calls, gen, dev))

    # ---- K3 at the 3D context compaction of the step (its largest mask)
    mask, cap = max(calls["compact"], key=lambda c: c[0][0].numel())[0]
    records["compact"] = check_compact_mask(torch, scatter_ops, mask.contiguous(), cap,
                                            "3D context")

    # ---- K7: one plane's sign histogram
    table, fine_offset, sel, row_valid, bnd = calls["pn_hist"][0][0]
    table, sel = table.contiguous(), sel.to(torch.int32).contiguous()
    bnd = bnd.to(torch.int32).contiguous()
    got = cops._pn_hist_cuda(table, fine_offset, sel, row_valid, bnd)
    want = cops._pn_hist_plain(table, fine_offset, sel, row_valid, bnd)
    if not torch.equal(got, want):
        raise AssertionError("[K7] the histogram differs from the twin")
    f, bins, rows = table.shape[1], bnd.shape[0] - 1, sel.shape[0]
    n_valid = int(row_valid.sum())
    n_entries = torch.unique(sel[row_valid]).numel()
    bin_of_row = (torch.searchsorted(bnd, torch.arange(rows, device=dev, dtype=torch.int32),
                                     right=True) - 1).clamp(0, bins - 1).long()
    ind = torch.where(row_valid[:, None], (table[fine_offset + sel.long()] > 0.9).float(), 0.0)
    library = lambda: torch.zeros(bins, f, device=dev).index_add_(0, bin_of_row, ind)
    if not torch.equal(library(), want):
        raise AssertionError("[K7] index_add_ of the indicator rows differs from the twin")
    b, by = bound_ms(rows * 5 + n_entries * 4 * f + (bins + 1) * 4 + bins * 4 * f, n_valid * f)
    # the backward kernel (taken with pn_frac_grad) against the twin's
    # autograd.  That differences reverse cumulative sums over all rows, which
    # float32 rounds at 1e-3 of the result, so the kernel is held to the twin
    # run in float64 and the float32 twin's own distance is printed
    cot = torch.randn(bins, f, generator=gen, device=dev)
    leaf = table.clone().requires_grad_()
    (want_dt,) = torch.autograd.grad(cops._pn_hist_plain(leaf, fine_offset, sel, row_valid, bnd),
                                     leaf, cot)
    leaf64 = table.double().requires_grad_()
    (exact_dt,) = torch.autograd.grad(
        cops._pn_hist_plain(leaf64, fine_offset, sel, row_valid, bnd), leaf64, cot.double())
    exact_dt = exact_dt.float()
    got_dt = cops._pn_hist_backward_cuda(table, fine_offset, sel, row_valid, bnd, cot)
    bwd_err, twin_err = rel_err(got_dt, exact_dt), rel_err(want_dt, exact_dt)
    if not bwd_err <= K7B_REL_TOL:
        raise AssertionError(f"[K7] backward rel err {bwd_err} > {K7B_REL_TOL}")
    del leaf64
    records["pn_hist"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: cops._pn_hist_cuda(table, fine_offset, sel, row_valid, bnd)),
        plain_ms=time_ms(lambda: cops._pn_hist_plain(table, fine_offset, sel, row_valid, bnd)),
        bound_ms=b, bound_by=by, library_ms=time_ms(library))
    grad_rows = ind.reshape(-1)
    flat = ((fine_offset + sel.long())[:, None] * f
            + torch.arange(f, device=dev)[None, :]).reshape(-1)
    vals = (cot[bin_of_row] * ind).reshape(-1)
    bb, bby = bound_ms(rows * 5 + 2 * n_entries * 4 * f + (bins + 1) * 4 + bins * 4 * f,
                       int(grad_rows.sum()))
    records["pn_hist_bwd"] = dict(
        max_abs_err=float((got_dt - exact_dt).abs().max()),
        ms=time_ms(lambda: cops._pn_hist_backward_cuda(table, fine_offset, sel, row_valid, bnd,
                                                       cot), iters=10),
        plain_ms=time_ms(lambda: torch.autograd.grad(
            cops._pn_hist_plain(leaf, fine_offset, sel, row_valid, bnd), leaf, cot), iters=5,
            warmup=1),
        bound_ms=bb, bound_by=bby,
        library_ms=time_ms(lambda: torch.zeros(table.numel(), device=dev).index_add_(
            0, flat, vals), iters=10))
    r = records["pn_hist"]
    log(f"[K7 pn_hist] rows={rows} valid={n_valid} bins={bins} distinct_entries={n_entries} F={f}"
        f" ({len(calls['pn_hist'])} calls in the step) exact ms={r['ms']:.4f}"
        f" plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} bound_ms={b:.4f};"
        f" backward rel_err {bwd_err:.3g} against the twin in float64 (limit {K7B_REL_TOL};"
        f" the float32 twin against it {twin_err:.3g})"
        f" ms={records['pn_hist_bwd']['ms']:.4f}")
    del ind, vals, flat, bin_of_row, leaf

    # ---- K1v / K2v at each call site of the step (see encode_sites); the
    # largest call of each site is checked and timed
    sites = encode_sites(tr, enc, calls)
    k1v, k2v = {}, {}
    for label in ENCODE_SITES:
        pts, table, levels, kw = encode_args(torch, max(sites[label],
                                                        key=lambda a: a["points"].shape[0]))
        k1v[label] = dict(check_grid_encode(torch, enc, levels, table, pts, label,
                                            perturb=False, name="K1v", **kw),
                          launches_per_step=len(sites[label]))
        k2v[label] = dict(check_grid_encode_bwd(torch, enc, levels, table, pts, gen, label,
                                                name="K2v", **kw),
                          launches_per_step=sum(c["table"].requires_grad for c in sites[label]))
    log("[K1v, K2v] launches per step by call site: "
        + json.dumps({k: [k1v[k]["launches_per_step"], k2v[k]["launches_per_step"]]
                      for k in k1v}))
    first = "3D mixed levels"
    records["grid_encode_v"] = dict(k1v[first], max_abs_err=max(v["max_abs_err"]
                                                                 for v in k1v.values()),
                                    sites=k1v)
    records["grid_encode_v_bwd"] = dict(k2v[first], max_abs_err=max(v["max_abs_err"]
                                                                     for v in k2v.values()),
                                        sites=k2v)
    return records


def check_pack(torch, enc, cache):
    """The mask packing against its twin (torch.equal) on a refreshed cache:
    the 3D levels' masks and the three planes'; each packed again equals the
    cache's copy.  Returns the 3D record, the planes' under "sites"."""
    recs = {}
    for key in ("mask3d", "mask2d"):
        mask = cache[key]
        kernel = lambda: enc.pack_mask_bits(mask)
        got, want = kernel(), enc._pack_bits_plain(mask)
        if not (torch.equal(got, want) and torch.equal(got, cache[key + "_bits"])):
            raise AssertionError(f"[pack] {key}: the packed words differ from the twin's")
        # bytes: the bools read once, the words written once
        b, by = bound_ms(mask.numel() + got.numel() * 4, 0)
        recs[key] = dict(max_abs_err=0.0, ms=time_ms(kernel),
                         device_ms=device_ms(kernel),
                         plain_ms=time_ms(lambda: enc._pack_bits_plain(mask), iters=5, warmup=1),
                         bound_ms=b, bound_by=by, library_ms=None)
        r = recs[key]
        log(f"[pack {key}] {tuple(mask.shape)} bools ({mask.numel() / 2**20:.1f} MiB) into"
            f" {got.numel() * 4 / 2**20:.2f} MiB of words, exact ms={r['ms']:.4f}"
            f" device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={b:.4f}")
        del got, want
    return dict(recs["mask3d"], sites=recs)


@contextlib.contextmanager
def swapped(*swaps):
    """Module attributes replaced for the length of a block: (module, name,
    replacement) each."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, repl in swaps:
        setattr(mod, name, repl)
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def check_rate_gradient(torch, tr, rf, cops, enc, ent_ops, label):
    """One full-width rate estimate's gradients (the four tables, the context
    MLPs) on the trainer's current state and one draw of the entry windows:
    through the kernels, through their plain twins on the card in float32,
    and through the twins with tables, MLPs and every sum in float64, the
    yardstick.  The gradient sums terms far larger than itself (d bits / d p
    of an entry is 1 / (p ln 2) inside the clamp [P_EPS, 1 - P_EPS] and 0
    outside it), so float32 moves both the kernels' and the twins' result;
    what is held is the norm of the kernels' distance from the yardstick
    over the gradient's norm.  Printed beside it: the float32 twins' distance
    from the yardstick, the kernels' from the float32 twins, a second kernel
    run's from the first (float atomics), and for each the largest entry's
    error over the largest entry.

    The comparison is made once per band of RATE_GRAD_BANDS, with the bits of
    the coded values whose p lies within the band of 0 or 1 left out of the
    sum (the same values on every side, chosen from the kernels' p; band 0
    leaves nothing out): a value at the clamp switches a gradient of 1.4e6
    on or off with the last bit of p, in float32 and float64 alike, so only
    RATE_GRAD_BAND is held.  Returns {band: the kernels' largest norm
    distance from the yardstick}; raises where a gradient's at RATE_GRAD_BAND
    exceeds twice the float32 twins' by more than RATE_GRAD_TOL."""
    entropy, cfg = tr.entropy, tr.cfg
    starts = entropy.draw_starts(tr.generator)
    cache = tr._last_ent_cache
    plain_bits = ent_ops.bernoulli_bits
    field64, params64 = copy.deepcopy(tr.field).double(), copy.deepcopy(tr.ent_params).double()
    n_tables = len(rf.TABLES)

    def grads(field, ent_params, keep_of):
        """Bits, gradients and the p of each bernoulli_bits call, with call
        i's bits summed over keep_of(i, p)."""
        seen = []
        wrt = [field.tables[k] for k in rf.TABLES] + list(ent_params.parameters())

        def bits_kept(x, p):
            keep = keep_of(len(seen), p.detach())
            seen.append(p.detach())
            return torch.where(keep, plain_bits(x, p), 0.0)

        with swapped((ent_ops, "bernoulli_bits", bits_kept)):
            tables = rf.quantized_tables(field, cfg.model)
            bits = (entropy.rate_bits_2d(ent_params, tables, starts["2d"], cache)
                    + entropy.rate_bits_3d(ent_params, tables["xyz"], starts["3d"], cache))
            got = torch.autograd.grad(bits, wrt, allow_unused=True)
        return (float(bits.detach()),
                [torch.zeros_like(w) if g is None else g for w, g in zip(wrt, got)], seen)

    def dist(got, want):
        """Per gradient (each table, the MLPs as one): [largest |got - want|
        over largest |want|, norm of got - want over norm of want]."""
        got, want = [g.double() for g in got], [w.double() for w in want]
        groups = [(k, [i]) for i, k in enumerate(rf.TABLES)]
        groups.append(("ctx_mlps", list(range(n_tables, len(want)))))
        out = {}
        for name, idx in groups:
            diff2 = sum(float(((got[i] - want[i]) ** 2).sum()) for i in idx)
            want2 = sum(float((want[i] ** 2).sum()) for i in idx)
            out[name] = [max(rel_err(got[i], want[i]) for i in idx),
                         math.sqrt(diff2 / max(want2, 1e-300))]
        return out

    twins = ((cops, "segment_mean", lambda x, den, seg, valid, num, min_den, weighted=False:
              cops._segment_mean_plain(x, den, seg, valid, num, min_den, weighted)),
             (cops, "segment_gather", cops._segment_gather_plain),
             (cops, "pn_hist", cops._pn_hist_plain),
             (enc, "_encode", lambda pts, table, res, offs, mask=None, moffs=None, bits=None,
              ids=None, n_calc=None:
              enc._encode_plain(pts.detach(), table, res, offs, mask,
                                None if mask is None else tuple(int(m) for m in moffs),
                                ids, n_calc)))
    keep_all = lambda i, p: torch.ones_like(p, dtype=torch.bool)
    _, _, ps = grads(tr.field, tr.ent_params, keep_all)
    p_all = torch.cat([p.reshape(-1) for p in ps])
    at_clamp = float(((p_all <= ent_ops.P_EPS) | (p_all >= 1 - ent_ops.P_EPS)).float().mean())
    out = {}
    for band in RATE_GRAD_BANDS:
        keeps = [(p > band) & (p < 1 - band) for p in ps]
        keep_of = (lambda i, p: keeps[i]) if band else keep_all
        left_out = 1.0 - float(torch.cat([k.reshape(-1) for k in keeps]).float().mean())
        bits_k, g_k, _ = grads(tr.field, tr.ent_params, keep_of)
        _, g_k2, _ = grads(tr.field, tr.ent_params, keep_of)
        with swapped(*twins):
            bits_t, g_t, _ = grads(tr.field, tr.ent_params, keep_of)
            bits_64, g_64, _ = grads(field64, params64, keep_of)
        errs = {"kernels against float64": dist(g_k, g_64),
                "float32 twins against float64": dist(g_t, g_64),
                "kernels against float32 twins": dist(g_k, g_t),
                "kernels, second run against first": dist(g_k2, g_k)}
        out[band] = max(e[1] for e in errs["kernels against float64"].values())
        log(f"[rate gradient, {label}] band {band:g}: {100 * left_out * bool(band):.3f}% of"
            f" {p_all.numel()} coded values left out ({100 * at_clamp:.3f}% at or beyond the"
            f" clamp); bits {bits_k:.1f} through the kernels, {bits_t:.1f} through the twins,"
            f" {bits_64:.1f} in float64; largest gradient entry"
            f" {max(float(g.abs().max()) for g in g_64):.4g}; per gradient [max |a - b| over"
            f" max |b|, norm of a - b over norm of b]: "
            + json.dumps({k: {n: [float(f"{x:.3g}") for x in e] for n, e in v.items()}
                          for k, v in errs.items()}))
        for name, (_, err) in errs["kernels against float64"].items():
            limit = 2 * errs["float32 twins against float64"][name][1] + RATE_GRAD_TOL
            if band == RATE_GRAD_BAND and not err <= limit:
                raise AssertionError(f"[rate gradient, {label}] band {band:g}, {name}: the kernels'"
                                     f" gradient is {err} of its norm from the float64 twins',"
                                     f" limit {limit}")
        del g_k, g_k2, g_t, g_64, keeps
    return out


def fit_and_read(kernels, tr, n_steps, test_set, on_step, tag):
    """One `tr.fit` to n_steps, the test views read from its step callback at
    PSNR_READINGS steps (see PSNR_READ_EVERY).  A reading renders with the serving
    kernels, which are not the training path: the launch counts are put back
    to what they were before it.  Returns (seconds inside fit less the
    readings, the reading with the median PSNR, with every reading's PSNR
    under "readings")."""
    read_at = {n_steps - 1 - back * PSNR_READ_EVERY for back in range(PSNR_READINGS)}
    readings, read_s = [], 0.0

    def callback(step, aux):
        nonlocal read_s
        on_step(step, aux)
        if step in read_at:
            t0 = time.time()
            counted = dict(kernels.launches)
            readings.append(tr.evaluate(test_set))
            kernels.launches.update(counted)
            read_s += time.time() - t0

    seconds = tr.fit(n_steps - 1, log_every=100, log_fn=lambda m: log(tag + m),
                     step_callback=callback)
    if len(readings) != PSNR_READINGS:
        raise AssertionError(f"{tag}read the test views {len(readings)} times,"
                             f" not {PSNR_READINGS}")
    median = sorted(readings, key=lambda r: r["psnr"])[PSNR_READINGS // 2]
    return seconds - read_s, dict(median, readings=[round(r["psnr"], 3) for r in readings])


def profile_view(torch, render, name: str = "profile") -> None:
    """Device busy share and time by operator over one call of `render`."""
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
    log(f"[{name}] wall {wall_ms:.1f} ms under the profiler, device busy {dev_ms:.1f} ms"
        f" ({100 * dev_ms / wall_ms:.1f}%)")
    log(table)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"{name}.txt").write_text(f"wall_ms {wall_ms}\ndevice_ms {dev_ms}\n{table}\n{host}\n")


def run_codec(torch, kernels, rf, trr, entropy, test_set, rate_cfg, bpp_end, records):
    """[codec]: the trained lambda = 2e-3 tables through the codec: the int
    cache, the codec kernels against their twins, encode, decode in the same
    process (lossless on the covered entries, the test views' PSNR kept), the
    bundle, and decode_bundle in a fresh python3 process whose render of test
    view 0 must equal this process's.  Returns the launch counts of the
    encode, of the decode and of the whole codec path."""
    import hashlib
    import shutil

    import numpy as np
    from cnc_torch.codec import codec as codec_mod
    from cnc_torch.codec import intctx
    bundle_dir = Path("chiprun_out") / "bundle"
    shutil.rmtree(bundle_dir, ignore_errors=True)
    occ_rate = trr.occ_state.binaries
    trained = {k: v.detach().clone() for k, v in rf.quantized_tables(trr.field,
                                                                     rate_cfg.model).items()}
    pre = trr.evaluate(test_set)
    view0_pre = trr.eval_image(0, test_set)[0]
    codec = codec_mod.CNCCodec(entropy)
    torch.cuda.synchronize()
    kernels.reset_launches()        # the codec path starts here
    t0 = time.time()
    cache_i = entropy.refresh_cache_int(occ_rate)
    torch.cuda.synchronize()
    cache_s = time.time() - t0
    cache_launches = dict(kernels.launches)
    log(f"[codec] refresh_cache_int {cache_s:.2f} s on {int(occ_rate.sum())} cells"
        f" (ovl_int {sum(v.numel() for v in cache_i['ovl_int'].values()) * 4 / 2**30:.2f} GiB,"
        f" mask3d {cache_i['mask3d'].numel() / 2**30:.2f} GiB); 3D chunks per level "
        + json.dumps({l: c[1] for l, c in codec.chunks3d.items()})
        + " m_shift3 " + json.dumps(codec.m_shift3) + " m_shift2 " + json.dumps(codec.m_shift2))
    ip = codec._int_params(trr.ent_params)
    sign3 = intctx.sign_table(trained["xyz"])
    sums3, _ = codec._stats(trained["xyz"], entropy.spec3)
    sums2, _ = codec._stats(trained["xy"], entropy.spec2)
    f = entropy.cfg.n_features
    l3, l2 = entropy.ctx_levels_3d[-1], entropy.ctx_levels_2d[-1]
    pg3 = intctx.quantize_pg(codec._pg_from_sum(int(sums3[l3]), entropy.spec3.level_sizes[l3] * f))
    pg2 = intctx.quantize_pg(codec._pg_from_sum(int(sums2[l2]), entropy.spec2.level_sizes[l2] * f))
    records.update(check_codec_kernels(torch, intctx, entropy, codec, ip, sign3,
                                       intctx.sign_table(trained["xy"]), cache_i, pg3, pg2))
    kernels.launches.update(cache_launches)     # comparison launches do not count

    t0 = time.time()
    pgs, est_mb, coded_mb = codec.encode(trr.ent_params, trained, occ_rate, str(bundle_dir),
                                         cache=cache_i)
    torch.cuda.synchronize()
    enc_s = time.time() - t0
    enc_launches = {k: kernels.launches[k] - cache_launches[k] for k in kernels.launches}
    kernels.reset_launches()
    t0 = time.time()
    rec = codec.decode(trr.ent_params, occ_rate, pgs, str(bundle_dir), cache=cache_i)
    torch.cuda.synchronize()
    dec_s = time.time() - t0
    dec_launches = dict(kernels.launches)
    codec_launches = {k: cache_launches[k] + enc_launches[k] + dec_launches[k]
                      for k in kernels.launches}
    codec_kernels = ("int_encode", "int_mlp_pool", "int_pq", "pn_hist_int")
    if not all(enc_launches[k] > 0 and dec_launches[k] > 0 for k in codec_kernels):
        raise AssertionError(f"[codec] a codec kernel was not launched: encode {enc_launches},"
                             f" decode {dec_launches}")
    n_streams = len(list(bundle_dir.glob("*.b")))
    cov = covered_rows(torch, intctx, entropy, codec, ip,
                       {k: intctx.sign_table(v) for k, v in trained.items()}, cache_i, pgs)
    n_symbols = sum(int(c.sum()) for c in cov.values()) * f
    for k in trained:
        if not torch.equal(rec[k][cov[k]], trained[k][cov[k]]) or not bool(
                (rec[k][~cov[k]] == 1).all()):
            raise AssertionError(f"[codec] {k}: decode is not lossless on the covered entries")
    embed_mb = bpp_end * entropy.total_param_count / 8 / 2**20
    log(f"[codec] encode {enc_s:.2f} s: {coded_mb:.4f} MB coded, {est_mb:.4f} MB analytic"
        f" ({100 * (coded_mb - est_mb) / coded_mb:+.2f}%), the trainer's last embed_MB"
        f" {embed_mb:.4f}; {n_streams} streams, {n_symbols} symbols coded"
        f" ({sum(int(c.sum()) for c in cov.values())} of"
        f" {sum(c.numel() for c in cov.values())} entries covered); decode {dec_s:.2f} s"
        f" (cache {cache_s:.2f} s shared); launches per encode "
        + json.dumps({k: enc_launches[k] for k in codec_kernels}) + ", per decode "
        + json.dumps({k: dec_launches[k] for k in codec_kernels}))
    if not abs(est_mb - coded_mb) / coded_mb < 0.15:
        raise AssertionError(f"[codec] coded {coded_mb} MB is not within 15% of the analytic"
                             f" {est_mb} MB")

    rf.replace_tables(trr.field, rec)
    post = trr.evaluate(test_set)
    view0 = trr.eval_image(0, test_set)[0]
    delta = post["psnr"] - pre["psnr"]
    log(f"[codec] test views psnr {pre['psnr']:.4f} before the codec, {post['psnr']:.4f} after"
        f" (delta {delta:+.6f} dB; view 0 max abs change"
        f" {float((view0 - view0_pre).abs().max()):.3g})")
    if not abs(delta) <= 1e-3:
        raise AssertionError(f"[codec] the codec moved the test psnr by {delta} dB")

    codec_mod.save_bundle(str(bundle_dir), pgs, trr.ent_params, trr.field, occ_rate,
                          {"scene": "blocks", "lmbda": rate_cfg.train.lmbda,
                           "n_features": rate_cfg.model.n_features_per_level,
                           "config": rate_cfg.to_dict()})
    size_mb = codec_mod.bundle_size_mb(str(bundle_dir))
    digests = {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest() for k, v in rec.items()}
    # the fresh process renders test view 0 of the same procedural test set
    fresh = ("import hashlib, json, sys, time\n"
             "t0 = time.time()\n"
             "import numpy as np, torch\n"
             "from cnc_torch.data import scenes\n"
             "from cnc_torch.render import renderer\n"
             "from cnc_torch.train.driver import decode_bundle\n"
             "dev = torch.device(sys.argv[3])\n"
             "torch.zeros(1, device=dev)\n"
             "t_ready = time.time()\n"
             "field, binaries, cfg = decode_bundle(sys.argv[1], device=dev, log_fn=print)\n"
             "t1 = time.time()\n"
             "ds = scenes.ProceduralDataset('blocks', n_images=2, split='test', device=dev)\n"
             "rays, _ = ds.image_and_rays(0)\n"
             "aabb = torch.tensor(cfg.render.aabb, dtype=torch.float32, device=dev)\n"
             "rgb = renderer.render_image(field, cfg.model, cfg.render, aabb, binaries,\n"
             "                            rays.origins, rays.viewdirs, torch.ones(3),\n"
             "                            device=dev)[0]\n"
             "np.save(sys.argv[2], rgb.cpu().numpy())\n"
             "print(json.dumps({'ready_s': t_ready - t0, 'decode_s': t1 - t_ready,"
             " 'total_s': time.time() - t0,"
             " 'tables': {k: hashlib.sha256(field.tables[k].detach().cpu().numpy().tobytes())"
             ".hexdigest() for k in ('xyz', 'xy', 'xz', 'yz')}}))\n")
    view_file = Path("chiprun_out") / "bundle_view0.npy"
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", fresh, str(bundle_dir), str(view_file),
                           str(trr.device)], capture_output=True, text=True, timeout=600)
    fresh_s = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[codec] decode_bundle in a fresh process failed:\n{proc.stderr}")
    fresh_out = json.loads(proc.stdout.strip().splitlines()[-1])
    view_fresh = torch.from_numpy(np.load(view_file)).to(view0.device)
    view_err = float((view_fresh - view0).abs().max())
    log(f"[codec] decode_bundle in a fresh python3 process: {fresh_s:.2f} s in all (imports"
        f" and the card's context {fresh_out['ready_s']:.2f} s; decode_bundle, that is the"
        f" ContextModels build, the int cache and the decode, {fresh_out['decode_s']:.2f} s;"
        f" with the view {fresh_out['total_s']:.2f} s; it logged"
        f" {proc.stdout.strip().splitlines()[0]!r}); bundle {size_mb:.4f} MB"
        f" ({len(list(bundle_dir.iterdir()))} files); tables bit-equal"
        f" {fresh_out['tables'] == digests}; view 0 max abs diff to the in-process render"
        f" {view_err:.3g} (exactly equal {bool(torch.equal(view_fresh, view0))})")
    if fresh_out["tables"] != digests or not view_err <= 1e-6:
        raise AssertionError("[codec] the fresh process's field differs from the in-process one")
    return enc_launches, dec_launches, codec_launches



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
    import dataclasses
    from cnc_torch.config import CNCConfig, ModelConfig, RenderConfig, TrainConfig
    from cnc_torch.data import cameras, scenes
    from cnc_torch.models import context_models as cm
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.ops import context_ops as cops
    from cnc_torch.ops import encoding as enc
    from cnc_torch.ops import entropy as ent_ops
    from cnc_torch.ops import scatter_ops
    from cnc_torch.render import marching, renderer, volrend
    from cnc_torch.train.trainer import Trainer
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
        for name in MARCH_FIELDS:
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
        late_march = lambda: marching._march_cuda(o, d, binaries, aabb, rcfg, capacity,
                                                  alive_late, cursor, None, mip)
        view_sites = {
            "view, first round": dict(ms=time_ms(march), device_ms=device_ms(march),
                                      plain_ms=time_ms(plain), samples=n_valid),
            "view, late round": dict(ms=time_ms(late_march), device_ms=device_ms(late_march),
                                     samples=int(late.valid.sum()))}
        records["march"] = dict(view_sites["view, first round"], max_abs_err=0.0, bound_ms=b,
                                bound_by=by, library_ms=None, sites=view_sites)
        log(f"[K4 march] rays={chunk} capacity={capacity} samples={n_valid}"
            f" truncated={bool(got.truncated)} coarse_tests={n_coarse} mip_cells={n_mip}"
            f" fine_tests={n_fine} voxels={n_vox}: every field, the per-ray outputs and the"
            f" padding exact at the first and a late round; ms={records['march']['ms']:.4f}"
            f" device_ms={records['march']['device_ms']:.4f}"
            f" plain_ms={records['march']['plain_ms']:.4f} bound_ms={b:.5f}; late round"
            f" ({view_sites['view, late round']['samples']} samples)"
            f" ms={view_sites['view, late round']['ms']:.4f}"
            f" device_ms={view_sites['view, late round']['device_ms']:.4f}")

        # K1 at the first round's sample positions, normalized to [0,1]^3
        pos, _ = marching.sample_positions(got, o, d)
        x01 = ((pos - aabb[:3]) / (aabb[3:] - aabb[:3])).contiguous()
        k1_xyz = check_grid_encode(torch, enc, mcfg.grid_3d, tables["xyz"], x01, "xyz")
        k1_xy = check_grid_encode(torch, enc, mcfg.grid_2d, tables["xy"],
                                  x01[:, [0, 1]].contiguous(), "xy")
        records["grid_encode"] = dict(k1_xyz, max_abs_err=max(k1_xyz["max_abs_err"],
                                                               k1_xy["max_abs_err"]),
                                      sites={"xyz view": k1_xyz, "xy view": k1_xy})

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
    serving = ("grid_encode", "march", "volrend")
    render_with = lambda fld, grid, **kw: renderer.render_image(
        fld, mcfg, rcfg, aabb, grid, rays.origins, rays.viewdirs, bkgd, device=dev, **kw)
    render_view = lambda **kw: render_with(field, binaries, **kw)
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
    if not all(launches[k] > 0 for k in serving):
        raise AssertionError(f"main path: a kernel was not launched: {launches}")
    # the march compacts its own samples, three launches a round; no K3
    if not (launches["compact"] == 0 and launches["march"] == 3 * stats["rounds"]):
        raise AssertionError(f"main path: the march's launches are not 3 a round: {launches}")
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

    # ---- 6. the probe kernels, driven once at the probe's shapes
    probe_records, probe_launches = check_probe(torch, kernels, scatter_ops, dev)
    records.update(probe_records)
    if not all(v > 0 for v in probe_launches.values()):
        raise AssertionError(f"[probe] a kernel was not launched: {probe_launches}")

    # ---- 7. the training path at full width
    cfg = CNCConfig(train=dataclasses.replace(TrainConfig(), lmbda=0.0))
    t0 = time.time()
    train_set = scenes.ProceduralDataset("blocks", device=dev)
    test_set = scenes.ProceduralDataset("blocks", n_images=2, split="test", device=dev)
    tr = Trainer(cfg, train_set)
    torch.cuda.synchronize()
    log(f"[train] datasets and trainer ready in {time.time() - t0:.1f} s: {len(train_set)} views"
        f" of {train_set.WIDTH}x{train_set.HEIGHT}, sample buffer {cfg.render.sample_capacity},"
        f" target {cfg.train.target_sample_batch_size} samples per step")
    history = []      # (host seconds at the step's end, mse, visible, marched, rays)

    def on_step(step, aux):
        history.append((time.time(), float(aux["mse"]), aux["n_samples"], aux["n_marched"],
                        aux["num_rays"]))

    tr.fit(TRAIN_WARM_STEPS - 1, log_every=0, step_callback=on_step)
    records.update(check_training_kernels(torch, tr, enc, marching, volrend, rf, gen))
    records["grid_encode"]["sites"]["xyz train"] = records.pop("grid_encode_train")
    records["march"]["sites"]["training march"] = records.pop("march_train")

    torch.cuda.synchronize()
    kernels.reset_launches()
    run_s, scores = fit_and_read(kernels, tr, TRAIN_STEPS, test_set, on_step, "[train] ")
    train_launches = dict(kernels.launches)
    n_run = TRAIN_STEPS - TRAIN_WARM_STEPS
    # (K3 runs in the occupancy update, every 16 steps, not in each step)
    training = ("grid_encode", "grid_encode_bwd", "march", "volrend", "volrend_bwd")
    if tr.step != TRAIN_STEPS or len(history) != TRAIN_STEPS:
        raise AssertionError(f"[train] ran {tr.step} steps, not {TRAIN_STEPS}")
    if not all(train_launches[k] >= n_run for k in training):
        raise AssertionError(f"[train] a kernel was not launched every step: {train_launches}")
    loss_start = statistics.mean(h[1] for h in history[:10])
    loss_end = statistics.mean(h[1] for h in history[-10:])
    before_readings = (PSNR_READINGS - 1) * PSNR_READ_EVERY
    last = history[-101 - before_readings:-before_readings]   # no reading inside
    ms_step = (last[-1][0] - last[0][0]) / 100 * 1e3
    marched = statistics.mean(h[3] for h in last[1:])
    if not (loss_end < loss_start and all(math.isfinite(h[1]) for h in history)):
        raise AssertionError(f"[train] the loss did not fall: {loss_start} -> {loss_end}")
    if not marched >= 0.8 * cfg.train.target_sample_batch_size:
        raise AssertionError(f"[train] the ray controller did not reach its target: {marched}"
                             f" samples marched per step")
    log(f"[train] {n_run} steps in {run_s:.2f} s ({n_run / run_s:.2f} steps/s over the whole"
        f" run, occupancy updates included); steps {TRAIN_STEPS - 100 - before_readings} to"
        f" {TRAIN_STEPS - before_readings} {ms_step:.2f} ms per step,"
        f" {marched:.0f} samples marched, {statistics.mean(h[2] for h in last[1:]):.0f} visible"
        f" and {statistics.mean(h[4] for h in last[1:]):.0f} rays per step;"
        f" loss {loss_start:.5f} -> {loss_end:.5f}; test views psnr {scores['psnr']:.3f}"
        f" ssim {scores['ssim']:.4f} (the median of {scores['readings']}; floor"
        f" {TRAIN_PSNR_MIN});"
        f" occupancy {int(tr.occ_state.binaries.sum())} cells;"
        f" launches over the run {json.dumps(train_launches)}")
    Path("chiprun_out").mkdir(exist_ok=True)
    (Path("chiprun_out") / "train_history.json").write_text(json.dumps(
        {"columns": ["host_s", "mse", "visible", "n_marched", "num_rays"],
         "steps": [[h[0] - history[0][0]] + list(h[1:]) for h in history],
         "test_psnr": scores["readings"], "test_psnr_every": PSNR_READ_EVERY}))
    if not scores["psnr"] > TRAIN_PSNR_MIN:
        raise AssertionError(f"[train] test psnr {scores['psnr']} <= {TRAIN_PSNR_MIN}")

    def one_step():
        batch, pixels = train_set.fetch_rays(tr.generator, history[-1][4])
        tr._train_step(batch.origins, batch.viewdirs, pixels, bkgd)

    one_step()
    profile_view(torch, one_step, "profile_train")

    # ---- 8. the view again, with the trained field and its occupancy grid
    trained_view = lambda **kw: render_with(tr.field, tr.occ_state.binaries, **kw)
    trained_view()
    torch.cuda.synchronize()
    stats_t = {}
    t0 = time.time()
    rgb_t = trained_view(stats=stats_t)[0]
    torch.cuda.synchronize()
    view_t = time.time() - t0
    log(f"[trained view] {VIEW}x{VIEW}: {view_t * 1e3:.1f} ms, {stats_t['rounds']} rounds,"
        f" {int(stats_t['samples'])} samples marched, psnr {float(metrics.psnr(rgb_t, gt)):.3f}"
        f" ssim {float(metrics.ssim(rgb_t, gt)):.4f}; the random-weights view above:"
        f" {view_s * 1e3:.1f} ms, {stats['rounds']} rounds, {n_samples} samples")

    # ---- 9. the rate path at full width: the model build and the lambda > 0 run
    rate_cfg = CNCConfig()
    if not rate_cfg.train.lmbda > 0:
        raise AssertionError("[rate] the default configuration has no rate term")
    torch.cuda.synchronize()
    kernels.reset_launches()        # the rate path starts here
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.time()
    entropy = cm.ContextModels(rate_cfg.entropy, rate_cfg.model.grid_3d, rate_cfg.model.grid_2d)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    log(f"[K10] ContextModels built in {build_s:.2f} s; peak device memory"
        f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, tables hold"
        f" {(torch.cuda.memory_allocated() - mem_before) / 2**30:.2f} GiB;"
        f" launches {kernels.launches['vertex_tables']} (compaction {kernels.launches['compact']});"
        f" 3D entries " + json.dumps({l: t.n_entries for l, t in entropy.tables3d.items()})
        + " sample_n " + json.dumps({l: t.sample_n for l, t in entropy.tables3d.items()})
        + " max_win_pts " + json.dumps({l: t.max_win_pts for l, t in entropy.tables3d.items()})
        + "; 2D entries " + json.dumps({l: t.n_entries for l, t in entropy.tables2d.items()})
        + " max_win_pts " + json.dumps({l: t.max_win_pts for l, t in entropy.tables2d.items()}))
    counted_so_far = dict(kernels.launches)
    records["vertex_tables"] = check_vertex_tables(torch, cops, entropy, dev)
    kernels.launches.update(counted_so_far)     # comparison launches do not count
    torch.cuda.reset_peak_memory_stats()

    trr = Trainer(rate_cfg, train_set, entropy=entropy)
    rate_hist = []     # (host seconds, mse, bits_per_param, ctx_util, marched, rays)

    def on_rate_step(step, aux):
        rate_hist.append((time.time(), float(aux["mse"]), float(aux["bits_per_param"]),
                          float(aux["ctx_util"]), aux["n_marched"], aux["num_rays"]))

    trr.fit(RATE_WARM_STEPS - 1, log_every=0, step_callback=on_rate_step)
    torch.cuda.synchronize()
    log(f"[rate] {RATE_WARM_STEPS} steps done; peak device memory after the first rate steps"
        f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counted_so_far = dict(kernels.launches)
    occ_grid = tr.occ_state.binaries        # the grid the lambda = 0 run ended with
    records["footprint"] = check_footprint(torch, cops, entropy, occ_grid)
    n_fp, n_pack = kernels.launches["footprint"], kernels.launches["pack_mask_bits"]
    occ_cache = entropy.refresh_cache(occ_grid)
    n_fp = kernels.launches["footprint"] - n_fp
    n_pack = kernels.launches["pack_mask_bits"] - n_pack
    refresh_ms = time_ms(lambda: entropy.refresh_cache(occ_grid), iters=3, warmup=1)
    log(f"[K8] refresh_cache on the trained occupancy grid ({int(occ_grid.sum())} cells):"
        f" {refresh_ms:.2f} ms for {n_fp} footprint launches, {n_pack} mask packings and the"
        f" pn coord lists (a compaction and three stable sorts of"
        f" {rate_cfg.entropy.pn_coords_cap} rows)")
    records["pack_mask_bits"] = dict(check_pack(torch, enc, occ_cache),
                                     launches_per_refresh=n_pack)
    del occ_cache
    check_order_faults(cops, dev, f"[rate] after {RATE_WARM_STEPS} steps:")
    records.update(check_rate_kernels(torch, trr, rf, cops, enc, gen))
    check_rate_gradient(torch, trr, rf, cops, enc, ent_ops, f"step {RATE_WARM_STEPS}")
    kernels.launches.update(counted_so_far)     # comparison launches do not count

    rate_s, rate_scores = fit_and_read(kernels, trr, RATE_STEPS, test_set, on_rate_step, "[rate] ")
    rate_launches = dict(kernels.launches)
    n_rate = RATE_STEPS - RATE_WARM_STEPS
    rate_kernels = ("vertex_tables", "footprint", "pack_mask_bits", "segment_mean",
                    "segment_mean_bwd", "segment_pool", "segment_pool_bwd", "pn_hist",
                    "grid_encode_v", "grid_encode_v_bwd", "compact", "grid_encode",
                    "grid_encode_bwd", "march", "volrend", "volrend_bwd")
    if trr.step != RATE_STEPS or len(rate_hist) != RATE_STEPS:
        raise AssertionError(f"[rate] ran {trr.step} steps, not {RATE_STEPS}")
    if not all(rate_launches[k] > 0 for k in rate_kernels):
        raise AssertionError(f"[rate] a kernel of the rate path was not launched: {rate_launches}")
    per_step = {k: (rate_launches[k] - counted_so_far[k]) / n_rate for k in rate_kernels}
    rate_per_step = per_step
    # the table build runs once, the footprints and the packing once per
    # refresh; every other kernel of the path runs in each step
    once = ("vertex_tables", "footprint", "pack_mask_bits")
    if not all(per_step[k] >= 1 for k in rate_kernels if k not in once):
        raise AssertionError(f"[rate] a kernel was not launched every step: {per_step}")
    bpp16 = rate_hist[RATE_WARM_STEPS][2]
    bpp_end = statistics.mean(h[2] for h in rate_hist[-10:])
    if not (all(math.isfinite(h[1]) and math.isfinite(h[2]) for h in rate_hist)
            and bpp_end < bpp16):
        raise AssertionError(f"[rate] bits_per_param did not fall: {bpp16} at step"
                             f" {RATE_WARM_STEPS} -> {bpp_end}")
    last_r = rate_hist[-101 - before_readings:-before_readings]   # no reading inside
    ms_rate_step = (last_r[-1][0] - last_r[0][0]) / 100 * 1e3
    log(f"[rate] {n_rate} steps in {rate_s:.2f} s ({n_rate / rate_s:.2f} steps/s, occupancy"
        f" updates and cache refreshes included); steps {RATE_STEPS - 100 - before_readings} to"
        f" {RATE_STEPS - before_readings} {ms_rate_step:.2f} ms per step"
        f" (lambda = 0 above: {ms_step:.2f} ms), {statistics.mean(h[4] for h in last_r[1:]):.0f}"
        f" samples marched and {statistics.mean(h[5] for h in last_r[1:]):.0f} rays per step;"
        f" bits_per_param {rate_hist[0][2]:.4f} at step 0, {bpp16:.4f} at step"
        f" {RATE_WARM_STEPS}, {bpp_end:.4f} at the end"
        f" ({bpp_end * entropy.total_param_count / 8 / 2**20:.3f} MB);"
        f" ctx_util {statistics.mean(h[3] for h in last_r):.3f} (max"
        f" {max(h[3] for h in rate_hist):.3f});"
        f" mse {statistics.mean(h[1] for h in rate_hist[:10]):.5f}"
        f" -> {statistics.mean(h[1] for h in rate_hist[-10:]):.5f}; test views psnr"
        f" {rate_scores['psnr']:.3f} ssim {rate_scores['ssim']:.4f} (the median of"
        f" {rate_scores['readings']}; floor {RATE_PSNR_MIN};"
        f" lambda = 0 above: {scores['psnr']:.3f});"
        f" launches per step after step {RATE_WARM_STEPS}: "
        + json.dumps({k: round(v, 3) for k, v in per_step.items()})
        + f"; launches over the path {json.dumps(rate_launches)}")
    (Path("chiprun_out") / "rate_history.json").write_text(json.dumps(
        {"columns": ["host_s", "mse", "bits_per_param", "ctx_util", "n_marched", "num_rays"],
         "steps": [[h[0] - rate_hist[0][0]] + list(h[1:]) for h in rate_hist]}))
    if not rate_scores["psnr"] > RATE_PSNR_MIN:
        raise AssertionError(f"[rate] test psnr {rate_scores['psnr']} <= {RATE_PSNR_MIN}")

    check_order_faults(cops, dev, f"[rate] after {RATE_STEPS} steps:")
    check_rate_gradient(torch, trr, rf, cops, enc, ent_ops, f"step {RATE_STEPS}")

    def one_rate_step():
        batch, pixels = train_set.fetch_rays(trr.generator, rate_hist[-1][5])
        trr._train_step(batch.origins, batch.viewdirs, pixels, bkgd,
                        ent_cache=trr._last_ent_cache)

    one_rate_step()
    profile_view(torch, one_rate_step, "profile_rate")

    # the sign histogram's backward kernel: three steps with pn_frac_grad on
    entropy_pn = copy.copy(entropy)
    entropy_pn.cfg = dataclasses.replace(entropy.cfg, pn_frac_grad=True)
    tr_pn = Trainer(dataclasses.replace(rate_cfg, entropy=entropy_pn.cfg), train_set,
                    entropy=entropy_pn)
    kernels.reset_launches()
    pn_bits = []
    tr_pn.fit(2, log_every=0, step_callback=lambda s, aux: pn_bits.append(
        float(aux["bits_per_param"])))
    torch.cuda.synchronize()
    pn_launches = dict(kernels.launches)
    log(f"[rate, pn_frac_grad] 3 steps, bits_per_param {pn_bits}; launches"
        f" pn_hist {pn_launches['pn_hist']} pn_hist_bwd {pn_launches['pn_hist_bwd']}")
    if not (pn_launches["pn_hist_bwd"] > 0 and all(math.isfinite(b) for b in pn_bits)):
        raise AssertionError(f"[rate, pn_frac_grad] the backward kernel did not launch:"
                             f" {pn_launches}")
    check_order_faults(cops, dev, "[rate, pn_frac_grad]")
    del tr_pn, entropy_pn

    # ---- 10. [codec]
    enc_launches, dec_launches, codec_launches = run_codec(
        torch, kernels, rf, trr, entropy, test_set, rate_cfg, bpp_end, records)

    # ---- 11. report: `launches` is the count over the path named beside it
    # (one view, the lambda = 0 training run, the probe's one drive, the rate
    # path from the model's build to the run's last step, the three
    # pn_frac_grad steps, or the codec path: int cache, encode and decode)
    meta = {
        "grid_encode": ("grid_encode.cu", "cnc_tpu/ops/encoding.py:104", "view"),
        "grid_encode_bwd": ("grid_encode.cu", "cnc_tpu/ops/scatter_ops.py:104", "train"),
        "compact": ("compact.cu", "cnc_tpu/ops/scatter_ops.py:146", "rate"),
        "march": ("march.cu", "cnc_tpu/render/marching.py:112", "view"),
        "volrend": ("volrend.cu", "cnc_tpu/render/volrend.py:71", "view"),
        "volrend_bwd": ("volrend.cu", "cnc_tpu/render/volrend.py:43", "train"),
        "scatter_add": ("scatter_add.cu", "tools/pallas_probe.py:113", "probe"),
        "lane_gather": ("probe.cu", "tools/pallas_probe.py:79", "probe"),
        "grid_encode_v": ("grid_encode.cu", "cnc_tpu/ops/encoding.py:211", "rate"),
        "grid_encode_v_bwd": ("grid_encode.cu", "cnc_tpu/ops/scatter_ops.py:104", "rate"),
        # segment_gather's backward and forward: cnc_tpu's pg_arr[clev] and its
        # scatter-add
        "segment_pool": ("segment_pool.cu", "cnc_tpu/models/context_models.py:1335", "rate"),
        "segment_pool_bwd": ("segment_pool.cu", "cnc_tpu/models/context_models.py:1335", "rate"),
        # one call site's pair of cnc_tpu's _segment_tail_values, clamp and divide
        "segment_mean": ("segment_pool.cu", "cnc_tpu/models/context_models.py:1346", "rate"),
        "segment_mean_bwd": ("segment_pool.cu", "cnc_tpu/models/context_models.py:1346", "rate"),
        "pn_hist": ("pn_hist.cu", "cnc_tpu/models/context_models.py:783", "rate"),
        "pn_hist_bwd": ("pn_hist.cu", "cnc_tpu/models/context_models.py:62", "rate_pn_grad"),
        "footprint": ("footprint.cu", "cnc_tpu/models/context_models.py:1415", "rate"),
        "vertex_tables": ("vertex_tables.cu", "cnc_tpu/models/context_models.py:269", "rate"),
        "int_encode": ("int_context.cu", "cnc_tpu/codec/intctx.py:110", "codec"),
        "int_mlp_pool": ("int_context.cu", "cnc_tpu/codec/intctx.py:228", "codec"),
        "int_pq": ("int_context.cu", "cnc_tpu/codec/intctx.py:344", "codec"),
        "pn_hist_int": ("pn_hist.cu", "cnc_tpu/codec/intctx.py:298", "codec"),
        # the packed copy of the mask cnc_tpu reads as bools at encoding.py:90-94
        "pack_mask_bits": ("grid_encode.cu", "cnc_tpu/ops/encoding.py:90", "rate"),
    }
    counted = {"view": launches, "train": train_launches, "probe": probe_launches,
               "rate": rate_launches, "rate_pn_grad": pn_launches, "codec": codec_launches}
    out = []
    for name, (source, replaces, path) in meta.items():
        r = records[name]
        out.append(dict(name=name, route="cuda", source="cnc_torch/csrc/" + source,
                        replaces=replaces, launches=counted[path][name], path=path,
                        train_launches=train_launches[name], train_steps=n_run,
                        rate_launches=rate_launches[name], rate_steps=RATE_STEPS,
                        encode_launches=enc_launches[name], decode_launches=dec_launches[name],
                        max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r.get("device_ms"),
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["library_ms"], sites=r.get("sites"),
                        launches_per_refresh=r.get("launches_per_refresh"),
                        rate_launches_per_step=rate_per_step.get(name)))
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
