#!/usr/bin/env python3
"""Smoke run of cnc_torch's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card (name, power limit), torch and CUDA versions;
  2. build the kernels from cnc_torch/csrc (nvcc, sm_90a);
  3. hold each serving kernel (K1, K4, K5; K3 at random masks) against its
     plain PyTorch twin on the card, at the shapes the serving path gives it,
     and count the device operations of one K3 call at each of its sites'
     shapes and of one mask packing at each refresh site's (the process's
     first profile: one each), and of one whole autograd backward of a
     sampled frac plane (K7b: the fill and one launch),
     and time both with CUDA events (the encode kernels and the march also by
     their device work alone, without the wrapper's host time: `device_ms`;
     the encode's forward must equal the twin bit for bit, and every field of
     the march, its padding slots and its per-ray hit counts and last t_mid
     included, at the view's first and a late round; K5 within 1e-4 relative
     with the visible counts equal, at both rounds);
  4. the serving path: render one 800x800 view of a full-width field
     (ModelConfig(), RenderConfig(), random weights from seed 0) through
     `render_image`, over the procedural `blocks` scene's 128^3 occupancy,
     with every kernel's launch count read just after (the march three a
     round, no K3); then render it once
     more under torch.profiler for the device's busy share and the time by
     operator (also written to chiprun_out/profile.txt);
  5. render a 64x64 crop of the view on the card and with device="cpu" (the
     plain twins), its 4,096 rays as one chunk, and require them to agree;
  6. [probe] the scatter-add and lane-gather kernels at the TPU probe's
     shapes (table [8, 2^18], 2^23 indices from a numpy seed), driven once
     through their public wrappers with the counts read just after, held
     against their twins and timed;
  7. [train] the training path at full width: `Trainer(CNCConfig() with
     lmbda=0, ProceduralDataset("blocks")).fit`.  After the first 16 steps
     the training kernels are held against their twins at one real training
     march's buffer: K4 with jitter (exact, timed), K1 on the xyz table, [K2] the
     encode backward on the xyz table and one plane, [K5] the composite, [K5b]
     its backward at the full and at a half-padded buffer (two runs
     bit-equal).  Then the counts are set to 0, `fit` runs on
     to TRAIN_STEPS, and the counts are read: every training kernel must
     have launched, the loss must have fallen, and the test views' PSNR must
     exceed TRAIN_PSNR_MIN (each phase reads the test views five times from
     `fit`'s step callback; those renders' launches are taken out of the
     counts).  One more step runs under torch.profiler
     (chiprun_out/profile_train.txt);
  8. render the 800x800 view once more with the trained field and grid;
  9. [rate] the rate path at full width, with the counts set to 0 just
     before it: build `ContextModels(EntropyConfig(), grid_3d, grid_2d)`
     with torch.sort taken away ([K10]: seconds, peak memory, entries and
     the longest segment per level; the counting sort by entry equal to the
     twin, the keys, a stable torch.sort and the fill, at the hashed 108^3
     level and a 2D level, the dense 80^3 level too; the finest level's
     count + scan + place + order timed beside the twin and a stable
     torch.sort of its keys), then `Trainer(CNCConfig(), ProceduralDataset(
     "blocks"), entropy=...)` with the default lmbda = 2e-3.  After 16 steps
     the rate kernels are held against their twins at that step's real
     shapes ([K8] and [pack], the packing of the masks, on the lambda = 0
     run's trained occupancy grid, with each of a refresh's footprint
     launches by its device ms and bound; [K6] segment_gather's gather and its
     backward's sums at the 3D context, [K6m] segment_mean at each pooling site (the 3D context, the 2D windows:
     within K6_REL_TOL, covered exact, two runs bit-equal, its backward), [K3]
     at each of its call sites (the 3D context, the refresh's pn coord lists,
     the occupancy update's grid: torch.equal,
     the count equal, device ms, bound, `nonzero`), [K7] the step's three frac planes (each
     equal to the plain plane, one launch and one allocation a plane, the
     backward, K7b, against float64, by device ms alone and as the whole
     autograd backward), and [K1v], [K2v] at each call site
     (the 3D mixed-level context, the 2D windows, the frac planes) with its
     launches per step, on the arguments one rate estimate gives them);
     those launches are taken out of the counts again.  `fit` then runs on to RATE_STEPS and
     the counts are read: every rate kernel must have launched (the step's
     kernels in every step, the frac plane's three times a step),
     bits_per_param must be finite and lower than at step 16, and the test
     views' PSNR must exceed RATE_PSNR_MIN.  At step 16
     and at the end, one whole rate estimate's gradients (the four tables, the
     context MLPs) through the kernels are held against the same estimate
     through the twins on the card in float64, beside the float32 twins' own
     distance from it (check_rate_gradient).  One more step runs under
     torch.profiler (chiprun_out/profile_rate.txt).  A three-step run with
     `pn_frac_grad=True` drives the frac plane's backward kernel, which
     the default configuration does not reach.  After each of these rate
     phases the word segment_mean sets when live ids decrease must be clear;
     [dp] the data-parallel path at full width: [K7p] on the rate run's
     planes split over 2, 4 and 8 ranks (DP_WORLD_SIZES), sampled and
     unsampled, the partials and divisors torch.equal to the twin's (every
     rank at W = 2, the first and the last at 4 and 8) and every rank's
     partial summed and finished torch.equal to K7's plane, [K7pb] within
     K7B_REL_TOL of the twin in float64 (the same ranks), rank 0's share
     timed (ms, device ms, bound, index_add_; the plain once, at W = 2);
     a group of one rank
     over NCCL: one step's gradients within DP_GRAD_TOL of each parameter's
     largest entry of the single-card trainer's on the same injected
     jitter and windows, then DP_STEPS steps from a fresh start (finite,
     the rate lower at the end than at step 16, every rate kernel launched,
     K7p not, ms per step beside [rate]'s); two ranks sharing the card over
     gloo, two processes (`chip_smoke.py --dp-rank R DIR`, their files in
     chiprun_out/dp/; started with the phase, they import and load the
     kernels, then wait for the one-rank run to end before they touch the
     card), build_entropy(cfg, 2), DP2_STEPS steps with the
     replicas checked bit-equal after every step, at DP_PLAIN_AT rank 0's
     all-reduced gradients within DP_GRAD_TOL of `dp_step_plain`'s from the
     same state and draws, K7p three times a rate step and K7 never, then
     two `pn_frac_grad` steps with K7pb three times a step; the children
     joined with a deadline and their exit codes checked;
 10. [codec] the lambda = 2e-3 run's binarized tables through the codec, with
     the counts set to 0 just before it: `refresh_cache_int`; the codec
     kernels held to their twins with torch.equal ([int_ctx_pool], the fused
     pool, twice, and [K9c] the same pool finished in its own launch
     (int_ctx_pool_pq: pq, covered, sign bits) against the pool's twin then
     K9c's, twice, on the middle chunk of the last 3D context level and on
     the last 2D context level with its plane, [K7i] pn_hist_int on one
     plane; their launches taken out of the counts; the pool's ms, device
     ms, its bound and the replaced kernels' bounds; the finish's device ms
     over the unfinished pool's); `CNCCodec.encode` into chiprun_out/bundle/
     and `decode` in the same process, with every codec kernel launched in
     each, int_ctx_pool once a pool, every pool finished in that launch (no
     launch of K9c's own) and pulled to the host in one copy; the encode's
     pools replayed for one pass's pool device ms; the decoded tables must
     equal the trained ones on every covered entry and be +1 elsewhere, the
     coded MB must lie within 15% of the analytic MB, and the test views'
     PSNR must move by at most 1e-3 dB; then `save_bundle` and
     `decode_bundle` in a fresh python3 process, whose tables and render of
     test view 0 must equal this process's;
 11. [bundles] cnc_tpu's committed bundles (BUNDLES: runs_20k's, the two
     of runs_depth10k and the 1920x1080 tanks run's) through `decode_bundle`
     on the card, each stream's sha256 checked by the decode, test view 0
     (of the 256x256 `blocks` test set; for the tanks bundle its own scene's,
     drawn in memory by tools/torch_tanks_view.py) through `render_image`,
     its PSNR within BUNDLE_DB of the port's CPU figure and the TPU's record
     printed beside it; decode and render seconds and their launches logged;
 12. [breadth] the single-card modules beside the main path, at full width,
     each held to the same inputs on the CPU in this process: K1s/K2s (the
     encode masked by the summed-area table of the [train] phase's 128^3
     occupancy grid) at grid_3d over 327,680 points and on the xy plane
     with the grid projected along z, driven through `grid_encode(
     occ_binary=)` forward and backward with the counts set to 0 just
     before and read just after (one sources launch a forward, which the
     backward reuses), then the sources kernel equal to its twin, the
     forward bit-equal to its twin and the backward within K2_REL_TOL of
     max |d_table|, with ms, device ms and bound, the forward also with its
     sources' launch, and K1/K2 with no mask on the same points (the
     floor under the mask); a `ModelConfig(unbounded=True)` trainer 200 steps at lambda
     = 0 (finite losses, the train-batch PSNR of steps 150-199 above that of
     0-49, the training kernels launched; SectionTimers); `propnet_sampling`
     over 4,096 rays (levels of 128 and 64 samples, 32 final; the
     deterministic run within PROP_TOL of the CPU's, both stratified settings,
     finite prop_loss); the vanilla NeRF (8x256, 65,536 points) and NDR
     (16,384 points with times), outputs within MLP_REL_TOL of the CPU's,
     gradients in norm and against the field in float64 (check_mlp_field);
     LPIPS on an 800x800 pair with synthetic weights within LPIPS_REL_TOL;
     the lens undistortion on 2^20 points within UNDISTORT_TOL;
 13. [pipeline] the configuration of cnc_tpu's recorded 2,000- and 20,000-step
     rows at full width (PIPE_*): `Trainer.fit` to step 199 with a
     checkpoint every 100 steps (ms per step over steps 150-199, the save's
     seconds and MB); a fresh python3 process (`chip_smoke.py
     --pipeline-resume DIR`) builds the Trainer, which resumes from the file
     at step 100 with the field equal to it, and runs
     `driver.run_with_trainer` to step 299 (evaluation, encode, decode,
     evaluation, MLP quantization) and `append_result_row`, with the counts
     set to 0 before the entropy model's build and read after; the row must
     have runs_20k's 23 columns, psnr_codec lie within PIPE_CODEC_DB of psnr,
     the coded MB within 15% of the analytic, and every kernel of the path
     have launched; then `python3 -m cnc_torch.cli nerf_synthetic
     --decode_only` in a third process must read the row's psnr_codec within
     PIPE_CLI_DB; the order-fault words clear in both processes;
 14. print the kernels line (each kernel's `pipeline_launches` from the
     resumed process; K7p's and K7pb's `launches` from [dp]'s two-rank run
     and its pn_frac_grad steps; also written to chiprun_out/kernels.json,
     and every log line to chiprun_out/smoke_log.txt), the seconds each
     phase took ([phases]), the card line and the final JSON line.

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

T_IMPORT = time.time()       # when this process read the script

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
RATE_STEPS = 800            # total steps of the lambda > 0 run (800 holds the time limit)
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
# [bundles]: cnc_tpu's committed bundles, each decoded on the card and test
# view 0 of the 256x256 blocks test set rendered as tools/rd_sweep_depth.py
# scored it, held within BUNDLE_DB of the PSNR the port's plain path reads on
# the CPU (`tools/torch_codec_ab.py psnr BUNDLE cpu`: 37.62525939941406 and
# 36.66496276855469 for the runs_depth10k pair), with the TPU's record
# printed beside it.  runs_20k's CPU figure, 40.09655 dB, is also what
# cnc_tpu's own decode and render on JAX's CPU backend read (40.09657).
# The tanks bundle (cnc_tpu's 800-step 1920x1080 NSVF run) is held on its own
# scene's test view 0, drawn in memory by tools/torch_tanks_view.py as the
# loader would read it; its CPU figure, 25.320985794067383, comes from
# `python3 tools/torch_tanks_view.py psnr cpu --procs 8` (on the H100
# machine's CPU: a 114 s decode and a 1,209 s render), and the TPU's record
# is the mean of its test views (runs_tanks/results/TanksAndTemple/
# output.txt), printed beside it and not held.
BUNDLES = {   # tag: (bundle, the port's CPU PSNR of view 0, the TPU's record, the view)
    "bundle 20k": ("runs_20k/bitstreams/l0.002_k4", 40.09655, 40.0573, "blocks"),
    "bundle depth10k l0.002": ("runs_depth10k/bitstreams/l0.002_k4", 37.62526, 37.6302,
                               "blocks"),
    "bundle depth10k l0.0007": ("runs_depth10k/bitstreams/l0.0007_k4", 36.66496, 36.6773,
                                "blocks"),
    "bundle tanks": ("runs_tanks/bitstreams/Spheres", 25.32099, 25.2352, "tanks"),
}
BUNDLE_DB = 0.01
# [breadth]: the proposal sampler's edges and weights against its CPU run
# (max abs; the deterministic run, uniform in t, edges in [0.1, 5]), the MLP
# fields' outputs and LPIPS (relative to the largest value) and their
# gradients (in norm, see check_mlp_field), the undistorted coordinates (max
# abs, in [-0.7, 0.7])
PROP_TOL, MLP_REL_TOL, LPIPS_REL_TOL, UNDISTORT_TOL = 1e-5, 1e-4, 1e-4, 1e-5
# [pipeline]: the configuration of cnc_tpu's recorded 2,000- and 20,000-step
# rows (tools/overnight_r5.sh:47-51, tools/rd_sweep_depth.py:127-151; the
# config in runs_20k/bitstreams/l0.002_k4/meta.json) at full width.  The
# parent trains steps 0-199 with a checkpoint every 100 steps; a fresh process
# resumes from the file (step 100: a checkpoint records the step whose update
# it follows, and the resumed run takes that step again, as in cnc_tpu) and
# runs the pipeline to step 299 under the CLI's default scene name, so the
# CLI's --decode_only finds the bundle.
PIPE_STEPS = 200
PIPE_CKPT_EVERY = 100
PIPE_END = 299
PIPE_EVAL_IMAGES = 2
PIPE_SCENE = "chair"
PIPE_CODEC_DB = 0.05        # |psnr_codec - psnr| (tests/test_pipeline.py:80)
PIPE_CLI_DB = 0.01          # the CLI's decode against the row's psnr_codec
PIPE_CODED_REL = 0.15       # coded MB against the analytic MB
PIPE_ROW_REFERENCE = "runs_20k/results/Procedural_depth/output.txt"
# [dp]: the data-parallel path.  K7p on the rate run's plane split over each
# W of DP_WORLD_SIZES; a group of one rank over NCCL (one step against the
# trainer without a group, then DP_STEPS steps); two ranks sharing the card
# over gloo, DP2_STEPS steps, dp_step_plain at step DP_PLAIN_AT.  Gradients
# against each other within DP_GRAD_TOL of each parameter's largest entry
# (K2's float atomics: no two runs are bit-equal).
DP_WORLD_SIZES = (2, 4, 8)
DP_STEPS = 100
DP2_STEPS = 32
DP_PLAIN_AT = 16
DP_GRAD_TOL = 1e-5
DP2_TIMEOUT_S = 400


LOG_FILE = Path("chiprun_out") / "smoke_log.txt"   # every log line, also past the output's tail


def log(msg: str) -> None:
    print(msg, flush=True)
    if LOG_FILE.parent.is_dir():
        with LOG_FILE.open("a") as fh:
            fh.write(msg + "\n")


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
    plain_kw = {k: v for k, v in kw.items() if k not in ("occ_bits", "sat_src")}
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
    n_bytes, n_flops = sat_work(torch, kw, n_bytes, n_flops, pts, res, offs, enc)
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


def sat_work(torch, kw, n_bytes, n_flops, pts, res, offs, enc):
    """K1s/K2s's share of the bound.  On given sources (`sat_src`, what the
    kernel alone reads): each word of the coarse levels' bits that a corner
    off the border reads, once (4 bytes), each 64-bit window of the
    occupancy rows that a fine (point, level) reads, once (8 bytes), and
    each fine (point, level)'s two footprint boxes an axis (6 operations
    each); the summed-area table is the sources launch's input, charged to
    it (`check_sat_sources`).  Without `sat_src` (the whole call, sources
    included, a function of the table): the table ((Rb+1)^D int32) read
    once, and for each corner off the border the footprint box (6
    operations an axis) and its 2^D-term inclusion-exclusion sum."""
    sat = kw.get("occ_sat")
    if sat is None:
        return n_bytes, n_flops
    d = pts.shape[1]
    if kw.get("sat_src") is None:
        gs, _ = enc._corner_sets(pts, res, offs)  # unmasked: the corners the kernel tests
        inside = ~((pts < 0.0) | (pts > 1.0)).any(dim=-1)
        tested = sum(int(((g != 0) & inside[:, None]).sum()) for g in gs)
        del gs
        return n_bytes + sat.numel() * 4, n_flops + tested * (6 * d + 2 ** d)
    rb = sat.shape[0] - 1
    nw = (rb + 31) // 32
    moffs = enc._sat_layout(d, tuple(int(r) for r in res), rb)[0]
    p = pts[~((pts < 0.0) | (pts > 1.0)).any(dim=-1)]
    words, windows, fine_pairs = [], [], 0
    for r, moff in zip(res, moffs):
        r = int(r)
        pg = torch.floor(p * float(r - 2) + 0.5).to(torch.int64)
        up = torch.clamp(pg + 1, max=r - 1)
        if moff >= 0:
            for k in range(2 ** d):
                cc = [up[:, ax] if (k >> ax) & 1 else pg[:, ax] for ax in range(d)]
                flat, valid = cc[0], (cc[0] != 0) & (cc[0] != r - 1)
                for ax in range(1, d):
                    flat = flat * r + cc[ax]
                    valid &= (cc[ax] != 0) & (cc[ax] != r - 1)
                words.append(torch.unique((moff + flat[valid]) >> 5))
            continue
        fine_pairs += p.shape[0]
        lo0, hi0 = enc.sat_ops.footprint_box(pg, r, rb)
        lo1, hi1 = enc.sat_ops.footprint_box(up, r, rb)
        base = torch.minimum(lo0, lo1).to(torch.int64)
        span = torch.maximum(hi0, hi1).to(torch.int64) - base
        word = base[:, d - 1] >> 5
        for a in range(4):
            for b in range(4 if d == 3 else 1):
                ok = (a <= span[:, 0]) & ((b <= span[:, 1]) if d == 3 else True)
                row = ((base[:, 0] + a) * rb + base[:, 1] + b) if d == 3 else base[:, 0] + a
                windows.append(torch.unique((row * nw + word)[ok]))
    n_words = torch.unique(torch.cat(words)).numel() if words else 0
    n_windows = torch.unique(torch.cat(windows)).numel() if windows else 0
    return n_bytes + n_words * 4 + n_windows * 8, n_flops + fine_pairs * 2 * 6 * d


def volrend_bound(n_valid: int, n_rays: int, prefix: bool, backward: bool = False):
    """K5's (backward: K5b's) bound on one buffer: each valid sample read
    once (sigma 4, rgb 12, t_mid 4, valid 1, ray_id 4; padding needs only its
    ray id and flag, left out), prefix_trans and each ray's outputs (K5b: its
    output gradients) once, K5b's 16 B of gradient a sample written once;
    16 operations a sample (K5b 40)."""
    per_sample = 25 + (16 if backward else 0)
    n_bytes = n_valid * per_sample + n_rays * (20 + (4 if prefix else 0)) + 4
    return bound_ms(n_bytes, n_valid * (40 if backward else 16))


def footprint_bound(cops, occ, resolution: int, with_overlap: bool):
    """K8's bound for one launch: the occupancy read once, one bool (and the
    overlap's float) written per corner; per occupied-box cell one operation
    for the mask, about 10 for the overlap (a multiply-add per axis)."""
    d, n = occ.dim(), resolution ** occ.dim()
    bd = cops.footprint_bounds(resolution, occ.shape[0])
    cells = float((bd.hi.astype("int64") - bd.lo + 1).sum()) ** d
    return bound_ms(occ.numel() + n * (5 if with_overlap else 1),
                    cells * (10 if with_overlap else 1))[0]


def bound_ms_int(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_codec_kernels(torch, intctx, entropy, codec, ip, sign3, sign2, cache, pg3, pg2):
    """The pool (int_ctx_pool), the pool finished by K9c in its launch
    (int_ctx_pool_pq) and K7i against their twins on the card, torch.equal
    (the pools twice, the second run equal to the first): one
    chunk of the last 3D context level (its middle chunk), the last 2D
    context level of the xy plane with its frac plane, and that plane (K7i).
    The pool's bound is counted for what it needs (the kept rows' encode and
    MLP, every row's id and mask byte) and, beside it, as the two kernels it
    replaced were charged (every row encoded, the features written and read
    back)."""
    import numpy as np
    records, log_parts = {}, {}
    k = entropy.cfg.max_context_layer_num
    f = entropy.cfg.n_features
    per = {name: [] for name in ("int_ctx_pool", "int_pq", "pn_hist_int")}

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
    k7i = lambda: intctx._frac_plane_cuda(*args)
    records["pn_hist_int"] = dict(max_abs_err=0.0, ms=time_ms(k7i), device_ms=device_ms(k7i),
                                  plain_ms=time_ms(lambda: intctx.int_frac_plane(*args), iters=5,
                                                   warmup=1),
                                  bound_ms=b, bound_by=by, library_ms=time_ms(library))
    log_parts["pn_hist_int"] = (f"rows={rows} listed={n_valid} distinct_entries={n_entries}"
                                f" bins={bins} plane={entropy.pn_res}^2")
    del ind, bin_of_row

    # ---- one 3D chunk and one 2D level through int_ctx_pool -> K9c
    l3 = entropy.ctx_levels_3d[-1]
    chunk_e, n_chunks, w3 = codec.chunks3d[l3]
    start = codec._chunk_bounds(l3)[n_chunks // 2][2]
    pos, slots, evals = entropy._entry_rows("3d", l3, start, chunk_e, w3, "pos_flat")
    r3 = entropy.tables3d[l3].resolution
    lv3 = entropy._ctx_levels_meta(entropy.spec3, entropy.mask3d_offsets, l3 - k, l3)
    l2 = entropy.ctx_levels_2d[-1]
    t2 = entropy.tables2d[l2]
    coords, slots2, evals2 = entropy._entry_rows("2d", l2, 0, t2.n_entries, t2.n_points,
                                                 "coords")
    lv2 = entropy._ctx_levels_meta(entropy.spec2, entropy.mask2d_offsets,
                                   l2 - min(l2, k), l2)
    cases = {
        "3D": dict(pool=(ip, None, pos, slots, start, chunk_e, r3, cache["mask3d"],
                         entropy.mask3d_offsets[l3], sign3, lv3, pg3, codec.m_shift3[l3], None,
                         cache["ovl_int"][str(l3)]),
                   pq=(codec.m_scale3[l3], sign3, entropy.tables3d[l3].offset, evals),
                   label=f"level {l3} chunk {n_chunks // 2} of {n_chunks}"),
        "2D": dict(pool=(ip, l2, coords, slots2, 0, t2.n_entries, t2.resolution,
                         cache["mask2d"][0], entropy.mask2d_offsets[l2], sign2, lv2, pg2,
                         codec.m_shift2[l2], (plane, entropy.pn_res, entropy.pn_mask_offset),
                         None),
                   pq=(codec.m_scale2[l2], sign2, t2.offset, evals2),
                   label=f"xy level {l2} with its plane"),
    }
    mlp_ops = lambda lv: sum(2 * ly["w"].shape[0] * ly["w"].shape[1] + ly["w"].shape[1] * 3
                             for ly in intctx._mlp_layers(ip, lv))
    for key, c in cases.items():
        _, level, ids, _, _, n_e, rf_, mask, moff, sign, levels, _, _, pl, ovl = \
            c["pool"]
        got = intctx.int_ctx_pool(*c["pool"])
        intctx.raise_on_pool_faults(sign3.device)
        touched = {}
        same("int_ctx_pool", c["label"], got, intctx.int_ctx_pool_plain(*c["pool"],
                                                                         touched=touched))
        same("int_ctx_pool", c["label"] + ", a second run", intctx.int_ctx_pool(*c["pool"]), got)
        d = 3 if level is None else 2
        fa = sign.shape[1]
        n_rows = ids.numel()
        keep = mask[moff + intctx.lattice_index(ids, d, rf_)]
        kept = int(keep.sum())
        # the bound of the function the pool needs: every row's id and mask
        # byte; the kept rows' slots (and overlap weights), their corners'
        # distinct mask bytes and sign (and plane) rows; the weights, the
        # interpolation table and the sums once.  Operations: the kept rows'
        # encode (16 a corner, 2F a live corner) and MLP (2 a multiply-add, 3
        # an output)
        n_mask = torch.unique(torch.cat(touched["mask"])).numel() if touched.get("mask") else 0
        live = torch.cat(touched["rows"]) if touched.get("rows") else ids[:0]
        n_tbl = torch.unique(live).numel()
        n_plane = torch.unique(torch.cat(touched["plane_rows"])).numel() \
            if touched.get("plane_rows") else 0
        n_live = live.numel() + sum(t.numel() for t in touched.get("plane_rows", []))
        n_tab = (len(levels) + (pl is not None)) * rf_
        n_par = sum(t.numel() for ly in intctx._mlp_layers(ip, level) for t in ly.values())
        n_ovl = torch.unique(ids[keep]).numel() if ovl is not None else 0
        corners = (len(levels) + (pl is not None)) * 2 ** d
        b, by = bound_ms_int(n_rows * 5 + kept * 4 + n_ovl * 4 + n_mask
                             + (n_tbl + n_plane) * 4 * fa + (n_par + n_tab) * 4
                             + n_e * (fa + 1) * 4,
                             kept * (corners * 16 + mlp_ops(level) + 4 * fa) + n_live * 2 * fa)
        # the bounds of the two kernels this one replaced, as they were
        # counted: K9a encoded every row of the window and wrote its
        # features, K9b read them back
        every = {}
        feats = intctx._int_encode_plain(ids, d, rf_, sign, levels, mask, pl, touched=every)
        live_all = torch.cat(every["rows"]) if every.get("rows") else ids[:0]
        n_plane_all = torch.unique(torch.cat(every["plane_rows"])).numel() \
            if every.get("plane_rows") else 0
        b9a, _ = bound_ms_int(
            n_rows * 4 + (torch.unique(torch.cat(every["mask"])).numel() if every.get("mask")
                          else 0)
            + (torch.unique(live_all).numel() + n_plane_all) * 4 * fa + feats.numel() * 4,
            n_rows * len(levels) * 2 ** d * 16 + live_all.numel() * 2 * fa)
        b9b, _ = bound_ms_int(n_rows + kept * (feats.shape[1] * 4 + 4 + (4 if ovl is not None
                                                                           else 0))
                              + n_ovl * 4 + n_e * (fa + 1) * 4,
                              kept * (mlp_ops(level) + 4 * fa))
        del feats, every, live_all, touched, live
        kernel = lambda c=c: intctx.int_ctx_pool(*c["pool"])
        per["int_ctx_pool"].append(dict(
            max_abs_err=0.0, ms=time_ms(kernel), device_ms=device_ms(kernel),
            plain_ms=time_ms(lambda c=c: intctx.int_ctx_pool_plain(*c["pool"]), iters=3,
                             warmup=1),
            bound_ms=b, bound_by=by, library_ms=None, bound_two_kernels_ms=b9a + b9b, rows=n_rows,
            kept=kept, entries=n_e))
        intctx.raise_on_pool_faults(sign.device)
        log_parts.setdefault("int_ctx_pool", "")
        log_parts["int_ctx_pool"] += (
            f" {key} ({c['label']}): rows={n_rows} kept={kept} entries={n_e}"
            f" live_corners={n_live} distinct_rows={n_tbl + n_plane} mask_bytes={n_mask}"
            f" device_ms={per['int_ctx_pool'][-1]['device_ms']:.4f} bound_ms={b:.4f} ({by});"
            f" the two-kernel form's K9a + K9b bounds {b9a:.4f} + {b9b:.4f};")
        # K9c: the same pool finished in its launch, against the pool's
        # twin then K9c's twin, on the card
        m_scale, _, offset, evals = c["pq"]
        fin = c["pool"][:13] + (m_scale,) + c["pool"][13:] + (offset, evals)
        got_pq = intctx.int_ctx_pool_pq(*fin)
        intctx.raise_on_pool_faults(sign.device)
        msum, wsum = got
        pq_args = (msum, wsum, m_scale, sign, offset, evals)
        same("K9c", c["label"], tuple(got_pq), intctx._int_pq_plain(*pq_args))
        same("K9c", c["label"] + ", a second run", tuple(intctx.int_ctx_pool_pq(*fin)),
             tuple(got_pq))
        intctx.raise_on_pool_faults(sign.device)
        pulled = intctx.pull_probs(got_pq)
        np.testing.assert_array_equal(pulled[0], intctx.host_pq(
            msum.cpu().numpy(), wsum.cpu().numpy(), m_scale))
        lib = lambda: intctx.pq_int64(msum, wsum, m_scale)
        if not torch.equal(lib(), got_pq[0]):
            raise AssertionError("[K9c] the int64 formula differs from the kernel")
        b, by = bound_ms_int(n_e * (4 * fa + 4 + 4 + 4 * fa + 2 * fa + 1 + fa), n_e * fa * 8)
        finished = lambda: intctx.int_ctx_pool_pq(*fin)
        fin_device = device_ms(finished)
        per["int_pq"].append(dict(
            max_abs_err=0.0, ms=time_ms(finished), device_ms=fin_device,
            added_device_ms=fin_device - per["int_ctx_pool"][-1]["device_ms"],
            plain_ms=time_ms(lambda: intctx._int_pq_plain(*pq_args)), bound_ms=b, bound_by=by,
            library_ms=time_ms(lib)))
        intctx.raise_on_pool_faults(sign.device)
        sat = int((got_pq[0] == 65535).sum())
        one = int((got_pq[0] == 1).sum())
        log_parts.setdefault("int_pq", "")
        log_parts["int_pq"] += (f" {key}: entries={n_e} covered={int(got_pq[1].sum())}"
                                f" pq at 65535: {sat}, at 1: {one}; the finishing pool"
                                f" device_ms={fin_device:.4f}, over the pool alone"
                                f" {per['int_pq'][-1]['added_device_ms']:+.4f};")
        del got, got_pq, msum, wsum
    for name, recs in per.items():
        if recs:
            records[name] = dict(recs[0], other={k: recs[1].get(k) for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_two_kernels_ms",
                "added_device_ms")})
    for name, r in records.items():
        o = r.get("other")
        log(f"[{name}] exact; {log_parts[name].strip()} ms={r['ms']:.4f}"
            + (f" device_ms={r['device_ms']:.4f}" if r.get("device_ms") is not None else "")
            + f" plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
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


def check_compact_mask(torch, scatter_ops, mask, cap, label, device_ops=None):
    """K3 against its twin (torch.equal, the count equal) on one mask, timed
    beside its bound and `torch.nonzero`; `device_ops` is the device
    operations one compaction ran in the process's first profile
    (count_device_ops), logged and kept with the record."""
    n = mask.numel()
    src, count = scatter_ops._compact_cuda(mask, cap)
    want_src, want_count = scatter_ops._compact_plain(mask, cap)
    torch.cuda.synchronize()
    if not (torch.equal(src, want_src) and int(count) == int(want_count)):
        raise AssertionError(f"K3 {label} n={n} cap={cap}: kernel and twin differ")
    # bytes: the mask read once, src written once, the count
    n_bytes = n + cap * 4 + 4
    b, by = bound_ms(n_bytes, n)
    rec = dict(max_abs_err=0.0, ms=time_ms(lambda: scatter_ops._compact_cuda(mask, cap)),
               device_ms=device_ms(lambda: scatter_ops._compact_cuda(mask, cap)),
               plain_ms=time_ms(lambda: scatter_ops._compact_plain(mask, cap), iters=5),
               bound_ms=b, bound_by=by,
               library_ms=time_ms(lambda: torch.nonzero(mask)[:cap]), n=n, cap=cap,
               count=int(count), device_ops=device_ops)
    log(f"[K3 compact, {label}] n={n} cap={cap} count={int(count)} exact ms={rec['ms']:.4f}"
        f" device_ms={rec['device_ms']:.4f} plain_ms={rec['plain_ms']:.4f}"
        f" library_ms={rec['library_ms']:.4f} bound_ms={b:.5f}"
        + ("" if device_ops is None else f" device operations per call {device_ops}"))
    return rec


# K3's call sites on the main path (cnc_torch), and the (n, cap) at which
# count_device_ops profiles one compaction of each: the 3D rate context
# (n as in the H100 runs of PERF.md), the pn coord lists, the occupancy
# update
K3_SITES = {"3D context": ("models/context_models.py:1026", 11_352_091, 1 << 21),
            "pn coord lists": ("models/context_models.py:598", 512 ** 3, 1 << 24),
            "occupancy": ("grids/occupancy.py:78", 128 ** 3, 128 ** 3)}
PACK_SITES = {"mask3d": (223_231_256,), "mask2d": (3, 1_400_336)}


def count_device_ops(torch, calls: dict) -> dict:
    """The device operations (kernels, memsets, copies) each call of `calls`
    (name -> fn, each warmed up first) runs, in ONE torch.profiler window:
    torch.profiler records every launch only in a process's first profile,
    so this runs before any other."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in calls.items():
            with record_function("ops_" + name):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    starts = sorted((min(e.time_range.start for e in events if e.name == "ops_" + name), name)
                    for name in calls)
    ops = {name: [] for name in calls}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith("ops_"):
            continue
        owner = [name for t, name in starts if t <= e.time_range.start]
        if owner:
            ops[owner[-1]].append(e.name)
    return ops


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


def check_walk_faults(volrend, dev, where: str) -> None:
    """The word K5/K5b's table pass sets when a sample buffer breaks their
    precondition (valid samples first in each ray, ids ascending) must be
    clear: every buffer the process composited so far kept it."""
    if volrend.walk_order_faults(dev):
        raise AssertionError(f"{where} a composite launch met a buffer that breaks its"
                             f" precondition")
    log(f"{where} the composite's order-fault word is clear")


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


def probe_inputs(torch, dev):
    """The probe's shapes and data (numpy seed 0, as tools/pallas_probe.py
    draws them): idx [N] int32, the [8, T] table, vals [N, 8]."""
    import numpy as np
    t, n = 1 << PROBE_LOG2_TABLE, PROBE_N
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, t, n, dtype=np.int32)).to(dev)
    tbl_t = torch.from_numpy(np.ascontiguousarray(
        rng.standard_normal((t, 8), np.float32).T)).to(dev)            # [8, T]
    vals = torch.from_numpy(np.ascontiguousarray(
        rng.standard_normal((8, n), np.float32).T)).to(dev)            # [N, 8]
    return idx, tbl_t, vals


def probe_times(torch, scatter_ops, idx, tbl_t, vals):
    """Each probe kernel's ms (CUDA events, with its wrapper), device ms, plain
    twin's and library call's ms (and the library's device ms), and bound, on
    the probe's inputs.  The bounds charge what the function must move,
    whatever implements it: lane_gather idx, out and each distinct column
    once; scatter_add idx and vals once, the table written once."""
    (rows, t), n, f = tbl_t.shape, idx.shape[0], vals.shape[1]
    idx64 = idx.long()
    calls = {"lane_gather": (lambda: scatter_ops._lane_gather_cuda(tbl_t, idx),
                             lambda: scatter_ops._lane_gather_plain(tbl_t, idx),
                             lambda: torch.index_select(tbl_t, 1, idx)),
             "scatter_add": (lambda: scatter_ops._scatter_add_cuda(vals, idx, t),
                             lambda: scatter_ops._scatter_add_plain(vals, idx, t),
                             lambda: torch.zeros(t, f, device=vals.device).index_add_(
                                 0, idx64, vals))}
    distinct = torch.unique(idx).numel()
    bounds = {"lane_gather": bound_ms(n * 4 + rows * n * 4 + distinct * rows * 4, 0),
              # every update adds f floats
              "scatter_add": bound_ms(n * 4 + f * n * 4 + t * f * 4, f * n)}
    out = {}
    for name, (kernel, plain, library) in calls.items():
        b, by = bounds[name]
        out[name] = dict(ms=time_ms(kernel, iters=10), device_ms=device_ms(kernel),
                         plain_ms=time_ms(plain, iters=10), bound_ms=b, bound_by=by,
                         library_ms=time_ms(library, iters=10),
                         other={"library_device_ms": device_ms(library),
                                "distinct_columns": distinct})
    return out


def check_probe(torch, kernels, scatter_ops, dev):
    """The two probe kernels at the probe's shapes and data.  Each is driven
    once through its public wrapper with the counts at 0, and that output is
    held against the twin's.  Returns (records, launch counts of the drive)."""
    idx, tbl_t, vals = probe_inputs(torch, dev)
    t, n = tbl_t.shape[1], idx.shape[0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    gathered = scatter_ops.lane_gather(tbl_t, idx)
    summed = scatter_ops.scatter_add(vals, idx, t)
    torch.cuda.synchronize()
    counts = {k: kernels.launches[k] for k in ("lane_gather", "scatter_add")}

    if not torch.equal(gathered, scatter_ops._lane_gather_plain(tbl_t, idx)):
        raise AssertionError("[probe] lane_gather differs from its twin")
    want = scatter_ops._scatter_add_plain(vals, idx, t)
    err = rel_err(summed, want)
    if not err <= SCATTER_REL_TOL:
        raise AssertionError(f"[probe] scatter_add: rel err {err} > {SCATTER_REL_TOL}")
    max_err = {"lane_gather": 0.0, "scatter_add": float((summed - want).abs().max())}
    width = scatter_ops.scatter_add_width(vals, summed)
    del gathered, summed, want
    recs = probe_times(torch, scatter_ops, idx, tbl_t, vals)
    recs["scatter_add"]["other"]["atomic_width"] = width
    for name, r in recs.items():
        r["max_abs_err"] = max_err[name]
        log(f"[probe {name}] table [8, {t}] idx {n} distinct {r['other']['distinct_columns']}"
            f" launches {counts[name]} max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f}"
            f" device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f}"
            f" library_ms={r['library_ms']:.4f}"
            f" library_device_ms={r['other']['library_device_ms']:.4f}"
            f" bound_ms={r['bound_ms']:.4f}")
    log(f"[probe scatter_add] atomics {width} floats wide")
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
    plain_kw = {k: v for k, v in kw.items() if k not in ("occ_bits", "sat_src")}
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
    n_bytes, n_flops = sat_work(torch, kw, n_bytes, n_flops, pts, res, offs, enc)
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


def check_volrend(torch, volrend, smp, n_rays, rgb, sig, pt, rcfg, label):
    """K5 against its twin on one sample buffer (max relative error within
    1e-4, visible counts equal), timed with its wrapper and by device ms;
    returns the kernel record fields."""
    args = (rgb, sig, smp, n_rays, rcfg.early_stop_eps, pt, rcfg.alpha_thre)
    comp = lambda: volrend._composite_cuda(*args)
    comp_plain = lambda: volrend._composite_plain(*args)
    a, b_ = comp(), comp_plain()
    torch.cuda.synchronize()
    err, rel = 0.0, 0.0
    for x, y in zip(a[:3], b_[:3]):
        diff = (x - y).abs()
        err = max(err, diff.max().item())
        rel = max(rel, (diff / y.abs().clamp(min=1e-3)).max().item())
    if not (rel <= 1e-4 and int(a[3]) == int(b_[3])):
        raise AssertionError(f"K5 {label}: max rel err {rel} > 1e-4 or visible counts"
                             f" differ ({int(a[3])} against {int(b_[3])})")
    n_valid = int(smp.valid.sum())
    b, by = volrend_bound(n_valid, n_rays, pt is not None)
    rec = dict(max_abs_err=err, ms=time_ms(comp), device_ms=device_ms(comp),
               plain_ms=time_ms(comp_plain), bound_ms=b, bound_by=by, library_ms=None,
               samples=n_valid, slots=smp.ray_id.shape[0], rays=n_rays)
    log(f"[K5 volrend {label}] slots={rec['slots']} valid={n_valid} rays={n_rays}"
        f" visible={int(a[3])} (the twin's too) max_abs_err={err:.3g}"
        f" max_rel_err={rel:.3g} ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f}"
        f" plain_ms={rec['plain_ms']:.4f} bound_ms={b:.5f}")
    return rec


def check_volrend_bwd(torch, volrend, smp, n_rays, rcfg, gen, label):
    """K5b against its twin (autograd of `_composite_plain`) on one sample
    buffer, and a second run bit-equal to the first; returns the kernel
    record fields."""
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
    got, again, want = kernel(), kernel(), twin()
    torch.cuda.synchronize()
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    if not max(errs) <= K5B_REL_TOL:
        raise AssertionError(f"[K5b] {label}: rel err {errs} > {K5B_REL_TOL}")
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"[K5b] {label}: two runs differ")
    n_valid = int(smp.valid.sum())
    b, by = volrend_bound(n_valid, n_rays, False, backward=True)
    rec = dict(max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
               ms=time_ms(kernel), device_ms=device_ms(kernel),
               plain_ms=time_ms(twin, iters=10), bound_ms=b, bound_by=by, library_ms=None,
               samples=n_valid, slots=n, rays=n_rays)
    log(f"[K5b volrend_bwd {label}] slots={n} valid={n_valid} rays={n_rays}"
        f" rel_err d_rgbs={errs[0]:.3g} d_sigmas={errs[1]:.3g} (limit"
        f" {K5B_REL_TOL}), two runs bit-equal; ms={rec['ms']:.4f}"
        f" device_ms={rec['device_ms']:.4f} plain_ms={rec['plain_ms']:.4f} bound_ms={b:.5f}")
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
    with torch.no_grad():
        sig = torch.empty(cap, device=dev).exponential_(1 / 40.0, generator=gen)
        rgb = torch.rand(cap, 3, generator=gen, device=dev)
        records["volrend_train"] = check_volrend(torch, volrend, got, bucket, rgb, sig, None,
                                                 cfg.render, "training march")
    k5b = {label: check_volrend_bwd(torch, volrend, smp, bucket, cfg.render, gen, label)
           for label, smp in (("training march", got), ("training march, half the rays",
                                                        padded))}
    records["volrend_bwd"] = dict(k5b["training march"],
                                  max_abs_err=max(v["max_abs_err"] for v in k5b.values()),
                                  sites=k5b)
    return records


def check_vertex_tables(torch, cops, entropy, dev):
    """K10 against its twins, exactly: the counting sort by entry on the
    hashed 108^3 level and on one 2D level (perm and inv), against the keys,
    a stable torch.sort and the fill on the card; the dense 80^3 level; then
    the finest level (514^3), the largest the build runs: count, scan,
    place and order timed beside the twin and a stable torch.sort of the
    same keys (whose indices are that level's pos_flat)."""
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
            perm, inv = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (perm_np, inv_np))
        args = (p["v"], d, p["r"], p["tbl"], p["e_max"], dev, tile, entropy.rb, perm, inv)
        got, again = cops.level_tables(*args), cops.level_tables(*args)
        twin = cops._level_tables_plain(*args)
        for k, v in twin.items():
            same = (torch.equal(got[k].reshape(-1), v.reshape(-1)) and torch.equal(again[k], got[k])
                    if isinstance(v, torch.Tensor) else got[k] == v == again[k])
            if not same:
                raise AssertionError(f"[K10] {k} differs from the twin on {p['kind']} r={p['r']}")
        log(f"[K10] {p['kind']} level {p['level']} (r={p['r']}, {p['v']} vertices,"
            f" {int(got['n_entries'])} entries, the longest {got['longest']}): tables exact"
            f" against the twin (keys, stable torch.sort, fill), two runs equal")
    pd = plans[("3d", 80)]
    perm = torch.from_numpy(threefry.permutation(1234 + pd["level"], pd["v"]).astype(np.int32))
    got, twin = cops.dense_level(perm.to(dev), pd["r"]), cops._dense_level_plain(perm, pd["r"])
    for k, v in twin.items():
        if not torch.equal(got[k].cpu(), v):
            raise AssertionError(f"[K10] dense level: {k} differs from the twin")
    del got, twin, again
    # timing at the finest level
    pf = plans[("3d", entropy.fine_res)]
    v, r, tbl, e_max = pf["v"], pf["r"], pf["tbl"], pf["e_max"]
    args = (v, 3, r, tbl, e_max, dev, 0, 0, None, None)
    keys = cops._vertex_keys_plain(v, 3, r, tbl, 0, 0, None, dev)
    kernel = lambda: cops.level_tables(*args)
    got, twin = kernel(), cops._level_tables_plain(*args)
    for k, t in twin.items():
        if not (torch.equal(got[k], t) if isinstance(t, torch.Tensor) else got[k] == t):
            raise AssertionError(f"[K10] {k} differs from the twin at the finest level")
    del twin
    sort = lambda: torch.sort(keys, stable=True)
    if not torch.equal(sort()[1].to(torch.int32), got["pos_flat"]):
        raise AssertionError("[K10] a stable torch.sort's indices differ from pos_flat")
    longest = got["longest"]
    del got
    # bytes: what any build must write, pos_flat and vert_entry (8 a
    # vertex) and cum and entry_values (8 an entry)
    b, by = bound_ms(8 * v + 8 * e_max, 0)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernel()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    rec = dict(max_abs_err=0.0, ms=time_ms(kernel, iters=5, warmup=1),
               device_ms=device_ms(kernel, iters=5),
               plain_ms=time_ms(lambda: cops._level_tables_plain(*args), iters=2, warmup=1),
               bound_ms=b, bound_by=by, library_ms=time_ms(sort, iters=3, warmup=1),
               longest=longest, level_peak_gib=peak)
    log(f"[K10 vertex_tables] finest level r={r}, {v} vertices, {e_max} entries (the longest"
        f" {longest}): count + scan + place + order ms={rec['ms']:.3f}"
        f" device_ms={rec['device_ms']:.3f} plain_ms={rec['plain_ms']:.3f} bound_ms={b:.3f};"
        f" a stable torch.sort of the same keys (the library's call) {rec['library_ms']:.3f};"
        f" the level's peak device memory {peak:.3f} GiB above its inputs")
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
    means, the level-probability gather, the frac planes, the encodes and
    the compactions): the wrappers
    are swapped for recorders while one rate estimate runs on the trainer's
    current tables, cache and freshly drawn windows.  The tables are made
    with their gradient, as a step makes them, so a recorded encode's table
    requires one where the step's backward runs K2v on it."""
    from cnc_torch.ops import scatter_ops
    calls = {"segment_mean": [], "segment_gather": [], "pn_frac_plane": [], "encode": [],
             "compact": []}
    originals = (cops.segment_mean, cops.segment_gather, cops.pn_frac_plane, enc._encode,
                 scatter_ops.compact_mask_indices)

    def recorder(key, fn):
        def wrapped(*args, **kw):
            calls[key].append((args, kw))
            return fn(*args, **kw)
        return wrapped

    cops.segment_mean = recorder("segment_mean", originals[0])
    cops.segment_gather = recorder("segment_gather", originals[1])
    cops.pn_frac_plane = recorder("pn_frac_plane", originals[2])
    enc._encode = recorder("encode", originals[3])
    scatter_ops.compact_mask_indices = recorder("compact", originals[4])
    try:
        tables = rf.quantized_tables(tr.field, tr.cfg.model)
        with torch.no_grad():
            starts = tr.entropy.draw_starts(tr.generator)
            tr.entropy.rate_estimate(tr.ent_params, tables, starts, tr._last_ent_cache)
    finally:
        (cops.segment_mean, cops.segment_gather, cops.pn_frac_plane, enc._encode,
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


def check_frac_planes(torch, kernels, cops, calls, gen, dev):
    """K7 on the three frac planes of one real rate step: each plane through
    the kernel equal to the plain plane (torch.equal); one plane's launches
    and allocations through the public wrapper; its backward (K7b, taken
    with pn_frac_grad) against the twin run in float64, the kernel alone
    and the whole autograd backward (the fill and the launch) timed."""
    planes = [(args[0].detach().contiguous(),) + tuple(args[1:]) for args, _ in
              calls["pn_frac_plane"]]
    for i, args in enumerate(planes):
        if not torch.equal(cops._pn_frac_plane_cuda(*args), cops._pn_frac_plane_plain(*args)):
            raise AssertionError(f"[K7] plane {i}: the frac plane differs from the twin's")
    args = planes[0]
    table, fine_offset, eidx, bounds, n, pn_res, sample_cap = args
    plane = lambda: cops.pn_frac_plane(*args)
    torch.cuda.synchronize()
    launched, key = dict(kernels.launches), "allocation.all.allocated"
    before = torch.cuda.memory_stats()[key]
    plane()
    allocations = torch.cuda.memory_stats()[key] - before
    launched = {k: v - launched[k] for k, v in kernels.launches.items() if v != launched[k]}
    if launched != {"pn_frac_plane": 1} or allocations != 1:
        raise AssertionError(f"[K7] a plane took launches {launched} and {allocations}"
                             f" allocations, not one each")
    # the rows the plane counts, for the bound and the library call
    sel, row_valid, bnd = cops._pn_rows(eidx, bounds, n, sample_cap)
    f, bins, rows = table.shape[1], bnd.shape[0] - 1, sel.shape[0]
    n_valid = int(row_valid.sum())
    n_entries = torch.unique(sel[row_valid]).numel()
    # bytes: an entry word a counted row, a table row a distinct entry, the
    # boundaries, the count and the plane written once; operations: a compare
    # a counted value, a divide a bin's value
    b, by = bound_ms(n_valid * 4 + n_entries * 4 * f + (bins + 1) * 4 + 4
                     + pn_res * pn_res * 4 * f, (n_valid + bins) * f)
    bin_of_row = (torch.searchsorted(bnd, torch.arange(rows, device=dev, dtype=torch.int32),
                                     right=True) - 1).clamp(0, bins - 1).long()
    ind = torch.where(row_valid[:, None], (table[fine_offset + sel.long()] > 0.9).float(), 0.0)
    library = lambda: torch.zeros(bins, f, device=dev).index_add_(0, bin_of_row, ind)
    pos = cops._pn_hist_plain(table, fine_offset, sel, row_valid, bnd)
    if not torch.equal(library(), pos):
        raise AssertionError("[K7] index_add_ of the indicator rows differs from the twin")
    records = {"pn_frac_plane": dict(
        max_abs_err=0.0, ms=time_ms(plane), device_ms=device_ms(plane),
        plain_ms=time_ms(lambda: cops._pn_frac_plane_plain(*args)), bound_ms=b, bound_by=by,
        library_ms=time_ms(library), launches_per_plane=1, allocations_per_plane=allocations,
        planes_per_step=len(planes))}
    # K7b, the backward through autograd, against the twin's in float64: that
    # differences reverse cumulative sums over all rows, which float32 rounds
    # at 1e-3 of the result, so the float32 twin's own distance is printed
    cot = torch.randn(pn_res * pn_res, f, generator=gen, device=dev)
    leaf = table.clone().requires_grad_()
    out = cops.pn_frac_plane(leaf, *args[1:])
    (got_dt,) = torch.autograd.grad(out, leaf, cot, retain_graph=True)
    (want_dt,) = torch.autograd.grad(cops._pn_frac_plane_plain(leaf, *args[1:]), leaf, cot)
    leaf64 = table.double().requires_grad_()
    (exact_dt,) = torch.autograd.grad(cops._pn_frac_plane_plain(leaf64, *args[1:]), leaf64,
                                      cot.double())
    exact_dt = exact_dt.float()
    bwd_err, twin_err = rel_err(got_dt, exact_dt), rel_err(want_dt, exact_dt)
    if not bwd_err <= K7B_REL_TOL:
        raise AssertionError(f"[K7] backward rel err {bwd_err} > {K7B_REL_TOL}")
    del leaf64
    # the library's yardstick: index_add_ of each row's scaled indicator row
    cnt = (bnd[1:] - bnd[:-1]).float()[:, None]
    g_bins = cot.reshape(pn_res, pn_res, f)[1:-1, 1:-1].transpose(0, 1).reshape(-1, f) / (
        cnt + 1e-6)
    flat = ((fine_offset + sel.long())[:, None] * f
            + torch.arange(f, device=dev)[None, :]).reshape(-1)
    vals = (g_bins[bin_of_row] * ind).reshape(-1)
    # bytes: the forward's reads, the gradient plane and d_table: a row a
    # distinct entry with a bit set (the kernel alone) or the whole table
    # written once (the backward: the fill and the launch); operations: a
    # compare a counted value, a divide a bin's value, an add a set bit
    n_set = torch.unique(sel[row_valid & (ind > 0).any(1)]).numel()
    reads = n_valid * 4 + n_entries * 4 * f + (bins + 1) * 4 + 4 + pn_res * pn_res * 4 * f
    n_ops = (n_valid + bins) * f + int(ind.sum())
    kb, _ = bound_ms(reads + n_set * 4 * f, n_ops)
    bb, bby = bound_ms(reads + table.numel() * 4, n_ops)
    d_table = torch.zeros_like(table)
    kernel = lambda: cops._pn_hist_backward_launch(table, fine_offset, eidx, bounds, n, pn_res,
                                                   sample_cap, cot, d_table)
    whole = lambda: torch.autograd.grad(out, leaf, cot, retain_graph=True)
    records["pn_hist_bwd"] = dict(
        max_abs_err=float((got_dt - exact_dt).abs().max()), ms=time_ms(whole, iters=10),
        device_ms=device_ms(whole), kernel_device_ms=device_ms(kernel),
        fill_device_ms=device_ms(lambda: torch.zeros_like(table)),
        plain_ms=time_ms(lambda: torch.autograd.grad(
            cops._pn_frac_plane_plain(leaf, *args[1:]), leaf, cot), iters=5, warmup=1),
        bound_ms=bb, bound_by=bby, kernel_bound_ms=kb,
        library_ms=time_ms(lambda: torch.zeros(table.numel(), device=dev).index_add_(
            0, flat, vals), iters=10))
    del d_table
    r, rb = records["pn_frac_plane"], records["pn_hist_bwd"]
    log(f"[K7 pn_frac_plane] {len(planes)} planes in the step, each equal to the twin's;"
        f" pn_res={pn_res} F={f} sample_cap={sample_cap} rows={rows} counted={n_valid}"
        f" bins={bins} distinct_entries={n_entries}; one plane: {r['launches_per_plane']}"
        f" launch, {allocations} allocation, ms={r['ms']:.4f} device_ms={r['device_ms']:.4f}"
        f" plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (index_add_ of the"
        f" indicator rows: the counts alone) bound_ms={b:.5f} ({by}); backward (K7b) rel_err"
        f" {bwd_err:.3g} against the twin in float64 (limit {K7B_REL_TOL}; the float32 twin"
        f" against it {twin_err:.3g}); the whole autograd backward ms={rb['ms']:.4f}"
        f" device_ms={rb['device_ms']:.4f} bound_ms={bb:.5f} ({bby}), its fill device_ms="
        f"{rb['fill_device_ms']:.4f}, the kernel alone device_ms={rb['kernel_device_ms']:.4f}"
        f" bound_ms={kb:.5f} ({n_set} entries with a bit set); library_ms="
        f"{rb['library_ms']:.4f} (zeros and index_add_ of the scaled indicator rows)"
        f" plain_ms={rb['plain_ms']:.4f}")
    return records


def frac_plane_backward(torch, cops, dev):
    """One whole autograd backward of a sampled frac plane (K7b), for its
    device operations in the process's first profile: a seeded bin-sorted
    list of 50,000 rows in 2^16 over 64^2 bins, 2^13 sampled, F 4."""
    gen = torch.Generator(device=dev).manual_seed(12)
    pn_res, cap, n, fine_offset, fine = 66, 1 << 16, 50_000, 37, 4096
    n_bins = (pn_res - 2) ** 2
    bins = torch.sort(torch.randint(0, n_bins, (n,), generator=gen, device=dev))[0]
    bins = torch.cat([bins, torch.full((cap - n,), n_bins, device=dev)])
    bounds = torch.searchsorted(bins, torch.arange(n_bins + 1, device=dev)).to(torch.int32)
    eidx = torch.randint(0, fine, (cap,), generator=gen, device=dev, dtype=torch.int32)
    table = torch.where(torch.rand(fine_offset + fine, 4, generator=gen, device=dev) > 0.4,
                        1.0, -1.0).requires_grad_()
    with torch.enable_grad():
        out = cops.pn_frac_plane(table, fine_offset, eidx, bounds,
                                 torch.tensor(n, dtype=torch.int32, device=dev), pn_res, 1 << 13)
    cot = torch.randn(out.shape, generator=gen, device=dev)
    return lambda: torch.autograd.grad(out, table, cot, retain_graph=True)


def check_rate_kernels(torch, tr, rf, cops, enc, gen):
    """K6, K6m, K3, K7 (check_frac_planes), K1v and K2v against their twins at the shapes of one
    real rate step of the trainer."""
    from cnc_torch import kernels
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

    # ---- K7: the step's three frac planes
    records.update(check_frac_planes(torch, kernels, cops, calls, gen, dev))

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


def check_pack(torch, enc, cache, device_ops):
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
                         bound_ms=b, bound_by=by, library_ms=None,
                         device_ops=device_ops[f"pack {key}"])
        r = recs[key]
        log(f"[pack {key}] {tuple(mask.shape)} bools ({mask.numel() / 2**20:.1f} MiB) into"
            f" {got.numel() * 4 / 2**20:.2f} MiB of words, exact ms={r['ms']:.4f}"
            f" device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={b:.4f};"
            f" device operations per call {r['device_ops']}")
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
             (cops, "pn_frac_plane", cops._pn_frac_plane_plain),
             (enc, "_encode", lambda pts, table, res, offs, mask=None, moffs=None, bits=None,
              ids=None, n_calc=None, occ_binary=None, occ_sat=None:
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

    # the encode's pools are recorded as they are called, to be replayed for
    # their device time once the counts are read; the pulls of both passes
    # are counted
    pool_calls, pool, pull = [], intctx.int_ctx_pool_pq, intctx.pull_probs
    pulls = []

    def recording_pool(*args, **kw):
        pool_calls.append((args, kw))
        return pool(*args, **kw)

    def counting_pull(p):
        pulls.append(p.raw.numel())
        return pull(p)

    t0 = time.time()
    with swapped((intctx, "int_ctx_pool_pq", recording_pool), (intctx, "pull_probs", counting_pull)):
        pgs, est_mb, coded_mb = codec.encode(trr.ent_params, trained, occ_rate, str(bundle_dir),
                                             cache=cache_i)
        torch.cuda.synchronize()
    enc_s = time.time() - t0
    enc_pulls = len(pulls)
    enc_launches = {k: kernels.launches[k] - cache_launches[k] for k in kernels.launches}
    kernels.reset_launches()
    t0 = time.time()
    with swapped((intctx, "pull_probs", counting_pull)):
        rec = codec.decode(trr.ent_params, occ_rate, pgs, str(bundle_dir), cache=cache_i)
        torch.cuda.synchronize()
    dec_s = time.time() - t0
    dec_launches = dict(kernels.launches)
    codec_launches = {k: cache_launches[k] + enc_launches[k] + dec_launches[k]
                      for k in kernels.launches}
    codec_kernels = ("int_ctx_pool", "int_pq", "pn_hist_int")
    if not all(enc_launches[k] > 0 and dec_launches[k] > 0 for k in codec_kernels):
        raise AssertionError(f"[codec] a codec kernel was not launched: encode {enc_launches},"
                             f" decode {dec_launches}")
    # one pool launch per 3D chunk and per plane's 2D level that is not coded globally
    n_pools = (sum(codec.chunks3d[l][1] for l in entropy.ctx_levels_3d
                   if not codec._is_global_3d(l))
               + 3 * sum(not codec._is_global_2d(l) for l in entropy.ctx_levels_2d))
    if not (enc_launches["int_ctx_pool"] == dec_launches["int_ctx_pool"] == n_pools
            == len(pool_calls)):
        raise AssertionError(f"[codec] {n_pools} pools a pass, but int_ctx_pool launched"
                             f" {enc_launches['int_ctx_pool']} times in the encode and"
                             f" {dec_launches['int_ctx_pool']} in the decode")
    # K9c has no launch of its own: every pool launch finishes its entries
    # (int_pq counts those), and each pool reaches the host in one copy
    if not (enc_launches["int_pq"] == dec_launches["int_pq"] == n_pools
            and enc_pulls == len(pulls) - enc_pulls == n_pools):
        raise AssertionError(f"[codec] {n_pools} pools a pass, but {enc_launches['int_pq']} and"
                             f" {dec_launches['int_pq']} finishing launches and {enc_pulls} and"
                             f" {len(pulls) - enc_pulls} pulls in the encode and the decode")
    records["int_pq"].update(finishing_launches_per_pass=enc_launches["int_pq"],
                             pulls_per_pool=len(pulls) / (2 * n_pools))
    pool_ms = [device_ms(lambda a=a, kw=kw: intctx.int_ctx_pool_pq(*a, **kw), iters=3)
               for a, kw in pool_calls]
    intctx.raise_on_pool_faults(trr.device)
    del pool_calls
    records["int_ctx_pool"]["pass_device_ms"] = sum(pool_ms)
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
        + json.dumps({k: dec_launches[k] for k in codec_kernels})
        + f"; K9c in every pool's launch and none of its own, one copy to the host a pool"
        f" ({len(pulls)} pulls, {sum(pulls) / len(pulls):.0f} bytes on average)"
        + f"; one pass's {n_pools} finished pools {sum(pool_ms):.4f} device ms in all (the largest"
        f" {max(pool_ms):.4f}, the encode's calls replayed)")
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



def pipeline_config(out_dir: Path):
    """The recorded configuration, its checkpoint under out_dir."""
    import dataclasses
    from cnc_torch.config import CNCConfig, EntropyConfig, ModelConfig, RenderConfig, TrainConfig
    return CNCConfig(
        model=ModelConfig(),
        entropy=EntropyConfig(sample_num=100000, ctx_grad=False, v_ctx_cap=1 << 20),
        render=dataclasses.replace(RenderConfig(), sample_budget=65536),
        train=dataclasses.replace(TrainConfig(), lmbda=2e-3, rate_update_interval=4,
                                  init_batch_size=1024, min_ray_bucket=1024,
                                  max_ray_bucket=1024, target_sample_batch_size=65536,
                                  checkpoint_every=PIPE_CKPT_EVERY,
                                  checkpoint_path=str(out_dir / "ckpt.npz")))


def pipeline_datasets(dev):
    """tools/rd_sweep_depth.py's datasets: 24 train and 8 test views of
    `blocks` at 256x256 (the CLI's procedural fallback too)."""
    from cnc_torch.data import scenes
    return (scenes.ProceduralDataset("blocks", 24, 256, 256, "train", device=dev),
            scenes.ProceduralDataset("blocks", 8, 256, 256, "test", device=dev))


# the kernels the pipeline launches at the recorded configuration: the
# training step's, the rate's, the table build's and the codec's.  Its
# ctx_grad is off, so the context lookups are constants of the rate graph and
# K1v's backward (K2v) is not on the path.
PIPE_KERNELS = ("grid_encode", "grid_encode_bwd", "march", "volrend", "volrend_bwd", "compact",
                "grid_encode_v", "segment_pool", "segment_pool_bwd", "segment_mean",
                "segment_mean_bwd", "pn_frac_plane", "footprint", "pack_mask_bits",
                "vertex_tables", "int_ctx_pool", "int_pq", "pn_hist_int")


def pipeline_resume(out_dir: str) -> int:
    """The fresh process of [pipeline]: build the Trainer (it resumes from
    the checkpoint), check the resumed state against the file, run the
    pipeline to PIPE_END with the counts set to 0 just before the entropy
    model's build and read just after, append the TSV row, and print the
    result as one JSON line."""
    import dataclasses
    import numpy as np
    import torch
    from cnc_torch import kernels
    from cnc_torch.ops import context_ops as cops
    from cnc_torch.render import volrend
    from cnc_torch.train import driver
    from cnc_torch.train.trainer import Trainer
    from cnc_torch.utils import checkpoint as ckpt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = Path(out_dir)
    cfg = pipeline_config(out)
    train_set, test_set = pipeline_datasets(dev)
    kernels.lib()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    entropy = driver.build_entropy(cfg, device=dev)
    tr = Trainer(cfg, train_set, entropy=entropy)          # resumes in __init__
    torch.cuda.synchronize()
    ready_s = time.time() - t0
    with np.load(ckpt.norm_path(cfg.train.checkpoint_path), allow_pickle=False) as npz:
        saved_step = int(npz["step"])
        equal = all(np.array_equal(p.detach().cpu().numpy(), npz[f"params|{k}"])
                    for k, p in ckpt._named(tr.field).items())
        equal &= all(np.array_equal(p.detach().cpu().numpy(), npz[f"ent|{k}"])
                     for k, p in ckpt._named(tr.ent_params).items())
    resumed = dict(step=tr.step, saved_step=saved_step, equal=bool(equal),
                   lr=tr.optimizer.param_groups[0]["lr"], num_rays=tr.num_rays)
    if not (tr.step == saved_step == PIPE_CKPT_EVERY and equal):
        raise AssertionError(f"[pipeline] the resumed trainer is not the file's: {resumed}")
    logs = []
    res = driver.run_with_trainer(tr, test_set, PIPE_SCENE, out_root=str(out),
                                  max_steps=PIPE_END, max_eval_images=PIPE_EVAL_IMAGES,
                                  log_fn=logs.append, log_every=100)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    row = driver.append_result_row(res, PIPE_SCENE, "Procedural", str(out))
    check_order_faults(cops, dev, "[pipeline, resumed]")
    check_walk_faults(volrend, dev, "[pipeline, resumed]")
    log(f"[pipeline, resumed] step {resumed['step']} (the file's {saved_step}) to {tr.step - 1}:"
        f" psnr {res.psnr:.4f} psnr_codec {res.psnr_codec:.4f} ssim {res.ssim:.4f};"
        f" coded {res.embed_MB_codec:.4f} MB (analytic {res.embed_MB_est:.4f}), total"
        f" {res.total_size_MB():.4f} MB, {res.compression_x():.2f}x; train"
        f" {res.elapsed_train_s:.2f} s, encode {res.encode_s:.2f} s, decode {res.decode_s:.2f} s;"
        f" entropy model and resumed trainer {ready_s:.2f} s")
    print(json.dumps({"resumed": resumed, "ready_s": ready_s, "steps": tr.step,
                      "result": dataclasses.asdict(res), "total_MB": res.total_size_MB(),
                      "compression_x": res.compression_x(), "row": row, "launches": launches,
                      "log": logs[:3] + logs[-6:]}))
    return 0


def run_pipeline_phase(torch, kernels, volrend, cops, dev) -> dict:
    """[pipeline]: the recorded configuration trained to step 199 with a
    checkpoint at step 100 (its save timed, its size read); a fresh process
    resumes from the file and runs the pipeline (run_with_trainer to step
    299, evaluation, encode, decode, evaluation, MLP quantization, the TSV
    row); the row's width, its codec PSNR and coded size and the kernels'
    launches checked; then the CLI's --decode_only in a third process, its
    PSNR held to the row's.  Returns the resumed process's launch counts."""
    import shutil
    import numpy as np
    from cnc_torch.train import driver
    from cnc_torch.train.trainer import Trainer
    from cnc_torch.utils import checkpoint as ckpt
    out = Path("chiprun_out") / "pipeline"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cfg = pipeline_config(out)
    t0 = time.time()
    train_set, test_set = pipeline_datasets(dev)
    torch.cuda.synchronize()
    data_s = time.time() - t0
    kernels.reset_launches()
    t0 = time.time()
    entropy = driver.build_entropy(cfg, device=dev)
    tr = Trainer(cfg, train_set, entropy=entropy)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    ends, saves = [], []
    save = ckpt.save_checkpoint

    def timed_save(path, trainer):
        torch.cuda.synchronize()
        t = time.time()
        save(path, trainer)
        saves.append(time.time() - t)

    with swapped((ckpt, "save_checkpoint", timed_save)):
        tr.fit(PIPE_STEPS - 1, log_every=0,
               step_callback=lambda s, aux: ends.append((time.time(), aux.get("embed_MB"))))
    torch.cuda.synchronize()
    train_launches = dict(kernels.launches)
    ck = Path(ckpt.norm_path(cfg.train.checkpoint_path))
    size_mb = ck.stat().st_size / 2**20
    with np.load(ck) as npz:
        ck_step = int(npz["step"])
    ms_step = (ends[199][0] - ends[150][0]) / 49 * 1e3
    mb = [e[1] for e in ends if e[1] is not None]
    log(f"[pipeline] the recorded configuration (lambda {cfg.train.lmbda}, the rate every"
        f" {cfg.train.rate_update_interval} steps, ctx_grad off, {cfg.train.max_ray_bucket} rays,"
        f" sample budget {cfg.render.sample_budget}, v_ctx_cap {cfg.entropy.v_ctx_cap}):"
        f" datasets {data_s:.1f} s, entropy model and trainer {build_s:.2f} s; {PIPE_STEPS} steps,"
        f" {ms_step:.2f} ms per step over steps 150-199; estimated rate {float(mb[0]):.3f} MB at"
        f" step 0, {float(mb[-1]):.3f} at step {4 * (len(mb) - 1)}; checkpoint at step"
        f" {ck_step}: {len(saves)} save(s) of {saves[0]:.2f} s, {size_mb:.1f} MB;"
        f" launches {json.dumps({k: v for k, v in train_launches.items() if v})}")
    check_order_faults(cops, dev, "[pipeline]")
    check_walk_faults(volrend, dev, "[pipeline]")
    if len(saves) != 1:
        raise AssertionError(f"[pipeline] {len(saves)} checkpoint saves in {PIPE_STEPS} steps,"
                             f" not 1")
    del tr, entropy, train_set, test_set
    torch.cuda.empty_cache()

    t0 = time.time()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--pipeline-resume",
                           str(out)], capture_output=True, text=True, timeout=900)
    resume_s = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[pipeline] the resumed process failed:\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-8000:]}")
    lines = proc.stdout.strip().splitlines()
    child = json.loads(lines[-1])
    for line in lines[:-1]:
        log(line)
    res = child["result"]
    row = child["row"]
    want_cols = len(Path(PIPE_ROW_REFERENCE).read_text().splitlines()[0].split("\t"))
    launches = child["launches"]
    log(f"[pipeline] resumed process {resume_s:.1f} s in all; row ({len(row)} columns,"
        f" {PIPE_ROW_REFERENCE} has {want_cols}): {' '.join(row)}; launches"
        f" {json.dumps({k: v for k, v in launches.items() if v})}; its log: {child['log']}")
    if len(row) != want_cols:
        raise AssertionError(f"[pipeline] the row has {len(row)} columns, not {want_cols}")
    if not abs(res["psnr_codec"] - res["psnr"]) <= PIPE_CODEC_DB:
        raise AssertionError(f"[pipeline] the codec moved the psnr: {res['psnr']} ->"
                             f" {res['psnr_codec']}")
    if not abs(res["embed_MB_codec"] - res["embed_MB_est"]) <= PIPE_CODED_REL * res["embed_MB_est"]:
        raise AssertionError(f"[pipeline] coded {res['embed_MB_codec']} MB against the analytic"
                             f" {res['embed_MB_est']}")
    missing = [k for k in PIPE_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"[pipeline] kernels not launched in the pipeline: {missing}")

    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "cnc_torch.cli", "nerf_synthetic",
                           "--decode_only", "--out_root", str(out), "--max_eval_images",
                           str(PIPE_EVAL_IMAGES)], capture_output=True, text=True, timeout=600)
    cli_s = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[pipeline] the CLI's --decode_only failed:\n{proc.stderr[-8000:]}")
    got = [line for line in proc.stdout.splitlines() if line.startswith("decode_only: psnr=")]
    if len(got) != 1:
        raise AssertionError(f"[pipeline] the CLI printed no psnr:\n{proc.stdout}")
    cli_psnr = float(got[0].split("=")[1].split()[0])
    diff = cli_psnr - res["psnr_codec"]
    log(f"[pipeline] CLI --decode_only in {cli_s:.1f} s: {got[0]!r}; the row's psnr_codec"
        f" {res['psnr_codec']:.4f}, difference {diff:+.4f} dB (limit {PIPE_CLI_DB})")
    if not abs(diff) <= PIPE_CLI_DB:
        raise AssertionError(f"[pipeline] the CLI's decode reads {cli_psnr}, the row"
                             f" {res['psnr_codec']}")
    # the checkpoint (a few hundred MB) stays out of what the run brings back
    ck.unlink()
    return launches


def tanks_view():
    """tools/torch_tanks_view.py, imported from this checkout."""
    import importlib.util
    path = Path(__file__).resolve().parent / "tools" / "torch_tanks_view.py"
    spec = importlib.util.spec_from_file_location("torch_tanks_view", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_bundles(torch, kernels, volrend, dev) -> None:
    """[bundles]: decode each of cnc_tpu's committed bundles with the
    kernels (decode checks every stream's sha256 itself), render test view 0
    through render_image and hold its PSNR to the CPU figure; the counts are
    set to 0 just before each decode and each render and read just after."""
    from cnc_torch.data import scenes
    from cnc_torch.render import renderer
    from cnc_torch.train import driver
    from cnc_torch.utils import metrics
    test = scenes.ProceduralDataset("blocks", 8, 256, 256, "test", device=dev)
    views = {"blocks": test.image_and_rays(0)}
    for tag, (bundle, cpu_psnr, tpu_psnr, view) in BUNDLES.items():
        if cpu_psnr is None:
            raise AssertionError(f"[{tag}] no CPU figure to hold the card to")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        field, binaries, cfg = driver.decode_bundle(bundle, device=dev, log_fn=lambda m: None)
        torch.cuda.synchronize()
        decode_s = time.time() - t0
        decode_launches = {k: v for k, v in kernels.launches.items() if v}
        aabb = torch.tensor(cfg.render.aabb, dtype=torch.float32, device=dev)
        if view == "tanks":
            rays, gt, box, _ = tanks_view().view0(dev)
            if not torch.equal(aabb.cpu(), torch.from_numpy(box)):
                raise AssertionError(f"[{tag}] the bundle's box {cfg.render.aabb} is not the"
                                     f" scene's {box}")
        else:
            rays, gt = views[view]
        render = lambda: renderer.render_image(field, cfg.model, cfg.render, aabb, binaries,
                                               rays.origins, rays.viewdirs,
                                               torch.ones(3, device=dev), device=dev)
        render()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        rgb = render()[0]
        torch.cuda.synchronize()
        render_s = time.time() - t0
        render_launches = {k: v for k, v in kernels.launches.items() if v}
        psnr = float(metrics.psnr(rgb, gt))
        diff = psnr - cpu_psnr
        log(f"[{tag}] {bundle}: decode_bundle {decode_s:.2f} s (launches"
            f" {json.dumps(decode_launches)}); test view 0 ({gt.shape[1]}x{gt.shape[0]},"
            f" {view}) rendered in"
            f" {render_s:.3f} s (launches {json.dumps(render_launches)}), psnr {psnr:.5f} dB,"
            f" ssim {float(metrics.ssim(rgb, gt)):.6f}; the CPU plain path {cpu_psnr:.5f},"
            f" difference {diff:+.6f} dB (limit {BUNDLE_DB}); the TPU's record {tpu_psnr}")
        if not all(decode_launches.get(k, 0) > 0 for k in ("int_ctx_pool", "int_pq")):
            raise AssertionError(f"[{tag}] the decode did not go through the codec kernels:"
                                 f" {decode_launches}")
        if not all(render_launches.get(k, 0) > 0 for k in ("grid_encode", "march", "volrend")):
            raise AssertionError(f"[{tag}] the render did not go through the kernels:"
                                 f" {render_launches}")
        if not abs(diff) <= BUNDLE_DB:
            raise AssertionError(f"[{tag}] psnr {psnr} is {diff:+.6f} dB from the CPU's")
        check_walk_faults(volrend, dev, f"[{tag}]")
        del field, binaries


def synth_lpips_weights(np, plan, seed=0):
    """tests/test_lpips.py's synthetic VGG16 weights (He-scaled random
    convolutions, zero biases, uniform linear heads)."""
    rng = np.random.default_rng(seed)
    w, cin = {}, 3
    for i, (cout, _) in enumerate(plan):
        w[f"conv{i}_w"] = (rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
                           * np.sqrt(2.0 / (9 * cin)))
        w[f"conv{i}_b"] = np.zeros(cout, np.float32)
        cin = cout
    for j, c in enumerate([c for c, t in plan if t]):
        w[f"lin{j}_w"] = rng.random(c).astype(np.float32)
    return w


def max_rel(torch, got, want) -> float:
    """max |got - want| over max |want|, on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def check_sat_encode(torch, kernels, enc, sat_ops, rf, tr, gen, dev, records):
    """[breadth] K1s/K2s: the encode masked by the summed-area table of the
    [train] phase's 128^3 occupancy grid, at the default grid_3d over the
    training capacity's 327,680 points, and on the xy plane of grid_2d with
    that grid's projection along z.  The path (the public encode with
    `occ_binary`, forward and backward through autograd, 3D then 2D) runs
    with the counts set to 0 just before it and read just after: one
    sources launch a forward, which the backward reuses.  Then the sources
    kernel against its twin (equal), each kernel against its twin (the
    forward bit-equal, the backward within K2_REL_TOL of max |d_table|) on
    the sources it reads, with ms, device ms and bound; the forward also
    with its sources' launch (what one call costs), and K1 and K2 with no
    mask on the same points and table (the floor under the mask)."""
    cfg = tr.cfg
    occ = tr.occ_state.binaries
    occ2 = occ.any(dim=2).contiguous()          # projected along the xy plane's normal
    n = cfg.render.sample_capacity
    pts = torch.rand(n, 3, generator=gen, device=dev)
    tables = {k: v.detach() for k, v in rf.quantized_tables(tr.field, cfg.model).items()}
    sites = (("xyz", cfg.model.grid_3d, pts, occ), ("xy", cfg.model.grid_2d,
                                                    pts[:, [0, 1]].contiguous(), occ2))
    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = []
    for key, spec, p, grid in sites:
        leaf = tables[key].clone().requires_grad_()
        out = enc.grid_encode(p, leaf, spec, occ_binary=grid)
        out.backward(torch.ones_like(out))
        outs.append((out.detach(), leaf.grad))
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    if not (launches.get("grid_encode_s") == 2 and launches.get("grid_encode_s_bwd") == 2
            and launches.get("sat_mask_sources") == 2):
        raise AssertionError(f"[breadth] the SAT-masked encode did not go through its sources"
                             f" kernel once a forward and K1s/K2s: {launches}")
    log(f"[breadth K1s/K2s] path: grid_encode(occ_binary=) forward and backward, 3D and xy;"
        f" launches {json.dumps(launches)}; occupancy {int(occ.sum())}/{occ.numel()} cells,"
        f" projected {int(occ2.sum())}/{occ2.numel()}")
    counted = dict(kernels.launches)
    fwd, bwd, srcs = {}, {}, {}
    for (key, spec, p, grid), (out, _) in zip(sites, outs):
        sat = sat_ops.build_sat(grid)
        if not torch.equal(sat.cpu(), sat_ops.build_sat(grid.cpu())):
            raise AssertionError(f"[breadth] {key}: the table differs from the CPU's")
        if not bool(out.any()):
            raise AssertionError(f"[breadth] {key}: every corner was masked")
        src, srcs[key] = check_sat_sources(torch, enc, sat, spec.resolutions, key)
        fwd[key] = check_grid_encode(torch, enc, spec, tables[key], p, f"{key}, SAT-masked",
                                     name="K1s", occ_sat=sat, sat_src=src)
        whole = lambda: enc._encode_cuda(p, tables[key], spec.resolutions, spec.offsets,
                                         occ_sat=sat)
        fwd[key]["with_sources"] = dict(ms=time_ms(whole), device_ms=device_ms(whole))
        bwd[key] = check_grid_encode_bwd(torch, enc, spec, tables[key], p, gen,
                                         f"{key}, SAT-masked", name="K2s", occ_sat=sat,
                                         sat_src=src)
        # the floor: the same points and table with no mask
        fwd[key]["no_mask"] = check_grid_encode(torch, enc, spec, tables[key], p,
                                                f"{key}, K1s's points, no mask", perturb=False)
        bwd[key]["no_mask"] = check_grid_encode_bwd(torch, enc, spec, tables[key], p, gen,
                                                    f"{key}, K2s's points, no mask")
        log(f"[breadth K1s/K2s {key}] device ms: sources {srcs[key]['device_ms']:.4f} + K1s"
            f" {fwd[key]['device_ms']:.4f} (one call {fwd[key]['with_sources']['device_ms']:.4f});"
            f" K2s {bwd[key]['device_ms']:.4f}; with no mask K1 {fwd[key]['no_mask']['device_ms']:.4f},"
            f" K2 {bwd[key]['no_mask']['device_ms']:.4f}")
    kernels.launches.update(counted)     # comparison launches do not count
    records["grid_encode_s"] = dict(fwd["xyz"], max_abs_err=max(r["max_abs_err"]
                                                                for r in fwd.values()),
                                    sites=fwd)
    records["grid_encode_s_bwd"] = dict(bwd["xyz"], max_abs_err=max(r["max_abs_err"]
                                                                    for r in bwd.values()),
                                        sites=bwd)
    records["sat_mask_sources"] = dict(srcs["xyz"], sites=srcs)
    return launches


def check_sat_sources(torch, enc, sat, resolutions, label):
    """The sources kernel of K1s/K2s against its twin (`_sat_sources_plain`,
    on the card): the coarse levels' words and the occupancy rows equal.
    Bound: operations, each coarse vertex's footprint box (6 an axis) and
    2^D-term sum and each cell's 2^D-term sum; bytes, the table read once
    and the words written once.  Returns (the sources, the record)."""
    d, rb = sat.dim(), sat.shape[0] - 1
    _, coarse, words, _ = enc._sat_layout(d, tuple(resolutions), rb)
    got = enc.sat_mask_sources(sat, resolutions)
    want = enc._sat_sources_plain(sat, resolutions)
    torch.cuda.synchronize()
    if not (torch.equal(got.bits[:words], want.bits[:words])
            and (got.rows is None) == (want.rows is None)
            and (got.rows is None or torch.equal(got.rows, want.rows))):
        raise AssertionError(f"[sat_mask_sources {label}] the sources differ from the twin's")
    n_vert = sum(r ** d for r, _ in coarse)
    n_cells = rb ** d if got.rows is not None else 0
    out_bytes = words * 4 + (got.rows.numel() * 8 if got.rows is not None else 0)
    b, by = bound_ms(sat.numel() * 4 + out_bytes,
                     n_vert * (6 * d + 2 ** d) + n_cells * 2 ** d)
    kernel = lambda: enc.sat_mask_sources(sat, resolutions)
    rec = dict(max_abs_err=0.0, ms=time_ms(kernel), device_ms=device_ms(kernel),
               plain_ms=time_ms(lambda: enc._sat_sources_plain(sat, resolutions), iters=3,
                                warmup=1),
               bound_ms=b, bound_by=by, library_ms=None, coarse_vertices=n_vert, cells=n_cells)
    log(f"[sat_mask_sources {label}] Rb={rb} D={d} coarse levels {len(coarse)}"
        f" ({n_vert} vertices, {words} words), occupancy rows"
        f" {'none' if got.rows is None else tuple(got.rows.shape)}: equal to the twin;"
        f" ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} plain_ms={rec['plain_ms']:.4f}"
        f" bound_ms={b:.5f} ({by})")
    return got, rec


def check_mlp_field(torch, name, make, n_pts, call, dev):
    """[breadth] one MLP field's forward and backward on the card against
    the CPU (the same weights, from one CPU generator, and inputs), and the
    gradients against the same field in float64 on the card.  Outputs: max
    |card - cpu| over max |cpu| within MLP_REL_TOL.  Gradients: summed over
    n_pts points through ReLU trunks (and, for NDR, through the warp's
    1e-4-scale output layers), float32 itself misses them by more than 1e-4
    (at these inputs the CPU's lie 2.7e-5 (vanilla) and 2.5e-3 (NDR) from
    float64 in norm over all leaves, up to 5.7e-4 and 8.8e-3 on one leaf),
    so, as the rate gradient is held, each float32 side is measured from
    float64: the card's distance, over all leaves and on its worst leaf, at
    most twice the CPU's plus MLP_REL_TOL / 10."""
    cg = torch.Generator().manual_seed(n_pts)
    x = torch.rand(n_pts, 3, generator=cg) * 3.0 - 1.5
    v = torch.nn.functional.normalize(torch.randn(n_pts, 3, generator=cg), dim=-1)
    t = torch.rand(n_pts, 1, generator=cg)
    cots = (torch.randn(n_pts, 3, generator=cg), torch.randn(n_pts, generator=cg))
    outs = []
    for where, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float32),
                         (dev, torch.float64)):
        m = make(where).to(dtype)
        to = lambda a: a.to(where, dtype)
        t0 = time.time()
        rgb, sigma = call(m, to(x), to(v), to(t))
        ((rgb * to(cots[0])).sum() + (sigma * to(cots[1])).sum()).backward()
        torch.cuda.synchronize()
        outs.append((rgb, sigma, {k: p.grad.double().cpu() for k, p in m.named_parameters()},
                     (time.time() - t0) * 1e3))
    (rg, sg, gg, ms_g), (rc, sc, gc, ms_c), (_, _, g64, _) = outs
    out_err = max(max_rel(torch, rg, rc), max_rel(torch, sg, sc))
    flat = lambda g: torch.cat([g[k].flatten() for k in sorted(g)])
    norm_rel = lambda a, b: float((a - b).norm()) / max(float(b.norm()), 1e-30)
    card_all, cpu_all = norm_rel(flat(gg), flat(g64)), norm_rel(flat(gc), flat(g64))
    card_leaf = max(norm_rel(gg[k], g64[k]) for k in g64)
    cpu_leaf = max(norm_rel(gc[k], g64[k]) for k in g64)
    slack = MLP_REL_TOL / 10
    log(f"[breadth {name}] {n_pts} points, forward and backward: card {ms_g:.2f} ms"
        f" (first call), cpu {ms_c:.1f} ms; outputs {out_err:.3g} relative (limit"
        f" {MLP_REL_TOL}, TF32 off); the {len(gc)} gradients' distance from float64 in norm,"
        f" card / cpu: all leaves {card_all:.3g} / {cpu_all:.3g}, the worst leaf"
        f" {card_leaf:.3g} / {cpu_leaf:.3g} (limit twice the CPU's + {slack}); printed: card"
        f" from cpu {norm_rel(flat(gg), flat(gc)):.3g} in norm, the largest entry error over a"
        f" leaf's largest entry {max(max_rel(torch, gg[k], gc[k]) for k in gc):.3g}")
    if not (out_err <= MLP_REL_TOL and card_all <= 2 * cpu_all + slack
            and card_leaf <= 2 * cpu_leaf + slack):
        raise AssertionError(f"[breadth {name}] outputs {out_err} from the CPU, gradients"
                             f" {card_all}, {card_leaf} from float64")


def check_lpips(torch, np, lpips, dev):
    """[breadth] LPIPS of an 800x800 pair with the synthetic weights, on the
    card against the CPU."""
    w = synth_lpips_weights(np, lpips._VGG_PLAN)
    cg = torch.Generator().manual_seed(13)
    a = torch.rand(VIEW, VIEW, 3, generator=cg)
    b = (a + 0.1 * torch.randn(VIEW, VIEW, 3, generator=cg)).clamp(0, 1)
    lp_card = lpips.lpips(a.to(dev), b.to(dev), weights=w)
    lp_ms = time_ms(lambda: lpips.lpips(a.to(dev), b.to(dev), weights=w), iters=3, warmup=0)
    lp_cpu = lpips.lpips(a, b, weights=w)
    lp_err = abs(lp_card - lp_cpu) / abs(lp_cpu)
    log(f"[breadth LPIPS] {VIEW}x{VIEW} pair, synthetic VGG16 weights: card {lp_card:.6g}"
        f" ({lp_ms:.2f} ms, the weights' upload included), cpu {lp_cpu:.6g}, relative"
        f" difference {lp_err:.3g} (limit {LPIPS_REL_TOL}, TF32 off)")
    if not lp_err <= LPIPS_REL_TOL:
        raise AssertionError(f"[breadth LPIPS] the card is {lp_err} from the CPU")


def check_undistort(torch, camera_undistort, dev):
    """[breadth] the OpenCV lens undistortion of 2^20 points, on the card
    against the CPU."""
    cg = torch.Generator().manual_seed(14)
    uv = torch.rand(1 << 20, 2, generator=cg) * 1.2 - 0.6
    params = torch.tensor([-0.12, 0.03, 0.0008, -0.0011])
    und = lambda u, p: camera_undistort.opencv_lens_undistortion(u, p)
    got = und(uv.to(dev), params.to(dev))
    und_ms = time_ms(lambda: und(uv.to(dev), params.to(dev)), iters=5, warmup=1)
    und_err = float((got.cpu() - und(uv, params)).abs().max())
    log(f"[breadth undistort] {uv.shape[0]} points, OpenCV (k1, k2, p1, p2): {und_ms:.3f} ms,"
        f" max abs difference from the CPU {und_err:.3g} (limit {UNDISTORT_TOL})")
    if not und_err <= UNDISTORT_TOL:
        raise AssertionError(f"[breadth undistort] the card is {und_err} from the CPU")


def analytic_sigmas(torch):
    """Two proposal densities of t, peaked at t = 2 and t = 3.5 (as in
    tests/test_utils.py's propnet test)."""
    def a(t0, t1):
        mid = (t0 + t1) / 2
        return torch.exp(-((mid - 2.0) ** 2) * 4.0) * 5.0

    def b(t0, t1):
        mid = (t0 + t1) / 2
        return torch.exp(-((mid - 3.5) ** 2) * 2.0) * 8.0 + 0.1
    return [a, b]


def run_breadth(torch, kernels, enc, tr, train_set, gen, dev, records) -> dict:
    """[breadth]: the single-card modules beside the main path at full
    width, each held to its CPU run in this process: K1s/K2s, an unbounded
    trainer, the proposal sampler, the MLP fields, LPIPS and the lens
    undistortion.  Returns the K1s/K2s path's launches."""
    import dataclasses
    import numpy as np
    from cnc_torch.config import CNCConfig, ModelConfig, TrainConfig
    from cnc_torch.grids import prop_net
    from cnc_torch.models import mlp_fields
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.ops import sat as sat_ops
    from cnc_torch.train.trainer import Trainer
    from cnc_torch.utils import camera_undistort, lpips, profiling

    t_phase = time.time()
    launches = check_sat_encode(torch, kernels, enc, sat_ops, rf, tr, gen, dev, records)

    # the unbounded trainer: 200 steps at lambda = 0
    timers = profiling.SectionTimers()
    with timers.section("unbounded set-up"):
        ucfg = CNCConfig(model=ModelConfig(unbounded=True),
                         train=dataclasses.replace(TrainConfig(), lmbda=0.0))
        utr = Trainer(ucfg, train_set)
    mses = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    with timers.section("unbounded fit, 200 steps"):
        utr.fit(199, log_every=0, step_callback=lambda s, aux: mses.append(float(aux["mse"])))
        profiling.force(next(utr.field.parameters()))
    ulaunches = {k: v for k, v in kernels.launches.items() if v}
    psnrs = [-10.0 * math.log10(max(m, 1e-10)) for m in mses]
    early, late = statistics.mean(psnrs[:50]), statistics.mean(psnrs[150:200])
    fit_s = timers.totals["unbounded fit, 200 steps"]
    log(f"[breadth unbounded] Trainer(ModelConfig(unbounded=True)), lambda 0, blocks: 200 steps,"
        f" {fit_s / 200 * 1e3:.2f} ms per step; train-batch psnr {early:.3f} over steps 0-49,"
        f" {late:.3f} over 150-199; launches {json.dumps(ulaunches)}; section timers:\n"
        + timers.summary())
    if len(mses) != 200 or not all(math.isfinite(m) for m in mses):
        raise AssertionError(f"[breadth unbounded] a loss is not finite: {len(mses)} steps")
    if not late > early:
        raise AssertionError(f"[breadth unbounded] psnr did not rise: {early} -> {late}")
    if not all(ulaunches.get(k, 0) > 0 for k in ("grid_encode", "grid_encode_bwd", "march",
                                                 "volrend", "volrend_bwd")):
        raise AssertionError(f"[breadth unbounded] a training kernel did not launch: {ulaunches}")
    del utr

    # the proposal sampler: 4,096 rays, levels of 128 and 64 samples, 32 final
    r = 4096
    o = torch.zeros(r, 3, device=dev)
    sig = analytic_sigmas(torch)
    args = (sig, (128, 64), 32, 0.1, 5.0)
    t0 = time.time()
    t_s, t_e, aux = prop_net.propnet_sampling(None, o, o, *args, sampling_type="uniform")
    torch.cuda.synchronize()
    prop_ms = (time.time() - t0) * 1e3
    c_s, c_e, c_aux = prop_net.propnet_sampling(None, o.cpu(), o.cpu(), *args,
                                                sampling_type="uniform")
    err_t = max(float((a.cpu() - b).abs().max()) for a, b in
                [(t_s, c_s), (t_e, c_e)] + [(x[0], y[0]) for x, y in zip(aux["levels"],
                                                                          c_aux["levels"])])
    err_w = max(float((x[1].cpu() - y[1]).abs().max())
                for x, y in zip(aux["levels"], c_aux["levels"]))
    t_rf = torch.cat([t_s, t_e[:, -1:]], -1)
    w_rf = torch.full((r, 32), 1.0 / 32, device=dev)
    loss = float(prop_net.prop_loss(aux, t_rf, w_rf))
    g = torch.Generator(device=dev).manual_seed(5)
    s_s, s_e, s_aux = prop_net.propnet_sampling(g, o, o, *args, sampling_type="uniform",
                                                stratified=True)
    s_loss = float(prop_net.prop_loss(s_aux, torch.cat([s_s, s_e[:, -1:]], -1), w_rf))
    log(f"[breadth propnet] {r} rays, levels (128, 64), 32 samples: {prop_ms:.2f} ms; against"
        f" the CPU run: edges max abs {err_t:.3g}, weights {err_w:.3g} (limit {PROP_TOL});"
        f" prop_loss {loss:.6g}, stratified {s_loss:.6g}")
    if not (err_t <= PROP_TOL and err_w <= PROP_TOL):
        raise AssertionError(f"[breadth propnet] the card is {err_t}, {err_w} from the CPU")
    if not (math.isfinite(loss) and math.isfinite(s_loss) and bool(s_s.isfinite().all())):
        raise AssertionError("[breadth propnet] a loss or an edge is not finite")

    # the MLP fields: vanilla NeRF 8x256 over 65,536 points, NDR over 16,384
    for name, make, n_pts, call in (
            ("vanilla NeRF 8x256", lambda d: mlp_fields.VanillaNeRF(
                torch.Generator().manual_seed(11), device=d), 65536,
             lambda m, x, v, t: mlp_fields.forward(m, x, v)),
            ("NDR", lambda d: mlp_fields.NDRField(torch.Generator().manual_seed(12), device=d),
             16384, lambda m, x, v, t: mlp_fields.ndr_forward(m, x, v, t))):
        check_mlp_field(torch, name, make, n_pts, call, dev)

    check_lpips(torch, np, lpips, dev)
    check_undistort(torch, camera_undistort, dev)
    log(f"[breadth] {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- [dp]
def check_pn_part(torch, cops, table, fine_offset, pn_ax, pn_res, sample_cap, gen, dev):
    """K7p and K7pb on one real frac plane of the rate step, for each W of
    DP_WORLD_SIZES and in the sampled and the unsampled mode: each rank's
    partial and divisors equal to the plain ones (torch.equal: integer
    counts; every rank at W = 2, the first and the last at the larger W),
    every rank's partial summed and finished equal to the one-launch K7
    plane (torch.equal); K7pb against the plain backward in float64
    (rel_err within K7B_REL_TOL; the same ranks).  Rank 0's share timed:
    ms, device ms, index_add_ of its indicator rows, and the bound; the
    plain share's ms once, at W = 2, from the call held to the kernel."""
    eidx, bounds, n = pn_ax["entry_idx"], pn_ax["bounds"], pn_ax["n"]
    args = (table, fine_offset, eidx, bounds, n, pn_res)
    bins, f = (pn_res - 2) ** 2, table.shape[1]
    sites, bwd_sites, worst_bwd, worst_abs = {}, {}, 0.0, 0.0
    for mode, cap in (("sampled", sample_cap), ("unsampled", None)):
        whole = cops._pn_frac_plane_cuda(*args, cap)
        rows = cops.pn_row_count(eidx, cap)
        for w in DP_WORLD_SIZES:
            chunk = -(-rows // w)
            total = plain_ms = None
            for r in range(w):
                part, den = cops._pn_part_cuda(*args, cap, r * chunk, chunk)
                total = part if total is None else total + part
                if w > 2 and r not in (0, w - 1):
                    continue        # in the sum below, not held to the twin alone
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                want, want_den = cops._pn_part_plain(table, fine_offset, eidx, bounds, n, cap,
                                                     r * chunk, chunk)
                end.record()
                end.synchronize()
                if r == 0:
                    want0 = want
                    # the plain share timed once, at W = 2 (a second a call unsampled)
                    plain_ms = start.elapsed_time(end) if w == 2 else None
                if not (torch.equal(part, want) and torch.equal(den, want_den)):
                    raise AssertionError(f"[K7p] {mode} W={w} rank {r}: the partial differs"
                                         f" from the twin's")
            if not torch.equal(cops.pn_frac_finish(total, den, pn_res), whole):
                raise AssertionError(f"[K7p] {mode} W={w}: the summed partials differ from the"
                                     f" K7 plane")
            # rank 0's share: its rows, the bound and the library's call
            sel, row_valid, bnd = cops._pn_rows(eidx, bounds, n, cap, 0, chunk)
            n_valid = int(row_valid.sum())
            n_entries = torch.unique(sel[row_valid]).numel()
            b, by = bound_ms(n_valid * 4 + n_entries * 4 * f + (bins + 1) * 4 + 4
                             + bins * 4 * f + bins * 4, (n_valid + bins) * f)
            bin_of_row = (torch.searchsorted(bnd, torch.arange(chunk, device=dev,
                                                               dtype=torch.int32), right=True)
                          - 1).clamp(0, bins - 1).long()
            ind = torch.where(row_valid[:, None],
                              (table[fine_offset + sel.long()] > 0.9).float(), 0.0)
            library = lambda: torch.zeros(bins, f, device=dev).index_add_(0, bin_of_row, ind)
            if not torch.equal(library(), want0):
                raise AssertionError("[K7p] index_add_ of the indicator rows differs from the"
                                     " twin")
            share = lambda: cops.pn_hist_part(*args, cap, 0, chunk)
            sites[f"{mode} W={w}"] = dict(
                rows=chunk, counted=n_valid, distinct_entries=n_entries, ms=time_ms(share),
                device_ms=device_ms(share), plain_ms=plain_ms, library_ms=time_ms(library),
                bound_ms=b, bound_by=by)
            # K7pb: the partial's gradient into the table against the plain
            # backward in float64, on every rank at W = 2, on the first and
            # the last rank at the larger W
            cot = torch.randn(bins, f, generator=gen, device=dev)
            errs = []
            for r in sorted({0, w - 1} if w > 2 else range(w)):
                leaf = table.clone().requires_grad_()
                (got,) = torch.autograd.grad(cops.pn_hist_part(leaf, *args[1:], cap, r * chunk,
                                                               chunk)[0], leaf, cot)
                leaf64 = table.double().requires_grad_()
                (exact,) = torch.autograd.grad(cops._pn_part_plain(
                    leaf64, fine_offset, eidx, bounds, n, cap, r * chunk, chunk)[0], leaf64,
                    cot.double())
                errs.append(rel_err(got, exact.float()) if exact.abs().max() > 0
                            else float(got.abs().max()))
                worst_abs = max(worst_abs, float((got - exact.float()).abs().max()))
            worst_bwd = max(worst_bwd, max(errs))
            if not max(errs) <= K7B_REL_TOL:
                raise AssertionError(f"[K7pb] {mode} W={w}: rel err {errs} > {K7B_REL_TOL}")
            d_table = torch.zeros_like(table)
            kernel = lambda: cops._pn_part_backward_launch(table, fine_offset, eidx, bounds, n,
                                                           pn_res, cap, 0, chunk, cot, d_table)
            leaf = table.clone().requires_grad_()
            out = cops.pn_hist_part(leaf, *args[1:], cap, 0, chunk)[0]
            whole_bwd = lambda: torch.autograd.grad(out, leaf, cot, retain_graph=True)
            n_set = torch.unique(sel[row_valid & (ind > 0).any(1)]).numel()
            reads = n_valid * 4 + n_entries * 4 * f + (bins + 1) * 4 + 4 + bins * 4 * f
            n_ops = (n_valid + bins) * f + int(ind.sum())
            kb, kby = bound_ms(reads + n_set * 4 * f, n_ops)
            bb, bby = bound_ms(reads + table.numel() * 4, n_ops)
            flat = ((fine_offset + sel.long())[:, None] * f
                    + torch.arange(f, device=dev)[None, :]).reshape(-1)
            vals = (cot[bin_of_row] * ind).reshape(-1)
            bwd_sites[f"{mode} W={w}"] = dict(
                rel_err=max(errs), ms=time_ms(whole_bwd, iters=10),
                device_ms=device_ms(whole_bwd), kernel_device_ms=device_ms(kernel),
                plain_ms=time_ms(lambda: torch.autograd.grad(cops._pn_part_plain(
                    leaf, fine_offset, eidx, bounds, n, cap, 0, chunk)[0], leaf, cot),
                    iters=1, warmup=0) if w == 2 else None,
                library_ms=time_ms(lambda: torch.zeros(table.numel(), device=dev).index_add_(
                    0, flat, vals), iters=10),
                bound_ms=bb, bound_by=bby, kernel_bound_ms=kb, kernel_bound_by=kby)
            del d_table, out, leaf
    head, bhead = sites["sampled W=2"], bwd_sites["sampled W=2"]
    log("[K7p pn_hist_part] the partials of W = " + ", ".join(map(str, DP_WORLD_SIZES))
        + " ranks each equal to the twin's and summed equal to the K7 plane (sampled and"
        f" unsampled), pn_res={pn_res} F={f} sample_cap={sample_cap}; rank 0's share by W: "
        + "; ".join(f"{k}: rows={s['rows']} counted={s['counted']} ms={s['ms']:.4f}"
                    f" device_ms={s['device_ms']:.4f} plain_ms={s['plain_ms']}"
                    f" library_ms={s['library_ms']:.4f} bound_ms={s['bound_ms']:.5f}"
                    f" ({s['bound_by']})" for k, s in sites.items()))
    log("[K7pb pn_hist_part_bwd] within " + f"{K7B_REL_TOL} of the float64 twin"
        f" (worst {worst_bwd:.3g}); rank 0's share by W: "
        + "; ".join(f"{k}: ms={s['ms']:.4f} device_ms={s['device_ms']:.4f} kernel_device_ms="
                    f"{s['kernel_device_ms']:.4f} plain_ms={s['plain_ms']} library_ms="
                    f"{s['library_ms']:.4f} bound_ms={s['bound_ms']:.5f} ({s['bound_by']})"
                    f" kernel_bound_ms={s['kernel_bound_ms']:.5f}" for k, s in bwd_sites.items()))
    return {"pn_hist_part": dict(head, max_abs_err=0.0, sites=sites),
            "pn_hist_part_bwd": dict(bhead, max_abs_err=worst_abs, sites=bwd_sites,
                                     kernel_device_ms=bhead["kernel_device_ms"],
                                     kernel_bound_ms=bhead["kernel_bound_ms"])}


def grads_of(trainer) -> dict:
    out = {f"field.{k}": p.grad.detach().clone() for k, p in trainer.field.named_parameters()}
    if trainer.ent_params is not None:
        out.update({f"ent.{k}": p.grad.detach().clone()
                    for k, p in trainer.ent_params.named_parameters() if p.grad is not None})
    return out


def worst_grad_err(got: dict, want: dict) -> tuple:
    """The largest max |got - want| over max |want| among the parameters."""
    if set(got) != set(want):
        raise AssertionError(f"gradients of {sorted(set(got) ^ set(want))} on one side only")
    errs = {k: rel_err(got[k], want[k]) for k in want if want[k].abs().max() > 0}
    k = max(errs, key=errs.get)
    return errs[k], k


def run_dp_phase(torch, kernels, cops, rate_cfg, train_set, trr, n_rays, ms_rate_step, gen,
                 dev, records) -> dict:
    """[dp]: K7p/K7pb on the rate run's planes; a group of one rank over
    NCCL (one step against the trainer without a group, then a DP_STEPS run);
    two ranks sharing the card over gloo (`--dp-rank`).  Returns the
    launches of the two-rank run's rank 0 and of its pn_frac_grad steps."""
    import shutil

    from cnc_torch.models import radiance_field as rf
    from cnc_torch.parallel import sharding
    from cnc_torch.train.driver import build_entropy
    from cnc_torch.train.trainer import Trainer

    t_phase = time.time()
    # ---- two ranks sharing the card over gloo, one process each: started
    # first, they import and load the kernels while the checks and the
    # one-rank run go on, and touch the card only once `go` exists
    dp_dir = Path("chiprun_out").resolve() / "dp"
    shutil.rmtree(dp_dir, ignore_errors=True)
    out_dir = dp_dir / "w2"
    out_dir.mkdir(parents=True)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                               str(r), str(out_dir)]) for r in range(2)]
    try:
        counted_so_far = dict(kernels.launches)
        cache = trr._last_ent_cache
        with torch.no_grad():
            table = rf.quantized_tables(trr.field, rate_cfg.model)["xyz"].contiguous()
        records.update(check_pn_part(torch, cops, table, trr.entropy.fine_offset, cache["pn"]["xy"],
                                     trr.entropy.pn_res, trr.entropy.cfg.pn_frac_sample_cap, gen,
                                     dev))
        kernels.launches.update(counted_so_far)      # comparison launches do not count
        t_k7p = time.time() - t_phase

        # ---- a group of one rank over NCCL
        group = sharding.make_group(1, 0, backend="nccl",
                                    init_method="file://" + str(dp_dir / "w1_rdzv"))
        try:
            ent1 = build_entropy(rate_cfg, 1)
            t_dp = Trainer(rate_cfg, train_set, entropy=ent1, group=group)
            t_one = Trainer(rate_cfg, train_set, entropy=ent1)
            binaries = trr.occ_state.binaries
            for t in (t_dp, t_one):
                t.occ_state = t.occ_state._replace(occs=trr.occ_state.occs.clone(),
                                                   binaries=binaries.clone())
            ent_cache = ent1.refresh_cache(binaries)
            rays, pixels = train_set.fetch_rays(gen, n_rays)
            jitter = torch.rand(n_rays, generator=gen, device=dev)
            starts = ent1.draw_starts(gen)
            bkgd = torch.ones(3, device=dev)
            aux_dp = t_dp._train_step(rays.origins, rays.viewdirs, pixels, bkgd, jitter=jitter,
                                      ent_cache=ent_cache, starts=starts)
            aux_one = t_one._train_step(rays.origins, rays.viewdirs, pixels, bkgd, jitter=jitter,
                                        ent_cache=ent_cache, starts=starts)
            err1, worst1 = worst_grad_err(grads_of(t_dp), grads_of(t_one))
            if not (err1 <= DP_GRAD_TOL and int(aux_dp["n_marched"]) == int(aux_one["n_marched"])):
                raise AssertionError(f"[dp W=1] the step's gradients differ from the single-card"
                                     f" step's by {err1} ({worst1}), limit {DP_GRAD_TOL}; marched"
                                     f" {int(aux_dp['n_marched'])} vs {int(aux_one['n_marched'])}")
            del t_one
            t_dp.reset_state()
            hist = []
            kernels.reset_launches()
            t0 = time.time()
            t_dp.fit(DP_STEPS - 1, log_every=0, step_callback=lambda s, aux: hist.append(
                (time.time(), float(aux["mse"]), float(aux["bits_per_param"]))))
            torch.cuda.synchronize()
            run_s = time.time() - t0
            w1_launches = dict(kernels.launches)
        finally:
            sharding.destroy_group(group)
        rate_step_kernels = ("segment_mean", "segment_mean_bwd", "segment_pool", "segment_pool_bwd",
                             "pn_frac_plane", "grid_encode_v", "grid_encode_v_bwd", "compact",
                             "grid_encode", "grid_encode_bwd", "march", "volrend", "volrend_bwd",
                             "footprint", "pack_mask_bits")
        if not all(w1_launches[k] > 0 for k in rate_step_kernels) or w1_launches["pn_hist_part"]:
            raise AssertionError(f"[dp W=1] launches {w1_launches}: every rate kernel, and not K7p")
        if w1_launches["pn_frac_plane"] != 3 * DP_STEPS:
            raise AssertionError(f"[dp W=1] {w1_launches['pn_frac_plane']} frac planes in"
                                 f" {DP_STEPS} steps, not 3 a step")
        bpp16, bpp_end = hist[16][2], statistics.mean(h[2] for h in hist[-10:])
        if not (all(math.isfinite(h[1]) and math.isfinite(h[2]) for h in hist) and bpp_end < bpp16):
            raise AssertionError(f"[dp W=1] bits_per_param {bpp16} at step 16 -> {bpp_end}")
        ms_w1 = (hist[-1][0] - hist[-51][0]) / 50 * 1e3
        log(f"[dp W=1 nccl] one step against the trainer without a group: gradients within"
            f" {err1:.3g} of each parameter's largest entry (worst {worst1}; limit {DP_GRAD_TOL}),"
            f" marched {int(aux_dp['n_marched'])} both; {DP_STEPS} steps in {run_s:.2f} s,"
            f" {ms_w1:.2f} ms per step over the last 50 (the [rate] phase: {ms_rate_step:.2f} ms),"
            f" bits_per_param {hist[0][2]:.4f} -> {bpp16:.4f} at step 16 -> {bpp_end:.4f}; launches"
            f" {json.dumps({k: v for k, v in w1_launches.items() if v})}")
        del t_dp, ent1, ent_cache
        torch.cuda.empty_cache()
        t_w1 = time.time() - t_phase - t_k7p
        (out_dir / "go").write_text("")
        deadline = time.time() + DP2_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    if any(p.returncode for p in procs):
        raise AssertionError(f"[dp W=2] rank exit codes {[p.returncode for p in procs]}")
    res = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(2)]
    r0 = res[0]
    log(f"[dp W=2 gloo, one card] {DP2_STEPS} steps a rank, every step's field, context MLPs"
        f" and occupancy grid bit-equal on both ranks; at step {DP_PLAIN_AT} the all-reduced"
        f" gradients within {r0['plain_err']:.3g} of dp_step_plain's (worst {r0['plain_worst']};"
        f" limit {DP_GRAD_TOL}); {r0['ms_per_step']:.2f} ms per step over the last"
        f" {DP2_STEPS - DP_PLAIN_AT - 1} (rank 1: {res[1]['ms_per_step']:.2f}); bits_per_param"
        f" {r0['bits'][0]:.4f} -> {r0['bits'][-1]:.4f}; K7p {r0['launches']['pn_hist_part']}"
        f" launches ({r0['launches']['pn_hist_part'] / DP2_STEPS:.0f} a rate step), K7"
        f" {r0['launches']['pn_frac_plane']}; pn_frac_grad steps: K7pb"
        f" {r0['pn_grad_launches']['pn_hist_part_bwd']} launches; rank 0 launches"
        f" {json.dumps({k: v for k, v in r0['launches'].items() if v})}; the ranks ready"
        f" {r0['ready_s']:.1f} s and {res[1]['ready_s']:.1f} s after they started; phase"
        f" {time.time() - t_phase:.1f} s (K7p/K7pb checks {t_k7p:.1f}, W = 1 {t_w1:.1f}, W = 2"
        f" {time.time() - t_phase - t_k7p - t_w1:.1f})")
    records["pn_hist_part"].update(dp_w1_ms_per_step=ms_w1, dp_w2_ms_per_step=r0["ms_per_step"])
    return {"dp": r0["launches"], "dp_pn_grad": r0["pn_grad_launches"]}


def dp_rank(rank: int, out_dir: str) -> int:
    """One rank of [dp]'s two-rank run (`chip_smoke.py --dp-rank R DIR`): the
    full-width lambda = 2e-3 trainer with per-rank quotas in a gloo group of
    two on the one card, DP2_STEPS steps, the replicas checked after every
    step; rank 0 holds step DP_PLAIN_AT's all-reduced gradients to
    `dp_step_plain` from the same state and draws (its launches left out of
    the counts), then two steps with pn_frac_grad drive K7pb."""
    import dataclasses

    import torch
    from cnc_torch import kernels
    from cnc_torch.config import CNCConfig
    from cnc_torch.data import scenes
    from cnc_torch.parallel import sharding
    from cnc_torch.train.driver import build_entropy
    from cnc_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.lib()
    ready_s = time.time() - T_IMPORT
    # the parent's checks and one-rank run go on until `go` exists
    deadline = time.time() + DP2_TIMEOUT_S
    while not (Path(out_dir) / "go").exists():
        if time.time() > deadline:
            raise TimeoutError(f"[dp W=2] rank {rank}: no go after {DP2_TIMEOUT_S} s")
        time.sleep(0.1)
    dev = torch.device("cuda", 0)
    group = sharding.make_group(2, rank, device=dev, backend="gloo",
                                init_method="file://" + str(Path(out_dir) / "rdzv"))
    try:
        cfg = CNCConfig()
        train_set = scenes.ProceduralDataset("blocks", device=dev)
        entropy = build_entropy(cfg, 2)
        tr = Trainer(cfg, train_set, entropy=entropy, group=group)
        plain = {}
        step_fn = tr._train_step

        def step_with_plain(o, d, pixels, bkgd, jitter=None, ent_cache=None, starts=None):
            if rank != 0 or tr.step != DP_PLAIN_AT:
                return step_fn(o, d, pixels, bkgd, jitter, ent_cache, starts)
            counted = dict(kernels.launches)
            state = tr.generator.get_state()
            sharding.dp_step_plain(tr, 2, o, d, pixels, bkgd, ent_cache=ent_cache, apply=False)
            want = grads_of(tr)
            tr.generator.set_state(state)
            kernels.launches.update(counted)
            aux = step_fn(o, d, pixels, bkgd, jitter, ent_cache, starts)
            plain["err"], plain["worst"] = worst_grad_err(grads_of(tr), want)
            return aux

        tr._train_step = step_with_plain
        hist = []

        def on_step(step, aux):
            sharding.check_replicated(group, sharding.trainer_state(tr), f"after step {step}")
            hist.append((time.time(), float(aux["mse"]), float(aux["bits_per_param"])))

        kernels.reset_launches()
        tr.fit(DP2_STEPS - 1, log_every=0, step_callback=on_step)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        if launches["pn_hist_part"] != 3 * DP2_STEPS or launches["pn_frac_plane"]:
            raise AssertionError(f"[dp W=2] rank {rank}: K7p {launches['pn_hist_part']} and K7"
                                 f" {launches['pn_frac_plane']} launches in {DP2_STEPS} steps")
        if rank == 0 and not plain.get("err", 1.0) <= DP_GRAD_TOL:
            raise AssertionError(f"[dp W=2] step {DP_PLAIN_AT}: the all-reduced gradients lie"
                                 f" {plain.get('err')} from dp_step_plain's ({plain.get('worst')})")
        if not all(math.isfinite(h[1]) and math.isfinite(h[2]) for h in hist):
            raise AssertionError(f"[dp W=2] rank {rank}: non-finite losses or bits")
        tail = hist[DP_PLAIN_AT + 1:]
        ms = (tail[-1][0] - tail[0][0]) / (len(tail) - 1) * 1e3
        # the frac planes' backward: two steps with pn_frac_grad on
        entropy_pn = copy.copy(entropy)
        entropy_pn.cfg = dataclasses.replace(entropy.cfg, pn_frac_grad=True)
        tr_pn = Trainer(dataclasses.replace(cfg, entropy=entropy_pn.cfg), train_set,
                        entropy=entropy_pn, group=group)
        kernels.reset_launches()
        tr_pn.fit(1, log_every=0)
        torch.cuda.synchronize()
        pn_launches = dict(kernels.launches)
        if pn_launches["pn_hist_part_bwd"] != 6:
            raise AssertionError(f"[dp W=2] rank {rank}: K7pb {pn_launches['pn_hist_part_bwd']}"
                                 f" launches in two pn_frac_grad steps, not 6")
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(dict(
            ms_per_step=ms, bits=[h[2] for h in hist], mse=[h[1] for h in hist],
            launches=launches, pn_grad_launches=pn_launches, plain_err=plain.get("err"),
            ready_s=ready_s,
            plain_worst=plain.get("worst"))))
        sharding.rank0_barrier(group, "dp_rank")
    finally:
        sharding.destroy_group(group)
    return 0


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
    phase_s, t_mark = {}, [t_start]

    def mark(name):
        """The seconds since the previous mark, under `name` in [phases]."""
        now = time.time()
        phase_s[name] = round(now - t_mark[0], 1)
        t_mark[0] = now

    Path("chiprun_out").mkdir(exist_ok=True)
    LOG_FILE.write_text("")
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
    mark("build")

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
        # the device operations of one compaction at each K3 site's shape and of
        # one packing at each refresh site's, in the process's first profile
        k3_masks = {site: torch.rand(n, generator=gen, device=dev) < 0.1
                    for site, (_, n, _) in K3_SITES.items()}
        pack_masks = {site: torch.rand(shape, generator=gen, device=dev) < 0.3
                      for site, shape in PACK_SITES.items()}
        op_calls = {f"K3 {site}": (lambda m=k3_masks[site], c=cap:
                                   scatter_ops.compact_mask_indices(m, c))
                    for site, (_, _, cap) in K3_SITES.items()}
        op_calls.update({f"pack {site}": (lambda m=m: enc.pack_mask_bits(m))
                         for site, m in pack_masks.items()})
        op_calls["K7b backward"] = frac_plane_backward(torch, cops, dev)
        device_ops = count_device_ops(torch, op_calls)
        del k3_masks, pack_masks, op_calls
        log("[K3, pack, K7b] device operations per call, in the process's first profile"
            " (K3 at each site's n and cap, the packing at each refresh site's shape, one"
            " whole autograd backward of a frac plane): " + json.dumps(device_ops))
        if not all(len(v) == 1 for k, v in device_ops.items() if k != "K7b backward"):
            raise AssertionError(f"[K3, pack] a call ran more than one device operation:"
                                 f" {device_ops}")
        if len(device_ops["K7b backward"]) != 2:
            raise AssertionError(f"[K7b] the backward ran {device_ops['K7b backward']}, not the"
                                 f" fill and one launch")
        device_ops = {k: len(v) for k, v in device_ops.items()}

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
        k5 = {label: check_volrend(torch, volrend, smp, chunk, rgb, sig, pt, rcfg, label)
              for label, smp in (("view, first round", got), ("view, late round", late))}
        records["volrend"] = dict(k5["view, late round"],
                                  max_abs_err=max(v["max_abs_err"] for v in k5.values()),
                                  sites=k5)

    mark("kernel checks")
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
    check_walk_faults(volrend, dev, "[main]")
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
    mark("view")

    # ---- 5. a 64x64 crop on the card and through the plain twins on the CPU, its
    # rays one chunk (a round's buffer holds those rays' samples alone, not a
    # chunk of eval_chunk_rays padded with copies: the plain path's time)
    lo = (VIEW - CROP) // 2
    co = rays.origins[lo:lo + CROP, lo:lo + CROP].contiguous()
    cd = rays.viewdirs[lo:lo + CROP, lo:lo + CROP].contiguous()
    t0 = time.time()
    gpu = renderer.render_image(field, mcfg, rcfg, aabb, binaries, co, cd, bkgd,
                                chunk=CROP * CROP, device=dev)
    torch.cuda.synchronize()
    t_gpu = time.time() - t0
    field_cpu = copy.deepcopy(field).to("cpu")
    t0 = time.time()
    cpu = renderer.render_image(field_cpu, mcfg, rcfg, aabb.cpu(), binaries.cpu(), co.cpu(),
                                cd.cpu(), bkgd.cpu(), chunk=CROP * CROP, device="cpu")
    t_cpu = time.time() - t0
    errs = [float((g.cpu() - c).abs().max()) for g, c in zip(gpu[:2], cpu[:2])]
    log(f"[crop] {CROP}x{CROP}: card {t_gpu:.2f} s, cpu {t_cpu:.2f} s, max abs rgb err"
        f" {errs[0]:.3g}, opacity err {errs[1]:.3g} (tolerance {CROP_RGB_TOL})")
    if not max(errs) <= CROP_RGB_TOL:
        raise AssertionError("crop: the card and the plain CPU path disagree")
    mark("crop")

    # ---- 6. the probe kernels, driven once at the probe's shapes
    probe_records, probe_launches = check_probe(torch, kernels, scatter_ops, dev)
    records.update(probe_records)
    if not all(v > 0 for v in probe_launches.values()):
        raise AssertionError(f"[probe] a kernel was not launched: {probe_launches}")
    mark("probe")

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
    records["volrend"]["sites"]["training march"] = records.pop("volrend_train")
    records["volrend"]["max_abs_err"] = max(v["max_abs_err"]
                                            for v in records["volrend"]["sites"].values())

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

    mark("train")

    # ---- 9. the rate path at full width: the model build and the lambda > 0 run
    rate_cfg = CNCConfig()
    if not rate_cfg.train.lmbda > 0:
        raise AssertionError("[rate] the default configuration has no rate term")
    torch.cuda.synchronize()
    kernels.reset_launches()        # the rate path starts here
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.time()
    with swapped((torch, "sort", None)):        # the build sorts nothing with torch.sort
        entropy = cm.ContextModels(rate_cfg.entropy, rate_cfg.model.grid_3d,
                                   rate_cfg.model.grid_2d)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    log(f"[K10] ContextModels built in {build_s:.2f} s (no torch.sort); peak device memory"
        f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, tables hold"
        f" {(torch.cuda.memory_allocated() - mem_before) / 2**30:.2f} GiB;"
        f" launches {kernels.launches['vertex_tables']} (compaction {kernels.launches['compact']});"
        f" the longest segment by level " + json.dumps(
            {f"{k}{l}": n for (k, l), n in entropy.longest_segments.items()}) + ";"
        f" 3D entries " + json.dumps({l: t.n_entries for l, t in entropy.tables3d.items()})
        + " sample_n " + json.dumps({l: t.sample_n for l, t in entropy.tables3d.items()})
        + " max_win_pts " + json.dumps({l: t.max_win_pts for l, t in entropy.tables3d.items()})
        + "; 2D entries " + json.dumps({l: t.n_entries for l, t in entropy.tables2d.items()})
        + " max_win_pts " + json.dumps({l: t.max_win_pts for l, t in entropy.tables2d.items()}))
    counted_so_far = dict(kernels.launches)
    records["vertex_tables"] = check_vertex_tables(torch, cops, entropy, dev)
    k3_sites = {}
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
    fp_calls, footprint = [], cops._footprint_cuda

    def recording(*args, **kw):
        fp_calls.append((args, kw))
        return footprint(*args, **kw)

    pn_calls, compact = [], scatter_ops.compact_mask_indices

    def recording_pn(mask, cap):
        pn_calls.append((mask, cap))
        return compact(mask, cap)

    with swapped((cops, "_footprint_cuda", recording),
                 (scatter_ops, "compact_mask_indices", recording_pn)):
        occ_cache = entropy.refresh_cache(occ_grid)
    # [K3] at the refresh's pn coord lists and at the occupancy update's
    # compaction of the grid (grids/occupancy.py: every cell, cap = cells)
    if len(pn_calls) != 1:
        raise AssertionError(f"[K3] a refresh made {len(pn_calls)} compactions, not 1")
    k3_sites["pn coord lists"] = check_compact_mask(
        torch, scatter_ops, *pn_calls[0], "pn coord lists", device_ops["K3 pn coord lists"])
    del pn_calls
    k3_sites["occupancy"] = check_compact_mask(
        torch, scatter_ops, occ_grid.reshape(-1), occ_grid.numel(), "occupancy",
        device_ops["K3 occupancy"])
    n_fp = kernels.launches["footprint"] - n_fp
    n_pack = kernels.launches["pack_mask_bits"] - n_pack
    refresh_ms = time_ms(lambda: entropy.refresh_cache(occ_grid), iters=3, warmup=1)
    # each of the refresh's footprint launches again, by its device work alone
    fp_ms = [device_ms(lambda a=a, k=k: footprint(*a, **k), iters=3) for a, k in fp_calls]
    fp_bounds = [footprint_bound(cops, *a[:3]) for a, _ in fp_calls]
    fp_bound = sum(fp_bounds)
    per_launch = [dict(d=a[0].dim(), r=a[1], overlap=bool(a[2]), device_ms=t, bound_ms=b)
                  for (a, _), t, b in zip(fp_calls, fp_ms, fp_bounds)]
    records["footprint"].update(launches_per_refresh=n_fp, refresh_device_ms=sum(fp_ms),
                                refresh_bound_ms=fp_bound, refresh_ms=refresh_ms,
                                refresh_launches=per_launch)
    log(f"[K8] refresh_cache on the trained occupancy grid ({int(occ_grid.sum())} cells):"
        f" {refresh_ms:.2f} ms for {n_fp} footprint launches, {n_pack} mask packings and the"
        f" pn coord lists (a compaction and three stable sorts of"
        f" {rate_cfg.entropy.pn_coords_cap} rows); the footprint launches' device ms"
        f" {sum(fp_ms):.4f} in all (their bounds {fp_bound:.4f}), the largest"
        f" {max(fp_ms):.4f}; each launch (D, r, overlap: device ms / bound ms): "
        + "; ".join(f"{p['d']}D r={p['r']}{' ovl' if p['overlap'] else ''}:"
                    f" {p['device_ms']:.4f} / {p['bound_ms']:.4f}" for p in per_launch))
    if n_fp > 24:
        raise AssertionError(f"[K8] a refresh made {n_fp} footprint launches, more than 24")
    records["pack_mask_bits"] = dict(check_pack(torch, enc, occ_cache, device_ops),
                                     launches_per_refresh=n_pack)
    del occ_cache
    check_order_faults(cops, dev, f"[rate] after {RATE_WARM_STEPS} steps:")
    records.update(check_rate_kernels(torch, trr, rf, cops, enc, gen))
    records["compact"]["device_ops"] = device_ops["K3 3D context"]
    records["pn_hist_bwd"]["device_ops"] = device_ops["K7b backward"]
    k3_sites = {"3D context": dict(records["compact"]), **k3_sites}
    for site, rec in k3_sites.items():
        rec["call_site"] = K3_SITES[site][0]
    records["compact"]["sites"] = k3_sites
    log("[K3] by call site (device ms / bound ms / nonzero ms; device operations): "
        + "; ".join(f"{k} n={r['n']} cap={r['cap']}: {r['device_ms']:.4f} / {r['bound_ms']:.4f}"
                    f" / {r['library_ms']:.4f}; {r['device_ops']}" for k, r in k3_sites.items()))
    check_rate_gradient(torch, trr, rf, cops, enc, ent_ops, f"step {RATE_WARM_STEPS}")
    kernels.launches.update(counted_so_far)     # comparison launches do not count

    rate_s, rate_scores = fit_and_read(kernels, trr, RATE_STEPS, test_set, on_rate_step, "[rate] ")
    rate_launches = dict(kernels.launches)
    n_rate = RATE_STEPS - RATE_WARM_STEPS
    rate_kernels = ("vertex_tables", "footprint", "pack_mask_bits", "segment_mean",
                    "segment_mean_bwd", "segment_pool", "segment_pool_bwd", "pn_frac_plane",
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
    # one launch a frac plane, three planes a step
    if per_step["pn_frac_plane"] != 3:
        raise AssertionError(f"[rate] {per_step['pn_frac_plane']} frac-plane launches per step,"
                             f" not 3")
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
    check_walk_faults(volrend, dev, f"[train, rate] after {RATE_STEPS} rate steps:")
    check_rate_gradient(torch, trr, rf, cops, enc, ent_ops, f"step {RATE_STEPS}")

    def one_rate_step():
        batch, pixels = train_set.fetch_rays(trr.generator, rate_hist[-1][5])
        trr._train_step(batch.origins, batch.viewdirs, pixels, bkgd,
                        ent_cache=trr._last_ent_cache)

    one_rate_step()
    profile_view(torch, one_rate_step, "profile_rate")

    # the frac plane's backward kernel: three steps with pn_frac_grad on
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
        f" pn_frac_plane {pn_launches['pn_frac_plane']} pn_hist_bwd"
        f" {pn_launches['pn_hist_bwd']}")
    if not (pn_launches["pn_hist_bwd"] > 0 and all(math.isfinite(b) for b in pn_bits)):
        raise AssertionError(f"[rate, pn_frac_grad] the backward kernel did not launch:"
                             f" {pn_launches}")
    check_order_faults(cops, dev, "[rate, pn_frac_grad]")
    del tr_pn, entropy_pn
    mark("rate")

    # ---- [dp]: K7p/K7pb on the rate run's planes, a group of one rank over
    # NCCL, two ranks sharing the card over gloo
    dp_launches = run_dp_phase(torch, kernels, cops, rate_cfg, train_set, trr, rate_hist[-1][5],
                               ms_rate_step, gen, dev, records)
    check_order_faults(cops, dev, "[dp]")
    mark("dp")

    # ---- 10. [codec]
    enc_launches, dec_launches, codec_launches = run_codec(
        torch, kernels, rf, trr, entropy, test_set, rate_cfg, bpp_end, records)

    # ---- 11. cnc_tpu's committed bundles, decoded and rendered on the card
    mark("codec")
    check_bundles(torch, kernels, volrend, dev)
    mark("bundles")

    # ---- 12. [breadth]: K1s/K2s on the trained occupancy grid, the unbounded
    # trainer, the proposal sampler, the MLP fields, LPIPS, the undistortion
    breadth_launches = run_breadth(torch, kernels, enc, tr, train_set, gen, dev, records)
    mark("breadth")

    # ---- 13. [pipeline]: train, checkpoint, resume in a fresh process, the
    # pipeline and its row, the CLI's decode
    pipeline_launches = run_pipeline_phase(torch, kernels, volrend, cops, dev)
    mark("pipeline")

    # ---- 14. report: `launches` is the count over the path named beside it
    # (one view, the lambda = 0 training run, the probe's one drive, the rate
    # path from the model's build to the run's last step, the three
    # pn_frac_grad steps, the codec path: int cache, encode and decode, or
    # the SAT-masked encode's drive in [breadth])
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
        # the whole plane: sampling, histogram, divide, border and layout
        "pn_frac_plane": ("pn_hist.cu", "cnc_tpu/models/context_models.py:756", "rate"),
        "pn_hist_bwd": ("pn_hist.cu", "cnc_tpu/models/context_models.py:62", "rate_pn_grad"),
        # a rank's share of the plane (the rows of its chunk) and its backward
        # in the data-parallel step: the sliced histogram under axis_name
        "pn_hist_part": ("pn_hist.cu", "cnc_tpu/models/context_models.py:783", "dp"),
        "pn_hist_part_bwd": ("pn_hist.cu", "cnc_tpu/models/context_models.py:62", "dp_pn_grad"),
        "footprint": ("footprint.cu", "cnc_tpu/models/context_models.py:1415", "rate"),
        "vertex_tables": ("vertex_tables.cu", "cnc_tpu/models/context_models.py:269", "rate"),
        # cnc_tpu's pool composition: int_encode_levels (intctx.py:110), the
        # plane (:173), the MLPs (:214-242) and segment_sum_int (:325)
        "int_ctx_pool": ("int_context.cu", "cnc_tpu/models/context_models.py:1197", "codec"),
        # K9c, the epilogue of the pool's launch: launches are the pool
        # launches that finish their entries
        "int_pq": ("int_context.cu", "cnc_tpu/codec/intctx.py:344", "codec"),
        "pn_hist_int": ("pn_hist.cu", "cnc_tpu/codec/intctx.py:298", "codec"),
        # the packed copy of the mask cnc_tpu reads as bools at encoding.py:90-94
        "pack_mask_bits": ("grid_encode.cu", "cnc_tpu/ops/encoding.py:90", "rate"),
        # K1s/K2s: the corner masking by the summed-area table
        # (encoding.py:95-97, sat.py:94) and its scatter-add backward
        "grid_encode_s": ("grid_encode.cu", "cnc_tpu/ops/encoding.py:95", "breadth"),
        "grid_encode_s_bwd": ("grid_encode.cu", "cnc_tpu/ops/scatter_ops.py:104", "breadth"),
        # their sources, made once a forward from the table: the coarse
        # levels' corner bits (occupancy_mask over the lattice) and the
        # occupancy rows (box_count of each cell)
        "sat_mask_sources": ("grid_encode.cu", "cnc_tpu/ops/sat.py:94", "breadth"),
    }
    counted = {"view": launches, "train": train_launches, "probe": probe_launches,
               "rate": rate_launches, "rate_pn_grad": pn_launches, "codec": codec_launches,
               "breadth": breadth_launches, **dp_launches}
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
                        refresh_device_ms=r.get("refresh_device_ms"),
                        refresh_bound_ms=r.get("refresh_bound_ms"),
                        refresh_launches=r.get("refresh_launches"),
                        pass_device_ms=r.get("pass_device_ms"),
                        bound_two_kernels_ms=r.get("bound_two_kernels_ms"), other=r.get("other"),
                        **{k: r[k] for k in ("added_device_ms", "finishing_launches_per_pass",
                                             "pulls_per_pool", "longest", "level_peak_gib",
                                             "kernel_device_ms", "kernel_bound_ms",
                                             "fill_device_ms", "device_ops",
                                             "dp_w1_ms_per_step", "dp_w2_ms_per_step")
                           if k in r},
                        rate_launches_per_step=rate_per_step.get(name),
                        pipeline_launches=pipeline_launches.get(name, 0)))
    log(f"[phases] seconds: {json.dumps(phase_s)}")
    log(f"[done] {time.time() - t_start:.1f} s")
    kernels_line = json.dumps({"kernels": out})
    (Path("chiprun_out") / "kernels.json").write_text(kernels_line + "\n")
    print(kernels_line)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--pipeline-resume":
        sys.exit(pipeline_resume(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--dp-rank":
        sys.exit(dp_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
