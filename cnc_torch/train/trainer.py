"""End-to-end training orchestration.

Port of `cnc_tpu/train/trainer.py`, the host loop of the reference training
script's hot loop (train_CNC_nerf_synthetic.py:302-366): per step the
occupancy EMA update every 16 steps, a random ray batch, the budgeted render,
MSE (+ lambda * bits_per_param once an entropy model is attached), two Adam
optimizers, and dynamic ray batching toward 2^18 samples per step.
Checkpoints are not ported yet and raise.

What differs from cnc_tpu is XLA mechanics, not semantics: there are no jit
caches, no mesh and no `warm_compile`; PyTorch runs the step eagerly.  One
backward over `mse + scale * (bits2d + bits3d)` takes the place of cnc_tpu's
three separately compiled gradients (the split was for the TPU compiler; the
sum is the same).  The ray count still moves in power-of-two buckets, so both
packages take the same batch sizes.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import CNCConfig
from ..grids import occupancy as occ
from ..models import radiance_field as rf
from ..render import renderer
from ..utils import metrics as M
from ..utils.device import resolve_device
from . import optim


def _next_bucket(n: int, lo: int, hi: int) -> int:
    """The smallest power-of-two multiple of `lo` that holds n, at most hi."""
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


class Trainer:
    """Owns the field, the optimizer, the occupancy grid and the generator.

    Runs on `device` (default cuda; raises when there is none and
    `device="cpu"` was not asked for).  The dataset must live on the same
    device.  The field's initial weights come from a CPU generator seeded
    with `seed`, so they do not depend on the device; the training draws
    (ray batches, jitter, occupancy candidates) come from `self.generator`,
    which lives on the device.

    `entropy` is a `models.context_models.ContextModels` on the same device;
    with it and `cfg.train.lmbda > 0` the step adds the rate terms and trains
    the context MLPs (`self.ent_params`) with their own Adam.
    """

    def __init__(self, cfg: CNCConfig, dataset, entropy=None, seed: Optional[int] = None,
                 device=None):
        if cfg.train.checkpoint_path:
            raise NotImplementedError("checkpoint save/resume (train.checkpoint_path) comes "
                                      "with port slice 5, the full pipeline")
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.entropy = entropy
        if entropy is not None and entropy.device != self.device:
            raise ValueError(f"the entropy model lives on {entropy.device}, the trainer on "
                             f"{self.device}")
        self.aabb = torch.tensor(cfg.render.aabb, dtype=torch.float32, device=self.device)
        self.reset_state(seed=seed)

    # ---------------------------------------------------------------- reset
    def reset_state(self, lmbda: Optional[float] = None,
                    rate_update_interval: Optional[int] = None, seed: Optional[int] = None):
        """Reinitialize all training state (field, context MLPs, optimizers,
        occupancy grid, generator, step counter), optionally with another
        lmbda or rate_update_interval (an in-process rate-distortion sweep);
        matches a fresh Trainer(cfg', dataset, entropy)."""
        tr = self.cfg.train
        if lmbda is not None or rate_update_interval is not None:
            tr = dataclasses.replace(
                tr, lmbda=tr.lmbda if lmbda is None else lmbda,
                rate_update_interval=(tr.rate_update_interval if rate_update_interval is None
                                      else rate_update_interval))
            self.cfg = dataclasses.replace(self.cfg, train=tr)
        cfg = self.cfg
        seed = cfg.train.seed if seed is None else seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        init_gen = torch.Generator().manual_seed(seed)
        self.field = rf.RadianceField(cfg.model, init_gen, device=self.device)
        self.optimizer, self.scheduler = optim.make_optimizer(
            self.field.parameters(), cfg.train, cfg.train.weight_decay)
        if self.entropy is not None:
            self.ent_params = self.entropy.init_params(init_gen)
            self.opt_ent, self.sched_ent = optim.make_optimizer(self.ent_params.parameters(),
                                                                cfg.train)
        else:
            self.ent_params = self.opt_ent = self.sched_ent = None
        self._last_ent_cache = None
        self.occ_state = occ.init_occ_grid(self.aabb, cfg.render.occ_resolution,
                                           device=self.device)
        self.num_rays = cfg.train.init_batch_size
        self.step = 0

    # ------------------------------------------------------------------ occ
    def _occ_eval_fn(self, x: torch.Tensor) -> torch.Tensor:
        d = rf.query_density(self.field, self.cfg.model, self.aabb, x)
        return d * self.cfg.render.render_step_size

    # ----------------------------------------------------------------- step
    def _render_loss(self, rays_o, rays_d, pixels, bkgd, jitter=None):
        """MSE of one training render and its sample counts."""
        cfg = self.cfg
        out = renderer.render_rays_train(
            self.field, cfg.model, cfg.render, self.aabb, self.occ_state.binaries, rays_o,
            rays_d, self.generator, bkgd, jitter=jitter)
        if out.resume_ray is not None:
            # visibility-pruned path: rays that lost samples to a buffer
            # overflow render partial colors; exclude them from the loss
            # rather than training on them (renderer.render_rays_train)
            rmask = (torch.arange(pixels.shape[0], device=pixels.device)
                     < out.resume_ray)[:, None]
            sq = torch.where(rmask, (out.rgb - pixels) ** 2, 0.0).sum()
            n_px = torch.clamp(rmask.sum().float() * 3.0, min=3.0)
        else:
            sq = ((out.rgb - pixels) ** 2).sum()
            n_px = float(pixels.numel())
        mse = sq / n_px
        aux = {"mse": mse.detach(), "n_samples": out.n_rendering_samples,
               "n_marched": out.n_marched_samples, "max_depth": out.depth.detach().max()}
        return mse, aux

    def _rate_scale(self) -> float:
        """lmbda * K / total_params, the rate-loss weight.  Scaling by the
        interval K keeps the time-averaged rate pressure equal to the
        reference's every-step objective (train_CNC_nerf_synthetic.py:383)."""
        return (self.cfg.train.lmbda * self.cfg.train.rate_update_interval
                / self.entropy.total_param_count)

    def _train_step(self, rays_o, rays_d, pixels, bkgd, jitter=None, ent_cache=None,
                    starts=None) -> Dict:
        """Render gradient, the rate gradients on the steps that take them,
        and one update of each optimizer.  `jitter`, when given, replaces the
        march's draw from the generator, `starts` the entry-window draws
        (`ContextModels.draw_starts`).  The entropy optimizer steps only on
        rate steps."""
        cfg = self.cfg
        use_entropy = (self.entropy is not None and cfg.train.lmbda > 0
                       and self.step % cfg.train.rate_update_interval == 0)
        if use_entropy and starts is None:
            # drawn (one small device read) before the step's work is queued
            starts = self.entropy.draw_starts(self.generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self._render_loss(rays_o, rays_d, pixels, bkgd, jitter)
        if use_entropy:
            self.opt_ent.zero_grad(set_to_none=True)
            tables = rf.quantized_tables(self.field, cfg.model)
            bits2d = self.entropy.rate_bits_2d(self.ent_params, tables, starts["2d"], ent_cache)
            bits3d, ctx_util = self.entropy.rate_bits_3d(
                self.ent_params, tables["xyz"], starts["3d"], ent_cache, with_util=True)
            ttl_bits = bits2d + bits3d
            loss = loss + self._rate_scale() * ttl_bits
            ttl = ttl_bits.detach()
            aux = {**aux, "bits_per_param": ttl / self.entropy.total_param_count,
                   "embed_MB": ttl / 8.0 / 1024.0 / 1024.0, "ctx_util": ctx_util}
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        if use_entropy:
            self.opt_ent.step()
            self.sched_ent.step()
        return aux

    # ------------------------------------------------------------------ fit
    def fit(self, max_steps: Optional[int] = None, log_every: int = 200, log_fn=print,
            step_callback=None) -> float:
        """Train until the absolute step counter passes max_steps (inclusive,
        matching the reference's `range(max_steps + 1)` loop,
        train_CNC_nerf_synthetic.py:302).  A completed run is a no-op.  Returns the seconds it took.

        step_callback(step, aux) is invoked after each completed step's host
        sync (the loop syncs per step to read the sample counts, so wall time
        between callbacks is true per-step latency)."""
        cfg = self.cfg
        max_steps = max_steps if max_steps is not None else cfg.train.max_steps
        tic = time.time()
        bkgd = torch.ones(3, device=self.device)
        ent_cache = None
        local = 0
        while self.step <= max_steps:
            s = self.step
            if s % cfg.render.occ_update_interval == 0 or local == 0:
                # local == 0: a run that continues refreshes the grid first
                self.occ_state = occ.update_occ_grid(
                    self.occ_state, self.generator, self._occ_eval_fn,
                    s < cfg.render.occ_warmup_steps, cfg.render)
                if self.entropy is not None:
                    ent_cache = self.entropy.refresh_cache(self.occ_state.binaries)

            bucket = _next_bucket(self.num_rays, cfg.train.min_ray_bucket,
                                  cfg.train.max_ray_bucket)
            rays, pixels = self.dataset.fetch_rays(self.generator, bucket)
            aux = self._train_step(rays.origins, rays.viewdirs, pixels, bkgd,
                                   ent_cache=ent_cache)

            # dynamic ray batching (train_CNC_nerf_synthetic.py:340-344), driven
            # by the true pre-truncation hit count so a saturated buffer
            # shrinks the batch; this read is the step's one host sync
            n_samples, n_marched = (int(v) for v in torch.stack(
                [aux["n_samples"].to(torch.int64), aux["n_marched"].to(torch.int64)]).tolist())
            aux["n_samples"], aux["n_marched"], aux["num_rays"] = n_samples, n_marched, bucket
            if cfg.train.target_sample_batch_size > 0 and n_marched > 0:
                self.num_rays = int(bucket * (cfg.train.target_sample_batch_size
                                              / float(n_marched)))
            if log_every and s % log_every == 0:
                mse = float(aux["mse"])
                msg = (f"elapsed_time={time.time() - tic:.2f}s | step={s} | mse={mse:.5f} | "
                       f"psnr={-10 * math.log10(max(mse, 1e-10)):.2f} | "
                       f"n_rendering_samples={n_samples} | num_rays={bucket} | "
                       f"max_depth={float(aux['max_depth']):.3f}")
                if "bits_per_param" in aux:
                    msg += (f" | bits_per_param={float(aux['bits_per_param']):.3f}"
                            f" | embed_MB={float(aux['embed_MB']):.3f}"
                            f" | ctx_util={float(aux['ctx_util']):.2f}")
                log_fn(msg)
            self.step += 1
            local += 1
            if step_callback is not None:
                step_callback(s, aux)
        self._last_ent_cache = ent_cache
        return time.time() - tic

    # ----------------------------------------------------------------- eval
    def eval_image(self, index: int, dataset=None):
        ds = dataset or self.dataset
        rays, gt = ds.image_and_rays(index)
        rgb, _, _ = renderer.render_image(
            self.field, self.cfg.model, self.cfg.render, self.aabb, self.occ_state.binaries,
            rays.origins, rays.viewdirs, torch.ones(3), device=self.device)
        return rgb, gt

    def evaluate(self, dataset=None, max_images: Optional[int] = None):
        ds = dataset or self.dataset
        n = len(ds) if max_images is None else min(max_images, len(ds))
        psnrs, ssims = [], []
        for i in range(n):
            rgb, gt = self.eval_image(i, ds)
            psnrs.append(float(M.psnr(rgb, gt)))
            ssims.append(float(M.ssim(rgb, gt)))
        # LPIPS needs VGG weights the repo does not ship: recorded as None
        return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)), "lpips": None}
