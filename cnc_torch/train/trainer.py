"""End-to-end training orchestration.

Port of `cnc_tpu/train/trainer.py`, the host loop of the reference training
script's hot loop (train_CNC_nerf_synthetic.py:302-366): per step the
occupancy EMA update every 16 steps, a random ray batch, the budgeted render,
MSE (+ lambda * bits_per_param once an entropy model is attached), two Adam
optimizers, and dynamic ray batching toward 2^18 samples per step.
Checkpoints are cnc_tpu's npz layout (`utils/checkpoint.py`): a Trainer
whose `train.checkpoint_path` exists resumes from it, and `fit` saves there
every `train.checkpoint_every` steps.

With `group` (`parallel/sharding.make_group`), the step is cnc_tpu's
`Trainer(mesh=)`: data parallel over rays, one process a rank.  Every rank
fetches the same global batch and keeps its rows, renders them with the
per-rank sample capacity, rates its own entry windows (with the group's
row-sharded frac plane), sums the gradients over the group in one all-reduce
and takes the same update; see `parallel/sharding.py`.

What differs from cnc_tpu is XLA mechanics, not semantics: there are no jit
caches and no `warm_compile`; PyTorch runs the step eagerly.  One backward
over `mse + scale * (bits2d + bits3d)` takes the place of cnc_tpu's three
separately compiled gradients (the split was for the TPU compiler; the sum is
the same).  The ray count still moves in power-of-two buckets, so both
packages take the same batch sizes.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import CNCConfig
from ..grids import occupancy as occ
from ..models import radiance_field as rf
from ..parallel import sharding
from ..render import renderer
from ..utils import checkpoint as ckpt
from ..utils import metrics as M
from ..utils import threefry
from ..utils.device import resolve_device, same_device
from . import optim


def _next_bucket(n: int, lo: int, hi: int, multiple: int = 1) -> int:
    """The smallest power-of-two multiple of `lo` that holds n, at most hi,
    rounded down to a multiple of `multiple` (the group's size: the batch
    splits evenly over the ranks) but never below it."""
    b = lo
    while b < n and b < hi:
        b *= 2
    b = min(b, hi)
    return max(b // multiple, 1) * multiple


def cnc_tpu_initial_state(cfg: CNCConfig, seed: int, entropy=None):
    """cnc_tpu `Trainer.__init__`'s `params` and `ent_params` at `seed`, as
    numpy trees, drawn with the port's threefry (no JAX): `PRNGKey(seed)`
    split three ways, the field from the second key, the context MLPs from
    the third (`{}` without an entropy model).  `rf.params_from_jax` and
    `ContextModels.ent_params_from_jax` load them; `Trainer.
    start_from_cnc_tpu` does both."""
    _, k_field, k_ent = threefry.split(threefry.prng_key(seed), 3)
    params = rf.cnc_tpu_initial_params(cfg.model, k_field)
    ent = entropy.cnc_tpu_initial_params(k_ent) if entropy is not None else {}
    return params, ent


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

    `group` (a `parallel.sharding.Group` on the trainer's device; the
    device defaults to the group's) makes the step data parallel over the
    group's ranks, as cnc_tpu's `mesh`: build the entropy model with the
    per-rank quotas (`driver.build_entropy(cfg, W)`).  Every rank must be
    built alike (same config, seed and checkpoint).  Rank 0 alone logs and
    saves checkpoints; `fit` checks that the ranks' replicas are bit-equal
    when it starts and when it ends.
    """

    def __init__(self, cfg: CNCConfig, dataset, entropy=None, seed: Optional[int] = None,
                 device=None, group=None):
        self.cfg = cfg
        self.dataset = dataset
        self.group = group
        if group is not None and device is None:
            device = group.device
        self.device = resolve_device(device)
        if group is not None and not same_device(group.device, self.device):
            raise ValueError(f"the group's rank lives on {group.device}, the trainer on "
                             f"{self.device}")
        self.world_size = group.world_size if group is not None else 1
        self.rank = group.rank if group is not None else 0
        self.entropy = entropy
        if entropy is not None and not same_device(entropy.device, self.device):
            raise ValueError(f"the entropy model lives on {entropy.device}, the trainer on "
                             f"{self.device}")
        self.aabb = torch.tensor(cfg.render.aabb, dtype=torch.float32, device=self.device)
        self.reset_state(seed=seed)
        # resume from an existing checkpoint when configured
        cp = cfg.train.checkpoint_path
        if cp and os.path.exists(ckpt.norm_path(cp)):
            ckpt.load_checkpoint(cp, self)

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
        self.seed = seed
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

    def start_from_cnc_tpu(self) -> None:
        """Replace the fresh field and context MLPs with cnc_tpu's initial
        ones at this trainer's seed (`cnc_tpu_initial_state`), in place, so
        the optimizers keep their parameters.  Only before the first step;
        the generator and everything else stay the port's."""
        if self.step != 0:
            raise ValueError(f"start_from_cnc_tpu at step {self.step}: only before the first")
        params, ent = cnc_tpu_initial_state(self.cfg, self.seed, self.entropy)
        pairs = [(self.field, rf.params_from_jax(params, self.cfg.model, device="cpu"))]
        if self.entropy is not None:
            pairs.append((self.ent_params, self.entropy.ent_params_from_jax(ent)))
        with torch.no_grad():
            for dst, src in pairs:
                src = src.state_dict()
                for name, p in dst.state_dict().items():
                    p.copy_(src[name])

    # ------------------------------------------------------------------ occ
    def _occ_eval_fn(self, x: torch.Tensor) -> torch.Tensor:
        d = rf.query_density(self.field, self.cfg.model, self.aabb, x)
        return d * self.cfg.render.render_step_size

    # ----------------------------------------------------------------- step
    def rank_capacity(self, world_size: int) -> int:
        """The sample buffer of one rank's render (cnc_tpu's per_dev_cap)."""
        cap = self.cfg.render.sample_capacity
        return cap if world_size == 1 else max(8, cap // world_size)

    def _render_terms(self, rays_o, rays_d, pixels, bkgd, jitter=None, generator=None,
                      capacity=None):
        """One training render: (the squared error summed over the kept
        pixels, their count, the render's output)."""
        cfg = self.cfg
        out = renderer.render_rays_train(
            self.field, cfg.model, cfg.render, self.aabb, self.occ_state.binaries, rays_o,
            rays_d, generator if generator is not None else self.generator, bkgd,
            capacity=capacity, jitter=jitter)
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
        return sq, n_px, out

    def _render_loss(self, rays_o, rays_d, pixels, bkgd, jitter=None):
        """MSE of one training render and its sample counts."""
        sq, n_px, out = self._render_terms(rays_o, rays_d, pixels, bkgd, jitter)
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

    def _uses_rate(self) -> bool:
        """Whether this step takes the rate terms."""
        cfg = self.cfg
        return (self.entropy is not None and cfg.train.lmbda > 0
                and self.step % cfg.train.rate_update_interval == 0)

    def _rate_terms(self, tables, starts, ent_cache, group):
        """(the estimated bits of the four tables over `starts`' windows, the
        3D context budget's utilization)."""
        bits2d = self.entropy.rate_bits_2d(self.ent_params, tables, starts["2d"], ent_cache,
                                           group=group)
        bits3d, ctx_util = self.entropy.rate_bits_3d(
            self.ent_params, tables["xyz"], starts["3d"], ent_cache, with_util=True)
        return bits2d + bits3d, ctx_util

    def _rate_aux(self, ttl, ctx_util) -> Dict:
        return {"bits_per_param": ttl / self.entropy.total_param_count,
                "embed_MB": ttl / 8.0 / 1024.0 / 1024.0, "ctx_util": ctx_util}

    def _zero_grads(self, use_entropy: bool) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        if use_entropy:
            self.opt_ent.zero_grad(set_to_none=True)

    def _apply_update(self, use_entropy: bool) -> None:
        """One step of the field's optimizer and, on rate steps, of the
        context MLPs'; each schedule moves with its optimizer."""
        self.optimizer.step()
        self.scheduler.step()
        if use_entropy:
            self.opt_ent.step()
            self.sched_ent.step()

    def _train_step(self, rays_o, rays_d, pixels, bkgd, jitter=None, ent_cache=None,
                    starts=None) -> Dict:
        """Render gradient, the rate gradients on the steps that take them,
        and one update of each optimizer.  `jitter`, when given, replaces the
        march's draw, `starts` the entry-window draws
        (`ContextModels.draw_starts`).  The entropy optimizer steps only on
        rate steps.

        One body serves both cases (cnc_tpu's shard_body and rate body).
        Without a group the reductions are the values themselves and the
        draws (the starts, then the jitter) come from `self.generator`.  With
        a group the rays are the global batch, of which the rank keeps its
        rows, and `jitter` and `starts` are the rank's: the render loss is
        this rank's squared error over the group's pixel count, the rate
        this rank's estimate over W; after the backward the gradients are
        summed over the group and every rank takes the same update.  The
        shared draws (the batch, the occupancy candidates) come from
        `self.generator`; the rank's own from a generator seeded from one
        shared draw and its rank."""
        cfg, group, w = self.cfg, self.group, self.world_size
        use_entropy = self._uses_rate()
        gen = self.generator
        if group is not None:
            rays_o, rays_d, pixels = sharding.shard_rays(group, rays_o, rays_d, pixels)
            if jitter is None or (use_entropy and starts is None):
                gen = sharding.rank_generator(self.device, sharding.draw_rank_seed(gen),
                                              group.rank)
        if use_entropy and starts is None:
            # drawn (one small device read) before the step's work is queued
            starts = self.entropy.draw_starts(gen)
        self._zero_grads(use_entropy)
        sq, n_px, out = self._render_terms(rays_o, rays_d, pixels, bkgd, jitter, gen,
                                           self.rank_capacity(w))
        stats = [sq, n_px, out.n_rendering_samples, out.n_marched_samples]
        if use_entropy:
            tables = rf.quantized_tables(self.field, cfg.model)
            ttl_bits, ctx_util = self._rate_terms(tables, starts, ent_cache, group)
            stats += [ttl_bits, ctx_util]
        tot = sharding.reduce_stats(stats, group)
        max_depth = sharding.reduce_stats([out.depth.detach().max()], group,
                                          sharding.ReduceOp.MAX)[0]
        loss = sq / tot[1].to(torch.float32)
        aux = {"mse": (tot[0] / tot[1]).to(torch.float32), "n_samples": tot[2].to(torch.int64),
               "n_marched": tot[3].to(torch.int64), "max_depth": max_depth.to(torch.float32)}
        if use_entropy:
            # pmean's share: the mean of the ranks' estimates
            loss = loss + self._rate_scale() * ttl_bits / w
            aux.update(self._rate_aux((tot[4] / w).to(torch.float32),
                                      (tot[5] / w).to(torch.float32)))
        loss.backward()
        if group is not None:
            params = list(self.field.parameters())
            if use_entropy:
                params += list(self.ent_params.parameters())
            sharding.all_reduce_grads(params, group)
        self._apply_update(use_entropy)
        return aux

    # ------------------------------------------------------------------ fit
    def fit(self, max_steps: Optional[int] = None, log_every: int = 200, log_fn=print,
            step_callback=None) -> float:
        """Train until the absolute step counter passes max_steps (inclusive,
        matching the reference's `range(max_steps + 1)` loop,
        train_CNC_nerf_synthetic.py:302).  A completed run is a no-op.  Returns the seconds it took.

        step_callback(step, aux) is invoked after each completed step's host
        sync (the loop syncs per step to read the sample counts, so wall time
        between callbacks is true per-step latency).

        With a group every rank calls it alike: the bucket is a multiple of
        the group's size, rank 0 alone logs and saves, and the ranks'
        replicas are checked bit-equal before the first step and after the
        last (`sharding.check_replicated`, which raises)."""
        cfg = self.cfg
        max_steps = max_steps if max_steps is not None else cfg.train.max_steps
        tic = time.time()
        if self.rank != 0:
            log_every = 0
        if self.group is not None:
            sharding.check_replicated(self.group, sharding.trainer_state(self),
                                      f"before step {self.step}")
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
                                  cfg.train.max_ray_bucket, self.world_size)
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
            # saved before the step counter moves on, as cnc_tpu does: a file
            # written after step s's update records s, and a run resumed
            # from it takes step s again
            cp = cfg.train.checkpoint_path
            if (cp and cfg.train.checkpoint_every > 0 and s > 0 and self.rank == 0
                    and s % cfg.train.checkpoint_every == 0):
                ckpt.save_checkpoint(cp, self)
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
        if self.group is not None:
            sharding.check_replicated(self.group, sharding.trainer_state(self),
                                      f"after step {self.step - 1}")
        return time.time() - tic

    # ----------------------------------------------------------------- eval
    def eval_image(self, index: int, dataset=None, progress_fn=None):
        ds = dataset or self.dataset
        rays, gt = ds.image_and_rays(index)
        rgb, _, _ = renderer.render_image(
            self.field, self.cfg.model, self.cfg.render, self.aabb, self.occ_state.binaries,
            rays.origins, rays.viewdirs, torch.ones(3), device=self.device,
            progress_fn=progress_fn)
        return rgb, gt

    def evaluate(self, dataset=None, max_images: Optional[int] = None, log_fn=None):
        """Mean PSNR, SSIM and LPIPS over the first `max_images` views; LPIPS
        is None (recorded "n/a") when no VGG weight file is found.  log_fn,
        when given, receives a heartbeat every 8 chunks of each view's
        render, so a long eval stays visible to a log-staleness watchdog."""
        ds = dataset or self.dataset
        n = len(ds) if max_images is None else min(max_images, len(ds))
        psnrs, ssims, lpips_vals = [], [], []
        for i in range(n):
            prog = (None if log_fn is None else
                    (lambda c, t, _i=i: log_fn(f"  eval image {_i + 1}/{n}: chunk {c}/{t}")))
            rgb, gt = self.eval_image(i, ds, progress_fn=prog)
            psnrs.append(float(M.psnr(rgb, gt)))
            ssims.append(float(M.ssim(rgb, gt)))
            lp = M.lpips_fn(rgb, gt)
            if lp is not None:
                lpips_vals.append(lp)
        return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
                "lpips": float(np.mean(lpips_vals)) if lpips_vals else None}
