"""Occupancy-guided ray marching with static-size compaction (K4 + K3).

Port of `cnc_tpu/render/marching.py`, with its structure and buffers, so the
sample sets are identical to cnc_tpu's, truncation included:

  1. COARSE: test each ray's lattice blocks (B consecutive steps) against a
     dilated low-res mip of the occupancy grid, one test per (ray, block).
  2. FINE: compact the candidate (ray, block) pairs to a fixed budget, test
     each of their B step midpoints against the full-res grid, and compact
     the hits into the fixed-capacity sample buffer.

Both compactions preserve (ray, t) order, so volume rendering is a plain
contiguous segment scan.  Samples are midpoints of [t, t+dt] intervals.
This is the deterministic (eval) march; the stratified near jitter of
cnc_tpu's `key` argument comes with training.

`march_rays` dispatches on the device of `rays_o`: a CPU tensor takes the
plain twin (`_march_plain`, with K3's plain twin between the passes), a CUDA
tensor the kernels of csrc/march.cu with K3 between the passes.

Float rounding follows cnc_tpu exactly: JAX rounds weak-typed Python scalars
(b*dt, (step+0.5)*dt, 1-1e-6) to f32 before the multiply, so both paths here
use f32-rounded constants (`_f32`), and the CUDA file is built without FMA
contraction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..config import RenderConfig
from ..ops import scatter_ops


class RaySamples(NamedTuple):
    """Compacted sample buffer (nerfacc RaySamples, data_specs.py:91)."""
    ray_id: torch.Tensor      # [cap] int32, sorted ascending
    t_mid: torch.Tensor       # [cap] float32 midpoint distance
    dt: float                 # step size, f32-rounded
    valid: torch.Tensor       # [cap] bool
    num_samples: torch.Tensor  # 0-dim int32: occupancy hits before truncation
    # (exact when the coarse pass fit its budget, else an extrapolation)
    truncated: Optional[torch.Tensor] = None   # 0-dim bool: a buffer overflowed
    resume_ray: Optional[torch.Tensor] = None  # 0-dim int32: first ray whose
    # samples may be incomplete (== n_rays when nothing truncated)


def _f32(x: float) -> float:
    """x rounded to float32, as JAX rounds a weak-typed Python scalar."""
    return float(np.float32(x))


def ray_aabb_intersect(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       aabb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test (nerfacc grid.cu:513-555). Returns (tmin, tmax); tmin > tmax
    means a miss."""
    eps = _f32(1e-10)
    small = torch.where(rays_d >= 0, eps, -eps)
    inv_d = 1.0 / torch.where(rays_d.abs() < eps, small, rays_d)
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    return tmin, tmax


def occupancy_lookup(pos: torch.Tensor, binaries: torch.Tensor,
                     aabb: torch.Tensor) -> torch.Tensor:
    """Binary-grid membership of world positions (inside-aabb AND occupied)."""
    res = binaries.shape[0]
    lo, hi = aabb[:3], aabb[3:]
    x01 = (pos - lo) / (hi - lo)
    inside = ((x01 >= 0.0) & (x01 < 1.0)).all(dim=-1)
    vox = (x01 * float(res)).to(torch.int64).clamp(0, res - 1)
    flat = (vox[..., 0] * res + vox[..., 1]) * res + vox[..., 2]
    return binaries.reshape(-1)[flat] & inside


def build_march_mip(binaries: torch.Tensor) -> torch.Tensor:
    """Dilated any-occupancy mip for coarse block culling: max-pool to ~16^3,
    then dilate by one cell per axis (plain torch; built once per chunk)."""
    res = binaries.shape[0]
    m = res // 16 if (res % 16 == 0 and res > 16) else 1
    mr = res // m
    mip = binaries.reshape(mr, m, mr, m, mr, m).any(dim=5).any(dim=3).any(dim=1)
    for axis in range(3):
        pad = [0, 0] * 3
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 1
        p = F.pad(mip.to(torch.uint8), pad).bool()
        n = mip.shape[axis]
        mip = p.narrow(axis, 0, n) | p.narrow(axis, 1, n) | p.narrow(axis, 2, n)
    return mip


def _coarse_block(cfg: RenderConfig, mip_res: int) -> int:
    """Largest safe block length: B*dt/2 must not exceed one mip-cell extent."""
    ext = min((cfg.aabb[3 + a] - cfg.aabb[a]) / mip_res for a in range(3))
    return max(1, min(cfg.march_block, int(2.0 * ext / cfg.render_step_size)))


class _Plan(NamedTuple):
    s: int          # steps per ray
    b: int          # steps per coarse block
    nb: int         # blocks per ray
    cap_c: int      # candidate-block budget
    dt: float       # f32-rounded constants
    bdt: float
    near: float
    far: float
    clip_hi: float


def _plan(cfg: RenderConfig, capacity: int, mres: int, max_steps: Optional[int]) -> _Plan:
    s = max_steps or cfg.max_march_steps
    b = _coarse_block(cfg, mres)
    return _Plan(s=s, b=b, nb=-(-s // b), cap_c=max(256, capacity // 4),
                 dt=_f32(cfg.render_step_size), bdt=_f32(b * cfg.render_step_size),
                 near=_f32(cfg.near_plane), far=_f32(cfg.far_plane),
                 clip_hi=_f32(1.0 - 1e-6))


def _march_plain(rays_o, rays_d, binaries, aabb, cfg, capacity, ray_mask, t_start, max_steps,
                 mip) -> RaySamples:
    r = rays_o.shape[0]
    dev = rays_o.device
    pl = _plan(cfg, capacity, mip.shape[0], max_steps)

    tmin, tmax = ray_aabb_intersect(rays_o, rays_d, aabb)
    tmin = torch.clamp(tmin, min=pl.near)
    tmax = torch.clamp(tmax, max=pl.far)
    if t_start is not None:
        tmin = torch.maximum(tmin, t_start)
    hit = tmin < tmax
    if ray_mask is not None:
        hit = hit & ray_mask

    # ---- coarse pass: dilated-mip test per (ray, block) midpoint
    mres = mip.shape[0]
    lo, hi = aabb[:3], aabb[3:]
    blk_i = torch.arange(pl.nb, dtype=torch.float32, device=dev)
    tc = tmin[:, None] + (blk_i[None, :] + 0.5) * pl.bdt                 # [R, NB]
    posc = rays_o[:, None, :] + rays_d[:, None, :] * tc[..., None]
    # clamp into the aabb before voxelizing (the 1-cell dilation covers it)
    x01 = torch.clamp((posc - lo) / (hi - lo), 0.0, pl.clip_hi)
    vox = (x01 * float(mres)).to(torch.int64)
    cand = mip.reshape(-1)[(vox[..., 0] * mres + vox[..., 1]) * mres + vox[..., 2]]
    blk_start = tmin[:, None] + blk_i[None, :] * pl.bdt
    cand = cand & (blk_start < tmax[:, None]) & hit[:, None]

    src_c, total_c = scatter_ops._compact_plain(cand.reshape(-1), pl.cap_c)
    slots_c = torch.arange(pl.cap_c, device=dev)
    cvalid = slots_c < torch.clamp(total_c, max=pl.cap_c)
    c_ray = src_c.long() // pl.nb
    c_blk = src_c.long() % pl.nb

    # ---- fine pass: full-res occupancy per candidate-block step midpoint
    j = torch.arange(pl.b, dtype=torch.float32, device=dev)
    step_f = c_blk[:, None].float() * float(pl.b) + j[None, :]             # [cap_c, b]
    tf = tmin[c_ray][:, None] + (step_f + 0.5) * pl.dt
    posf = rays_o[c_ray][:, None, :] + rays_d[c_ray][:, None, :] * tf[..., None]
    bits = occupancy_lookup(posf, binaries, aabb)
    bits = (bits & (tf < tmax[c_ray][:, None]) & cvalid[:, None]
            & (step_f < float(pl.s)))

    src_f, total_f = scatter_ops._compact_plain(bits.reshape(-1), capacity)
    fvalid = torch.arange(capacity, device=dev) < torch.clamp(total_f, max=capacity)
    ci = src_f.long() // pl.b
    ray_id = c_ray[ci]
    step = c_blk[ci] * pl.b + src_f.long() % pl.b
    t_mid = tmin[ray_id] + (step.float() + 0.5) * pl.dt
    ray_id = torch.where(fvalid, ray_id, r - 1).to(torch.int32)  # park padding on last ray

    # hit-count estimate: exact when the coarse pass fit, else extrapolated
    kept_c = torch.clamp(torch.clamp(total_c, max=pl.cap_c), min=1)
    est = total_f.float() * total_c.float() / kept_c.float()
    truncated = (total_f > capacity) | (total_c > pl.cap_c)
    # first possibly-incomplete ray: a fine-buffer cut precedes a coarse cut
    no_cut = torch.full((), r, dtype=torch.int32, device=dev)
    resume_ray = torch.where(
        total_f > capacity, ray_id[capacity - 1],
        torch.where(total_c > pl.cap_c, c_ray[pl.cap_c - 1].to(torch.int32), no_cut))
    return RaySamples(ray_id=ray_id, t_mid=t_mid, dt=pl.dt, valid=fvalid,
                      num_samples=est.to(torch.int32), truncated=truncated,
                      resume_ray=resume_ray)


def _march_cuda(rays_o, rays_d, binaries, aabb, cfg, capacity, ray_mask, t_start, max_steps,
                mip) -> RaySamples:
    kernels.require_cuda("march_rays", rays_o, rays_d, aabb, binaries, mip, t_start, ray_mask)
    f32s, bools = (rays_o, rays_d, aabb, t_start), (binaries, mip, ray_mask)
    if any(t is not None and t.dtype != torch.float32 for t in f32s) or any(
            t is not None and t.dtype != torch.bool for t in bools):
        raise ValueError("march_rays: rays, aabb and t_start must be float32; binaries, mip "
                         "and ray_mask bool")
    r = rays_o.shape[0]
    dev = rays_o.device
    mres, res = mip.shape[0], binaries.shape[0]
    pl = _plan(cfg, capacity, mres, max_steps)
    p = kernels.ptr
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    tmin, tmax = torch.empty(r, **f32), torch.empty(r, **f32)
    cand = torch.empty(r * pl.nb, dtype=torch.bool, device=dev)
    kernels.call("cnc_march_coarse", p(rays_o), p(rays_d), p(aabb), p(t_start), p(ray_mask),
                 p(mip), mres, r, pl.nb, pl.bdt, pl.near, pl.far, pl.clip_hi, p(tmin), p(tmax),
                 p(cand))
    kernels.launches["march"] += 1
    src_c, total_c = scatter_ops.compact_mask_indices(cand, pl.cap_c)

    bits = torch.empty(pl.cap_c * pl.b, dtype=torch.bool, device=dev)
    kernels.call("cnc_march_fine", p(rays_o), p(rays_d), p(aabb), p(tmin), p(tmax), p(src_c),
                 p(total_c), pl.cap_c, pl.nb, pl.b, pl.s, pl.dt, p(binaries), res, p(bits))
    kernels.launches["march"] += 1
    src_f, total_f = scatter_ops.compact_mask_indices(bits, capacity)

    ray_id, t_mid = torch.empty(capacity, **i32), torch.empty(capacity, **f32)
    valid = torch.empty(capacity, dtype=torch.bool, device=dev)
    scalars = torch.empty(3, **i32)
    kernels.call("cnc_march_finish", p(tmin), p(src_c), p(total_c), pl.cap_c, p(src_f),
                 p(total_f), capacity, pl.nb, pl.b, r, pl.dt, p(ray_id), p(t_mid), p(valid),
                 p(scalars))
    kernels.launches["march"] += 1
    return RaySamples(ray_id=ray_id, t_mid=t_mid, dt=pl.dt, valid=valid,
                      num_samples=scalars[2], truncated=scalars[0].bool(),
                      resume_ray=scalars[1])


def march_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, binaries: torch.Tensor,
               aabb: torch.Tensor, cfg: RenderConfig, capacity: int,
               ray_mask: Optional[torch.Tensor] = None,
               t_start: Optional[torch.Tensor] = None,
               max_steps: Optional[int] = None,
               mip: Optional[torch.Tensor] = None) -> RaySamples:
    """March rays through the occupancy grid and compact the hits.

    Args:
      rays_o/rays_d: [R, 3] float32.
      binaries: [res, res, res] bool occupancy grid; aabb: [6] float32.
      capacity: output buffer size.
      ray_mask: optional [R] bool; masked-out rays yield no samples.
      t_start: optional [R] per-ray start distance (resuming eval marches).
      max_steps: steps per ray (default cfg.max_march_steps).
      mip: optional precomputed build_march_mip(binaries), for loops.
    Returns:
      RaySamples in (ray, t) order.
    """
    if mip is None:
        mip = build_march_mip(binaries)
    if rays_o.is_cuda:
        c = lambda t: None if t is None else t.contiguous()
        return _march_cuda(c(rays_o), c(rays_d), c(binaries), c(aabb), cfg, capacity,
                           c(ray_mask), c(t_start), max_steps, c(mip))
    return _march_plain(rays_o, rays_d, binaries, aabb, cfg, capacity, ray_mask, t_start,
                        max_steps, mip)


def sample_positions(samples: RaySamples, rays_o: torch.Tensor,
                     rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World positions and unit directions of compacted samples."""
    rid = samples.ray_id.long()
    d = rays_d[rid]
    return rays_o[rid] + d * samples.t_mid[:, None], d
