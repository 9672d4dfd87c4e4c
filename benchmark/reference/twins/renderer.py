"""Training and evaluation renderers.

Port of `cnc_tpu/render/renderer.py`, the reference's two paths:
  * training (`render_rays_train`, 27-91): one budgeted pass: march with the
    stratified jitter, compact to a static sample budget, evaluate the field
    once, composite (render_image_with_occgrid, examples/utils.py:83-216);
  * evaluation (`render_rays_eval` 94-162, `render_image` 165-207): the
    iterative alive-ray test renderer (utils.py:316-489): repeatedly march
    from per-ray cursors with a bounded per-round sample budget, composite
    incrementally with carried transmittance (prefix_trans = 1 - opacity),
    stop rays at opacity > 1 - early_stop_eps.

cnc_tpu runs the eval rounds inside one jitted `lax.while_loop`; here the
loop is Python, and its test `alive.any()` costs one host sync per round (a
CUDA graph can remove it later).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import ModelConfig, RenderConfig
from . import radiance_field as rf
from . import scatter_ops
from .device import resolve_device
from . import marching, volrend


def render_rays_train(field: rf.RadianceField, mcfg: ModelConfig, rcfg: RenderConfig,
                      aabb: torch.Tensor, binaries: torch.Tensor,
                      rays_o: torch.Tensor, rays_d: torch.Tensor,
                      generator: Optional[torch.Generator], render_bkgd: torch.Tensor,
                      capacity: Optional[int] = None, tables: Optional[Dict] = None,
                      visible_capacity: Optional[int] = None,
                      jitter: Optional[torch.Tensor] = None) -> volrend.RenderedRays:
    """One differentiable training render pass over a ray batch, on the rays'
    device.

    The march's stratified near jitter is drawn from `generator` (on the
    generator's device, then moved), unless `jitter`, an [R] tensor of
    uniforms in [0, 1), is given.

    With rcfg.visible_frac set (or an explicit visible_capacity), a
    gradient-free density prefilter prunes invisible samples before the
    differentiable field eval, the reference's structure: estimator.sampling
    runs under no_grad and drops samples whose transmittance fell below
    early_stop_eps (occ_grid.py:88-239, volrend.py:424-482), then `rendering`
    re-evaluates the field on the survivors only.  Invisible samples carry
    zero rendering weight and no gradient path, so pruning leaves the
    gradients unchanged; the one divergence, an overflow of the pruned
    buffer, is surfaced through `resume_ray` so the trainer can mask the
    affected rays out of the loss.
    """
    n_rays = rays_o.shape[0]
    dev = rays_o.device
    cap = capacity or rcfg.sample_capacity
    if visible_capacity is None and rcfg.visible_frac is not None:
        visible_capacity = max(8, int(cap * rcfg.visible_frac)) // 8 * 8
    if jitter is None:
        jitter = torch.rand(n_rays, generator=generator, device=generator.device).to(dev)
    samples = marching.march_rays(rays_o, rays_d, binaries, aabb, rcfg, cap, jitter=jitter)
    pos, dirs = marching.sample_positions(samples, rays_o, rays_d)
    if tables is None:
        tables = rf.quantized_tables(field, mcfg)
    resume_ray = n_visible = None
    if visible_capacity is not None and visible_capacity < cap:
        with torch.no_grad():
            sig_pre = rf.query_density(field, mcfg, aabb, pos, tables=tables)
            _, _, vis = volrend.render_weights(sig_pre, samples, rcfg.early_stop_eps,
                                               alpha_thre=rcfg.alpha_thre)
            n_visible = vis.sum()
            src, total = scatter_ops.compact_mask_indices(vis, visible_capacity)
            valid2 = (torch.arange(visible_capacity, device=dev)
                      < torch.clamp(total, max=visible_capacity))
            src = src.long()
            ray_id2 = torch.where(valid2, samples.ray_id[src], n_rays - 1).to(torch.int32)
            # overflow: the ray owning the last kept slot may have lost samples,
            # and every later ray certainly did; march truncation composes in
            resume_ray = torch.where(total > visible_capacity, ray_id2[visible_capacity - 1],
                                     torch.full((), n_rays, dtype=torch.int32, device=dev))
            if samples.resume_ray is not None:
                resume_ray = torch.minimum(resume_ray, samples.resume_ray.to(torch.int32))
            samples = marching.RaySamples(ray_id=ray_id2, t_mid=samples.t_mid[src],
                                          dt=samples.dt, valid=valid2,
                                          num_samples=samples.num_samples)
            pos, dirs = marching.sample_positions(samples, rays_o, rays_d)
    rgbs, sigmas = rf.forward(field, mcfg, aabb, pos, dirs, tables=tables)
    out = volrend.composite(rgbs, sigmas, samples, n_rays, render_bkgd, rcfg.early_stop_eps,
                            alpha_thre=rcfg.alpha_thre)
    if n_visible is not None:
        # report the prefilter's TRUE visible count (the pruned buffer's own
        # count saturates at its capacity) and the overflow resume point
        out = out._replace(n_rendering_samples=n_visible, resume_ray=resume_ray)
    return out


@torch.no_grad()
def render_rays_eval(field: rf.RadianceField, mcfg: ModelConfig, rcfg: RenderConfig,
                     aabb: torch.Tensor, binaries: torch.Tensor,
                     rays_o: torch.Tensor, rays_d: torch.Tensor,
                     render_bkgd: torch.Tensor,
                     round_capacity: Optional[int] = None,
                     max_rounds: Optional[int] = None,
                     stats: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iterative exact eval renderer for one ray chunk, on the rays' device.

    Per-round budget: R rays x rcfg.eval_samples_per_iter samples, up to
    rcfg.eval_max_iters rounds.  Returns (rgb [R,3], opacity [R,1], depth [R,1]).
    `stats`, when given, gains "rounds" and "samples" (marched samples, a
    device tensor, so counting adds no host sync).
    """
    r = rays_o.shape[0]
    dev = rays_o.device
    if round_capacity is None:
        round_capacity = r * rcfg.eval_samples_per_iter
    if max_rounds is None:
        max_rounds = rcfg.eval_max_iters
    tables = rf.quantized_tables(field, mcfg)
    opc_thre = float(np.float32(1.0 - rcfg.early_stop_eps))
    mip = marching.build_march_mip(binaries)

    rgb = torch.zeros(r, 3, device=dev)
    opacity = torch.zeros(r, 1, device=dev)
    depth = torch.zeros(r, 1, device=dev)
    cursor = torch.full((r,), float(np.float32(rcfg.near_plane)), device=dev)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    ray_index = torch.arange(r, device=dev)
    for _ in range(max_rounds):
        if not bool(alive.any()):          # the one host sync per round
            break
        samples = marching.march_rays(rays_o, rays_d, binaries, aabb, rcfg, round_capacity,
                                      ray_mask=alive, t_start=cursor, mip=mip)
        pos, dirs = marching.sample_positions(samples, rays_o, rays_d)
        rgbs, sigmas = rf.forward(field, mcfg, aabb, pos, dirs, tables=tables)
        out = volrend.composite(rgbs, sigmas, samples, r, render_bkgd=None,
                                early_stop_eps=rcfg.early_stop_eps,
                                prefix_trans=1.0 - opacity[:, 0],
                                alpha_thre=rcfg.alpha_thre)
        if stats is not None:
            stats["rounds"] = stats.get("rounds", 0) + 1
            stats["samples"] = stats.get("samples", 0) + samples.valid.sum()
        rgb = rgb + out.rgb
        opacity = opacity + out.opacity
        depth = depth + out.depth

        # advance cursors: rays whose hits all fit are done this round;
        # the first possibly-incomplete ray resumes after its last sample
        # (the march returns each ray's kept hits and last kept t_mid)
        ray_done = ray_index < samples.resume_ray
        cursor = torch.where(samples.ray_hits > 0,
                             torch.maximum(cursor, samples.ray_last_t + samples.dt * 0.5),
                             cursor)
        alive = alive & ~ray_done & (opacity[:, 0] <= opc_thre)
    rgb = rgb + render_bkgd * (1.0 - opacity)
    depth = depth / torch.clamp(opacity, min=1e-10)
    return rgb, opacity, depth


def render_image(field: rf.RadianceField, mcfg: ModelConfig, rcfg: RenderConfig,
                 aabb, binaries, rays_o, rays_d, render_bkgd,
                 chunk: Optional[int] = None, device=None, stats: Optional[dict] = None,
                 progress_fn=None):
    """Render a full image in chunks of rays through render_rays_eval.

    rays_o/rays_d: [H, W, 3].  Runs on `device` (default: cuda; raises when
    there is none and `device="cpu"` was not asked for).  The field must
    already live on that device.  Returns (rgb [H,W,3], opacity [H,W,1],
    depth [H,W,1]).  `stats`: see render_rays_eval.  progress_fn(done,
    total), when given, is called every 8 chunks and after the last, once
    the latest chunk has finished on the device.
    """
    dev = resolve_device(device)
    field_dev = next(field.parameters()).device
    if field_dev.type != dev.type:
        raise ValueError(f"render_image: the field is on {field_dev}, not {dev}")
    to = lambda t: (t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))).to(dev)
    aabb, binaries = to(aabb).float(), to(binaries).bool()
    render_bkgd = to(render_bkgd).float()
    h, w = rays_o.shape[:2]
    n = h * w
    chunk = chunk or rcfg.eval_chunk_rays
    o = to(rays_o).reshape(-1, 3).float()
    d = to(rays_d).reshape(-1, 3).float()
    pad = (-n) % chunk
    if pad:
        o = torch.cat([o, o[-1:].expand(pad, 3)])
        d = torch.cat([d, d[-1:].expand(pad, 3)])
    total = o.shape[0] // chunk
    outs = []
    for i in range(0, o.shape[0], chunk):
        outs.append(render_rays_eval(field, mcfg, rcfg, aabb, binaries, o[i:i + chunk].contiguous(),
                                     d[i:i + chunk].contiguous(), render_bkgd, stats=stats))
        if progress_fn is not None and (len(outs) % 8 == 0 or len(outs) == total):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            progress_fn(len(outs), total)
    rgb = torch.cat([x[0] for x in outs])[:n].reshape(h, w, 3)
    opacity = torch.cat([x[1] for x in outs])[:n].reshape(h, w, 1)
    depth = torch.cat([x[2] for x in outs])[:n].reshape(h, w, 1)
    return rgb, opacity, depth
