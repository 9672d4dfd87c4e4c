"""The evaluation renderer: the serving path that re-renders a field.

Port of `cnc_tpu/render/renderer.py:render_rays_eval` (94-162) and
`render_image` (165-207), the reference's iterative alive-ray test renderer
(utils.py:316-489): repeatedly march from per-ray cursors with a bounded
per-round sample budget, composite incrementally with carried transmittance
(prefix_trans = 1 - opacity), stop rays at opacity > 1 - early_stop_eps.

cnc_tpu runs the rounds inside one jitted `lax.while_loop`; here the loop is
Python, and its test `alive.any()` costs one host sync per round (a CUDA
graph can remove it later).  The training renderer comes with training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, RenderConfig
from ..models import radiance_field as rf
from ..utils.device import resolve_device
from . import marching, volrend


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
        seg = samples.ray_id.long()
        hits_per_ray = torch.zeros(r, dtype=torch.int32, device=dev).index_add_(
            0, seg, samples.valid.to(torch.int32))
        last_t = torch.full((r,), -torch.inf, device=dev).scatter_reduce_(
            0, seg, torch.where(samples.valid, samples.t_mid, -torch.inf), reduce="amax")
        ray_done = ray_index < samples.resume_ray
        cursor = torch.where(hits_per_ray > 0,
                             torch.maximum(cursor, last_t + samples.dt * 0.5), cursor)
        alive = alive & ~ray_done & (opacity[:, 0] <= opc_thre)
    rgb = rgb + render_bkgd * (1.0 - opacity)
    depth = depth / torch.clamp(opacity, min=1e-10)
    return rgb, opacity, depth


def render_image(field: rf.RadianceField, mcfg: ModelConfig, rcfg: RenderConfig,
                 aabb, binaries, rays_o, rays_d, render_bkgd,
                 chunk: Optional[int] = None, device=None, stats: Optional[dict] = None):
    """Render a full image in chunks of rays through render_rays_eval.

    rays_o/rays_d: [H, W, 3].  Runs on `device` (default: cuda; raises when
    there is none and `device="cpu"` was not asked for).  The field must
    already live on that device.  Returns (rgb [H,W,3], opacity [H,W,1],
    depth [H,W,1]).  `stats`: see render_rays_eval.
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
    outs = [render_rays_eval(field, mcfg, rcfg, aabb, binaries, o[i:i + chunk].contiguous(),
                             d[i:i + chunk].contiguous(), render_bkgd, stats=stats)
            for i in range(0, o.shape[0], chunk)]
    rgb = torch.cat([x[0] for x in outs])[:n].reshape(h, w, 3)
    opacity = torch.cat([x[1] for x in outs])[:n].reshape(h, w, 1)
    depth = torch.cat([x[2] for x in outs])[:n].reshape(h, w, 1)
    return rgb, opacity, depth
