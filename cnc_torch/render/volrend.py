"""Volume rendering over compacted sample buffers (K5, forward).

Port of `cnc_tpu/render/volrend.py` (nerfacc volrend.py): transmittance from
density in log space, T_i = exp(-sum_{j<i} sigma_j dt), weights
w_i = T_i (1 - exp(-sigma_i dt)), samples with T below early_stop_eps zeroed,
and per-ray sums of w*rgb, w and w*t.  Samples arrive sorted per ray, so the
prefix sums are contiguous segment scans.

`composite` dispatches on the device of `sigmas`: a CPU tensor takes the
plain twin (`_composite_plain`), a CUDA tensor the per-ray kernel of
csrc/volrend.cu.  The backward comes with training.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..ops import scan as scan_ops
from .marching import RaySamples


class RenderedRays(NamedTuple):
    rgb: torch.Tensor       # [R, 3]
    opacity: torch.Tensor   # [R, 1]
    depth: torch.Tensor     # [R, 1]
    n_rendering_samples: torch.Tensor  # 0-dim: visible samples
    n_marched_samples: torch.Tensor    # 0-dim: occupancy hits before truncation


def render_weights(sigmas: torch.Tensor, samples: RaySamples,
                   early_stop_eps: float = 1e-4,
                   prefix_trans: Optional[torch.Tensor] = None,
                   alpha_thre: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample rendering weights, transmittance and visibility.

    prefix_trans: optional [R] carried transmittance (the iterative eval
    renderer's 1 - opacity).  alpha_thre: samples with alpha below it are
    skipped (the CNC drivers pin it to 0).
    """
    sdt = torch.where(samples.valid, sigmas * samples.dt, 0.0)
    alpha = 1.0 - torch.exp(-sdt)
    if alpha_thre > 0.0:
        keep = alpha >= alpha_thre
        sdt = torch.where(keep, sdt, 0.0)
        alpha = torch.where(keep, alpha, 0.0)
    trans = torch.exp(-scan_ops.segment_exclusive_sum(sdt, samples.ray_id))
    if prefix_trans is not None:
        trans = trans * prefix_trans[samples.ray_id.long()]
    visible = (trans >= early_stop_eps) & samples.valid
    return torch.where(visible, trans * alpha, 0.0), trans, visible


def _composite_plain(rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans, alpha_thre):
    weights, _, visible = render_weights(sigmas, samples, early_stop_eps, prefix_trans,
                                         alpha_thre)
    seg = samples.ray_id.long()
    zeros = lambda *shape: torch.zeros(shape, dtype=weights.dtype, device=weights.device)
    rgb = zeros(n_rays, 3).index_add_(0, seg, weights[:, None] * rgbs)
    opacity = zeros(n_rays).index_add_(0, seg, weights)
    depth = zeros(n_rays).index_add_(0, seg, weights * samples.t_mid)
    return rgb, opacity, depth, visible.sum()


def _composite_cuda(rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans, alpha_thre):
    kernels.require_cuda("composite", sigmas, rgbs, samples.t_mid, samples.valid,
                         samples.ray_id, prefix_trans)
    n = sigmas.shape[0]
    if (samples.ray_id.dtype != torch.int32 or samples.valid.dtype != torch.bool
            or tuple(rgbs.shape) != (n, 3) or samples.ray_id.shape[0] != n):
        raise ValueError("composite: expects rgbs [S,3], sigmas [S], int32 ray_id and bool "
                         "valid over the same S samples")
    dev = sigmas.device
    rgb = torch.empty(n_rays, 3, dtype=torch.float32, device=dev)
    opacity = torch.empty(n_rays, dtype=torch.float32, device=dev)
    depth = torch.empty(n_rays, dtype=torch.float32, device=dev)
    n_visible = torch.empty(1, dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.call("cnc_volrend_forward", p(sigmas), p(rgbs), p(samples.t_mid), p(samples.valid),
                 p(samples.ray_id), p(prefix_trans), n, n_rays, samples.dt, early_stop_eps,
                 alpha_thre, p(rgb), p(opacity), p(depth), p(n_visible))
    kernels.launches["volrend"] += 1
    return rgb, opacity, depth, n_visible[0]


def composite(rgbs: torch.Tensor, sigmas: torch.Tensor, samples: RaySamples, n_rays: int,
              render_bkgd: Optional[torch.Tensor] = None, early_stop_eps: float = 1e-4,
              prefix_trans: Optional[torch.Tensor] = None,
              alpha_thre: float = 0.0) -> RenderedRays:
    """Full compositing pass (nerfacc `rendering`, volrend.py:14-160).

    Samples are sorted by ray_id; within each ray the valid samples come
    first (as `march_rays` emits them, padding last).  The CUDA kernel relies
    on that order and skips each ray's trailing invalid samples.
    """
    if sigmas.is_cuda:
        c = lambda t: None if t is None else t.contiguous().float()
        rgb, opacity, depth, n_vis = _composite_cuda(
            c(rgbs), c(sigmas), samples, n_rays, early_stop_eps, c(prefix_trans), alpha_thre)
    else:
        rgb, opacity, depth, n_vis = _composite_plain(
            rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans, alpha_thre)
    opacity, depth = opacity[:, None], depth[:, None]
    if render_bkgd is not None:
        rgb = rgb + render_bkgd * (1.0 - opacity)
    return RenderedRays(rgb=rgb, opacity=opacity, depth=depth, n_rendering_samples=n_vis,
                        n_marched_samples=samples.num_samples)
