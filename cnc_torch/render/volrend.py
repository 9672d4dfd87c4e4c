"""Volume rendering over compacted sample buffers (K5 forward, K5b backward).

Port of `cnc_tpu/render/volrend.py` (nerfacc volrend.py): transmittance from
density in log space, T_i = exp(-sum_{j<i} sigma_j dt), weights
w_i = T_i (1 - exp(-sigma_i dt)), samples with T below early_stop_eps zeroed,
and per-ray sums of w*rgb, w and w*t.  Samples arrive sorted per ray, so the
prefix sums are contiguous segment scans.

`composite` dispatches on the device of `sigmas`: a CPU tensor takes the
plain twin (`_composite_plain`, differentiated by autograd as it stands), a
CUDA tensor an `autograd.Function` whose forward and backward are the per-ray
kernels of csrc/volrend.cu.  `sigmas` and `rgbs` get gradients; the sample
buffer, `visible` and `prefix_trans` carry none.  `render_weights` stays plain
torch on both devices: the training prefilter calls it without gradients.
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
    # set by the visibility-pruned training path: first ray whose samples were
    # dropped by a buffer overflow (== n_rays when none were); the trainer
    # masks rays at and after it out of the loss
    resume_ray: Optional[torch.Tensor] = None


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


def _check_composite_args(rgbs, sigmas, samples, prefix_trans, *grads):
    kernels.require_cuda("composite", sigmas, rgbs, samples.t_mid, samples.valid,
                         samples.ray_id, prefix_trans, *grads)
    n = sigmas.shape[0]
    if (samples.ray_id.dtype != torch.int32 or samples.valid.dtype != torch.bool
            or tuple(rgbs.shape) != (n, 3) or samples.ray_id.shape[0] != n):
        raise ValueError("composite: expects rgbs [S,3], sigmas [S], int32 ray_id and bool "
                         "valid over the same S samples")
    if any(t is not None and t.dtype != torch.float32
           for t in (rgbs, sigmas, samples.t_mid, prefix_trans, *grads)):
        raise ValueError("composite: the kernels take float32")


def _composite_cuda(rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans, alpha_thre):
    _check_composite_args(rgbs, sigmas, samples, prefix_trans)
    n = sigmas.shape[0]
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


def _composite_backward_cuda(rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans,
                             alpha_thre, d_rgb, d_opacity, d_depth):
    """K5b: (d_rgbs [S,3], d_sigmas [S]) of `_composite_cuda` for the output
    gradients d_rgb [R,3], d_opacity [R], d_depth [R]."""
    _check_composite_args(rgbs, sigmas, samples, prefix_trans, d_rgb, d_opacity, d_depth)
    if (tuple(d_rgb.shape) != (n_rays, 3) or tuple(d_opacity.shape) != (n_rays,)
            or tuple(d_depth.shape) != (n_rays,)):
        raise ValueError("composite backward: expects d_rgb [R,3], d_opacity [R], d_depth [R]")
    n = sigmas.shape[0]
    d_sigmas = torch.zeros(n, dtype=torch.float32, device=sigmas.device)
    d_rgbs = torch.zeros(n, 3, dtype=torch.float32, device=sigmas.device)
    p = kernels.ptr
    kernels.call("cnc_volrend_backward", p(sigmas), p(rgbs), p(samples.t_mid), p(samples.valid),
                 p(samples.ray_id), p(prefix_trans), p(d_rgb), p(d_opacity), p(d_depth), n,
                 n_rays, samples.dt, early_stop_eps, alpha_thre, p(d_sigmas), p(d_rgbs))
    kernels.launches["volrend_bwd"] += 1
    return d_rgbs, d_sigmas


class _CompositeCuda(torch.autograd.Function):
    """K5 forward, K5b backward; gradients for rgbs and sigmas only."""

    @staticmethod
    def forward(ctx, rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans, alpha_thre):
        ctx.save_for_backward(rgbs, sigmas, samples.t_mid, samples.valid, samples.ray_id,
                              prefix_trans)
        ctx.args = (samples.dt, n_rays, early_stop_eps, alpha_thre)
        rgb, opacity, depth, n_vis = _composite_cuda(rgbs, sigmas, samples, n_rays,
                                                     early_stop_eps, prefix_trans, alpha_thre)
        ctx.mark_non_differentiable(n_vis)
        return rgb, opacity, depth, n_vis

    @staticmethod
    def backward(ctx, d_rgb, d_opacity, d_depth, _):
        rgbs, sigmas, t_mid, valid, ray_id, prefix_trans = ctx.saved_tensors
        dt, n_rays, early_stop_eps, alpha_thre = ctx.args
        samples = RaySamples(ray_id=ray_id, t_mid=t_mid, dt=dt, valid=valid, num_samples=None)
        dev = sigmas.device
        g = lambda t, *shape: (torch.zeros(*shape, dtype=torch.float32, device=dev)
                               if t is None else t.contiguous())
        d_rgbs, d_sigmas = _composite_backward_cuda(
            rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans, alpha_thre,
            g(d_rgb, n_rays, 3), g(d_opacity, n_rays), g(d_depth, n_rays))
        return d_rgbs, d_sigmas, None, None, None, None, None


def composite(rgbs: torch.Tensor, sigmas: torch.Tensor, samples: RaySamples, n_rays: int,
              render_bkgd: Optional[torch.Tensor] = None, early_stop_eps: float = 1e-4,
              prefix_trans: Optional[torch.Tensor] = None,
              alpha_thre: float = 0.0) -> RenderedRays:
    """Full compositing pass (nerfacc `rendering`, volrend.py:14-160).

    Samples are sorted by ray_id; within each ray the valid samples come
    first (as `march_rays` emits them, padding last).  The CUDA kernels rely
    on that order and skip each ray's trailing invalid samples.  Gradients
    flow to `rgbs`, `sigmas` and `render_bkgd`; `prefix_trans` carries the
    eval loop's transmittance and must not require one.
    """
    if prefix_trans is not None and prefix_trans.requires_grad:
        raise ValueError("composite: prefix_trans gets no gradient; pass it detached")
    if sigmas.is_cuda:
        c = lambda t: None if t is None else t.contiguous().float()
        rgb, opacity, depth, n_vis = _CompositeCuda.apply(
            c(rgbs), c(sigmas), samples, n_rays, early_stop_eps, c(prefix_trans), alpha_thre)
    else:
        rgb, opacity, depth, n_vis = _composite_plain(
            rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans, alpha_thre)
    opacity, depth = opacity[:, None], depth[:, None]
    if render_bkgd is not None:
        rgb = rgb + render_bkgd * (1.0 - opacity)
    return RenderedRays(rgb=rgb, opacity=opacity, depth=depth, n_rendering_samples=n_vis,
                        n_marched_samples=samples.num_samples)
