"""Volume rendering over compacted sample buffers (K5 forward, K5b backward).

Port of `cnc_tpu/render/volrend.py` (nerfacc volrend.py): transmittance from
density in log space, T_i = exp(-sum_{j<i} sigma_j dt), weights
w_i = T_i (1 - exp(-sigma_i dt)), samples with T below early_stop_eps zeroed,
and per-ray sums of w*rgb, w and w*t.  Samples arrive sorted per ray, so the
prefix sums are contiguous segment scans.

`composite` dispatches on the device of `sigmas`: a CPU tensor takes the
plain twin (`_composite_plain`, differentiated by autograd as it stands), a
CUDA tensor an `autograd.Function` whose forward and backward are the
kernels of csrc/volrend.cu: a sample-parallel pass writes each ray's walk
[start, end) into a table (its twin `_walk_ranges_plain`; the table is kept
per device and stream and left zero by the kernels), then a warp scans each
ray.  The table's pass sets a fault word where a buffer breaks the kernels'
precondition (`walk_order_faults`).  `sigmas` and `rgbs` get gradients; the
sample buffer, `visible` and `prefix_trans` carry none.  `render_weights`
stays plain torch on both devices: the training prefilter calls it without
gradients.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import scan as scan_ops
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


# K5/K5b's walk table per device and stream (at least 2 int32 a ray).  The
# scan kernels leave it zero, so it needs no clearing; the launches that
# share it, being on one stream, run one at a time.  A call that raises drops
# its table, which a launch that did not run may have left dirty.
_walk_tables: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# per device: set to 1 by a launch whose buffer has a valid sample after an
# invalid one in its segment, or ray ids that decrease
_walk_faults: Dict[torch.device, torch.Tensor] = {}


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
    rgb, opacity, depth, n_vis = _composite_plain(
        rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans, alpha_thre)
    opacity, depth = opacity[:, None], depth[:, None]
    if render_bkgd is not None:
        rgb = rgb + render_bkgd * (1.0 - opacity)
    return RenderedRays(rgb=rgb, opacity=opacity, depth=depth, n_rendering_samples=n_vis,
                        n_marched_samples=samples.num_samples)
