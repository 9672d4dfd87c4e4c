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


def _walk_ranges_plain(ray_id: torch.Tensor, valid: torch.Tensor, n_rays: int) -> torch.Tensor:
    """Twin of K5/K5b's walk table: [R, 2] int32, each ray's [start, end) of
    the valid samples that lead its segment ([start, start) when there are
    none), [0, 0) for a ray without a segment.  Samples must be sorted by ray
    with each segment's valid samples first; ids outside [0, R) are left out."""
    n = ray_id.shape[0]
    table = torch.zeros(n_rays, 2, dtype=torch.int32, device=ray_id.device)
    if n == 0:
        return table
    rid = ray_id.long()
    pos = torch.arange(n, dtype=torch.int32, device=ray_id.device)
    ok = (rid >= 0) & (rid < n_rays)
    head = torch.ones(n, dtype=torch.bool, device=ray_id.device)
    head[1:] = rid[1:] != rid[:-1]
    run_goes_on = torch.zeros_like(head)
    run_goes_on[:-1] = (rid[1:] == rid[:-1]) & valid[1:]
    head, bare, last = head & ok, head & ok & ~valid, valid & ~run_goes_on & ok
    table[rid[head], 0] = pos[head]
    table[rid[bare], 1] = pos[bare]
    table[rid[last], 1] = pos[last] + 1
    return table


def _walk_order_faults_plain(ray_id: torch.Tensor, valid: torch.Tensor, n_rays: int) -> int:
    """Twin of the fault word K5/K5b's table pass sets: 1 where a sample of a
    ray in [0, R) follows a larger ray id, or is valid and follows an invalid
    sample of its own ray; else 0."""
    rid = ray_id.long()
    cur, prev = rid[1:], rid[:-1]
    ok = (cur >= 0) & (cur < n_rays)
    return int((ok & ((prev > cur) | ((prev == cur) & valid[1:] & ~valid[:-1]))).any())


# K5/K5b's walk table per device and stream (at least 2 int32 a ray).  The
# scan kernels leave it zero, so it needs no clearing; the launches that
# share it, being on one stream, run one at a time.  A call that raises drops
# its table, which a launch that did not run may have left dirty.
_walk_tables: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# per device: set to 1 by a launch whose buffer has a valid sample after an
# invalid one in its segment, or ray ids that decrease
_walk_faults: Dict[torch.device, torch.Tensor] = {}


def _fault_word(device: torch.device) -> torch.Tensor:
    word = _walk_faults.get(device)
    if word is None:
        word = _walk_faults[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return word


def _indexed(device) -> torch.device:
    device = torch.device(device)
    return device if device.index is not None else torch.device(device.type,
                                                                 torch.cuda.current_device())


def walk_order_faults(device) -> int:
    """1 if a K5/K5b launch on the CUDA `device` met a buffer that breaks the
    kernels' precondition since the last `clear_walk_order_faults`, else 0
    (one host sync)."""
    return int(_fault_word(_indexed(device))[0])


def clear_walk_order_faults(device) -> None:
    _fault_word(_indexed(device)).zero_()


def _launch(name: str, device: torch.device, n_rays: int, head: tuple, tail: tuple) -> None:
    """Calls `name` on the device's current stream with the arguments `head`,
    the stream's walk table, the fault word and `tail`."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, stream)
    table = _walk_tables.get(key)
    if table is None or table.numel() < 2 * n_rays:
        size = 1 << max(10, (n_rays - 1).bit_length())
        table = _walk_tables[key] = torch.zeros(2 * size, dtype=torch.int32, device=device)
    try:
        kernels.call(name, *head, kernels.ptr(table), kernels.ptr(_fault_word(device)), *tail,
                     stream=stream)
    except BaseException:
        del _walk_tables[key]
        raise


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
    """K5: (rgb [R,3], opacity [R], depth [R], visible count), views of one
    allocation."""
    _check_composite_args(rgbs, sigmas, samples, prefix_trans)
    n, dev = sigmas.shape[0], sigmas.device
    out = torch.empty(5 * n_rays + 1, dtype=torch.float32, device=dev)
    # the outputs' pointers by offset, so the views are made once, for the caller
    at = lambda k: out.data_ptr() + 4 * k * n_rays
    p = kernels.ptr
    _launch("cnc_volrend_forward", dev, n_rays,
            (p(sigmas), p(rgbs), p(samples.t_mid), p(samples.valid), p(samples.ray_id),
             p(prefix_trans), n, n_rays, samples.dt, early_stop_eps, alpha_thre),
            (at(0), at(3), at(4), at(5)))
    kernels.launches["volrend"] += 2
    return (out.as_strided((n_rays, 3), (3, 1)), out.as_strided((n_rays,), (1,), 3 * n_rays),
            out.as_strided((n_rays,), (1,), 4 * n_rays), out.view(torch.int32)[5 * n_rays])


def _composite_backward_cuda(rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans,
                             alpha_thre, d_rgb, d_opacity, d_depth):
    """K5b: (d_rgbs [S,3], d_sigmas [S]) of `_composite_cuda` for the output
    gradients d_rgb [R,3], d_opacity [R], d_depth [R]; None stands for zeros."""
    _check_composite_args(rgbs, sigmas, samples, prefix_trans, d_rgb, d_opacity, d_depth)
    for g, shape in ((d_rgb, (n_rays, 3)), (d_opacity, (n_rays,)), (d_depth, (n_rays,))):
        if g is not None and tuple(g.shape) != shape:
            raise ValueError("composite backward: expects d_rgb [R,3], d_opacity [R], "
                             "d_depth [R]")
    n, dev = sigmas.shape[0], sigmas.device
    d_sigmas = torch.empty(n, dtype=torch.float32, device=dev)
    d_rgbs = torch.empty(n, 3, dtype=torch.float32, device=dev)
    p = kernels.ptr
    _launch("cnc_volrend_backward", dev, n_rays,
            (p(sigmas), p(rgbs), p(samples.t_mid), p(samples.valid), p(samples.ray_id),
             p(prefix_trans), p(d_rgb), p(d_opacity), p(d_depth), n, n_rays, samples.dt,
             early_stop_eps, alpha_thre),
            (p(d_sigmas), p(d_rgbs)))
    kernels.launches["volrend_bwd"] += 2
    return d_rgbs, d_sigmas


class _CompositeCuda(torch.autograd.Function):
    """K5 forward, K5b backward; gradients for rgbs and sigmas only.  An
    output without a gradient reaches K5b as a null pointer, not as zeros."""

    @staticmethod
    def forward(ctx, rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans, alpha_thre):
        ctx.save_for_backward(rgbs, sigmas, samples.t_mid, samples.valid, samples.ray_id,
                              prefix_trans)
        ctx.args = (samples.dt, n_rays, early_stop_eps, alpha_thre)
        ctx.set_materialize_grads(False)
        rgb, opacity, depth, n_vis = _composite_cuda(rgbs, sigmas, samples, n_rays,
                                                     early_stop_eps, prefix_trans, alpha_thre)
        ctx.mark_non_differentiable(n_vis)
        return rgb, opacity, depth, n_vis

    @staticmethod
    def backward(ctx, d_rgb, d_opacity, d_depth, _):
        rgbs, sigmas, t_mid, valid, ray_id, prefix_trans = ctx.saved_tensors
        dt, n_rays, early_stop_eps, alpha_thre = ctx.args
        samples = RaySamples(ray_id=ray_id, t_mid=t_mid, dt=dt, valid=valid, num_samples=None)
        c = lambda t: None if t is None else t.contiguous()
        d_rgbs, d_sigmas = _composite_backward_cuda(
            rgbs, sigmas, samples, n_rays, early_stop_eps, prefix_trans, alpha_thre, c(d_rgb),
            c(d_opacity), c(d_depth))
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
