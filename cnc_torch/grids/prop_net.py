"""Proposal-network estimator (mip-NeRF 360 style PDF sampling).

Port of `cnc_tpu/grids/prop_net.py` (nerfacc's PropNetEstimator,
nerfacc/estimators/prop_net.py:17-313): present in the reference library
and unused by the CNC drivers.  Interval sets are dense padded [n_rays,
S(+1)] tensors; the proposal sigma functions are callables on tensors
`(t_starts, t_ends) -> sigmas [R, S]`.  Plain torch on the rays' device; the
random draws come from a `torch.Generator` in cnc_tpu's order of keys: one
draw for the first level when stratified, one for each later level and one
for the final samples.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..ops import pdf as pdf_ops


def transform_stot(sampling_type: str, s_vals: torch.Tensor, t_min: torch.Tensor,
                   t_max: torch.Tensor) -> torch.Tensor:
    """Map normalized s in [0, 1] to distances (prop_net.py `_transform_stot`)."""
    if sampling_type == "uniform":
        return s_vals * (t_max - t_min)[..., None] + t_min[..., None]
    if sampling_type == "lindisp":
        inv = (1.0 / torch.clamp(t_min, min=1e-10))[..., None] * (1 - s_vals) + \
              (1.0 / torch.clamp(t_max, min=1e-10))[..., None] * s_vals
        return 1.0 / torch.clamp(inv, min=1e-10)
    raise ValueError(sampling_type)


def _weights_from_sigmas(sigmas: torch.Tensor, t_vals: torch.Tensor) -> torch.Tensor:
    """Dense per-ray rendering weights (volrend math, batched layout)."""
    dt = t_vals[..., 1:] - t_vals[..., :-1]
    sdt = sigmas * dt
    # the exclusive cumsum: `cumsum - sdt` would give inf - inf = NaN at the
    # opaque last bin, whose sigma is set to infinity
    excl = torch.cat([torch.zeros_like(sdt[..., :1]), torch.cumsum(sdt[..., :-1], -1)], -1)
    trans = torch.exp(-excl)
    return trans * (1.0 - torch.exp(-sdt))


def _propnet_sampling(uniform: Callable, rays_o: torch.Tensor,
                      prop_sigma_fns: Sequence[Callable], prop_samples: Sequence[int],
                      num_samples: int, near_plane: float, far_plane: float,
                      sampling_type: str, stratified: bool, opaque_bkgd: bool):
    """`propnet_sampling` with its uniforms from `uniform(shape)`, called in
    cnc_tpu's order of draws."""
    r, dev = rays_o.shape[0], rays_o.device
    t_min = torch.full((r,), near_plane, device=dev)
    t_max = torch.full((r,), far_plane, device=dev)
    s_vals = torch.linspace(0.0, 1.0, prop_samples[0] + 1, device=dev).expand(r, -1)
    aux = {"levels": []}
    prev_t = prev_w = None
    for lvl, (fn, n) in enumerate(zip(prop_sigma_fns, prop_samples)):
        if lvl > 0:
            u = (pdf_ops.stratified_u(uniform((r, n + 1))) if stratified else
                 torch.linspace(0.0, 1.0, n + 1, device=dev).expand(r, -1))
            t_vals = pdf_ops._sample_at(prev_t, prev_w, u)
        else:
            if stratified:
                jitter = uniform((r, prop_samples[0] + 1)) / (prop_samples[0] + 1)
                s_vals = torch.clamp(s_vals + jitter, 0.0, 1.0)
            t_vals = transform_stot(sampling_type, s_vals, t_min, t_max)
        sigmas = fn(t_vals[..., :-1], t_vals[..., 1:])
        if opaque_bkgd:
            sigmas = torch.cat([sigmas[..., :-1], torch.full_like(sigmas[..., -1:], torch.inf)],
                               -1)
        weights = _weights_from_sigmas(sigmas, t_vals)
        aux["levels"].append((t_vals, weights))
        prev_t, prev_w = t_vals, weights
    u = (pdf_ops.stratified_u(uniform((r, num_samples + 1))) if stratified else
         torch.linspace(0.0, 1.0, num_samples + 1, device=dev).expand(r, -1))
    t_final = pdf_ops._sample_at(prev_t, prev_w, u)
    return t_final[..., :-1], t_final[..., 1:], aux


def propnet_sampling(generator: Optional[torch.Generator], rays_o: torch.Tensor,
                     rays_d: torch.Tensor, prop_sigma_fns: Sequence[Callable],
                     prop_samples: Sequence[int], num_samples: int, near_plane: float,
                     far_plane: float, sampling_type: str = "lindisp",
                     stratified: bool = False, opaque_bkgd: bool = True):
    """Hierarchical proposal sampling (prop_net.py `sampling`).

    `generator` gives the stratified draws (it may be None when not
    stratified).  Returns (t_starts [R, num_samples], t_ends [R,
    num_samples], aux with the per-level (t_vals, weights) for `prop_loss`).
    """
    if stratified and generator is None:
        raise ValueError("propnet_sampling: stratified sampling needs a generator")
    dev = rays_o.device
    uniform = lambda shape: torch.rand(shape, generator=generator,
                                       device=generator.device).to(dev)
    return _propnet_sampling(uniform, rays_o, prop_sigma_fns, prop_samples, num_samples,
                             near_plane, far_plane, sampling_type, stratified, opaque_bkgd)


def prop_loss(aux, t_vals_rf: torch.Tensor, weights_rf: torch.Tensor) -> torch.Tensor:
    """Total proposal supervision loss against the radiance field's histogram
    (prop_net.py `update_every_n_steps` / `_pdf_loss`)."""
    t_q, w_q = t_vals_rf.detach(), weights_rf.detach()
    loss = 0.0
    for t_k, w_k in aux["levels"]:
        loss = loss + torch.mean(torch.sum(pdf_ops.pdf_loss(t_q, w_q, t_k, w_k), dim=-1))
    return loss
