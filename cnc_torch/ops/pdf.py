"""PDF resampling over per-ray interval sets.

Port of `cnc_tpu/ops/pdf.py` (nerfacc's ragged PDF ops, nerfacc/pdf.py:13-219
and cuda/csrc/pdf.cu, in dense padded form): intervals live in [n_rays, S+1]
tensors, so the binary search and the inverse-CDF sampling run batched.
Plain torch on either device (`torch.searchsorted`); no Pallas kernel and no
hot path of cnc_tpu lies here.

The stratified draw is split from the sampling: `sample_from_weighted`
draws its uniforms from an explicit `torch.Generator`, and `_sample_at`
maps given positions `u` through the inverse CDF, so a test can feed the
very numbers another generator drew.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def searchsorted(sorted_vals: torch.Tensor, values: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row search, left side (nerfacc pdf.py `searchsorted`).

    sorted_vals: [R, S] ascending per row; values: [R, Q].  Returns
    (ids_left, ids_right): the bracketing elements' indices, clamped to the
    row.
    """
    right = torch.searchsorted(sorted_vals.contiguous(), values.contiguous())
    s = sorted_vals.shape[-1]
    return torch.clamp(right - 1, 0, s - 1), torch.clamp(right, 0, s - 1)


def stratified_u(noise: torch.Tensor) -> torch.Tensor:
    """Sorted stratified positions in [0, 1] from uniforms `noise` [R, n+1]."""
    m = noise.shape[-1]
    u = (torch.arange(m, dtype=noise.dtype, device=noise.device) + noise) / m
    return torch.sort(u, dim=-1).values


def _sample_at(t_vals: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The inverse CDF of the bins' weights at positions u [R, n+1]."""
    r = weights.shape[0]
    pdf = weights + eps
    pdf = pdf / torch.sum(pdf, -1, keepdim=True)
    zero = torch.zeros((r, 1), dtype=pdf.dtype, device=pdf.device)
    cdf = torch.cat([zero, torch.cumsum(pdf, -1)], -1)
    cdf = cdf / cdf[:, -1:]
    ids_left, ids_right = searchsorted(cdf, u)
    cdf_l = torch.gather(cdf, -1, ids_left)
    cdf_r = torch.gather(cdf, -1, ids_right)
    t_l = torch.gather(t_vals, -1, ids_left)
    t_r = torch.gather(t_vals, -1, ids_right)
    denom = torch.where(cdf_r - cdf_l < 1e-10, 1.0, cdf_r - cdf_l)
    frac = torch.clamp((u - cdf_l) / denom, 0.0, 1.0)
    return t_l + frac * (t_r - t_l)


def sample_from_weighted(t_vals: torch.Tensor, weights: torch.Tensor, n_samples: int,
                         stratified: bool = False,
                         generator: Optional[torch.Generator] = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF sampling of new interval edges from per-bin weights.

    t_vals: [R, S+1] ascending edges; weights: [R, S] non-negative.  With
    `stratified`, one uniform per new edge is drawn from `generator` (on the
    generator's device).  Returns [R, n_samples+1] edges covering
    [t_vals[:, 0], t_vals[:, -1]].
    """
    r = weights.shape[0]
    if stratified:
        if generator is None:
            raise ValueError("sample_from_weighted: stratified sampling needs a generator")
        noise = torch.rand((r, n_samples + 1), generator=generator, device=generator.device)
        u = stratified_u(noise.to(weights.device))
    else:
        u = torch.linspace(0.0, 1.0, n_samples + 1, device=weights.device).expand(r, -1)
    return _sample_at(t_vals, weights, u, eps)


def outer_measure(t0: torch.Tensor, w0: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """Outer measure of the histogram (t0 [R, S0+1], w0 [R, S0]) on the bins
    t1 [R, S1+1] (PropNet `_outer`): [R, S1] upper-bound mass per bin."""
    r = t0.shape[0]
    zero = torch.zeros((r, 1), dtype=w0.dtype, device=w0.device)
    cw0 = torch.cat([zero, torch.cumsum(w0, -1)], -1)
    idx_lo, _ = searchsorted(t0, t1[:, :-1])
    _, idx_hi = searchsorted(t0, t1[:, 1:])
    sum_lo = torch.gather(cw0, -1, idx_lo)
    sum_hi = torch.gather(cw0, -1, idx_hi)
    return torch.clamp(sum_hi - sum_lo, min=0.0)


def pdf_loss(t_query: torch.Tensor, w_query: torch.Tensor, t_key: torch.Tensor,
             w_key: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Proposal supervision loss (PropNet `_pdf_loss`, mip-NeRF 360 eq. 13):
    the radiance field's mass the proposal's outer measure fails to cover."""
    w_outer = outer_measure(t_key, w_key, t_query)
    return torch.clamp(w_query - w_outer, min=0.0) ** 2 / (w_query + eps)
