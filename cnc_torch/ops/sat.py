"""Summed-area-table occupancy queries.

Port of `cnc_tpu/ops/sat.py`: the TPU form of the per-corner scan loops
over the Rb^D occupancy grid in the reference (the corner masking inside the
hash-grid encoder, gridencoder.cu:222-276, and `query_mask_3D` / `_qlist`
with the overlap-area pooling, aligner_kernel.cu:4-326).  An integer
summed-area table, built once per occupancy grid, answers a box "any" query
with 2^D exact int32 gathers; the fractional overlap volume is an
inclusion-exclusion of the D-linearly interpolated table, rebased locally to
an integer baseline so float32 holds at Rb^3 cell counts.

Plain torch in cnc_tpu's operation order: the integer results are exact and
the float overlap matches cnc_tpu to rounding.  `build_sat` is an int32
`torch.cumsum` per axis on either device (an XLA cumsum in cnc_tpu, on no
hot path).  On the card the encode's corner masking does not come here: the
K1s/K2s kernels (csrc/grid_encode.cu) read the table themselves, and
`occupancy_mask` is their plain twin.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def build_sat(binary: torch.Tensor) -> torch.Tensor:
    """Integer SAT of a D-dim boolean grid; output shape = grid.shape + 1,
    int32, with a zero first slice on every axis."""
    s = binary.to(torch.int32)
    for ax in range(s.dim()):
        s = torch.cumsum(s, dim=ax, dtype=torch.int32)
        pad = list(s.shape)
        pad[ax] = 1
        s = torch.cat([torch.zeros(pad, dtype=torch.int32, device=s.device), s], dim=ax)
    return s


def _gather_sat(sat: torch.Tensor, idx: Sequence[torch.Tensor]) -> torch.Tensor:
    """sat[idx0, idx1, ...] with broadcast integer index tensors."""
    return sat[tuple(i.to(torch.int64) for i in idx)]


def box_count(sat: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Number of set cells in the inclusive index box [lo, hi] per point.

    sat: [R+1]*D int32; lo, hi: [..., D] integer cell indices in [0, R-1].
    Returns [...] int32 counts.
    """
    d = lo.shape[-1]
    total = None
    for s in range(1 << d):
        idx = []
        sign = 1
        for ax in range(d):
            if s & (1 << ax):
                idx.append(lo[..., ax])
                sign = -sign
            else:
                idx.append(hi[..., ax] + 1)
        term = _gather_sat(sat, idx)
        total = term * sign if total is None else total + term * sign
    return total


def _scale_re(resolution, device) -> torch.Tensor:
    """float32(1 / (R - 2)): formed in double and rounded once for a static
    level, a float32 division per point for per-point resolutions (the two
    agree: the double rounding of a quotient is innocuous)."""
    if isinstance(resolution, torch.Tensor):
        return (1.0 / (resolution.to(torch.float32) - 2.0))[..., None]
    return torch.tensor(np.float32(1.0 / (int(resolution) - 2.0)), device=device)


def footprint_box(corners: torch.Tensor, resolution, rb: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized footprint of grid corners on the Rb occupancy grid
    (gridencoder.cu:224-241, aligner_kernel.cu:24-41).

    The corner at lattice coordinate c of a resolution-R grid has the
    normalized center pn = (c - 0.5) / (R - 2) and the half-width 1 / (R - 2);
    both edges are scaled by Rb, clamped to [0, Rb - 1] and truncated to
    ints, in float32 as cnc_tpu rounds them.

    corners: [..., D] lattice coordinates; resolution: int, or an integer
    tensor [...] (per-point levels).  Returns (lo, hi) [..., D] int32.
    """
    c = corners.to(torch.float32)
    scale_re = _scale_re(resolution, c.device)
    pn = (c - 0.5) * scale_re
    lo = torch.clamp((pn - scale_re) * rb, 0, rb - 1).to(torch.int32)
    hi = torch.clamp((pn + scale_re) * rb, 0, rb - 1).to(torch.int32)
    return lo, hi


def occupancy_mask(sat: torch.Tensor, corners: torch.Tensor, resolution,
                   rb: int) -> torch.Tensor:
    """True where any occupied cell overlaps the corner's footprint."""
    lo, hi = footprint_box(corners, resolution, rb)
    return box_count(sat, lo, hi) > 0


def _interp_sat_rebased(sat: torch.Tensor, u: Sequence[torch.Tensor],
                        base_val: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation of (sat - base_val) at continuous cell
    coordinates u; the rebasing keeps the interpolated magnitudes within the
    local variation of the table, so float32 stays accurate."""
    d = len(u)
    i0 = [torch.clamp(torch.floor(ui), 0, sat.shape[ax] - 2).to(torch.int32)
          for ax, ui in enumerate(u)]
    f = [ui - i0[ax] for ax, ui in enumerate(u)]
    out = None
    for s in range(1 << d):
        idx = []
        w = None
        for ax in range(d):
            bit = (s >> ax) & 1
            idx.append(i0[ax] + bit)
            wax = f[ax] if bit else (1.0 - f[ax])
            w = wax if w is None else w * wax
        val = (_gather_sat(sat, idx) - base_val).to(torch.float32)
        term = w * val
        out = term if out is None else out + term
    return out


def overlap_volume_cells(sat: torch.Tensor, corners: torch.Tensor, resolution,
                         rb: int) -> torch.Tensor:
    """Occupied volume overlapping the corner footprint, in cell^D units:
    the occupancy indicator integrated over the footprint box clipped to
    [0, 1]^D, times Rb^D (aligner_kernel.cu's per-cell accumulation in
    continuous form)."""
    d = corners.shape[-1]
    c = corners.to(torch.float32)
    scale_re = _scale_re(resolution, c.device)
    pn = (c - 0.5) * scale_re
    a = torch.clamp(pn - scale_re, 0.0, 1.0) * rb   # cell units
    b = torch.clamp(pn + scale_re, 0.0, 1.0) * rb
    base_idx = [torch.clamp(a[..., ax].to(torch.int32), 0, rb - 1) for ax in range(d)]
    base_val = _gather_sat(sat, base_idx)
    total = None
    for s in range(1 << d):
        u = []
        sign = 1
        for ax in range(d):
            if s & (1 << ax):
                u.append(a[..., ax])
                sign = -sign
            else:
                u.append(b[..., ax])
        term = _interp_sat_rebased(sat, u, base_val)
        total = term * sign if total is None else total + term * sign
    return total


def overlap_area_pool_int(sat: torch.Tensor, corners: torch.Tensor, resolution,
                          rb: int) -> torch.Tensor:
    """int(overlap * 1000), as aligner_kernel.cu:79/241."""
    v = overlap_volume_cells(sat, corners, resolution, rb)
    return torch.clamp(v * 1000.0, min=0.0).to(torch.int32)
