"""The least bytes and operations of the field's kernels, from the shapes and
inputs of each call, for their roofline shares.

Each input byte is counted once and each output byte once, and only what
these inputs need:

  * K1, the hash-grid encode forward (`grid_encode_forward_kernel`): the
    points [N, D], the distinct table rows that the valid corners of the
    in-range points read (border corners and points outside [0, 1] read
    none), and the output [N, L F];
  * K2, its backward (`grid_encode_backward_kernel`): the points, the
    output's gradient [N, L F] and the same distinct rows of the table's
    gradient, written;
  * K5, the composite forward (`walk_ranges_kernel`, `volrend_forward_kernel`):
    the valid samples' rgb, sigma, t, ray id and valid flag, the carried
    transmittance of the eval loop, and rgb, opacity and depth per ray;
  * K5b, its backward (`walk_ranges_kernel`, `volrend_backward_kernel`):
    the valid samples' inputs, the rays' output gradients, and the valid
    samples' rgb and sigma gradients.

Operations: the encode's corner weights and weighted sums (2^D corners a
point and level, D multiplies and 2F multiply-adds each); the composite's
few per sample.  The distinct rows come from a frozen copy of the plain hash
(`cnc_torch/ops/hash_ops.py`, the reference's gridencoder.cu:45-87).
"""

from __future__ import annotations

from typing import Sequence

import torch

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _grid_index(cc: torch.Tensor, resolution: int, size: int) -> torch.Tensor:
    d = cc.shape[-1]
    pg = cc & _U32
    if resolution ** d <= size:
        idx, stride = torch.zeros_like(pg[..., 0]), 1
        for i in range(d):
            idx = (idx + pg[..., i] * stride) & _U32
            stride = (stride * resolution) & _U32
        return idx
    h = torch.zeros_like(pg[..., 0])
    for i in range(d):
        h = h ^ ((pg[..., i] * PRIMES[i]) & _U32)
    return h & (size - 1) if size & (size - 1) == 0 else h % size


def rows_touched(points: torch.Tensor, resolutions: Sequence[int],
                 offsets: Sequence[int]) -> int:
    """Distinct table rows that one encode call over `points` [N, D] reads."""
    pts = points[((points >= 0.0) & (points <= 1.0)).all(dim=-1)]
    d = pts.shape[-1]
    found = []
    for li, r in enumerate(resolutions):
        x = pts * float(r - 2) + 0.5
        pg = torch.floor(x).to(torch.int64)
        for corner in range(1 << d):
            cc = pg + torch.tensor([(corner >> a) & 1 for a in range(d)], device=pg.device)
            cc = torch.minimum(cc, torch.full_like(cc, r - 1))
            valid = ((cc != 0) & (cc != r - 1)).all(dim=-1)
            found.append(_grid_index(cc[valid], r, offsets[li + 1] - offsets[li]) + offsets[li])
    return int(torch.unique(torch.cat(found)).numel()) if found else 0


def field_query(model, x01: torch.Tensor):
    """(n, d, levels, f, rows) of each of the four encodes of one field
    query at the positions x01 [N, 3] in [0, 1]^3 (xyz, xy, xz, yz)."""
    out = []
    for cols, spec in (((0, 1, 2), model.grid_3d), ((0, 1), model.grid_2d),
                       ((0, 2), model.grid_2d), ((1, 2), model.grid_2d)):
        pts = x01[:, list(cols)]
        out.append((pts.shape[0], len(cols), spec.n_levels, spec.n_features,
                    rows_touched(pts, spec.resolutions, spec.offsets)))
    return out


def encode(n: int, d: int, levels: int, f: int, rows: int, backward: bool = False):
    """(bytes, operations) of one K1 call (K2 with `backward`)."""
    io = n * d * 4 + n * levels * f * 4 + rows * f * 4
    ops = n * levels * (1 << d) * (d + 2 * f)
    return io, ops


def composite(valid: int, rays: int, carried: bool, backward: bool = False):
    """(bytes, operations) of one K5 call (K5b with `backward`) over `valid`
    samples of `rays` rays."""
    per_sample = 3 * 4 + 4 + 4 + 4 + 1                 # rgb, sigma, t, ray id, valid
    io = valid * per_sample + rays * (3 + 1 + 1) * 4    # rgb, opacity, depth a ray
    if carried:
        io += rays * 4                                  # the eval loop's transmittance
    if backward:
        io += valid * (3 + 1) * 4                       # the samples' rgb and sigma gradients
    return io, valid * (30 if backward else 15)
