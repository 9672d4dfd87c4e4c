"""Multiresolution hash-grid encode: K1 forward, K2 backward.

Port of `cnc_tpu/ops/encoding.py` (reference gridencoder.cu:45-396):

  * per level: map points in [0,1]^D to a (R-2)-cell lattice with a one-cell
    zero border (`pos = x*(R-2)+0.5`), take the 2^D corners with D-linear
    weights;
  * corners on the border (coord 0 or R-1) are excluded;
  * weights are renormalized over surviving corners (1e-9 when none survive);
  * hashing matches `fast_hash`/`get_grid_index` bit for bit (ops/hash_ops).

`encode_explicit` dispatches on the device of `points`: a CPU tensor takes
the plain twin (`_encode_plain`, differentiated by autograd as it stands), a
CUDA tensor an `autograd.Function` whose forward is the K1 kernel and whose
backward is the K2 kernel (csrc/grid_encode.cu).  Only the table gets a
gradient: cnc_tpu never differentiates with respect to sample positions
(`need_dw=False` in every hot call), so neither path returns one for
`points`.  The occupancy-masked variants and `grid_encode_diff_levels` /
`grid_encode_given_table` serve the rate estimate and come with it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .. import kernels
from ..config import GridSpec
from . import hash_ops, scatter_ops


def _level_setup(points: torch.Tensor, resolution: int):
    x = points * float(resolution - 2) + 0.5
    pg = torch.floor(x)
    return x - pg, pg.to(torch.int64)


def _corner_setup(frac: torch.Tensor, pg: torch.Tensor, offset: int, hashmap_size: int,
                  resolution: int):
    """Global table indices and weights of one level's 2^D corners.

    Returns (gidx [N, 2^D] int64, w [N, 2^D] f32); border corners carry
    weight 0 and index 0.
    """
    n, d = pg.shape
    gidx_list, w_list = [], []
    for corner in range(1 << d):
        cc = []
        w = torch.ones(n, dtype=torch.float32, device=frac.device)
        for ax in range(d):
            if (corner >> ax) & 1:
                cc.append(torch.clamp(pg[:, ax] + 1, max=resolution - 1))
                w = w * frac[:, ax]
            else:
                cc.append(pg[:, ax])
                w = w * (1.0 - frac[:, ax])
        cc = torch.stack(cc, dim=-1)
        valid = ~((cc == 0) | (cc == resolution - 1)).any(dim=-1)
        idx = hash_ops.grid_index(cc, resolution, hashmap_size)
        gidx_list.append(torch.where(valid, idx + offset, 0))
        w_list.append(torch.where(valid, w, 0.0))
    return torch.stack(gidx_list, dim=-1), torch.stack(w_list, dim=-1)


def _gather_levels(table: torch.Tensor, gidx_list, w_list, points: torch.Tensor):
    """Gather + renormalize + out-of-[0,1] zeroing over per-level corner sets."""
    n = points.shape[0]
    g = len(gidx_list)
    c = gidx_list[0].shape[-1]
    f = table.shape[-1]
    w2 = torch.cat(w_list, dim=1)
    acc = scatter_ops.grouped_gather_interp(table.float(), torch.cat(gidx_list, dim=1), w2, g)
    wn = w2.reshape(n, g, c).sum(dim=-1)
    wn = torch.where(wn == 0.0, 1e-9, wn)
    out = acc.reshape(n, g, f) / wn[..., None]
    oob = ((points < 0.0) | (points > 1.0)).any(dim=-1)
    out = torch.where(oob[:, None, None], 0.0, out)
    return out.reshape(n, g * f)


def _encode_plain(points, table, resolutions, offsets):
    gs, ws = [], []
    for li, r in enumerate(resolutions):
        frac, pg = _level_setup(points, r)
        gi, wi = _corner_setup(frac, pg, offsets[li], offsets[li + 1] - offsets[li], int(r))
        gs.append(gi)
        ws.append(wi)
    return _gather_levels(table, gs, ws, points)


def _check_cuda_args(name, points, other, f, resolutions, offsets, rows):
    """What K1 and K2 take; returns the ctypes level arrays."""
    kernels.require_cuda(name, points, other)
    if points.dtype != torch.float32 or other.dtype != torch.float32:
        raise ValueError(f"{name}: points, table and gradient must be float32")
    d = points.shape[1]
    n_levels = len(resolutions)
    if d not in (2, 3) or f not in (2, 4) or not 1 <= n_levels <= 32:
        raise ValueError(f"{name}: the kernel takes D in (2, 3), F in (2, 4) and "
                         f"1..32 levels, got D={d}, F={f}, {n_levels} levels")
    if offsets[n_levels] > rows:
        raise ValueError(f"{name}: level offsets run past the table")
    sizes = [offsets[i + 1] - offsets[i] for i in range(n_levels)]
    arr = ctypes.c_int * n_levels
    return (arr(*map(int, resolutions)), arr(*map(int, offsets[:n_levels])),
            arr(*map(int, sizes)))


def _encode_cuda(points, table, resolutions, offsets):
    n, d = points.shape
    f = table.shape[1]
    levels = _check_cuda_args("grid_encode", points, table, f, resolutions, offsets,
                              table.shape[0])
    if table.data_ptr() % (4 * f):
        # the kernel reads a row as one float2/float4
        raise ValueError(f"grid_encode: table rows must be {4 * f}-byte aligned")
    out = torch.empty(n, len(resolutions) * f, dtype=torch.float32, device=points.device)
    kernels.call("cnc_grid_encode_forward", kernels.ptr(points), kernels.ptr(table),
                 kernels.ptr(out), n, d, f, len(resolutions), *levels)
    kernels.launches["grid_encode"] += 1
    return out


def _encode_backward_cuda(points, grad, rows, resolutions, offsets):
    """K2: d_table [rows, F] of `_encode_cuda` for the output gradient `grad`
    [N, L*F].  The sum runs through float atomics, so its order, and the last
    bits of the result, vary from run to run."""
    n, d = points.shape
    n_levels = len(resolutions)
    if grad.dim() != 2 or grad.shape[0] != n or grad.shape[1] % n_levels:
        raise ValueError("grid_encode_bwd: grad must be [N, L*F]")
    f = grad.shape[1] // n_levels
    levels = _check_cuda_args("grid_encode_bwd", points, grad, f, resolutions, offsets, rows)
    d_table = torch.zeros(rows, f, dtype=torch.float32, device=points.device)
    kernels.call("cnc_grid_encode_backward", kernels.ptr(points), kernels.ptr(grad),
                 kernels.ptr(d_table), n, d, f, n_levels, *levels)
    kernels.launches["grid_encode_bwd"] += 1
    return d_table


class _GridEncodeCuda(torch.autograd.Function):
    """K1 forward, K2 backward; a gradient for the table only."""

    @staticmethod
    def forward(ctx, points, table, resolutions, offsets):
        ctx.save_for_backward(points)
        ctx.levels = (table.shape[0], resolutions, offsets)
        return _encode_cuda(points, table, resolutions, offsets)

    @staticmethod
    def backward(ctx, grad):
        (points,) = ctx.saved_tensors
        rows, resolutions, offsets = ctx.levels
        d_table = _encode_backward_cuda(points, grad.contiguous(), rows, resolutions, offsets)
        return None, d_table, None, None


def encode_explicit(points: torch.Tensor, table: torch.Tensor,
                    resolutions: Sequence[int], offsets: Sequence[int]) -> torch.Tensor:
    """Encode against explicit per-level (resolution, offset) lists.

    offsets has len(resolutions)+1 entries; a level's table size is the
    difference.  Returns [N, L*F] float32, level-major.  CPU tensors take the
    plain twin, CUDA tensors the K1 kernel (and K2 in the backward).  Only
    `table` gets a gradient.
    """
    if points.is_cuda:
        return _GridEncodeCuda.apply(points.detach().contiguous(), table.contiguous(),
                                     tuple(resolutions), tuple(offsets))
    return _encode_plain(points.detach(), table, resolutions, offsets)


def grid_encode(points: torch.Tensor, table: torch.Tensor, spec: GridSpec,
                min_level: int = 0, max_level: Optional[int] = None) -> torch.Tensor:
    """Encode levels [min_level, max_level) of a GridSpec table.

    points [N, D] in [0, 1]; table [spec.total_entries, F].
    Returns [N, (max_level-min_level) * F] float32, level-major.
    """
    min_level = max(min_level, 0)
    max_level = spec.n_levels if max_level is None else min(max_level, spec.n_levels)
    return encode_explicit(points, table, spec.resolutions[min_level:max_level],
                           spec.offsets[min_level:max_level + 1])
