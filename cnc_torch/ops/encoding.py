"""Multiresolution hash-grid encode (K1), forward.

Port of `cnc_tpu/ops/encoding.py` (reference gridencoder.cu:45-396):

  * per level: map points in [0,1]^D to a (R-2)-cell lattice with a one-cell
    zero border (`pos = x*(R-2)+0.5`), take the 2^D corners with D-linear
    weights;
  * corners on the border (coord 0 or R-1) are excluded;
  * weights are renormalized over surviving corners (1e-9 when none survive);
  * hashing matches `fast_hash`/`get_grid_index` bit for bit (ops/hash_ops).

`encode_explicit` dispatches on the device of `points`: a CPU tensor takes
the plain twin (`_encode_plain`), a CUDA tensor the hand-written kernel
(csrc/grid_encode.cu).  The occupancy-masked variants and
`grid_encode_diff_levels` / `grid_encode_given_table` serve the rate
estimate and come with it; the backward (K2) comes with training.
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


def _encode_cuda(points, table, resolutions, offsets):
    kernels.require_cuda("grid_encode", points, table)
    if points.dtype != torch.float32 or table.dtype != torch.float32:
        raise ValueError("grid_encode: points and table must be float32")
    n, d = points.shape
    f = table.shape[1]
    n_levels = len(resolutions)
    if d not in (2, 3) or f not in (2, 4) or not 1 <= n_levels <= 32:
        raise ValueError(f"grid_encode: the kernel takes D in (2, 3), F in (2, 4) and "
                         f"1..32 levels, got D={d}, F={f}, {n_levels} levels")
    sizes = [offsets[i + 1] - offsets[i] for i in range(n_levels)]
    if offsets[n_levels] > table.shape[0]:
        raise ValueError("grid_encode: level offsets run past the table")
    if table.data_ptr() % (4 * f):
        # the kernel reads a row as one float2/float4
        raise ValueError(f"grid_encode: table rows must be {4 * f}-byte aligned")
    out = torch.empty(n, n_levels * f, dtype=torch.float32, device=points.device)
    arr = ctypes.c_int * n_levels
    kernels.call("cnc_grid_encode_forward", kernels.ptr(points), kernels.ptr(table),
                 kernels.ptr(out), n, d, f, n_levels, arr(*map(int, resolutions)),
                 arr(*map(int, offsets[:n_levels])), arr(*map(int, sizes)))
    kernels.launches["grid_encode"] += 1
    return out


def encode_explicit(points: torch.Tensor, table: torch.Tensor,
                    resolutions: Sequence[int], offsets: Sequence[int]) -> torch.Tensor:
    """Encode against explicit per-level (resolution, offset) lists.

    offsets has len(resolutions)+1 entries; a level's table size is the
    difference.  Returns [N, L*F] float32, level-major.  CPU tensors take the
    plain twin, CUDA tensors the K1 kernel.
    """
    if points.is_cuda:
        return _encode_cuda(points.contiguous(), table.contiguous(), resolutions, offsets)
    return _encode_plain(points, table, resolutions, offsets)


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
