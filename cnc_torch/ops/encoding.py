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
`points`.

The rate estimate adds three variants, all through the same twin and the
same two kernels:

  * `occ_mask` / `mask_offsets`: a flat bool grid per level, read at
    `mask_offset + flat(corner)` with the LAST axis fastest
    (`flat = (cc0*R + cc1)*R + cc2`, not the x-fastest dense table index); a
    corner whose bit is false is dropped like a border corner;
  * `grid_encode_diff_levels`: point i encodes levels
    `clip(min_level_ids[i] + j, 0, L-1)` for j < n_levels_calc;
  * `grid_encode_given_table`: one dense level over a caller's table.

cnc_tpu's summed-area-table masking (`occ_sat`, `occ_binary`) is not ported:
no module of cnc_tpu passes it to an encode.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .. import kernels
from ..config import GridSpec
from . import hash_ops, scatter_ops


def _level_setup(points: torch.Tensor, resolution):
    """Lattice cell and fractional position; `resolution` is an int or a
    per-point integer tensor (mixed levels)."""
    if isinstance(resolution, torch.Tensor):
        x = points * (resolution.to(torch.float32) - 2.0)[:, None] + 0.5
    else:
        x = points * float(resolution - 2) + 0.5
    pg = torch.floor(x)
    return x - pg, pg.to(torch.int64)


def _corner_setup(frac: torch.Tensor, pg: torch.Tensor, offset, hashmap_size, resolution,
                  occ_mask: Optional[torch.Tensor] = None, mask_offset=0):
    """Global table indices and weights of one level's 2^D corners.

    Returns (gidx [N, 2^D] int64, w [N, 2^D] f32); border corners, and
    corners whose `occ_mask` bit is false, carry weight 0 and index 0.
    offset / hashmap_size / resolution / mask_offset are ints (a static
    level) or per-point integer tensors (mixed levels).
    """
    n, d = pg.shape
    lim = resolution - 1
    gidx_list, w_list = [], []
    for corner in range(1 << d):
        cc = []
        w = torch.ones(n, dtype=torch.float32, device=frac.device)
        for ax in range(d):
            if (corner >> ax) & 1:
                up = pg[:, ax] + 1
                cc.append(torch.minimum(up, lim) if isinstance(lim, torch.Tensor)
                          else torch.clamp(up, max=lim))
                w = w * frac[:, ax]
            else:
                cc.append(pg[:, ax])
                w = w * (1.0 - frac[:, ax])
        valid = torch.ones(n, dtype=torch.bool, device=frac.device)
        for ax in range(d):
            valid = valid & (cc[ax] != 0) & (cc[ax] != lim)
        if occ_mask is not None:
            flat = cc[0]
            for ax in range(1, d):
                flat = flat * resolution + cc[ax]
            # points outside [0,1] (zeroed later) may fall off the grid
            valid = valid & occ_mask[(mask_offset + flat).clamp(0, occ_mask.numel() - 1)]
        idx = hash_ops.grid_index(torch.stack(cc, dim=-1), resolution, hashmap_size)
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


def _corner_sets(points, resolutions, offsets, occ_mask=None, mask_offsets=None,
                 min_level_ids=None, n_levels_calc=None):
    """Per encoded level, the corner indices and weights ([N, 2^D] each) of
    one encode call, before any table access.  With `min_level_ids`,
    `resolutions`/`offsets`/`mask_offsets` describe every level of the table
    and each point encodes `n_levels_calc` of them."""
    n_levels = len(resolutions)
    gs, ws = [], []
    if min_level_ids is None:
        for li, r in enumerate(resolutions):
            frac, pg = _level_setup(points, r)
            moff = mask_offsets[li] if occ_mask is not None else 0
            gi, wi = _corner_setup(frac, pg, offsets[li], offsets[li + 1] - offsets[li], int(r),
                                   occ_mask, moff)
            gs.append(gi)
            ws.append(wi)
        return gs, ws
    as_t = lambda v: torch.tensor(list(v), dtype=torch.int64, device=points.device)
    res_arr, off_arr = as_t(resolutions), as_t(offsets[:n_levels])
    hs_arr = as_t([offsets[i + 1] - offsets[i] for i in range(n_levels)])
    moff_arr = as_t(mask_offsets) if occ_mask is not None else None
    for j in range(n_levels_calc):
        lvl = torch.clamp(min_level_ids.to(torch.int64) + j, 0, n_levels - 1)
        r = res_arr[lvl]
        frac, pg = _level_setup(points, r)
        gi, wi = _corner_setup(frac, pg, off_arr[lvl], hs_arr[lvl], r, occ_mask,
                               moff_arr[lvl] if occ_mask is not None else 0)
        gs.append(gi)
        ws.append(wi)
    return gs, ws


def _encode_plain(points, table, resolutions, offsets, occ_mask=None, mask_offsets=None,
                  min_level_ids=None, n_levels_calc=None):
    """The plain twin of K1 (and, through autograd, of K2)."""
    gs, ws = _corner_sets(points, resolutions, offsets, occ_mask, mask_offsets, min_level_ids,
                          n_levels_calc)
    return _gather_levels(table, gs, ws, points)


def _check_cuda_args(name, points, other, f, resolutions, offsets, rows, occ_mask, mask_offsets,
                     min_level_ids, n_levels_calc):
    """What K1 and K2 take; returns the kernel's level arguments."""
    kernels.require_cuda(name, points, other, occ_mask, min_level_ids)
    if points.dtype != torch.float32 or other.dtype != torch.float32:
        raise ValueError(f"{name}: points, table and gradient must be float32")
    n, d = points.shape
    n_levels = len(resolutions)
    if d not in (2, 3) or f not in (2, 4) or not 1 <= n_levels <= 32:
        raise ValueError(f"{name}: the kernel takes D in (2, 3), F in (2, 4) and "
                         f"1..32 levels, got D={d}, F={f}, {n_levels} levels")
    if offsets[n_levels] > rows:
        raise ValueError(f"{name}: level offsets run past the table")
    moffs = [0] * n_levels
    if occ_mask is not None:
        if occ_mask.dtype != torch.bool or occ_mask.dim() != 1 or len(mask_offsets) != n_levels:
            raise ValueError(f"{name}: occ_mask must be a flat bool tensor with one offset "
                             "per level")
        moffs = [int(m) for m in mask_offsets]
        if any(m < 0 or m + int(r) ** d > occ_mask.numel() for m, r in zip(moffs, resolutions)):
            raise ValueError(f"{name}: a level's mask grid runs past occ_mask")
    n_out = n_levels
    if min_level_ids is not None:
        if min_level_ids.dtype != torch.int32 or min_level_ids.shape != (n,):
            raise ValueError(f"{name}: min_level_ids must be int32 [N]")
        n_out = int(n_levels_calc)
        if not 1 <= n_out <= n_levels:
            raise ValueError(f"{name}: n_levels_calc must lie in 1..{n_levels}")
    sizes = [offsets[i + 1] - offsets[i] for i in range(n_levels)]
    arr, larr = ctypes.c_int * n_levels, ctypes.c_longlong * n_levels
    return n_out, (n_out, n_levels, arr(*map(int, resolutions)), arr(*map(int, offsets[:n_levels])),
                   arr(*map(int, sizes)), kernels.ptr(occ_mask), larr(*moffs),
                   kernels.ptr(min_level_ids))


def _encode_cuda(points, table, resolutions, offsets, occ_mask=None, mask_offsets=None,
                 min_level_ids=None, n_levels_calc=None):
    n, d = points.shape
    f = table.shape[1]
    n_out, levels = _check_cuda_args("grid_encode", points, table, f, resolutions, offsets,
                                     table.shape[0], occ_mask, mask_offsets, min_level_ids,
                                     n_levels_calc)
    if table.data_ptr() % (4 * f):
        # the kernel reads a row as one float2/float4
        raise ValueError(f"grid_encode: table rows must be {4 * f}-byte aligned")
    out = torch.empty(n, n_out * f, dtype=torch.float32, device=points.device)
    kernels.call("cnc_grid_encode_forward", kernels.ptr(points), kernels.ptr(table),
                 kernels.ptr(out), n, d, f, *levels)
    variant = occ_mask is not None or min_level_ids is not None
    kernels.launches["grid_encode_v" if variant else "grid_encode"] += 1
    return out


def _encode_backward_cuda(points, grad, rows, resolutions, offsets, occ_mask=None,
                          mask_offsets=None, min_level_ids=None, n_levels_calc=None):
    """K2: d_table [rows, F] of `_encode_cuda` for the output gradient `grad`
    [N, L*F].  The sum runs through float atomics, so its order, and the last
    bits of the result, vary from run to run."""
    n, d = points.shape
    n_out = len(resolutions) if min_level_ids is None else int(n_levels_calc)
    if grad.dim() != 2 or grad.shape[0] != n or grad.shape[1] % n_out:
        raise ValueError("grid_encode_bwd: grad must be [N, L*F]")
    f = grad.shape[1] // n_out
    _, levels = _check_cuda_args("grid_encode_bwd", points, grad, f, resolutions, offsets, rows,
                                 occ_mask, mask_offsets, min_level_ids, n_levels_calc)
    d_table = torch.zeros(rows, f, dtype=torch.float32, device=points.device)
    kernels.call("cnc_grid_encode_backward", kernels.ptr(points), kernels.ptr(grad),
                 kernels.ptr(d_table), n, d, f, *levels)
    variant = occ_mask is not None or min_level_ids is not None
    kernels.launches["grid_encode_v_bwd" if variant else "grid_encode_bwd"] += 1
    return d_table


class _GridEncodeCuda(torch.autograd.Function):
    """K1 forward, K2 backward; a gradient for the table only."""

    @staticmethod
    def forward(ctx, points, table, resolutions, offsets, occ_mask, mask_offsets, min_level_ids,
                n_levels_calc):
        ctx.save_for_backward(points, occ_mask, min_level_ids)
        ctx.levels = (table.shape[0], resolutions, offsets, mask_offsets, n_levels_calc)
        return _encode_cuda(points, table, resolutions, offsets, occ_mask, mask_offsets,
                            min_level_ids, n_levels_calc)

    @staticmethod
    def backward(ctx, grad):
        points, occ_mask, min_level_ids = ctx.saved_tensors
        rows, resolutions, offsets, mask_offsets, n_levels_calc = ctx.levels
        d_table = _encode_backward_cuda(points, grad.contiguous(), rows, resolutions, offsets,
                                        occ_mask, mask_offsets, min_level_ids, n_levels_calc)
        return (None, d_table) + (None,) * 6


def _encode(points, table, resolutions, offsets, occ_mask, mask_offsets, min_level_ids=None,
            n_levels_calc=None):
    if occ_mask is not None and mask_offsets is None:
        raise ValueError("occ_mask needs mask_offsets, one per level")
    moffs = tuple(int(m) for m in mask_offsets) if occ_mask is not None else None
    if points.is_cuda:
        ids = None if min_level_ids is None else min_level_ids.to(torch.int32).contiguous()
        if occ_mask is not None:
            occ_mask = occ_mask.contiguous()
        return _GridEncodeCuda.apply(points.detach().contiguous(), table.contiguous(),
                                     tuple(resolutions), tuple(offsets), occ_mask, moffs, ids,
                                     n_levels_calc)
    return _encode_plain(points.detach(), table, resolutions, offsets, occ_mask, moffs,
                         min_level_ids, n_levels_calc)


def encode_explicit(points: torch.Tensor, table: torch.Tensor,
                    resolutions: Sequence[int], offsets: Sequence[int],
                    occ_mask: Optional[torch.Tensor] = None,
                    mask_offsets: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Encode against explicit per-level (resolution, offset) lists.

    offsets has len(resolutions)+1 entries; a level's table size is the
    difference.  occ_mask/mask_offsets: flat per-corner bool grids and each
    level's start in them.  Returns [N, L*F] float32, level-major.  CPU
    tensors take the plain twin, CUDA tensors the K1 kernel (and K2 in the
    backward).  Only `table` gets a gradient.
    """
    return _encode(points, table, resolutions, offsets, occ_mask, mask_offsets)


def grid_encode(points: torch.Tensor, table: torch.Tensor, spec: GridSpec,
                min_level: int = 0, max_level: Optional[int] = None,
                occ_mask: Optional[torch.Tensor] = None,
                mask_offsets: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Encode levels [min_level, max_level) of a GridSpec table.

    points [N, D] in [0, 1]; table [spec.total_entries, F]; occ_mask /
    mask_offsets cover ALL levels of the spec.
    Returns [N, (max_level-min_level) * F] float32, level-major.
    """
    min_level = max(min_level, 0)
    max_level = spec.n_levels if max_level is None else min(max_level, spec.n_levels)
    moffs = mask_offsets[min_level:max_level] if mask_offsets is not None else None
    return encode_explicit(points, table, spec.resolutions[min_level:max_level],
                           spec.offsets[min_level:max_level + 1], occ_mask, moffs)


def grid_encode_diff_levels(points: torch.Tensor, table: torch.Tensor, spec: GridSpec,
                            min_level_ids: torch.Tensor, n_levels_calc: int,
                            occ_mask: Optional[torch.Tensor] = None,
                            mask_offsets: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Per-point mixed-level encode (GridEncoder.forward_diff_levels): point i
    contributes levels min_level_ids[i] .. min_level_ids[i]+J-1, each clipped
    into [0, L-1], in one call.  Returns [N, J*F]."""
    return _encode(points, table, spec.resolutions, spec.offsets, occ_mask, mask_offsets,
                   min_level_ids, n_levels_calc)


def grid_encode_given_table(points: torch.Tensor, table: torch.Tensor, resolution: int,
                            occ_mask: Optional[torch.Tensor] = None,
                            mask_offset: int = 0) -> torch.Tensor:
    """One-level dense-table encode (GridEncoder.forward_given_params).

    Used for the dimension-wise prior: `table` is a dense [resolution**2, F]
    plane flattened with x fastest (flat = x + y*resolution), matching the
    dense table index; cnc_tpu keeps this orientation on both codec sides
    (the reference reads the transposed map).
    """
    return encode_explicit(points, table, [resolution], [0, table.shape[0]], occ_mask,
                           [mask_offset] if occ_mask is not None else None)
