"""Frozen copy of `cnc_torch/ops/encoding.py`, its plain path only (no CUDA kernel);
what follows is the original's description.

Multiresolution hash-grid encode: K1 forward, K2 backward.

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
    corner whose bit is false is dropped like a border corner.  The CUDA
    kernels read the same grid packed one bit per vertex (`occ_bits =
    pack_mask_bits(occ_mask)`, which a caller makes once per mask: the
    rate's cache holds both), the plain twin the bools;
  * `grid_encode_diff_levels`: point i encodes levels
    `clip(min_level_ids[i] + j, 0, L-1)` for j < n_levels_calc;
  * `grid_encode_given_table`: one dense level over a caller's table.

and cnc_tpu's summed-area-table masking, the TPU form of the reference's
corner masking (gridencoder.cu:222-276): with `occ_binary` (an Rb^D bool
occupancy grid) or its prebuilt table `occ_sat` (`ops/sat.build_sat`), a
corner is also dropped when its +-1-cell footprint on the Rb grid holds no
occupied cell.  The twin asks `sat.occupancy_mask`; on the card K1s/K2s, the
same two kernels instantiated with the table as their mask source, read
the sources one launch makes from it (`sat_mask_sources`): the packed
corner bits of the coarse levels and the occupancy itself, one bit a cell,
for the fine ones (R - 2 > Rb), whose corners share one window of it
(csrc/grid_encode.cu).  The backward reuses the forward's sources.
`occ_mask` wins when both forms are given, as in cnc_tpu.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .config import GridSpec
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
                  occ_mask: Optional[torch.Tensor] = None, mask_offset=0,
                  occ_sat: Optional[torch.Tensor] = None):
    """Global table indices and weights of one level's 2^D corners.

    Returns (gidx [N, 2^D] int64, w [N, 2^D] f32); border corners, and
    corners whose `occ_mask` bit is false (or, without occ_mask, whose
    footprint on the `occ_sat` grid is empty), carry weight 0 and index 0.
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
    w3 = w2.reshape(n, g, c)
    wn = w3[:, :, 0]
    for i in range(1, c):            # in order, as K1 sums them
        wn = wn + w3[:, :, i]
    wn = torch.where(wn == 0.0, 1e-9, wn)
    out = acc.reshape(n, g, f) / wn[..., None]
    oob = ((points < 0.0) | (points > 1.0)).any(dim=-1)
    out = torch.where(oob[:, None, None], 0.0, out)
    return out.reshape(n, g * f)


def _corner_sets(points, resolutions, offsets, occ_mask=None, mask_offsets=None,
                 min_level_ids=None, n_levels_calc=None, occ_sat=None):
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
                                   occ_mask, moff, occ_sat)
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
                               moff_arr[lvl] if occ_mask is not None else 0, occ_sat)
        gs.append(gi)
        ws.append(wi)
    return gs, ws


def _encode_plain(points, table, resolutions, offsets, occ_mask=None, mask_offsets=None,
                  min_level_ids=None, n_levels_calc=None, occ_bits=None, occ_sat=None):
    """The plain twin of K1 (and, through autograd, of K2), and with
    `occ_sat` of K1s (K2s).  It reads the bools of `occ_mask`; `occ_bits`,
    the packed copy the kernels read, is taken so that one set of arguments
    serves both, and not read."""
    gs, ws = _corner_sets(points, resolutions, offsets, occ_mask, mask_offsets, min_level_ids,
                          n_levels_calc, occ_sat)
    return _gather_levels(table, gs, ws, points)


def _encode(points, table, resolutions, offsets, occ_mask=None, mask_offsets=None,
            occ_bits=None, min_level_ids=None, n_levels_calc=None, occ_binary=None,
            occ_sat=None):
    if occ_mask is not None and mask_offsets is None:
        raise ValueError("occ_mask needs mask_offsets, one per level")
    moffs = tuple(int(m) for m in mask_offsets) if occ_mask is not None else None
    if occ_mask is None and (occ_sat is not None or occ_binary is not None):
        raise NotImplementedError("the reference has no summed-area-table masking")
    return _encode_plain(points.detach(), table, resolutions, offsets, occ_mask, moffs,
                         min_level_ids, n_levels_calc, occ_sat=occ_sat)


def encode_explicit(points: torch.Tensor, table: torch.Tensor,
                    resolutions: Sequence[int], offsets: Sequence[int],
                    occ_binary: Optional[torch.Tensor] = None,
                    occ_sat: Optional[torch.Tensor] = None,
                    occ_mask: Optional[torch.Tensor] = None,
                    mask_offsets: Optional[Sequence[int]] = None,
                    occ_bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode against explicit per-level (resolution, offset) lists.

    offsets has len(resolutions)+1 entries; a level's table size is the
    difference.  occ_binary/occ_sat: an Rb^D bool occupancy grid or its
    summed-area table (`sat.build_sat`; pass the table when calling
    repeatedly), masking each corner whose footprint on the grid is empty.
    occ_mask/mask_offsets: flat per-corner bool grids and each level's start
    in them; occ_bits: `pack_mask_bits(occ_mask)`, which the CUDA kernels
    read in its place (required with a CUDA occ_mask, unused by the plain
    twin); occ_mask wins over the grid.  Returns [N, L*F] float32,
    level-major.  CPU tensors take the plain twin, CUDA tensors the K1
    kernel (K1s with the grid; K2, K2s in the backward).  Only `table` gets
    a gradient.
    """
    return _encode(points, table, resolutions, offsets, occ_mask, mask_offsets, occ_bits,
                   occ_binary=occ_binary, occ_sat=occ_sat)


def grid_encode(points: torch.Tensor, table: torch.Tensor, spec: GridSpec,
                min_level: int = 0, max_level: Optional[int] = None,
                occ_binary: Optional[torch.Tensor] = None,
                occ_sat: Optional[torch.Tensor] = None,
                occ_mask: Optional[torch.Tensor] = None,
                mask_offsets: Optional[Sequence[int]] = None,
                occ_bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode levels [min_level, max_level) of a GridSpec table.

    points [N, D] in [0, 1]; table [spec.total_entries, F]; occ_mask /
    mask_offsets cover ALL levels of the spec (occ_binary, occ_sat and
    occ_bits as in `encode_explicit`).
    Returns [N, (max_level-min_level) * F] float32, level-major.
    """
    min_level = max(min_level, 0)
    max_level = spec.n_levels if max_level is None else min(max_level, spec.n_levels)
    moffs = mask_offsets[min_level:max_level] if mask_offsets is not None else None
    return encode_explicit(points, table, spec.resolutions[min_level:max_level],
                           spec.offsets[min_level:max_level + 1], occ_binary, occ_sat,
                           occ_mask, moffs, occ_bits)


def grid_encode_diff_levels(points: torch.Tensor, table: torch.Tensor, spec: GridSpec,
                            min_level_ids: torch.Tensor, n_levels_calc: int,
                            occ_binary: Optional[torch.Tensor] = None,
                            occ_sat: Optional[torch.Tensor] = None,
                            occ_mask: Optional[torch.Tensor] = None,
                            mask_offsets: Optional[Sequence[int]] = None,
                            occ_bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-point mixed-level encode (GridEncoder.forward_diff_levels): point i
    contributes levels min_level_ids[i] .. min_level_ids[i]+J-1, each clipped
    into [0, L-1], in one call.  Returns [N, J*F]."""
    return _encode(points, table, spec.resolutions, spec.offsets, occ_mask, mask_offsets,
                   occ_bits, min_level_ids, n_levels_calc, occ_binary=occ_binary,
                   occ_sat=occ_sat)


def grid_encode_given_table(points: torch.Tensor, table: torch.Tensor, resolution: int,
                            occ_binary: Optional[torch.Tensor] = None,
                            occ_sat: Optional[torch.Tensor] = None,
                            occ_mask: Optional[torch.Tensor] = None,
                            mask_offset: int = 0,
                            occ_bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-level dense-table encode (GridEncoder.forward_given_params).

    Used for the dimension-wise prior: `table` is a dense [resolution**2, F]
    plane flattened with x fastest (flat = x + y*resolution), matching the
    dense table index; cnc_tpu keeps this orientation on both codec sides
    (the reference reads the transposed map).
    """
    return encode_explicit(points, table, [resolution], [0, table.shape[0]], occ_binary,
                           occ_sat, occ_mask, [mask_offset] if occ_mask is not None else None,
                           occ_bits)
