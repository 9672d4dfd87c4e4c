"""Frozen copy of `cnc_torch/ops/context_ops.py`, its plain path only (no CUDA kernel);
what follows is the original's description.

The rate estimate's kernels: context pooling (K6m, one call site's pooled
mean in one launch, and K6, segment_gather's backward), the frac plane (K7;
K7p, a data-parallel rank's share of it over a range of rows),
the footprint grids (K8) and the vertex->entry tables (K10).

Each function here replaces one XLA composition of
`cnc_tpu/models/context_models.py` and dispatches on the device of its input:
a CPU tensor takes the plain twin beside it (which keeps cnc_tpu's order of
operations and is what the CPU tests hold against cnc_tpu), a CUDA tensor the
kernel in `cnc_torch/csrc/` or an error.  Nothing on the card's path calls a
twin.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as nn_functional

from . import hash_ops


# ------------------------------------------------------------------ K6
def _live_rows(seg: torch.Tensor, valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    return valid & (seg >= 0) & (seg < num_segments)


def _segment_pool_plain(x, seg, valid, num_segments):
    # row `num_segments` is a drop slot (cnc_tpu scatters with mode="drop")
    live = _live_rows(seg, valid, num_segments)
    seg_safe = torch.where(live, seg.long(), num_segments)
    out = torch.zeros((num_segments + 1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    xm = torch.where(live if x.dim() == 1 else live[:, None], x, 0.0)
    return out.index_add(0, seg_safe, xm)[:num_segments]


def _segment_gather_plain(values, seg, valid):
    live = _live_rows(seg, valid, values.shape[0])
    out = values.index_select(0, torch.where(live, seg.long(), 0))
    return torch.where(live if values.dim() == 1 else live[:, None], out, 0.0)


def segment_gather(values: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """out[i] = values[seg[i]] where `valid` (and the id lies in range), else
    0: each row's segment value.

    values [S] float32 ([S, F] on the CPU); seg [N] integers in runs; valid
    [N] bool.
    `values` gets the per-segment sums of the row gradients, through K6's
    warp-aggregated adds (a plain gather's backward would queue every row of
    a segment on one address).  CPU tensors take the plain twin.
    """
    return _segment_gather_plain(values, seg, valid)


def _check_live_order(seg, valid, num_segments):
    """segment_mean's precondition: the ids of the live rows do not decrease."""
    ids = seg[_live_rows(seg, valid, num_segments)]
    if ids.numel() > 1 and bool((ids[1:] < ids[:-1]).any()):
        raise ValueError("segment_mean: the ids of the live rows decrease")


def _segment_mean_plain(x, den, seg, valid, num_segments, min_den, weighted):
    _check_live_order(seg, valid, num_segments)
    den_sum = _segment_pool_plain(den, seg, valid, num_segments)
    num = x * den[:, None] if weighted else x
    pooled = _segment_pool_plain(num, seg, valid, num_segments)
    return pooled / torch.clamp(den_sum, min=min_den)[:, None], den_sum > 0


_mean_work: Dict[Tuple[torch.device, int], _SegmentMeanWork] = {}
# per device: the word every segment_mean launch there sets when live ids
# decrease (set only, so launches on any stream may share it)
_fault_words: Dict[torch.device, torch.Tensor] = {}


def segment_mean(x: torch.Tensor, den: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                 num_segments: int, min_den: float, weighted: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call site's context pooling: per segment s, over its live rows i
    (valid, id in [0, num_segments)),

        pooled[s] = sum_i w_i x[i] / max(sum_i den[i], min_den),
        covered[s] = sum_i den[i] > 0,

    with w_i = den[i] when `weighted` (the overlap-weighted pooling) and 1
    otherwise.  Segments without a live row read 0 and False.

    x [N, F] float32 (F in 1, 2, 4 on the card); den [N] float32, which takes
    no gradient; seg [N] integers whose live rows' ids do not decrease (the
    twin raises where they do; the kernel sets the word that
    `segment_order_faults` reads); valid [N] bool.  Only x gets a gradient.
    CPU tensors take the plain twin, CUDA tensors the kernels of
    csrc/segment_pool.cu (one launch forward, one backward).
    """
    if (x.dim() != 2 or seg.shape != x.shape[:1] or valid.shape != seg.shape
            or den.shape != seg.shape):
        raise ValueError("segment_mean expects x [N, F], den [N], seg [N] and valid [N]")
    if den.requires_grad:
        raise ValueError("segment_mean: den takes no gradient")
    min_den = float(np.float32(min_den))
    return _segment_mean_plain(x, den, seg, valid, num_segments, min_den, weighted)


# ------------------------------------------------------------------ K7
class _PosIndicator(torch.autograd.Function):
    """Straight-through positive-sign indicator: forward counts entries > 0.9
    (cnt_np_embed_kernel, gridencoder.cu:909), backward routes the gradient
    to the positive entries only (cu:1011-1018)."""

    @staticmethod
    def forward(ctx, e):
        ctx.save_for_backward(e)
        return (e > 0.9).to(e.dtype)

    @staticmethod
    def backward(ctx, g):
        (e,) = ctx.saved_tensors
        return torch.where(e > 0.9, g, 0.0)


def _pn_hist_plain(table, fine_offset, sel, row_valid, bnd):
    svals = _PosIndicator.apply(table[fine_offset + sel.long()])
    svals = torch.where(row_valid[:, None], svals, 0.0)
    # per-feature cumulative sums differenced at the boundaries (_csum_diffs)
    cs = torch.cat([torch.zeros(1, svals.shape[1], dtype=svals.dtype, device=svals.device),
                    torch.cumsum(svals, dim=0)])
    b = bnd.long()
    return cs[b[1:]] - cs[b[:-1]]


def _pn_rows(entry_idx, bounds, n, sample_cap, lo=0, size=None):
    """The rows a frac plane counts, as cnc_tpu's pn_frac_plane forms them:
    (sel [rows] entry indices, row_valid [rows], bnd [bins + 1] the bins'
    row boundaries).  With `sample_cap` below the list's capacity, row j is
    the stride sample src(j) = floor(j * m / take) of the m = min(n, cap)
    listed rows (in float32, as cnc_tpu: int products would overflow int32),
    and the boundaries map through the same formula by searchsorted, so the
    sampling stays self-consistent.

    With `size`, the rows [lo, lo + size) of that row space (past its end
    invalid) and the boundaries clip(bnd - lo, 0, size), as cnc_tpu's
    `_sliced` forms one device's chunk under `axis_name`."""
    cap = entry_idx.shape[0]
    dev = entry_idx.device
    if sample_cap is not None and sample_cap < cap:
        m = torch.clamp(n, max=cap)
        take = torch.clamp(m, max=sample_cap)
        stride = m.to(torch.float32) / torch.clamp(take, min=1).to(torch.float32)
        j = torch.arange(sample_cap, dtype=torch.int32, device=dev)
        src = torch.floor(j.to(torch.float32) * stride).to(torch.int32)
        src = torch.minimum(src, torch.clamp(m - 1, min=0))
        bmap = torch.minimum(torch.searchsorted(src, bounds).to(torch.int32), take)
        sel, row_valid, bnd = entry_idx[torch.clamp(src, max=cap - 1).long()], j < take, bmap
    else:
        sel, row_valid, bnd = entry_idx, torch.arange(cap, device=dev) < torch.clamp(n, max=cap), \
            bounds
    if size is None:
        return sel, row_valid, bnd
    pad = max(lo + size - sel.shape[0], 0)
    return (nn_functional.pad(sel, (0, pad))[lo:lo + size],
            nn_functional.pad(row_valid, (0, pad))[lo:lo + size],
            torch.clamp(bnd - lo, 0, size))


def _pn_frac_plane_plain(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap=None):
    sel, row_valid, bnd = _pn_rows(entry_idx, bounds, n, sample_cap)
    pos = _pn_hist_plain(table, fine_offset, sel, row_valid, bnd)
    cnt = (bnd[1:] - bnd[:-1]).to(torch.float32)[:, None]
    scale, f = pn_res - 2, table.shape[1]
    plane = nn_functional.pad((pos / (cnt + 1e-6)).reshape(scale, scale, f), (0, 0, 1, 1, 1, 1))
    # x-fastest flat layout to match dense grid indexing (see
    # ops/encoding.grid_encode_given_table)
    return plane.transpose(0, 1).reshape(-1, f)


def pn_frac_plane(table: torch.Tensor, fine_offset: int, entry_idx: torch.Tensor,
                  bounds: torch.Tensor, n: torch.Tensor, pn_res: int,
                  sample_cap: Optional[int] = None) -> torch.Tensor:
    """The positive-sign fraction plane of the finest level at the cached
    coords: [pn_res**2, F] float32, x fastest, with a zero border ring.

    table [T, F] float32 (the 3D table; the finest level starts at
    `fine_offset`); entry_idx [cap] int32 bin-sorted finest-level entries,
    bounds [(pn_res - 2)**2 + 1] their bins' row boundaries, n the 0-dim
    int32 count of listed rows (the refresh's pn coord list of one axis).
    pos[b] counts the valid rows of bin b whose entry is > 0.9 (a stride
    sample of at most `sample_cap` rows when that is below cap), frac =
    pos / (cnt + 1e-6).  `table` gets the straight-through gradient of the
    indicator.  CPU tensors take the plain twin, CUDA tensors the kernels of
    csrc/pn_hist.cu (one launch; with a gradient, K7b's fill and one launch).
    """
    return _pn_frac_plane_plain(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap)


# ------------------------------------------------------------------ K8
class FootprintBounds(NamedTuple):
    """Per-axis footprint bounds of one level lattice over an Rb grid, as
    cnc_tpu computes them in float64 (context_models.py:1393-1397,1427-1433
    and `lerp`, 1446-1450)."""
    lo: np.ndarray        # [R] int32, first cell the +-1-cell box touches
    hi: np.ndarray        # [R] int32, last cell
    a_i: np.ndarray       # [R] int32, cell of the box's continuous lower end
    b_i: np.ndarray
    a_fr: np.ndarray      # [R] float32, that end's fraction inside its cell
    b_fr: np.ndarray


@functools.lru_cache(maxsize=None)
def footprint_bounds(resolution: int, rb: int) -> FootprintBounds:
    r = resolution
    c = np.arange(r, dtype=np.float64)
    scale_re = 1.0 / (r - 2.0)
    pn = (c - 0.5) * scale_re
    lo = np.clip((pn - scale_re) * rb, 0, rb - 1).astype(np.int32)
    hi = np.clip((pn + scale_re) * rb, 0, rb - 1).astype(np.int32)
    a_f = np.clip(pn - scale_re, 0.0, 1.0) * rb       # continuous, cell units
    b_f = np.clip(pn + scale_re, 0.0, 1.0) * rb

    def split(u):
        i0 = np.clip(np.floor(u).astype(np.int32), 0, rb - 1)
        return i0, (u - i0).astype(np.float32)

    (a_i, a_fr), (b_i, b_fr) = split(a_f), split(b_f)
    return FootprintBounds(lo, hi, a_i, b_i, a_fr, b_fr)


def _footprint_plain(occ: torch.Tensor, resolution: int, with_overlap: bool):
    """cnc_tpu's separable form: per axis a cumulative sum read at the
    per-corner bounds (interpolated at the continuous ones for the overlap),
    pooling along axis 0 and rolling it to the back."""
    rb = occ.shape[0]
    bd = footprint_bounds(resolution, rb)
    dev = occ.device
    lo, hi = torch.from_numpy(bd.lo).long().to(dev), torch.from_numpy(bd.hi).long().to(dev)

    def csum0(x):
        s = torch.cumsum(x, dim=0)
        return torch.cat([torch.zeros_like(s[:1]), s], dim=0)

    def pool_any0(x):
        s = csum0(x)
        return s[hi + 1] - s[lo]

    def pool_frac0(x):
        s = csum0(x)

        def lerp(i0, fr):
            i0 = torch.from_numpy(i0).long().to(dev)
            fr = torch.from_numpy(fr).to(dev).reshape((resolution,) + (1,) * (x.dim() - 1))
            return s[i0] * (1.0 - fr) + s[i0 + 1] * fr

        return lerp(bd.b_i, bd.b_fr) - lerp(bd.a_i, bd.a_fr)

    m = occ.to(torch.int32)
    o = occ.to(torch.float32) if with_overlap else None
    for _ in range(occ.dim()):
        m = torch.movedim(pool_any0(m), 0, -1)
        if with_overlap:
            o = torch.movedim(pool_frac0(o), 0, -1)
    return (m > 0).reshape(-1), (o.reshape(-1) if with_overlap else None)


def footprint_grids(occ: torch.Tensor, resolution: int, with_overlap: bool = False,
                    mask_out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-corner footprint grids of one level over an occupancy grid.

    occ: bool [Rb]*D (D = 2 or 3).  Returns (mask [R**D] bool, whether any
    occupied cell lies in the corner's +-1-cell footprint box; ovl [R**3]
    float32, the occupied volume inside that box in cell units, or None),
    both flat with the last axis fastest.  `mask_out`, when given, is the
    flat bool buffer the mask is written into (and returned).  CPU tensors
    take the plain twin, CUDA tensors the kernel of csrc/footprint.cu.
    """
    mask, ovl = _footprint_plain(occ, resolution, with_overlap)
    if mask_out is not None:
        mask = mask_out.copy_(mask)
    return mask, ovl


# ------------------------------------------------------------------ K10
def coords_2d(ids: torch.Tensor, tile: int, rb: int):
    """Block-lattice coords: point j of block (bi,bj) at offsets (oi,oj)
    (fetch_2D_batches, utils_bpp_acc.py:443-448).  Returns (x, y, block)."""
    per_block = (tile + 2) ** 2
    blk = ids // per_block
    off = ids % per_block
    bi, bj = blk // rb, blk % rb
    oi, oj = off // (tile + 2), off % (tile + 2)
    return bi * tile + oi, bj * tile + oj, blk


def _vertex_keys_plain(v, d, r, size, tile, rb, perm, device):
    ids = torch.arange(v, dtype=torch.int64, device=device)
    if d == 3:
        coords = torch.stack([ids // (r * r), (ids // r) % r, ids % r], dim=-1)
    else:
        x, y, _ = coords_2d(ids, tile, rb)
        coords = torch.stack([x, y], dim=-1)
    idx = hash_ops.grid_index(coords, r, size)
    if perm is not None:
        idx = perm.long()[idx]
    return idx.to(torch.int32)


def _entry_fill_plain(skey, loc, e_max, d, tile, rb, inv):
    v = skey.shape[0]
    dev = skey.device
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), skey[1:] != skey[:-1]])
    hc = torch.cumsum(head.to(torch.int32), 0, dtype=torch.int32)
    ords = hc - 1                                   # level-local entry ordinal
    starts = torch.arange(v, dtype=torch.int32, device=dev)
    # slots e_max + 1 (cum) and e_max (values) are drop slots
    cum = torch.full((e_max + 2,), v, dtype=torch.int32, device=dev)
    cum[torch.where(head, ords, e_max + 1).long()] = starts
    values = torch.zeros(e_max + 1, dtype=torch.int32, device=dev)
    values[torch.where(head, ords, e_max).long()] = skey
    values = values[:e_max]
    if inv is not None:
        values = inv[values.long()]
    out = {"cum": cum[:e_max + 1], "entry_values": values, "vert_entry": ords,
           "n_entries": hc[-1] if v else torch.zeros((), dtype=torch.int32, device=dev)}
    if d == 3:
        out["pos_flat"] = loc.to(torch.int32)
    else:
        x, y, blk = coords_2d(loc, tile, rb)
        out["coords"] = ((x << 16) | y).to(torch.int32)
        out["block_id"] = blk.to(torch.int32)
    return out


def _level_tables_plain(v, d, r, size, e_max, device, tile, rb, perm, inv):
    keys = _vertex_keys_plain(v, d, r, size, tile, rb, perm, device)
    skey, loc = torch.sort(keys, stable=True)
    out = _entry_fill_plain(skey, loc, e_max, d, tile, rb, inv)
    counts = torch.bincount(keys.long(), minlength=1) if v else keys
    out["longest"] = int(counts.max()) if v else 0
    return out


def level_tables(v: int, d: int, r: int, size: int, e_max: int, device, tile: int = 0,
                 rb: int = 0, perm: Optional[torch.Tensor] = None,
                 inv: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The tables of one hashed level (K10): its v vertices (the 3D raster
    with the last axis fastest, or the 2D block lattice) sorted stably by
    their keys (`grid_index`, then `perm[entry]` when an entry permutation
    is given).  Returns int32 tensors: cum [e_max + 1] (each entry's first
    sorted slot, v past the exact entry count), entry_values [e_max] (each
    entry's key through `inv`, the inverse of `perm`; the key 0 through it
    past the count), vert_entry [v] (each slot's entry ordinal), n_entries
    (0-dim), and pos_flat [v] in 3D or coords [v] ((x << 16) | y) and
    block_id [v] in 2D; and `longest`, the most vertices of one entry (an
    int).  Within one entry the vertices stay in ascending vertex id.

    On the CPU the plain twin: the keys, a stable torch.sort, the fill
    (`_level_tables_plain`).  On a CUDA device the counting sort of
    csrc/vertex_tables.cu (count, scan, place, order; no sort), with one
    host read of n_entries and the longest segment, and two more launches
    and the merge passes where a segment exceeds the kernel's cap.
    """
    device = torch.device(device)
    if v > 0x7fffffff:
        raise ValueError("vertex_tables: vertex ids are int32")
    return _level_tables_plain(v, d, r, size, e_max, device, tile, rb, perm, inv)


def _dense_level_plain(perm, r):
    v = r ** 3
    dev = perm.device
    ids = torch.arange(v, dtype=torch.int64, device=dev)
    coords = torch.stack([ids // (r * r), (ids // r) % r, ids % r], dim=-1)
    idx = hash_ops.grid_index(coords, r, v)          # a bijection onto [0, V)
    inv = torch.zeros(v, dtype=torch.int32, device=dev)
    inv[idx] = ids.to(torch.int32)
    return {"pos_flat": inv[perm.long()], "vert_entry": ids.to(torch.int32),
            "entry_values": perm.clone(), "cum": torch.arange(v + 1, dtype=torch.int32, device=dev)}


def dense_level(perm: torch.Tensor, r: int) -> Dict[str, torch.Tensor]:
    """Tables of a dense 3D level (r**3 vertices, one entry each) in the
    shuffled entry order `perm` (int32 [r**3], entry e holds table index
    perm[e]): pos_flat, vert_entry, entry_values [r**3] and cum [r**3 + 1].
    CPU tensors take the plain twin, CUDA tensors the kernel."""
    return _dense_level_plain(perm.contiguous(), r)
