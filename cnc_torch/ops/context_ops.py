"""The rate estimate's kernels: context pooling (K6m, one call site's pooled
mean in one launch, and K6, segment_gather's backward), the sign histogram (K7),
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

from .. import kernels
from . import hash_ops, scatter_ops


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


def _check_segment_args(name, x, seg, valid):
    kernels.require_cuda(name, x, seg, valid)
    if x.dtype != torch.float32 or seg.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"{name}: the kernel takes float32 rows, int32 ids and a bool mask")
    if x.dim() != 1:
        raise ValueError(f"{name}: the kernel takes one float a row, got {tuple(x.shape)}")


def _segment_pool_cuda(x, seg, valid, num_segments):
    """K6: out[seg[i]] += x[i] over the live rows, x [N]."""
    _check_segment_args("segment_pool", x, seg, valid)
    out = torch.zeros(num_segments, dtype=torch.float32, device=x.device)
    kernels.call("cnc_segment_pool", kernels.ptr(x), kernels.ptr(seg), kernels.ptr(valid),
                 kernels.ptr(out), x.shape[0], num_segments)
    kernels.launches["segment_pool"] += 1
    return out


def _segment_pool_backward_cuda(g, seg, valid):
    """K6's gather: d_x[i] = g[seg[i]] on the live rows, else 0; g [S]."""
    _check_segment_args("segment_pool_bwd", g, seg, valid)
    d_x = torch.empty(seg.shape, dtype=torch.float32, device=g.device)
    kernels.call("cnc_segment_pool_backward", kernels.ptr(g), kernels.ptr(seg),
                 kernels.ptr(valid), kernels.ptr(d_x), seg.shape[0], g.shape[0])
    kernels.launches["segment_pool_bwd"] += 1
    return d_x


def _segment_gather_plain(values, seg, valid):
    live = _live_rows(seg, valid, values.shape[0])
    out = values.index_select(0, torch.where(live, seg.long(), 0))
    return torch.where(live if values.dim() == 1 else live[:, None], out, 0.0)


class _SegmentGatherCuda(torch.autograd.Function):
    """K6's pair: the forward gathers each row's segment value, the backward
    is K6 (the per-segment sums of the row gradients)."""

    @staticmethod
    def forward(ctx, values, seg, valid):
        ctx.save_for_backward(seg, valid)
        ctx.num_segments = values.shape[0]
        return _segment_pool_backward_cuda(values, seg, valid)

    @staticmethod
    def backward(ctx, g):
        seg, valid = ctx.saved_tensors
        return _segment_pool_cuda(g.contiguous(), seg, valid, ctx.num_segments), None, None


def segment_gather(values: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """out[i] = values[seg[i]] where `valid` (and the id lies in range), else
    0: each row's segment value.

    values [S] float32 ([S, F] on the CPU); seg [N] integers in runs; valid
    [N] bool.
    `values` gets the per-segment sums of the row gradients, through K6's
    warp-aggregated adds (a plain gather's backward would queue every row of
    a segment on one address).  CPU tensors take the plain twin.
    """
    if values.is_cuda:
        return _SegmentGatherCuda.apply(values.contiguous(), seg.to(torch.int32).contiguous(),
                                        valid.contiguous())
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


class _SegmentMeanWork:
    """Per device and stream: the kernel's block records (as many as its
    largest grid needs) and its finish counter (the kernel leaves it 0).
    The launches that share them, being on one stream, run one at a time."""

    def __init__(self, device):
        words = kernels.lib().cnc_segment_mean_scratch(1 << 62, 4)
        self.scratch = torch.empty(words, dtype=torch.int32, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)


_mean_work: Dict[Tuple[torch.device, int], _SegmentMeanWork] = {}
# per device: the word every segment_mean launch there sets when live ids
# decrease (set only, so launches on any stream may share it)
_fault_words: Dict[torch.device, torch.Tensor] = {}


def _cuda_device(device) -> torch.device:
    key = torch.device(device)
    return key if key.index is not None else torch.device(key.type, torch.cuda.current_device())


def _segment_mean_work(device) -> _SegmentMeanWork:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    work = _mean_work.get(key)
    if work is None:
        work = _mean_work[key] = _SegmentMeanWork(device)
    return work


def _fault_word(device) -> torch.Tensor:
    device = _cuda_device(device)
    word = _fault_words.get(device)
    if word is None:
        word = _fault_words[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return word


def segment_order_faults(device) -> int:
    """1 if a segment_mean launch on the CUDA `device` met live ids that
    decrease since the last `clear_segment_order_faults`, else 0 (one host
    sync, on the current stream)."""
    return int(_fault_word(device)[0])


def clear_segment_order_faults(device) -> None:
    _fault_word(device).zero_()


def _check_mean_args(x, den, seg, valid):
    kernels.require_cuda("segment_mean", x, den, seg, valid)
    if (x.dtype != torch.float32 or den.dtype != torch.float32 or seg.dtype != torch.int32
            or valid.dtype != torch.bool):
        raise ValueError("segment_mean: the kernel takes float32 rows and den, int32 ids and a"
                         " bool mask")
    if x.shape[1] not in (1, 2, 4):
        raise ValueError(f"segment_mean: the kernel takes rows of 1, 2 or 4 floats, got"
                         f" {x.shape[1]}")


def _segment_mean_cuda(x, den, seg, valid, num_segments, min_den, weighted):
    """(pooled, covered, den_sum) through K6m, one launch."""
    _check_mean_args(x, den, seg, valid)
    n, f = x.shape
    work = _segment_mean_work(x.device)
    fault = _fault_word(x.device)
    pooled = torch.empty(num_segments, f, dtype=torch.float32, device=x.device)
    covered = torch.empty(num_segments, dtype=torch.bool, device=x.device)
    den_sum = torch.empty(num_segments, dtype=torch.float32, device=x.device)
    p = kernels.ptr
    kernels.call("cnc_segment_mean", p(x), p(den), p(seg), p(valid), n, f, num_segments,
                 min_den, int(weighted), p(pooled), p(covered), p(den_sum), p(work.scratch),
                 p(work.counter), p(fault))
    kernels.launches["segment_mean"] += 1
    return pooled, covered, den_sum


def _segment_mean_backward_cuda(g, den, seg, valid, den_sum, min_den, weighted):
    _check_mean_args(g, den_sum, seg, valid)
    d_x = torch.empty(seg.shape[0], g.shape[1], dtype=torch.float32, device=g.device)
    p = kernels.ptr
    kernels.call("cnc_segment_mean_backward", p(g), p(den), p(seg), p(valid), p(den_sum),
                 seg.shape[0], g.shape[1], g.shape[0], min_den, int(weighted), p(d_x))
    kernels.launches["segment_mean_bwd"] += 1
    return d_x


class _SegmentMeanCuda(torch.autograd.Function):
    """K6m forward; its backward kernel scales each live row's segment
    gradient by w_i / max(D_s, min_den)."""

    @staticmethod
    def forward(ctx, x, den, seg, valid, num_segments, min_den, weighted):
        pooled, covered, den_sum = _segment_mean_cuda(x, den, seg, valid, num_segments, min_den,
                                                      weighted)
        ctx.save_for_backward(den, seg, valid, den_sum)
        ctx.min_den, ctx.weighted = min_den, weighted
        ctx.mark_non_differentiable(covered)
        return pooled, covered

    @staticmethod
    def backward(ctx, g, _):
        den, seg, valid, den_sum = ctx.saved_tensors
        d_x = _segment_mean_backward_cuda(g.contiguous(), den, seg, valid, den_sum, ctx.min_den,
                                          ctx.weighted)
        return d_x, None, None, None, None, None, None


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
    if x.is_cuda:
        return _SegmentMeanCuda.apply(x.contiguous(), den.contiguous(),
                                      seg.to(torch.int32).contiguous(), valid.contiguous(),
                                      num_segments, min_den, bool(weighted))
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


def _check_pn_args(name, table, sel, row_valid, bnd):
    kernels.require_cuda(name, table, sel, row_valid, bnd)
    if (table.dtype != torch.float32 or sel.dtype != torch.int32 or bnd.dtype != torch.int32
            or row_valid.dtype != torch.bool):
        raise ValueError(f"{name}: the kernel takes a float32 table, int32 sel and bnd and a "
                         "bool row mask")
    f = table.shape[1]
    if f not in (2, 4) or table.data_ptr() % (4 * f):
        raise ValueError(f"{name}: the kernel takes {4 * f}-byte aligned rows of 2 or 4 floats")
    if row_valid.shape != sel.shape or bnd.dim() != 1 or bnd.shape[0] < 1:
        raise ValueError(f"{name}: sel and row_valid must be [rows], bnd [bins + 1]")
    return f


def _pn_hist_cuda(table, fine_offset, sel, row_valid, bnd):
    f = _check_pn_args("pn_hist", table, sel, row_valid, bnd)
    n_bins = bnd.shape[0] - 1
    pos = torch.empty(n_bins, f, dtype=torch.float32, device=table.device)
    kernels.call("cnc_pn_hist", kernels.ptr(table), fine_offset, table.shape[0], kernels.ptr(sel),
                 kernels.ptr(row_valid), kernels.ptr(bnd), kernels.ptr(pos), n_bins, sel.shape[0],
                 f)
    kernels.launches["pn_hist"] += 1
    return pos


def _pn_hist_backward_cuda(table, fine_offset, sel, row_valid, bnd, g):
    f = _check_pn_args("pn_hist_bwd", table, sel, row_valid, bnd)
    kernels.require_cuda("pn_hist_bwd", g)
    d_table = torch.zeros_like(table)
    kernels.call("cnc_pn_hist_backward", kernels.ptr(table), fine_offset, table.shape[0],
                 kernels.ptr(sel), kernels.ptr(row_valid), kernels.ptr(bnd), kernels.ptr(g),
                 kernels.ptr(d_table), bnd.shape[0] - 1, sel.shape[0], f)
    kernels.launches["pn_hist_bwd"] += 1
    return d_table


class _PnHistCuda(torch.autograd.Function):
    """K7 forward; the backward kernel is the indicator's straight-through
    rule scattered into the table."""

    @staticmethod
    def forward(ctx, table, fine_offset, sel, row_valid, bnd):
        ctx.save_for_backward(table, sel, row_valid, bnd)
        ctx.fine_offset = fine_offset
        return _pn_hist_cuda(table, fine_offset, sel, row_valid, bnd)

    @staticmethod
    def backward(ctx, g):
        table, sel, row_valid, bnd = ctx.saved_tensors
        return (_pn_hist_backward_cuda(table, ctx.fine_offset, sel, row_valid, bnd,
                                       g.contiguous()), None, None, None, None)


def pn_hist(table: torch.Tensor, fine_offset: int, sel: torch.Tensor, row_valid: torch.Tensor,
            bnd: torch.Tensor) -> torch.Tensor:
    """Per-bin counts of positive entries: pos[b, f] is the number of rows r
    in [bnd[b], bnd[b+1]) with row_valid[r] and
    table[fine_offset + sel[r], f] > 0.9.

    table [T, F] float32; sel [rows] entry indices of the finest level;
    row_valid [rows] bool; bnd [bins + 1] ascending row positions.  Returns
    [bins, F] float32.  `table` gets the straight-through gradient of the
    indicator.  CPU tensors take the plain twin, CUDA tensors the kernels of
    csrc/pn_hist.cu.
    """
    if table.is_cuda:
        return _PnHistCuda.apply(table.contiguous(), int(fine_offset),
                                 sel.to(torch.int32).contiguous(), row_valid.contiguous(),
                                 bnd.to(torch.int32).contiguous())
    return _pn_hist_plain(table, fine_offset, sel, row_valid, bnd)


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


@functools.lru_cache(maxsize=None)
def _bounds_on_device(resolution: int, rb: int, device: str):
    bd = footprint_bounds(resolution, rb)
    if not (np.all(bd.lo >= 0) and np.all(bd.lo <= bd.hi) and np.all(bd.hi < rb)):
        raise ValueError("footprint: bounds fall outside the occupancy grid")
    ints = torch.from_numpy(np.stack([bd.lo, bd.hi, bd.a_i, bd.b_i])).to(device)
    floats = torch.from_numpy(np.stack([bd.a_fr, bd.b_fr])).to(device)
    return ints.contiguous(), floats.contiguous()


def _footprint_cuda(occ, resolution, with_overlap, mask_out=None):
    d, rb = occ.dim(), occ.shape[0]
    n = resolution ** d
    if mask_out is None:
        mask_out = torch.empty(n, dtype=torch.bool, device=occ.device)
    kernels.require_cuda("footprint", occ, mask_out)
    if (occ.dtype != torch.bool or d not in (2, 3) or occ.shape != (rb,) * d
            or mask_out.dtype != torch.bool or mask_out.shape != (n,)):
        raise ValueError("footprint: the kernel takes a cubic (or square) bool grid and a flat "
                         "bool output of resolution**D")
    if with_overlap and d != 3:
        raise ValueError("footprint: the overlap volume is computed in 3D only")
    ints, floats = _bounds_on_device(resolution, rb, str(occ.device))
    ovl = torch.empty(n, dtype=torch.float32, device=occ.device) if with_overlap else None
    kernels.call("cnc_footprint", kernels.ptr(occ), rb, d, resolution, kernels.ptr(ints),
                 kernels.ptr(floats), kernels.ptr(mask_out), kernels.ptr(ovl))
    kernels.launches["footprint"] += 1
    return mask_out, ovl


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
    if occ.is_cuda:
        return _footprint_cuda(occ.contiguous(), resolution, with_overlap, mask_out)
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


def _vertex_keys_cuda(v, d, r, size, tile, rb, perm, device):
    kernels.require_cuda("vertex_keys", perm)
    if perm is not None and (perm.dtype != torch.int32 or perm.shape != (size,)):
        raise ValueError("vertex_keys: perm must be int32 [size]")
    keys = torch.empty(v, dtype=torch.int32, device=device)
    kernels.call("cnc_vertex_keys", kernels.ptr(keys), v, d, r, size, tile, rb, kernels.ptr(perm))
    kernels.launches["vertex_tables"] += 1
    return keys


def vertex_keys(v: int, d: int, r: int, size: int, device, tile: int = 0, rb: int = 0,
                perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sort keys of one level's vertices: vertex id -> lattice coords (the 3D
    raster with the last axis fastest, or the 2D block lattice) -> table
    entry (`grid_index`) -> `perm[entry]` when an entry permutation is given.
    Returns int32 [v] on `device`; the plain twin on the CPU, the kernel of
    csrc/vertex_tables.cu on a CUDA device."""
    device = torch.device(device)
    fn = _vertex_keys_cuda if device.type == "cuda" else _vertex_keys_plain
    return fn(v, d, r, size, tile, rb, perm, device)


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
    out = {"cum": cum[:e_max + 1], "entry_values": values, "vert_entry": ords, "n_entries": hc[-1]}
    if d == 3:
        out["pos_flat"] = loc.to(torch.int32)
    else:
        x, y, blk = coords_2d(loc, tile, rb)
        out["coords"] = ((x << 16) | y).to(torch.int32)
        out["block_id"] = blk.to(torch.int32)
    return out


def _entry_fill_cuda(skey, loc, e_max, d, tile, rb, inv):
    kernels.require_cuda("vertex_fill", skey, loc, inv)
    v = skey.shape[0]
    if skey.dtype != torch.int32 or loc.dtype != torch.int64 or loc.shape != (v,) or \
            (inv is not None and inv.dtype != torch.int32):
        raise ValueError("vertex_fill: the kernel takes int32 keys, int64 sort indices and an "
                         "int32 inverse permutation")
    dev = skey.device
    head = torch.empty(v, dtype=torch.bool, device=dev)
    kernels.call("cnc_vertex_heads", kernels.ptr(skey), v, kernels.ptr(head))
    kernels.launches["vertex_tables"] += 1
    # the heads' positions in ascending order are cum[0 .. n_entries)
    heads, n_entries = scatter_ops.compact_mask_indices(head, e_max + 1)
    del head
    new = lambda n: torch.empty(n, dtype=torch.int32, device=dev)
    cum, values, vert_entry, pos = new(e_max + 1), new(e_max), new(v), new(v)
    block_id = new(v) if d == 2 else None
    kernels.call("cnc_vertex_fill", kernels.ptr(skey), kernels.ptr(loc), kernels.ptr(heads),
                 kernels.ptr(n_entries), v, e_max, d, tile, rb, kernels.ptr(inv), kernels.ptr(cum),
                 kernels.ptr(values), kernels.ptr(vert_entry), kernels.ptr(pos),
                 kernels.ptr(block_id))
    kernels.launches["vertex_tables"] += 1
    out = {"cum": cum, "entry_values": values, "vert_entry": vert_entry, "n_entries": n_entries}
    if d == 3:
        out["pos_flat"] = pos
    else:
        out["coords"], out["block_id"] = pos, block_id
    return out


def entry_fill(skey: torch.Tensor, loc: torch.Tensor, e_max: int, d: int, tile: int = 0,
               rb: int = 0, inv: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One level's tables from its stably sorted keys.

    skey [V] int32 ascending, loc [V] int64 the vertex id of each sorted slot
    (the sort's indices), e_max the padded entry capacity, inv the inverse of
    the entry permutation behind the keys (or None).  Returns int32 tensors:
    cum [e_max + 1] (first sorted slot of each entry, V past the exact entry
    count), entry_values [e_max] (each entry's table index, 0 past the count
    before `inv` is applied), vert_entry [V] (each slot's entry ordinal),
    n_entries (0-dim), and pos_flat [V] in 3D or coords [V] ((x << 16) | y)
    and block_id [V] in 2D.  CPU tensors take the plain twin, CUDA tensors
    the kernels of csrc/vertex_tables.cu (and the compaction kernel).
    """
    fn = _entry_fill_cuda if skey.is_cuda else _entry_fill_plain
    return fn(skey.contiguous(), loc.contiguous(), e_max, d, tile, rb, inv)


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


def _dense_level_cuda(perm, r):
    kernels.require_cuda("dense_level", perm)
    v = r ** 3
    if perm.dtype != torch.int32 or perm.shape != (v,):
        raise ValueError("dense_level: perm must be int32 [r**3]")
    new = lambda n: torch.empty(n, dtype=torch.int32, device=perm.device)
    out = {"pos_flat": new(v), "vert_entry": new(v), "entry_values": new(v), "cum": new(v + 1)}
    kernels.call("cnc_dense_level", kernels.ptr(perm), v, r, kernels.ptr(out["pos_flat"]),
                 kernels.ptr(out["vert_entry"]), kernels.ptr(out["entry_values"]),
                 kernels.ptr(out["cum"]))
    kernels.launches["vertex_tables"] += 1
    return out


def dense_level(perm: torch.Tensor, r: int) -> Dict[str, torch.Tensor]:
    """Tables of a dense 3D level (r**3 vertices, one entry each) in the
    shuffled entry order `perm` (int32 [r**3], entry e holds table index
    perm[e]): pos_flat, vert_entry, entry_values [r**3] and cum [r**3 + 1].
    CPU tensors take the plain twin, CUDA tensors the kernel."""
    fn = _dense_level_cuda if perm.is_cuda else _dense_level_plain
    return fn(perm.contiguous(), r)
