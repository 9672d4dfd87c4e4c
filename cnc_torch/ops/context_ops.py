"""The rate estimate's kernels: context pooling (K6m, one call site's pooled
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

from .. import kernels
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


def pn_row_count(entry_idx: torch.Tensor, sample_cap: Optional[int]) -> int:
    """The size of a frac plane's row space: the sample's capacity in the
    sampled mode, the list's otherwise (the rows a data-parallel step splits)."""
    cap = entry_idx.shape[0]
    return int(sample_cap) if sample_cap is not None and sample_cap < cap else cap


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


def _pn_part_plain(table, fine_offset, entry_idx, bounds, n, sample_cap, lo, size):
    """K7p's twin: (the rows [lo, lo + size)'s per-bin positive counts [bins,
    F], the bins' divisors f32(count) + 1e-6 [bins] over the whole row space)."""
    sel, row_valid, bnd = _pn_rows(entry_idx, bounds, n, sample_cap, lo, size)
    part = _pn_hist_plain(table, fine_offset, sel, row_valid, bnd)
    whole = _pn_rows(entry_idx, bounds, n, sample_cap)[2]
    return part, (whole[1:] - whole[:-1]).to(torch.float32) + 1e-6


def pn_frac_finish(pos: torch.Tensor, den: torch.Tensor, pn_res: int) -> torch.Tensor:
    """The plane from the summed per-bin counts pos [bins, F] and the bins'
    divisors den [bins]: frac = pos / den, the zero border ring and the
    x-fastest [pn_res**2, F] layout (elementwise, as K7 finishes its plane)."""
    scale, f = pn_res - 2, pos.shape[1]
    plane = nn_functional.pad((pos / den[:, None]).reshape(scale, scale, f), (0, 0, 1, 1, 1, 1))
    return plane.transpose(0, 1).reshape(-1, f)


def pn_hist_backward_plain(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap, g):
    """K7b's plain twin in its kernel's arguments: the gradient g [pn_res**2,
    F] of the frac plane into d_table [T, F].  Each valid row j of bin b =
    x * (pn_res - 2) + y (map[b] <= j < map[b+1], the rows and map of
    `_pn_rows`) adds, where its entry's value is > 0.9, its bin's scale
    g[(y + 1) * pn_res + x + 1] / (f32(map[b+1] - map[b]) + 1e-6) into its
    entry's row; in g's dtype."""
    sel, row_valid, bnd = _pn_rows(entry_idx, bounds, n, sample_cap)
    scale, dev = pn_res - 2, table.device
    b = torch.arange(scale * scale, device=dev)
    cnt = (bnd[1:] - bnd[:-1]).to(g.dtype)
    bin_scale = g[(b % scale + 1) * pn_res + b // scale + 1] / (cnt + 1e-6)[:, None]
    j = torch.arange(sel.shape[0], dtype=torch.int32, device=dev)
    bin_of = torch.searchsorted(bnd, j, right=True).long() - 1   # the last b with map[b] <= j
    inside = row_valid & (bin_of >= 0) & (bin_of < scale * scale)
    rows = fine_offset + sel.long()
    on = inside[:, None] & (table[rows] > 0.9)
    add = torch.where(on, bin_scale[bin_of.clamp(0, scale * scale - 1)], 0.0)
    return torch.zeros(table.shape, dtype=g.dtype, device=dev).index_add_(0, rows, add)


def _check_plane_args(name, table, entry_idx, bounds, n, pn_res):
    kernels.require_cuda(name, table, entry_idx, bounds, n)
    if (table.dtype != torch.float32 or entry_idx.dtype != torch.int32
            or bounds.dtype != torch.int32 or n.dtype != torch.int32 or n.numel() != 1):
        raise ValueError(f"{name}: the kernel takes a float32 table, int32 entry_idx and "
                         "bounds and a one-element int32 count")
    f = table.shape[1]
    if f not in (2, 4) or table.data_ptr() % (4 * f):
        raise ValueError(f"{name}: the kernel takes {4 * f}-byte aligned rows of 2 or 4 floats")
    if (pn_res < 3 or entry_idx.dim() != 1 or entry_idx.numel() < 1
            or bounds.shape != ((pn_res - 2) ** 2 + 1,)):
        raise ValueError(f"{name}: entry_idx must be [cap], cap >= 1, bounds "
                         "[(pn_res - 2)**2 + 1]")
    return f


def _sample_arg(name, entry_idx, sample_cap):
    """The kernels' sample_cap: 0 for the unsampled mode."""
    if sample_cap is None or sample_cap >= entry_idx.shape[0]:
        return 0
    if sample_cap < 1:
        raise ValueError(f"{name}: sample_cap must be positive")
    return int(sample_cap)


def _pn_frac_plane_cuda(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap=None):
    """K7: the whole plane in one launch, one allocation."""
    f = _check_plane_args("pn_frac_plane", table, entry_idx, bounds, n, pn_res)
    sample = _sample_arg("pn_frac_plane", entry_idx, sample_cap)
    plane = torch.empty(pn_res * pn_res, f, dtype=torch.float32, device=table.device)
    kernels.call("cnc_pn_frac_plane", kernels.ptr(table), fine_offset, table.shape[0],
                 kernels.ptr(entry_idx), kernels.ptr(bounds), kernels.ptr(n),
                 entry_idx.shape[0], sample, pn_res, f, kernels.ptr(plane))
    kernels.launches["pn_frac_plane"] += 1
    return plane


def _pn_hist_backward_launch(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap, g,
                             d_table):
    """K7b alone: adds the plane's gradient g [pn_res**2, F] into d_table."""
    f = _check_plane_args("pn_hist_bwd", table, entry_idx, bounds, n, pn_res)
    sample = _sample_arg("pn_hist_bwd", entry_idx, sample_cap)
    kernels.require_cuda("pn_hist_bwd", table, g, d_table)
    if (g.dtype != torch.float32 or g.shape != (pn_res * pn_res, f) or g.data_ptr() % (4 * f)
            or d_table.dtype != torch.float32 or d_table.shape != table.shape
            or d_table.data_ptr() % (4 * f)):
        raise ValueError(f"pn_hist_bwd: g [pn_res**2, {f}] and d_table shaped as the table, "
                         f"float32 with {4 * f}-byte aligned rows")
    kernels.call("cnc_pn_hist_backward", kernels.ptr(table), fine_offset, table.shape[0],
                 kernels.ptr(entry_idx), kernels.ptr(bounds), kernels.ptr(n),
                 entry_idx.shape[0], sample, pn_res, f, kernels.ptr(g), kernels.ptr(d_table))
    kernels.launches["pn_hist_bwd"] += 1


def _pn_hist_backward_cuda(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap, g):
    """K7b: the zero fill of d_table and one launch."""
    d_table = torch.zeros_like(table)
    _pn_hist_backward_launch(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap, g,
                             d_table)
    return d_table


class _PnFracPlaneCuda(torch.autograd.Function):
    """K7 forward; the backward (taken only with pn_frac_grad) is K7b on the
    forward's own inputs: the fill of d_table and one launch."""

    @staticmethod
    def forward(ctx, table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap):
        ctx.save_for_backward(table, entry_idx, bounds, n)
        ctx.args = (fine_offset, pn_res, sample_cap)
        return _pn_frac_plane_cuda(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap)

    @staticmethod
    def backward(ctx, g):
        table, entry_idx, bounds, n = ctx.saved_tensors
        fine_offset, pn_res, sample_cap = ctx.args
        d_table = _pn_hist_backward_cuda(table, fine_offset, entry_idx, bounds, n, pn_res,
                                         sample_cap, g.contiguous())
        return d_table, None, None, None, None, None, None


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
    if table.is_cuda:
        return _PnFracPlaneCuda.apply(table.contiguous(), int(fine_offset), entry_idx, bounds, n,
                                      int(pn_res), sample_cap)
    return _pn_frac_plane_plain(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap)


def _check_range(name, lo, size):
    if lo < 0 or size < 0 or lo + size >= 1 << 31:
        raise ValueError(f"{name}: the row range [{lo}, {lo + size}) must lie in [0, 2^31)")


def _pn_part_cuda(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap, lo, size):
    """K7p: one launch, the partial and the divisors."""
    f = _check_plane_args("pn_hist_part", table, entry_idx, bounds, n, pn_res)
    sample = _sample_arg("pn_hist_part", entry_idx, sample_cap)
    _check_range("pn_hist_part", lo, size)
    bins = (pn_res - 2) ** 2
    part = torch.empty(bins, f, dtype=torch.float32, device=table.device)
    den = torch.empty(bins, dtype=torch.float32, device=table.device)
    kernels.call("cnc_pn_hist_part", kernels.ptr(table), fine_offset, table.shape[0],
                 kernels.ptr(entry_idx), kernels.ptr(bounds), kernels.ptr(n),
                 entry_idx.shape[0], sample, pn_res, f, lo, size, kernels.ptr(part),
                 kernels.ptr(den))
    kernels.launches["pn_hist_part"] += 1
    return part, den


def _pn_part_backward_launch(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap, lo,
                             size, g_part, d_table):
    """K7pb alone: adds the partial's gradient g_part [bins, F] into d_table."""
    f = _check_plane_args("pn_hist_part_bwd", table, entry_idx, bounds, n, pn_res)
    sample = _sample_arg("pn_hist_part_bwd", entry_idx, sample_cap)
    _check_range("pn_hist_part_bwd", lo, size)
    kernels.require_cuda("pn_hist_part_bwd", table, g_part, d_table)
    if (g_part.dtype != torch.float32 or g_part.shape != ((pn_res - 2) ** 2, f)
            or g_part.data_ptr() % (4 * f) or d_table.dtype != torch.float32
            or d_table.shape != table.shape or d_table.data_ptr() % (4 * f)):
        raise ValueError(f"pn_hist_part_bwd: g_part [(pn_res - 2)**2, {f}] and d_table shaped "
                         f"as the table, float32 with {4 * f}-byte aligned rows")
    kernels.call("cnc_pn_hist_part_backward", kernels.ptr(table), fine_offset, table.shape[0],
                 kernels.ptr(entry_idx), kernels.ptr(bounds), kernels.ptr(n),
                 entry_idx.shape[0], sample, pn_res, f, lo, size, kernels.ptr(g_part),
                 kernels.ptr(d_table))
    kernels.launches["pn_hist_part_bwd"] += 1


class _PnPartCuda(torch.autograd.Function):
    """K7p forward; the backward (only with pn_frac_grad) is K7pb on the
    forward's own inputs: the fill of d_table and one launch."""

    @staticmethod
    def forward(ctx, table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap, lo, size):
        ctx.save_for_backward(table, entry_idx, bounds, n)
        ctx.args = (fine_offset, pn_res, sample_cap, lo, size)
        part, den = _pn_part_cuda(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap,
                                  lo, size)
        ctx.mark_non_differentiable(den)
        return part, den

    @staticmethod
    def backward(ctx, g_part, _):
        table, entry_idx, bounds, n = ctx.saved_tensors
        fine_offset, pn_res, sample_cap, lo, size = ctx.args
        d_table = torch.zeros_like(table)
        _pn_part_backward_launch(table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap, lo,
                                 size, g_part.contiguous(), d_table)
        return d_table, None, None, None, None, None, None, None, None


def pn_hist_part(table: torch.Tensor, fine_offset: int, entry_idx: torch.Tensor,
                 bounds: torch.Tensor, n: torch.Tensor, pn_res: int, sample_cap: Optional[int],
                 lo: int, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's share of a frac plane: the positive counts of the rows
    [lo, lo + size) of the plane's row space (`pn_row_count`) per bin,
    [bins, F] float32 in bin order, and the bins' divisors [bins] over the
    whole space.  The ranks' partials summed and `pn_frac_finish`ed equal
    `pn_frac_plane` exactly (integer counts below 2^24).  The arguments are
    `pn_frac_plane`'s; `table` gets the straight-through gradient of the
    indicator through the partial.  CPU tensors take the plain twin, CUDA
    tensors K7p (one launch; with a gradient, K7pb's fill and one launch)."""
    if table.is_cuda:
        return _PnPartCuda.apply(table.contiguous(), int(fine_offset), entry_idx, bounds, n,
                                 int(pn_res), sample_cap, int(lo), int(size))
    return _pn_part_plain(table, fine_offset, entry_idx, bounds, n, sample_cap, lo, size)


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
    """The kernel's per-coordinate table, [R, 8] int32: lo, hi, a_fr, b_fr
    (f32 bit patterns), then for a corner's last coordinate lo, hi and the
    f32 weights of cells lo and hi (the cells between weigh 1); and the
    largest span hi - lo + 1.  The kernel weighs cells lo and hi by the
    continuous ends, so it needs them to fall there."""
    bd = footprint_bounds(resolution, rb)
    if not (np.all(bd.lo >= 0) and np.all(bd.lo <= bd.hi) and np.all(bd.hi < rb)):
        raise ValueError("footprint: bounds fall outside the occupancy grid")
    if not (np.array_equal(bd.a_i, bd.lo) and np.array_equal(bd.b_i, bd.hi)):
        raise ValueError("footprint: the box's continuous ends fall outside cells lo and hi")
    w_lo = np.where(bd.lo < bd.hi, np.float32(1.0), bd.b_fr) - bd.a_fr   # float32, as the kernel
    w_hi = np.where(bd.hi > bd.lo, bd.b_fr, np.float32(0.0))
    table = np.stack([bd.lo, bd.hi, bd.a_fr.view(np.int32), bd.b_fr.view(np.int32), bd.lo,
                      bd.hi, w_lo.astype(np.float32).view(np.int32), w_hi.view(np.int32)],
                     axis=1)
    return (torch.from_numpy(np.ascontiguousarray(table)).to(device),
            int((bd.hi - bd.lo).max()) + 1)


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
    if rb % 16 or not 16 <= rb <= 512 or occ.data_ptr() % 16:
        raise ValueError("footprint: the kernel takes a 16-byte aligned occupancy grid of 16 to "
                         "512 cells a side, a multiple of 16")
    table, max_span = _bounds_on_device(resolution, rb, str(occ.device))
    ovl = torch.empty(n, dtype=torch.float32, device=occ.device) if with_overlap else None
    kernels.call("cnc_footprint", kernels.ptr(occ), rb, d, resolution, kernels.ptr(table),
                 max_span, kernels.ptr(mask_out), kernels.ptr(ovl))
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


def _level_tables_cuda(v, d, r, size, e_max, device, tile, rb, perm, inv):
    kernels.require_cuda("vertex_tables", perm, inv)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    for name, t in (("perm", perm), ("inv", inv)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (size,) or t.device != device):
            raise ValueError(f"vertex_tables: {name} must be int32 [size] on {device}")
    lib = kernels.lib()
    scratch = torch.zeros(lib.cnc_vertex_scratch_words(size), dtype=torch.int32, device=device)
    new = lambda n: torch.empty(n, dtype=torch.int32, device=device)
    cum, values, vert_entry, pos = new(e_max + 1), new(e_max), new(v), new(v)
    block_id = new(v) if d == 2 else None
    p = kernels.ptr
    kernels.call("cnc_vertex_tables", v, d, r, size, tile, rb, p(perm), p(inv), e_max,
                 p(scratch), p(cum), p(values), p(vert_entry), p(pos), p(block_id))
    kernels.launches["vertex_tables"] += 4      # count, scan, place, order
    # the build's one host read a level: n_entries and the longest segment
    n_entries, longest = (int(x) for x in scratch[1:3].cpu())
    cap = lib.cnc_vertex_segment_cap()
    if longest > cap:
        _long_segments(v, d, r, size, tile, rb, cum, n_entries, longest, cap, vert_entry, pos,
                       block_id)
    out = {"cum": cum, "entry_values": values, "vert_entry": vert_entry,
           "n_entries": scratch[1].clone(), "longest": longest}
    if d == 3:
        out["pos_flat"] = pos
    else:
        out["coords"], out["block_id"] = pos, block_id
    return out


def _long_segments(v, d, r, size, tile, rb, cum, n_entries, longest, cap, vert_entry, pos,
                   block_id):
    """The order of the segments above the kernel's shared-memory cap: the
    host lists them (and their tiles of `cap` ids), the kernels sort the
    tiles and merge them in passes of doubling width."""
    starts = cum[:n_entries].cpu().numpy().astype(np.int64)
    lens = np.append(starts[1:], v) - starts
    big = np.nonzero(lens > cap)[0]
    segs = np.stack([starts[big], lens[big], big], 1).astype(np.int32)
    first = np.concatenate([[0], np.cumsum(lens[big])]).astype(np.int32)
    tiles = np.array([(s + o, min(cap, n - o)) for s, n in zip(starts[big], lens[big])
                      for o in range(0, n, cap)], np.int32)
    passes = max(0, int(np.ceil(np.log2(longest / cap))))
    dev = cum.device
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    segs_d, first_d, tiles_d = on(segs), on(first), on(tiles)
    p = kernels.ptr
    kernels.call("cnc_vertex_long_segments", v, d, r, size, tile, rb, p(segs_d), p(first_d),
                 len(big), int(first[-1]), p(tiles_d), len(tiles), passes, p(vert_entry), p(pos),
                 p(block_id))
    kernels.launches["vertex_tables"] += 2 + passes


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
    fn = _level_tables_cuda if device.type == "cuda" else _level_tables_plain
    return fn(v, d, r, size, e_max, device, tile, rb, perm, inv)


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
