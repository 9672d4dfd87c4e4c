"""Table scatter-add, stream compaction (K3) and the grouped gather-interpolate
twin of K1/K2.

Port of `cnc_tpu/ops/scatter_ops.py`.  `scatter_add` and `lane_gather` are
also the counterparts of the two TPU probe kernels (tools/pallas_probe.py:
the serial scatter-add and the lane gather).  Each dispatches on the device
of its input: a CPU tensor takes the plain twin, a CUDA tensor the kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import kernels


def _scatter_add_plain(vals: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    # row `size` is a drop slot (cnc_tpu scatters with mode="drop")
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = torch.zeros(size + 1, vals.shape[1], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, vals)[:size]


def _scatter_add_cuda(vals: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """One launch (csrc/scatter_add.cu): a thread a row, its values added by
    float4, float2 or single-float atomics as `scatter_add_width` says."""
    kernels.require_cuda("scatter_add", vals, idx)
    if vals.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError("scatter_add: the kernel takes float32 values and int32 indices")
    n, f = vals.shape
    out = torch.zeros(size, f, dtype=torch.float32, device=vals.device)
    if n == 0 or f == 0:
        return out
    kernels.call("cnc_scatter_add", kernels.ptr(vals), kernels.ptr(idx), kernels.ptr(out), n, f,
                 size)
    kernels.launches["scatter_add"] += 1
    return out


def scatter_add_width(vals: torch.Tensor, out: torch.Tensor) -> int:
    """The vector width (4, 2 or 1 floats) of the kernel's atomics for these
    CUDA tensors: 4 where F % 4 == 0 and both start 16-byte aligned, else 2
    where F is even and both start 8-byte aligned."""
    return kernels.lib().cnc_scatter_add_width(kernels.ptr(vals), kernels.ptr(out),
                                               vals.shape[1])


def scatter_add(vals: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """zeros([size, F]).index_add(idx, vals) with out-of-range rows dropped.

    vals [N, F] float32; idx [N] integers, rows with idx outside [0, size)
    are dropped, not clamped (cnc_tpu's `mode="drop"`).  CPU tensors take the
    plain twin, CUDA tensors the kernel of csrc/scatter_add.cu (whose sum
    order, being atomic, varies from run to run).
    """
    if vals.dim() != 2 or idx.shape != vals.shape[:1] or idx.dtype.is_floating_point:
        raise ValueError("scatter_add expects vals [N, F] and integer idx [N]")
    if vals.is_cuda:
        if idx.dtype != torch.int32:
            idx = idx.clamp(-1, size).to(torch.int32)   # out-of-range stays out of range
        return _scatter_add_cuda(vals.contiguous(), idx.contiguous(), size)
    return _scatter_add_plain(vals, idx, size)


def scatter_add_cols(cols, idx: torch.Tensor, size: int):
    """Per-column form of `scatter_add`: a sequence of [N] columns sharing idx
    in, a tuple of [size] accumulations out."""
    return scatter_add(torch.stack(tuple(cols), dim=-1), idx, size).unbind(dim=-1)


def _lane_gather_plain(tbl_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tbl_t[:, idx.long().clamp(0, tbl_t.shape[1] - 1)]


def _lane_gather_cuda(tbl_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The transpose into a [groups, T, 4 or 8] scratch, then the gather
    (csrc/probe.cu); one count a call."""
    kernels.require_cuda("lane_gather", tbl_t, idx)
    if tbl_t.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError("lane_gather: the kernel takes a float32 table and int32 indices")
    rows, t_cols = tbl_t.shape
    n = idx.shape[0]
    out = torch.empty(rows, n, dtype=torch.float32, device=tbl_t.device)
    if n == 0 or rows == 0:
        return out
    if t_cols == 0:
        raise ValueError("lane_gather: indices into a table with no columns")
    scratch = torch.empty(kernels.lib().cnc_lane_gather_scratch(rows, t_cols),
                          dtype=torch.float32, device=tbl_t.device)
    kernels.call("cnc_lane_gather", kernels.ptr(tbl_t), kernels.ptr(idx), kernels.ptr(out),
                 kernels.ptr(scratch), rows, t_cols, n)
    kernels.launches["lane_gather"] += 1
    return out


def lane_gather(tbl_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[:, j] = tbl_t[:, idx[j]] on a transposed [rows, T] table.

    The function of the TPU lane-gather probe, in its layout; the port's
    encode gathers rows of a [T, F] table instead (K1), so nothing else in
    the package calls this.  Indices are clamped into the table.  CPU tensors
    take the plain twin, CUDA tensors the kernel of csrc/probe.cu.
    """
    if tbl_t.dim() != 2 or idx.dim() != 1 or idx.dtype.is_floating_point:
        raise ValueError("lane_gather expects a [rows, T] table and a 1-D integer idx")
    if tbl_t.is_cuda:
        return _lane_gather_cuda(tbl_t.contiguous(), idx.to(torch.int32).contiguous())
    return _lane_gather_plain(tbl_t, idx)


class _GroupedGatherInterp(torch.autograd.Function):
    """`grouped_gather_interp` with cnc_tpu's custom backward (`_ggi_bwd` with
    need_dw=False): d_table by a scatter-add of g*w, and no gradient for the
    indices or the weights."""

    @staticmethod
    def forward(ctx, table, gidx2, w2, groups):
        ctx.save_for_backward(gidx2, w2)
        ctx.groups, ctx.rows = groups, table.shape[0]
        n, k = gidx2.shape
        feats = table[gidx2.clamp(0, table.shape[0] - 1)]          # [N, K, F]
        prod = (w2[..., None] * feats).reshape(n, groups, k // groups, -1)
        # the corners one by one, in order, as K1 adds them (bit-equal forward)
        out = prod[:, :, 0]
        for c in range(1, k // groups):
            out = out + prod[:, :, c]
        return out.reshape(n, -1)

    @staticmethod
    def backward(ctx, g):
        gidx2, w2 = ctx.saved_tensors
        n, k = gidx2.shape
        c = k // ctx.groups
        f = g.shape[1] // ctx.groups
        # [N, G, C, F]: each corner's weight times its group's output gradient
        vals = w2.reshape(n, ctx.groups, c, 1) * g.reshape(n, ctx.groups, 1, f)
        d_table = _scatter_add_plain(vals.reshape(n * k, f), gidx2.reshape(-1), ctx.rows)
        return d_table, None, None, None


def grouped_gather_interp(table: torch.Tensor, gidx2: torch.Tensor, w2: torch.Tensor,
                          groups: int) -> torch.Tensor:
    """out[n, g*F+f] = sum_c w2[n, g*C+c] * table[gidx2[n, g*C+c], f].

    table [T, F]; gidx2/w2 [N, G*C], corner-major within each group.  Indices
    are clamped into the table, as cnc_tpu's `mode="clip"` gather does.
    Returns [N, G*F].  The plain half of K1 and K2 (`ops/encoding.py`): only
    `table` gets a gradient.  Every hot call of cnc_tpu passes
    need_dw=False (sample positions and lattice points are never optimized),
    so the port returns none for the weights, nor for the points behind them.
    """
    return _GroupedGatherInterp.apply(table, gidx2, w2, groups)


def _compact_plain(mask: torch.Tensor, cap: int):
    n = mask.shape[0]
    c = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    count = c[-1] if n else torch.zeros((), dtype=torch.int32, device=mask.device)
    # slot `cap` is a drop slot (cnc_tpu scatters with mode="drop")
    pos = torch.where(mask & (c <= cap), c - 1, cap).to(torch.int64)
    src = torch.zeros(cap + 1, dtype=torch.int32, device=mask.device)
    src.scatter_(0, pos, torch.arange(n, dtype=torch.int32, device=mask.device))
    return src[:cap], count


class _CompactWork:
    """Per device and stream: K3's look-back status words (one per tile of the
    largest mask the kernel takes, 1 MiB) and its claim counter and epoch.
    Made zero once; each launch tags its words with the epoch and its last
    claim resets the counter, so no launch clears them.  The launches that
    share them, being on one stream, run one at a time."""

    def __init__(self, device):
        self.status = torch.zeros(kernels.lib().cnc_compact_scratch(), dtype=torch.int64,
                                  device=device)
        self.work = torch.zeros(2, dtype=torch.int32, device=device)


_compact_works: Dict[Tuple[torch.device, int], _CompactWork] = {}


def _compact_work(device) -> _CompactWork:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    work = _compact_works.get(key)
    if work is None:
        work = _compact_works[key] = _CompactWork(device)
    return work


def _compact_cuda(mask: torch.Tensor, cap: int):
    """K3 in one launch (csrc/compact.cu); the mask may start at any byte."""
    kernels.require_cuda("compact_mask_indices", mask)
    n = mask.shape[0]
    if n >= 2 ** 31 or cap < 0:
        raise ValueError(f"compact_mask_indices: the kernel takes n < 2^31 and cap >= 0, got"
                         f" n={n}, cap={cap}")
    work = _compact_work(mask.device)
    src = torch.empty(cap, dtype=torch.int32, device=mask.device)
    count = torch.empty(1, dtype=torch.int32, device=mask.device)
    kernels.call("cnc_compact_mask", kernels.ptr(mask), n, cap, kernels.ptr(src),
                 kernels.ptr(count), kernels.ptr(work.status), kernels.ptr(work.work))
    kernels.launches["compact"] += 1
    return src, count[0]


def compact_mask_indices(mask: torch.Tensor, cap: int):
    """Positions of the first `cap` set entries of a 1-D bool mask, ascending.

    Returns (src [cap] int32, 0 past the count; count, a 0-dim int32 tensor of
    ALL set entries, not clamped to cap).  No host sync on either path.
    CPU tensors take the plain twin, CUDA tensors the K3 kernel.
    """
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError("compact_mask_indices expects a 1-D bool mask")
    if mask.is_cuda:
        return _compact_cuda(mask.contiguous(), cap)
    return _compact_plain(mask, cap)
