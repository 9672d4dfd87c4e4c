"""Frozen copy of `cnc_torch/ops/scatter_ops.py`, its plain path only (no CUDA kernel);
what follows is the original's description.

Table scatter-add, stream compaction (K3) and the grouped gather-interpolate
twin of K1/K2.

Port of `cnc_tpu/ops/scatter_ops.py`.  `scatter_add` and `lane_gather` are
also the counterparts of the two TPU probe kernels (tools/pallas_probe.py:
the serial scatter-add and the lane gather).  Each dispatches on the device
of its input: a CPU tensor takes the plain twin, a CUDA tensor the kernel.
"""

from __future__ import annotations

import torch



def _scatter_add_plain(vals: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    # row `size` is a drop slot (cnc_tpu scatters with mode="drop")
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = torch.zeros(size + 1, vals.shape[1], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, vals)[:size]


def scatter_add(vals: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """zeros([size, F]).index_add(idx, vals) with out-of-range rows dropped.

    vals [N, F] float32; idx [N] integers, rows with idx outside [0, size)
    are dropped, not clamped (cnc_tpu's `mode="drop"`).  CPU tensors take the
    plain twin, CUDA tensors the kernel of csrc/scatter_add.cu (whose sum
    order, being atomic, varies from run to run).
    """
    if vals.dim() != 2 or idx.shape != vals.shape[:1] or idx.dtype.is_floating_point:
        raise ValueError("scatter_add expects vals [N, F] and integer idx [N]")
    return _scatter_add_plain(vals, idx, size)


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


def compact_mask_indices(mask: torch.Tensor, cap: int):
    """Positions of the first `cap` set entries of a 1-D bool mask, ascending.

    Returns (src [cap] int32, 0 past the count; count, a 0-dim int32 tensor of
    ALL set entries, not clamped to cap).  No host sync on either path.
    CPU tensors take the plain twin, CUDA tensors the K3 kernel.
    """
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError("compact_mask_indices expects a 1-D bool mask")
    return _compact_plain(mask, cap)
