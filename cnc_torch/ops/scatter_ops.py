"""Stream compaction (K3) and the grouped gather-interpolate twin of K1.

Port of the forward half of `cnc_tpu/ops/scatter_ops.py`.  The table
scatter-adds (`scatter_add*`) and the encode backward (`_ggi_bwd`, K2) come
with training.
"""

from __future__ import annotations

import torch

from .. import kernels


def grouped_gather_interp(table: torch.Tensor, gidx2: torch.Tensor, w2: torch.Tensor,
                          groups: int) -> torch.Tensor:
    """out[n, g*F+f] = sum_c w2[n, g*C+c] * table[gidx2[n, g*C+c], f].

    table [T, F]; gidx2/w2 [N, G*C], corner-major within each group.  Indices
    are clamped into the table, as cnc_tpu's `mode="clip"` gather does.
    Returns [N, G*F].  The plain half of K1 (`ops/encoding.py`).
    """
    n, k = gidx2.shape
    feats = table[gidx2.clamp(0, table.shape[0] - 1)]          # [N, K, F]
    out = (w2[..., None] * feats).reshape(n, groups, k // groups, -1).sum(dim=2)
    return out.reshape(n, -1)


def _compact_plain(mask: torch.Tensor, cap: int):
    n = mask.shape[0]
    c = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    count = c[-1] if n else torch.zeros((), dtype=torch.int32, device=mask.device)
    # slot `cap` is a drop slot (cnc_tpu scatters with mode="drop")
    pos = torch.where(mask & (c <= cap), c - 1, cap).to(torch.int64)
    src = torch.zeros(cap + 1, dtype=torch.int32, device=mask.device)
    src.scatter_(0, pos, torch.arange(n, dtype=torch.int32, device=mask.device))
    return src[:cap], count


def _compact_cuda(mask: torch.Tensor, cap: int):
    kernels.require_cuda("compact_mask_indices", mask)
    n = mask.shape[0]
    lib = kernels.lib()
    src = torch.empty(cap, dtype=torch.int32, device=mask.device)
    count = torch.empty(1, dtype=torch.int32, device=mask.device)
    scratch = torch.empty(lib.cnc_compact_scratch(n), dtype=torch.int32, device=mask.device)
    kernels.call("cnc_compact_mask", kernels.ptr(mask), n, cap, kernels.ptr(src),
                 kernels.ptr(count), kernels.ptr(scratch))
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
