"""Frozen copy of `cnc_torch/ops/entropy.py`, its plain path only (no CUDA kernel);
what follows is the original's description.

Bernoulli rate model for binarized hash-table entries.

Port of `cnc_tpu/ops/entropy.py` (reference Bernoulli_entropy,
utils_bpp_acc.py:1002-1013): the context model's raw output is the
probability of the +1 symbol (no sigmoid), clamped to [1e-6, 1-1e-6].
"""

from __future__ import annotations

import torch

P_EPS = 1e-6
_INV_LN2 = 1.4426950408889634


def bernoulli_bits(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Bits to code symbols x in {-1,+1} under P(+1)=p.

    Returns elementwise -log2(p)*[x=+1] - log2(1-p)*[x=-1].
    """
    p = torch.clamp(p, P_EPS, 1.0 - P_EPS)
    pos_mask = (1.0 + x) / 2.0
    neg_mask = (1.0 - x) / 2.0
    return (-torch.log(p) * _INV_LN2) * pos_mask + (-torch.log1p(-p) * _INV_LN2) * neg_mask


def global_pg_bits(params_q: torch.Tensor):
    """Level-wise global-probability rate (get_BiRF_wentropy_leveln,
    utils_bpp_acc.py:472-486).

    params_q: binarized (+-1) entries of one level.
    Returns (Pg, total_bits, total_count).
    """
    ttl = params_q.numel()
    s = params_q.sum()
    pos = (ttl + s) / 2.0
    neg = (ttl - s) / 2.0
    pg = pos / ttl
    # clamp only inside the logs: a one-sided level (pg = 0 or 1) costs ~0
    # bits rather than 0 * inf = NaN
    pg_safe = torch.clamp(pg, 1e-6, 1.0 - 1e-6)
    pos_bit = pos * (-torch.log2(pg_safe))
    neg_bit = neg * (-torch.log2(1.0 - pg_safe))
    return pg, pos_bit + neg_bit, ttl
