"""Segment scans over flattened, ray-sorted sample buffers.

Port of `cnc_tpu/ops/scan.py` (nerfacc scan.py / scan.cu): a segment is a
run of equal, contiguous ids.  These are the plain twin of K5's per-ray scan
(csrc/volrend.cu); the sums are taken in float64 and rounded once, which is
at least as accurate as cnc_tpu's f32 associative scan.
"""

from __future__ import annotations

import torch


def _segment_sums(x: torch.Tensor, seg_id: torch.Tensor):
    """(inclusive, exclusive) global float64 prefix sums, and the exclusive
    sum at each element's segment start."""
    incl = torch.cumsum(x.double(), 0)
    excl = torch.cat([incl.new_zeros(1), incl[:-1]])
    head = torch.ones_like(seg_id, dtype=torch.bool)
    head[1:] = seg_id[1:] != seg_id[:-1]
    pos = torch.arange(x.shape[0], device=x.device)
    start = torch.cummax(torch.where(head, pos, 0), 0).values
    return incl, excl, excl[start]


def segment_inclusive_sum(x: torch.Tensor, seg_id: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum within contiguous segments: x=[1,2,3,4],
    ids=[0,0,1,1] -> [1,3,3,7]."""
    incl, _, base = _segment_sums(x, seg_id)
    return (incl - base).to(x.dtype)


def segment_exclusive_sum(x: torch.Tensor, seg_id: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum within contiguous segments: x=[1,2,3,4],
    ids=[0,0,1,1] -> [0,1,0,3]."""
    _, excl, base = _segment_sums(x, seg_id)
    return (excl - base).to(x.dtype)


def pack_info(seg_id: torch.Tensor, valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(start, count) per segment over the valid elements — nerfacc pack.py:11-49."""
    counts = torch.zeros(num_segments, dtype=torch.int32, device=seg_id.device)
    counts.index_add_(0, seg_id.long(), valid.to(torch.int32))
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return torch.stack([starts, counts], dim=-1)
