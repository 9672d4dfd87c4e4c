"""Occupancy-grid state.

Port of the state half of `cnc_tpu/grids/occupancy.py` (reference
OccGridEstimator, nerfacc/estimators/occ_grid.py:14-443): a binary voxel grid
feeding the ray marcher.  The EMA update (`update_occ_grid`) and
`mark_invisible_cells` come with training.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device


class OccGridState(NamedTuple):
    occs: torch.Tensor      # [cells] float32; -1 marks camera-invisible cells
    binaries: torch.Tensor  # [R, R, R] bool
    aabb: torch.Tensor      # [6] float32

    @property
    def resolution(self) -> int:
        return self.binaries.shape[0]


def init_occ_grid(aabb, resolution: int = 128, device=None) -> OccGridState:
    dev = resolve_device(device)
    return OccGridState(
        occs=torch.zeros(resolution ** 3, dtype=torch.float32, device=dev),
        binaries=torch.zeros((resolution,) * 3, dtype=torch.bool, device=dev),
        aabb=torch.as_tensor(aabb, dtype=torch.float32).to(dev),
    )


def occupancy_grid_size_bits(binaries: torch.Tensor):
    """Analytic rate of the occupancy grid itself (driver get_binary_vxl_size,
    train_CNC_nerf_synthetic.py:53-68).  Returns (p, bits, cells)."""
    ttl = binaries.numel()
    pos = binaries.sum().float()
    pg = pos / ttl
    pos_bit = pos * (-torch.log2(torch.clamp(pg, min=1e-12)))
    neg_bit = (ttl - pos) * (-torch.log2(torch.clamp(1 - pg, min=1e-12)))
    return pg, pos_bit + neg_bit + 32.0, ttl
