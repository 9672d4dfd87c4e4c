"""Spatial hashing for multiresolution hash grids.

Port of `cnc_tpu/ops/hash_ops.py` (the reference's gridencoder.cu:45-87
`fast_hash` / `get_grid_index`).  The uint32 arithmetic is done in int64 and
masked with `& 0xFFFFFFFF` after every product and sum, which is exactly
uint32 wrap-around: torch has no unsigned 32-bit multiply on every device.
The CUDA encoder (csrc/grid_encode.cu) does the same in native uint32.
"""

from __future__ import annotations

import torch

# gridencoder.cu:49
PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
          2165219737)
_U32 = 0xFFFFFFFF


def fast_hash(pos_grid: torch.Tensor) -> torch.Tensor:
    """XOR-prime hash over integer lattice coords.

    Args:
      pos_grid: [..., D] integer coords (negative values wrap as uint32 would).
    Returns:
      [...] int64 hash values in [0, 2**32).
    """
    pg = pos_grid.to(torch.int64) & _U32
    result = torch.zeros(pg.shape[:-1], dtype=torch.int64, device=pg.device)
    for i in range(pg.shape[-1]):
        result = result ^ ((pg[..., i] * PRIMES[i]) & _U32)
    return result


def dense_index(pos_grid: torch.Tensor, resolution: int) -> torch.Tensor:
    """Row-major index x + y*R + z*R^2 (gridencoder.cu:72-77), uint32-wrapped."""
    pg = pos_grid.to(torch.int64) & _U32
    idx = torch.zeros(pg.shape[:-1], dtype=torch.int64, device=pg.device)
    stride = 1
    for i in range(pg.shape[-1]):
        idx = (idx + pg[..., i] * stride) & _U32
        stride = (stride * resolution) & _U32
    return idx


def grid_index(pos_grid: torch.Tensor, resolution: int, hashmap_size: int) -> torch.Tensor:
    """Level-local entry index for lattice coords (gridencoder.cu:61-87).

    Dense row-major indexing when resolution**D <= hashmap_size, spatial hash
    otherwise, taken mod hashmap_size (a bit mask for power-of-two sizes).
    Returns int64 in [0, hashmap_size).  The per-point (mixed-level) form of
    `cnc_tpu`'s `grid_index` is not needed until `grid_encode_diff_levels`.
    """
    d = pos_grid.shape[-1]
    if resolution ** d <= hashmap_size:
        # dense index < R**D <= hashmap_size: the final modulus is an identity
        return dense_index(pos_grid, resolution)
    idx = fast_hash(pos_grid)
    if hashmap_size & (hashmap_size - 1) == 0:
        return idx & (hashmap_size - 1)
    return idx % hashmap_size
