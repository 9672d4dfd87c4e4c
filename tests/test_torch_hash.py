"""cnc_torch hash indices against cnc_tpu's, bit for bit.

Every default level resolution is checked (3D 18..514 at 2^19, 2D 130..1026
at 2^17), with lattice coordinates up to R-1 where the uint32 products wrap.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnc_tpu.config import default_grid_2d, default_grid_3d
from cnc_tpu.ops import hash_ops as jhash
from cnc_torch.ops import hash_ops as thash


def _levels():
    for spec in (default_grid_3d(), default_grid_2d()):
        for lvl in range(spec.n_levels):
            yield spec.num_dim, spec.resolutions[lvl], spec.level_sizes[lvl]


@pytest.mark.parametrize("d,res,size", list(_levels()),
                         ids=lambda v: str(v))
def test_grid_index_matches_cnc_tpu(d, res, size):
    rng = np.random.default_rng(res)
    coords = rng.integers(0, res, size=(4096, d))
    coords[:2] = [[res - 1] * d, [0] * d]          # the extreme corners
    want_jax = np.asarray(jhash.grid_index(jnp.asarray(coords, jnp.int32), res, size))
    want_np = jhash.grid_index_np(coords, res, size)
    got = thash.grid_index(torch.from_numpy(coords), res, size).numpy()
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_np)
    assert got.min() >= 0 and got.max() < size


def test_fast_hash_wraps_like_uint32():
    coords = np.array([[1025, 1025, 1025], [2 ** 31 - 1, 7, 2 ** 20]], np.int64)
    want = np.asarray(jhash.fast_hash(jnp.asarray(coords, jnp.uint32)))
    got = thash.fast_hash(torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
