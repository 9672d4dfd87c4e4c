"""cnc_torch's hash-grid encode (K1's twin) and compaction (K3's twin)
against cnc_tpu on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnc_tpu.config import GridSpec
from cnc_tpu.ops import encoding as jenc
from cnc_tpu.ops import scatter_ops as jscatter
from cnc_torch.config import GridSpec as TGridSpec
from cnc_torch.ops import encoding as tenc
from cnc_torch.ops import scatter_ops as tscatter

# dense and hashed levels mixed: with 2^10 entries, 3D levels 6 and 10 are
# dense (6^3, 10^3 <= 1024), 18 and 34 hash; 2D 18 and 34 hash, 10 is dense
SPECS = {
    "3d": dict(num_dim=3, n_features=4, resolutions=(6, 10, 18, 34), log2_hashmap_size=10),
    "2d": dict(num_dim=2, n_features=2, resolutions=(10, 18, 34), log2_hashmap_size=10),
}


def _points(d, n, rng):
    pts = rng.uniform(0.0, 1.0, size=(n, d)).astype(np.float32)
    pts[:8] = rng.choice([0.0, 1.0], size=(8, d))          # exactly on the border
    pts[8:16] = rng.uniform(-0.3, 1.3, size=(8, d))        # outside [0,1]
    pts[16] = 0.5                                          # lattice-aligned center
    return pts


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_grid_encode_matches_cnc_tpu(kind):
    spec_kw = SPECS[kind]
    jspec, tspec = GridSpec(**spec_kw), TGridSpec(**spec_kw)
    assert any(jspec.is_dense(i) for i in range(jspec.n_levels))
    assert not all(jspec.is_dense(i) for i in range(jspec.n_levels))
    rng = np.random.default_rng(0)
    pts = _points(jspec.num_dim, 2048, rng)
    table = rng.normal(size=(jspec.total_entries, jspec.n_features)).astype(np.float32)
    want = np.asarray(jenc.grid_encode(jnp.asarray(pts), jnp.asarray(table), jspec))
    got = tenc.grid_encode(torch.from_numpy(pts), torch.from_numpy(table), tspec).numpy()
    assert got.shape == want.shape == (2048, jspec.output_dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # a level range
    want = np.asarray(jenc.grid_encode(jnp.asarray(pts), jnp.asarray(table), jspec, 1, 3))
    got = tenc.grid_encode(torch.from_numpy(pts), torch.from_numpy(table), tspec, 1, 3).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_set,cap", [(37, 64), (64, 64), (500, 64)],
                         ids=["below_cap", "at_cap", "over_cap"])
def test_compact_mask_indices_exact(n_set, cap):
    rng = np.random.default_rng(n_set)
    mask = np.zeros(4096, bool)
    mask[rng.choice(4096, n_set, replace=False)] = True
    want_src, want_count = jscatter.compact_mask_indices(jnp.asarray(mask), cap)
    got_src, got_count = tscatter.compact_mask_indices(torch.from_numpy(mask), cap)
    np.testing.assert_array_equal(got_src.numpy(), np.asarray(want_src))
    assert int(got_count) == int(want_count) == n_set
    assert got_src.dtype == torch.int32


def test_compact_rejects_non_bool():
    with pytest.raises(ValueError):
        tscatter.compact_mask_indices(torch.zeros(8, dtype=torch.int32), 4)
