"""cnc_torch's summed-area-table queries (ops/sat.py) and the SAT-masked
encodes (the plain twin of K1s/K2s) against cnc_tpu and the reference
walk in tests/oracle.py, on the same numpy inputs.

Tolerances: the integer queries (table, box counts, boxes, masks, the
pooled int overlap) exactly; the float overlap within 1e-6 of its largest
value (cnc_tpu's operation order, float32); the encodes within 1e-6 of
cnc_tpu and 2e-5 of the float64 oracle (as tests/test_grid_encode.py
holds cnc_tpu); table gradients within 1e-5 of the largest entry of
jax.grad's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.config import GridSpec
from cnc_tpu.ops import encoding as jenc
from cnc_tpu.ops import sat as jsat
from cnc_torch.config import GridSpec as TGridSpec
from cnc_torch.ops import encoding as tenc
from cnc_torch.ops import sat as tsat

import oracle

SPECS = {
    3: dict(num_dim=3, n_features=2, resolutions=(10, 18, 34), log2_hashmap_size=9),
    2: dict(num_dim=2, n_features=4, resolutions=(18, 34, 66), log2_hashmap_size=9),
}


def _grid(d, rb, p, seed):
    return np.random.default_rng(seed).random((rb,) * d) < p


def _corners(d, r, n, rng):
    c = rng.integers(0, r, size=(n, d))
    c[:4] = 0              # footprints clipped at 0
    c[4:8] = r - 1         # and at Rb - 1
    return c.astype(np.int32)


def _points(d, n, rng):
    pts = rng.random((n, d)).astype(np.float32)
    pts[:6] = rng.choice([0.0, 1.0], size=(6, d))          # on the border
    pts[6:10] = rng.uniform(-0.3, 1.3, size=(4, d))        # outside [0,1]
    return pts


@pytest.mark.parametrize("d", [2, 3])
def test_build_sat_and_box_count_exact(d):
    rb = 16
    grid = _grid(d, rb, 0.2, d)
    want = np.asarray(jsat.build_sat(jnp.asarray(grid)))
    got = tsat.build_sat(torch.from_numpy(grid))
    assert got.dtype == torch.int32 and got.shape == (rb + 1,) * d
    np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(d + 10)
    a, b = rng.integers(0, rb, size=(2, 500, d))
    lo, hi = np.minimum(a, b).astype(np.int32), np.maximum(a, b).astype(np.int32)
    want_n = np.asarray(jsat.box_count(jnp.asarray(want), jnp.asarray(lo), jnp.asarray(hi)))
    got_n = tsat.box_count(got, torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(got_n, want_n)
    # against the grid itself
    for (l, h), n in zip(zip(lo[:20], hi[:20]), got_n[:20]):
        assert n == grid[tuple(slice(i, j + 1) for i, j in zip(l, h))].sum()


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("per_point", [False, True], ids=["static", "per_point"])
def test_footprint_and_occupancy_mask_exact(d, per_point):
    rb = 32 if d == 3 else 128
    grid = _grid(d, rb, 0.01 if d == 3 else 0.003, 20 + d)
    sat_j = jsat.build_sat(jnp.asarray(grid))
    sat_t = tsat.build_sat(torch.from_numpy(grid))
    rng = np.random.default_rng(d)
    kept = []
    for r in ((10, 44, 108, 514) if d == 3 else (18, 130, 258, 1026)):
        c = _corners(d, r, 400, rng)
        res_j = (jnp.full((400,), r, jnp.int32) if per_point else r)
        res_t = (torch.full((400,), r, dtype=torch.int64) if per_point else r)
        lo_j, hi_j = jsat.footprint_box(jnp.asarray(c), res_j, rb)
        lo_t, hi_t = tsat.footprint_box(torch.from_numpy(c), res_t, rb)
        np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
        np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
        m_j = np.asarray(jsat.occupancy_mask(sat_j, jnp.asarray(c), res_j, rb))
        m_t = tsat.occupancy_mask(sat_t, torch.from_numpy(c), res_t, rb).numpy()
        np.testing.assert_array_equal(m_t, m_j)
        kept.append(m_t)
        for ci, mi in zip(c[:40], m_t[:40]):
            assert mi == oracle.corner_mask_oracle(ci, r, grid)
    kept = np.concatenate(kept)
    assert kept.any() and not kept.all()


@pytest.mark.parametrize("d", [2, 3])
def test_overlap_matches_cnc_tpu(d):
    rb = 32
    grid = _grid(d, rb, 0.25, 30 + d)
    sat_j = jsat.build_sat(jnp.asarray(grid))
    sat_t = tsat.build_sat(torch.from_numpy(grid))
    rng = np.random.default_rng(40 + d)
    for r in ((18, 44, 108) if d == 3 else (18, 130, 514)):
        c = _corners(d, r, 300, rng)
        want = np.asarray(jsat.overlap_volume_cells(sat_j, jnp.asarray(c), r, rb))
        got = tsat.overlap_volume_cells(sat_t, torch.from_numpy(c), r, rb).numpy()
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=0)
        want_i = np.asarray(jsat.overlap_area_pool_int(sat_j, jnp.asarray(c), r, rb))
        got_i = tsat.overlap_area_pool_int(sat_t, torch.from_numpy(c), r, rb).numpy()
        np.testing.assert_array_equal(got_i, want_i)
    # per-point resolutions (the qlist form)
    res = rng.choice([18, 44, 108], size=300).astype(np.int32)
    c = np.stack([rng.integers(0, r, size=d) for r in res]).astype(np.int32)
    want = np.asarray(jsat.overlap_volume_cells(sat_j, jnp.asarray(c), jnp.asarray(res), rb))
    got = tsat.overlap_volume_cells(sat_t, torch.from_numpy(c),
                                    torch.from_numpy(res.astype(np.int64)), rb).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * float(np.abs(want).max()), rtol=0)


def _encode_pair(d, fn_j, fn_t, seed, rb=16, p=0.15, **kw):
    spec_kw = SPECS[d]
    jspec, tspec = GridSpec(**spec_kw), TGridSpec(**spec_kw)
    rng = np.random.default_rng(seed)
    pts = _points(d, 300, rng)
    table = rng.standard_normal((jspec.total_entries, jspec.n_features)).astype(np.float32)
    grid = _grid(d, rb, p, seed + 1)
    want = np.asarray(fn_j(jnp.asarray(pts), jnp.asarray(table), jspec, jnp.asarray(grid), **kw))
    got = fn_t(torch.from_numpy(pts), torch.from_numpy(table), tspec, torch.from_numpy(grid),
               **kw).numpy()
    return pts, table, grid, jspec, got, want


@pytest.mark.parametrize("d", [2, 3])
def test_masked_grid_encode_matches_cnc_tpu_and_oracle(d):
    pts, table, grid, spec, got, want = _encode_pair(
        d, lambda p, t, s, g: jenc.grid_encode(p, t, s, occ_binary=g),
        lambda p, t, s, g: tenc.grid_encode(p, t, s, occ_binary=g), 50 + d)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    walk = oracle.grid_encode_oracle(pts, table, spec.resolutions, spec.offsets,
                                     binary_vxl=grid)
    np.testing.assert_allclose(got, walk, rtol=2e-4, atol=2e-5)
    unmasked = tenc.grid_encode(torch.from_numpy(pts), torch.from_numpy(table),
                                TGridSpec(**SPECS[d])).numpy()
    assert not np.allclose(got, unmasked)      # the mask drops corners
    # a prebuilt table gives the same, and occ_mask wins over it
    sat = tsat.build_sat(torch.from_numpy(grid))
    again = tenc.grid_encode(torch.from_numpy(pts), torch.from_numpy(table),
                             TGridSpec(**SPECS[d]), occ_sat=sat).numpy()
    np.testing.assert_array_equal(again, got)
    tspec = TGridSpec(**SPECS[d])
    moffs = [0] * tspec.n_levels
    full = torch.ones(max(r ** d for r in tspec.resolutions), dtype=torch.bool)
    wins = tenc.grid_encode(torch.from_numpy(pts), torch.from_numpy(table), tspec, occ_sat=sat,
                            occ_mask=full, mask_offsets=moffs).numpy()
    np.testing.assert_array_equal(wins, unmasked)


@pytest.mark.parametrize("d", [2, 3])
def test_masked_level_range_and_mixed_levels(d):
    _, _, _, _, got, want = _encode_pair(
        d, lambda p, t, s, g: jenc.grid_encode(p, t, s, 1, 3, occ_binary=g),
        lambda p, t, s, g: tenc.grid_encode(p, t, s, 1, 3, occ_binary=g), 60 + d)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    ids = np.random.default_rng(d).integers(-1, 3, size=300).astype(np.int32)
    _, _, _, _, got, want = _encode_pair(
        d, lambda p, t, s, g: jenc.grid_encode_diff_levels(p, t, s, jnp.asarray(ids), 2,
                                                           occ_binary=g),
        lambda p, t, s, g: tenc.grid_encode_diff_levels(p, t, s, torch.from_numpy(ids), 2,
                                                        occ_binary=g), 70 + d)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_masked_given_table_matches_cnc_tpu():
    rng = np.random.default_rng(80)
    r, rb = 34, 16
    pts = _points(2, 300, rng)
    plane = rng.standard_normal((r * r, 4)).astype(np.float32)
    grid = _grid(2, rb, 0.2, 81)
    want = np.asarray(jenc.grid_encode_given_table(jnp.asarray(pts), jnp.asarray(plane), r,
                                                   occ_binary=jnp.asarray(grid)))
    got = tenc.grid_encode_given_table(torch.from_numpy(pts), torch.from_numpy(plane), r,
                                       occ_binary=torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    walk = oracle.grid_encode_oracle(pts, plane, [r], [0, r * r], binary_vxl=grid)
    np.testing.assert_allclose(got, walk, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("mixed", [False, True], ids=["static", "mixed"])
def test_masked_encode_table_gradient_matches_jax_grad(d, mixed):
    spec_kw = SPECS[d]
    jspec, tspec = GridSpec(**spec_kw), TGridSpec(**spec_kw)
    rng = np.random.default_rng(90 + d)
    pts = _points(d, 300, rng)
    table = rng.standard_normal((jspec.total_entries, jspec.n_features)).astype(np.float32)
    grid = _grid(d, 16, 0.15, 91 + d)
    ids = rng.integers(0, 3, size=300).astype(np.int32)
    n_out = 2 if mixed else jspec.n_levels
    cot = rng.standard_normal((300, n_out * jspec.n_features)).astype(np.float32)

    def jfn(t):
        if mixed:
            out = jenc.grid_encode_diff_levels(jnp.asarray(pts), t, jspec, jnp.asarray(ids), 2,
                                               occ_binary=jnp.asarray(grid))
        else:
            out = jenc.grid_encode(jnp.asarray(pts), t, jspec, occ_binary=jnp.asarray(grid))
        return jnp.sum(out * jnp.asarray(cot))

    want = np.asarray(jax.grad(jfn)(jnp.asarray(table)))
    leaf = torch.from_numpy(table).requires_grad_()
    if mixed:
        out = tenc.grid_encode_diff_levels(torch.from_numpy(pts), leaf, tspec,
                                           torch.from_numpy(ids), 2,
                                           occ_binary=torch.from_numpy(grid))
    else:
        out = tenc.grid_encode(torch.from_numpy(pts), leaf, tspec,
                               occ_binary=torch.from_numpy(grid))
    (out * torch.from_numpy(cot)).sum().backward()
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(leaf.grad.numpy(), want, atol=1e-5 * scale, rtol=0)

