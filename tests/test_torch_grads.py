"""Gradients of cnc_torch's encode (K2's twin) and composite (K5b's twin)
against jax.grad of cnc_tpu on the same numpy inputs, and the table
scatter-add and lane gather (the twins of the two probe kernels).

Tolerances: 1e-5 of the largest gradient entry, the margin of a different
summation order in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.config import GridSpec
from cnc_tpu.ops import encoding as jenc
from cnc_tpu.ops import scatter_ops as jscatter
from cnc_tpu.render import marching as jmarch
from cnc_tpu.render import volrend as jvol
from cnc_torch.config import GridSpec as TGridSpec
from cnc_torch.ops import encoding as tenc
from cnc_torch.ops import scatter_ops as tscatter
from cnc_torch.render import marching as tmarch
from cnc_torch.render import volrend as tvol

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


@pytest.mark.parametrize("levels", [(0, None), (1, 3)], ids=["all_levels", "level_range"])
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_grid_encode_d_table_matches_jax_grad(kind, levels):
    jspec, tspec = GridSpec(**SPECS[kind]), TGridSpec(**SPECS[kind])
    rng = np.random.default_rng(1)
    pts = _points(jspec.num_dim, 2048, rng)
    table = rng.normal(size=(jspec.total_entries, jspec.n_features)).astype(np.float32)
    n_out = ((levels[1] or jspec.n_levels) - levels[0]) * jspec.n_features
    cot = rng.normal(size=(2048, n_out)).astype(np.float32)

    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jenc.grid_encode(jnp.asarray(pts), t, jspec, *levels) * cot))(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    p = torch.from_numpy(pts).requires_grad_()
    (tenc.grid_encode(p, t, tspec, *levels) * torch.from_numpy(cot)).sum().backward()
    got = t.grad.numpy()
    assert got.shape == want.shape and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    assert p.grad is None       # no gradient for the points, as cnc_tpu's need_dw=False


def test_grouped_gather_interp_grads_only_the_table():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(50, 4)).astype(np.float32)
    gidx = rng.integers(0, 50, size=(30, 6)).astype(np.int64)
    w = rng.uniform(size=(30, 6)).astype(np.float32)
    cot = rng.normal(size=(30, 8)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(jscatter.grouped_gather_interp(
        t, jnp.asarray(gidx), jnp.asarray(w), 2, 4, False) * cot))(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = tscatter.grouped_gather_interp(t, torch.from_numpy(gidx), tw, 2)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-5, rtol=0)
    assert tw.grad is None


@pytest.mark.parametrize("f", [1, 4, 8])
def test_scatter_add_drops_out_of_range_rows(f):
    rng = np.random.default_rng(f)
    size, n = 37, 500
    idx = rng.integers(0, size + 20, n).astype(np.int32)      # a third out of range
    assert (idx >= size).sum() > 50
    vals = rng.normal(size=(n, f)).astype(np.float32)
    want = np.asarray(jscatter.scatter_add(jnp.asarray(vals), jnp.asarray(idx), size))
    got = tscatter.scatter_add(torch.from_numpy(vals), torch.from_numpy(idx), size)
    assert got.shape == (size, f)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    ref = np.zeros((size, f), np.float32)
    keep = idx < size
    np.add.at(ref, idx[keep], vals[keep])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    cols = tscatter.scatter_add_cols([torch.from_numpy(vals[:, i]) for i in range(f)],
                                     torch.from_numpy(idx).long(), size)
    jcols = jscatter.scatter_add_cols(tuple(jnp.asarray(vals[:, i]) for i in range(f)),
                                      jnp.asarray(idx), size)
    for a, b in zip(cols, jcols):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_scatter_add_with_every_row_out_of_range_is_zero():
    vals = torch.ones(10, 4)
    got = tscatter.scatter_add(vals, torch.full((10,), 99, dtype=torch.int32), 16)
    assert got.shape == (16, 4) and not got.any()
    with pytest.raises(ValueError):
        tscatter.scatter_add(vals, torch.zeros(10), 16)


def test_lane_gather_matches_take_along_lane_axis():
    # the probe's function at a small size: out[:, j] = tbl[:, idx[j]]
    rng = np.random.default_rng(0)
    tbl_t = rng.standard_normal((8, 256)).astype(np.float32)
    idx = rng.integers(0, 256, 1000, dtype=np.int32)
    idx8 = np.broadcast_to(idx[None, :], (8, 1000))
    want = np.asarray(jnp.take_along_axis(jnp.asarray(tbl_t), jnp.asarray(idx8), axis=1))
    got = tscatter.lane_gather(torch.from_numpy(tbl_t), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tscatter.lane_gather(torch.from_numpy(tbl_t), torch.zeros(4))


def _samples_and_field(n_rays=40, per_ray=12, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, per_ray, n_rays)
    rid = np.repeat(np.arange(n_rays), counts).astype(np.int32)
    n_pad = 16
    ray_id = np.concatenate([rid, np.full(n_pad, n_rays - 1, np.int32)])
    valid = np.concatenate([np.ones(rid.shape[0], bool), np.zeros(n_pad, bool)])
    t_mid = np.sort(rng.uniform(0, 4, ray_id.shape[0])).astype(np.float32)
    sig = rng.exponential(30.0, ray_id.shape[0]).astype(np.float32)
    rgb = rng.uniform(0, 1, (ray_id.shape[0], 3)).astype(np.float32)
    return ray_id, valid, t_mid, sig, rgb


@pytest.mark.parametrize("alpha_thre", [0.0, 0.3], ids=["no_alpha_thre", "alpha_thre"])
def test_composite_grads_match_jax_grad(alpha_thre):
    ray_id, valid, t_mid, sig, rgb = _samples_and_field()
    n_rays, n = 40, ray_id.shape[0]
    rng = np.random.default_rng(7)
    c_rgb = rng.normal(size=(n_rays, 3)).astype(np.float32)
    c_op = rng.normal(size=(n_rays, 1)).astype(np.float32)
    c_dep = rng.normal(size=(n_rays, 1)).astype(np.float32)
    bkgd = np.ones(3, np.float32)
    js = jmarch.RaySamples(ray_id=jnp.asarray(ray_id), t_mid=jnp.asarray(t_mid),
                           dt=jnp.float32(0.02), valid=jnp.asarray(valid),
                           num_samples=jnp.int32(valid.sum()))
    ts = tmarch.RaySamples(ray_id=torch.from_numpy(ray_id), t_mid=torch.from_numpy(t_mid),
                           dt=float(np.float32(0.02)), valid=torch.from_numpy(valid),
                           num_samples=torch.tensor(int(valid.sum())))

    def jloss(rgbs, sigmas):
        o = jvol.composite(rgbs, sigmas, js, n_rays, jnp.asarray(bkgd), 1e-4, None, alpha_thre)
        return jnp.sum(o.rgb * c_rgb) + jnp.sum(o.opacity * c_op) + jnp.sum(o.depth * c_dep)

    want_rgbs, want_sig = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(rgb), jnp.asarray(sig))
    trgb = torch.from_numpy(rgb).requires_grad_()
    tsig = torch.from_numpy(sig).requires_grad_()
    o = tvol.composite(trgb, tsig, ts, n_rays, torch.from_numpy(bkgd), 1e-4, None, alpha_thre)
    ((o.rgb * torch.from_numpy(c_rgb)).sum() + (o.opacity * torch.from_numpy(c_op)).sum()
     + (o.depth * torch.from_numpy(c_dep)).sum()).backward()
    for got, want in ((trgb.grad, want_rgbs), (tsig.grad, want_sig)):
        want = np.asarray(want)
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)
    if alpha_thre:
        cut = (1.0 - np.exp(-sig * np.float32(0.02)) < alpha_thre) & valid
        assert cut.sum() > 10 and not tsig.grad.numpy()[cut].any()
    assert not tsig.grad.numpy()[~valid].any()       # padding gets no gradient


def test_composite_rejects_prefix_trans_that_requires_grad():
    ray_id, valid, t_mid, sig, rgb = _samples_and_field()
    ts = tmarch.RaySamples(ray_id=torch.from_numpy(ray_id), t_mid=torch.from_numpy(t_mid),
                           dt=0.02, valid=torch.from_numpy(valid), num_samples=torch.tensor(0))
    with pytest.raises(ValueError, match="prefix_trans"):
        tvol.composite(torch.from_numpy(rgb), torch.from_numpy(sig), ts, 40,
                       prefix_trans=torch.ones(40, requires_grad=True))
