"""cnc_torch's march (K4's twin) and composite (K5's twin) against cnc_tpu.

March sample sets must be identical (same ray ids, same t bits, same
truncation flags); composites agree to rtol 1e-5 / atol 1e-6, the margin of
a different summation order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnc_tpu.config import RenderConfig
from cnc_tpu.data import cameras as jcam
from cnc_tpu.data import scenes as jscenes
from cnc_tpu.render import marching as jmarch
from cnc_tpu.render import volrend as jvol
from cnc_torch.config import RenderConfig as TRenderConfig
from cnc_torch.data import scenes as tscenes
from cnc_torch.render import marching as tmarch
from cnc_torch.render import volrend as tvol

KW = dict(render_step_size=0.02, occ_resolution=64, sample_budget=8192)
RCFG, TRCFG = dataclasses.replace(RenderConfig(), **KW), dataclasses.replace(TRenderConfig(), **KW)
AABB = np.asarray(jscenes.make_scene("sphere").aabb, np.float32)


def _binaries():
    return tscenes.occupancy_from_scene(tscenes.make_scene("sphere"), 64,
                                        RCFG.render_step_size, device="cpu").numpy()


def _rays(n_side=32, stride=3):
    poses = jcam.look_at_poses(1, radius=3.0)
    K = jnp.asarray([[40.0, 0, n_side / 2], [0, 40.0, n_side / 2], [0, 0, 1]])
    rays = jcam.image_rays(K, jnp.asarray(poses[0]), n_side, n_side)
    o = np.asarray(rays.origins).reshape(-1, 3)[::stride]
    d = np.asarray(rays.viewdirs).reshape(-1, 3)[::stride]
    return np.ascontiguousarray(o), np.ascontiguousarray(d)


def test_occupancy_from_scene_matches_cnc_tpu_helper():
    scene = jscenes.make_scene("sphere")
    g = jnp.arange(64, dtype=jnp.float32)
    xs = (jnp.stack(jnp.meshgrid(g, g, g, indexing="ij"), -1) + 0.5) / 64
    lo, hi = jnp.asarray(scene.aabb[:3]), jnp.asarray(scene.aabb[3:])
    want = np.asarray(scene.sigma_fn(lo + xs.reshape(-1, 3) * (hi - lo)).reshape(64, 64, 64)
                      * RCFG.render_step_size > 1e-2)
    got = _binaries()
    assert want.sum() > 1000
    # the analytic density is evaluated by two frameworks: allow a handful of
    # cells exactly at the threshold to differ, none elsewhere
    assert (got != want).sum() <= 4


def test_ray_aabb_intersect_matches():
    o, d = _rays()
    d[0] = [0.0, 0.0, 1.0]            # axis-parallel: the 1e-10 guard
    d[1] = [1e-12, -1.0, 0.0]
    o[2] = [5.0, 5.0, 5.0]            # a miss
    jt = jmarch.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(AABB))
    tt = tmarch.ray_aabb_intersect(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(AABB))
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _march_both(o, d, binaries, capacity, ray_mask=None, t_start=None):
    kw_j = dict(ray_mask=None if ray_mask is None else jnp.asarray(ray_mask),
                t_start=None if t_start is None else jnp.asarray(t_start))
    kw_t = dict(ray_mask=None if ray_mask is None else torch.from_numpy(ray_mask),
                t_start=None if t_start is None else torch.from_numpy(t_start))
    js = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(binaries),
                           jnp.asarray(AABB), None, RCFG, capacity, **kw_j)
    ts = tmarch.march_rays(torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(binaries), torch.from_numpy(AABB), TRCFG,
                           capacity, **kw_t)
    return js, ts


def _assert_same_samples(js, ts):
    np.testing.assert_array_equal(ts.ray_id.numpy(), np.asarray(js.ray_id))
    np.testing.assert_array_equal(ts.t_mid.numpy(), np.asarray(js.t_mid))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert bool(ts.truncated) == bool(js.truncated)
    assert int(ts.resume_ray) == int(js.resume_ray)
    assert int(ts.num_samples) == int(js.num_samples)
    assert ts.dt == float(js.dt)


# (grid, rays, capacity): everything fits; only the fine buffer overflows
# (4 rays through a full grid: 36 candidate blocks fit the 256-block floor);
# the coarse candidate buffer overflows too
@pytest.mark.parametrize("grid,n_rays,capacity", [("sphere", None, 1 << 15),
                                                  ("full", 4, 64),
                                                  ("sphere", None, 2048)],
                         ids=["fits", "fine_cut", "coarse_cut"])
def test_march_rays_identical(grid, n_rays, capacity):
    o, d = _rays()
    o, d = o[:n_rays], d[:n_rays]
    binaries = _binaries() if grid == "sphere" else np.ones((64, 64, 64), bool)
    js, ts = _march_both(o, d, binaries, capacity)
    _assert_same_samples(js, ts)
    exact = int(ts.num_samples) == int(ts.valid.sum())   # the coarse pass fit
    if capacity == 1 << 15:
        assert not bool(ts.truncated) and exact and int(ts.valid.sum()) > 1000
    else:
        assert bool(ts.truncated) and int(ts.resume_ray) < o.shape[0]
        assert (int(ts.num_samples) > capacity) if grid == "full" else not exact


def test_march_rays_identical_with_cursor_and_mask():
    o, d = _rays()
    rng = np.random.default_rng(1)
    ray_mask = rng.random(o.shape[0]) < 0.7
    t_start = rng.uniform(0.0, 3.0, o.shape[0]).astype(np.float32)
    js, ts = _march_both(o, d, _binaries(), 4096, ray_mask, t_start)
    _assert_same_samples(js, ts)
    assert int(np.asarray(js.valid).sum()) > 50


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


@pytest.mark.parametrize("prefix,alpha_thre", [(False, 0.0), (True, 0.0), (True, 0.05)],
                         ids=["plain", "prefix_trans", "alpha_thre"])
def test_composite_matches(prefix, alpha_thre):
    ray_id, valid, t_mid, sig, rgb = _samples_and_field()
    n_rays = 40
    pt = np.random.default_rng(5).uniform(0.2, 1.0, n_rays).astype(np.float32)
    js = jmarch.RaySamples(ray_id=jnp.asarray(ray_id), t_mid=jnp.asarray(t_mid),
                           dt=jnp.float32(0.02), valid=jnp.asarray(valid),
                           num_samples=jnp.int32(valid.sum()))
    ts = tmarch.RaySamples(ray_id=torch.from_numpy(ray_id), t_mid=torch.from_numpy(t_mid),
                           dt=float(np.float32(0.02)), valid=torch.from_numpy(valid),
                           num_samples=torch.tensor(int(valid.sum())))
    bkgd = np.ones(3, np.float32)
    jo = jvol.composite(jnp.asarray(rgb), jnp.asarray(sig), js, n_rays, jnp.asarray(bkgd),
                        1e-4, jnp.asarray(pt) if prefix else None, alpha_thre)
    to = tvol.composite(torch.from_numpy(rgb), torch.from_numpy(sig), ts, n_rays,
                        torch.from_numpy(bkgd), 1e-4, torch.from_numpy(pt) if prefix else None,
                        alpha_thre)
    for name in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert int(to.n_rendering_samples) == int(jo.n_rendering_samples)
    assert float(np.asarray(jo.opacity).max()) > 0.5     # transmittance really falls


def test_segment_scans_and_pack_info_match():
    from cnc_tpu.ops import scan as jscan
    from cnc_torch.ops import scan as tscan
    ray_id, valid, _, sig, _ = _samples_and_field(seed=3)
    x = (sig * 0.02).astype(np.float32)
    jr, tr = jnp.asarray(ray_id), torch.from_numpy(ray_id)
    for name in ("segment_inclusive_sum", "segment_exclusive_sum"):
        np.testing.assert_allclose(getattr(tscan, name)(torch.from_numpy(x), tr).numpy(),
                                   np.asarray(getattr(jscan, name)(jnp.asarray(x), jr)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(
        tscan.pack_info(tr, torch.from_numpy(valid), 40).numpy(),
        np.asarray(jscan.pack_info(jr, jnp.asarray(valid), 40)))
