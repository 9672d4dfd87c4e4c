"""cnc_torch's config, cameras, scenes, occupancy state and metrics against
cnc_tpu's on the same numpy inputs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnc_tpu import config as jconfig
from cnc_tpu.data import cameras as jcam
from cnc_tpu.data import scenes as jscenes
from cnc_tpu.grids import occupancy as jocc
from cnc_tpu.ops import sh as jsh
from cnc_tpu.utils import metrics as jmetrics
from cnc_torch import config as tconfig
from cnc_torch.data import cameras as tcam
from cnc_torch.data import scenes as tscenes
from cnc_torch.grids import occupancy as tocc
from cnc_torch.ops import sh as tsh
from cnc_torch.utils import metrics as tmetrics


def test_config_round_trips_between_packages():
    j = jconfig.CNCConfig.with_n_features(2, sample_num=1000)
    t = tconfig.CNCConfig.from_dict(j.to_dict())
    assert t.to_dict() == j.to_dict()
    assert jconfig.CNCConfig.from_dict(t.to_dict()) == j
    tm, jm = tconfig.ModelConfig(), jconfig.ModelConfig()
    assert tm.grid_3d.offsets == jm.grid_3d.offsets
    assert tm.grid_3d.total_entries == 4_003_896 and tm.grid_2d.total_entries == 345_616
    assert tconfig.RenderConfig().max_march_steps == jconfig.RenderConfig().max_march_steps


def test_image_rays_match():
    pose = jcam.look_at_poses(1, radius=3.2, seed=7, full_sphere=True)[0]
    np.testing.assert_array_equal(tcam.look_at_poses(1, radius=3.2, seed=7, full_sphere=True)[0],
                                  pose)
    K = np.array([[30.0, 0, 12.0], [0, 30.0, 10.0], [0, 0, 1]], np.float32)
    jr = jcam.image_rays(jnp.asarray(K), jnp.asarray(pose), 24, 20)
    tr = tcam.image_rays(torch.from_numpy(K), torch.from_numpy(pose), 24, 20)
    assert tuple(tr.origins.shape) == (20, 24, 3)
    np.testing.assert_allclose(tr.origins.numpy(), np.asarray(jr.origins), atol=1e-6)
    np.testing.assert_allclose(tr.viewdirs.numpy(), np.asarray(jr.viewdirs), atol=1e-6)


@pytest.mark.parametrize("name", ["blocks", "sphere"])
def test_scene_fields_and_gt_render_match(name):
    rng = np.random.default_rng(0)
    p = rng.uniform(-1.5, 1.5, (4096, 3)).astype(np.float32)
    js, ts = jscenes.make_scene(name), tscenes.make_scene(name)
    np.testing.assert_allclose(ts.sigma_fn(torch.from_numpy(p)).numpy(),
                               np.asarray(js.sigma_fn(jnp.asarray(p))), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts.rgb_fn(torch.from_numpy(p)).numpy(),
                               np.asarray(js.rgb_fn(jnp.asarray(p))), atol=1e-6)
    pose = jcam.look_at_poses(1, radius=3.2, seed=0, full_sphere=True)[0]
    K = jnp.asarray([[12.8, 0, 8.0], [0, 12.8, 8.0], [0, 0, 1]])
    rays = jcam.image_rays(K, jnp.asarray(pose), 16, 16)
    o = np.array(rays.origins).reshape(-1, 3)
    d = np.array(rays.viewdirs).reshape(-1, 3)
    jrgb, jop = jscenes.render_gt_rays(js, jnp.asarray(o), jnp.asarray(d), 128)
    trgb, top = tscenes.render_gt_rays(ts, torch.from_numpy(o), torch.from_numpy(d), 128)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), atol=1e-4)
    np.testing.assert_allclose(top.numpy(), np.asarray(jop), atol=1e-4)
    assert float(np.asarray(jop).max()) > 0.9


def test_procedural_dataset_matches():
    jd = jscenes.ProceduralDataset("sphere", n_images=2, width=12, height=12, n_steps_gt=64)
    td = tscenes.ProceduralDataset("sphere", n_images=2, width=12, height=12, n_steps_gt=64,
                                   device="cpu")
    np.testing.assert_allclose(td.camtoworlds.numpy(), np.asarray(jd.camtoworlds))
    np.testing.assert_allclose(td.images.numpy(), np.asarray(jd.images), atol=1e-4)
    rays, pixels = td.fetch_rays(torch.Generator().manual_seed(0), 32)
    assert tuple(rays.origins.shape) == (32, 3) and tuple(pixels.shape) == (32, 3)


def test_metrics_match():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(tmetrics.psnr(ta, tb)),
                               float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics.ssim(ta, tb)),
                               float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-4)


def test_occupancy_state_and_size_bits():
    rng = np.random.default_rng(0)
    bins = rng.random((16, 16, 16)) < 0.1
    state = tocc.init_occ_grid([-1.5] * 3 + [1.5] * 3, 16, device="cpu")
    assert state.resolution == 16 and state.occs.shape == (4096,)
    want = jocc.occupancy_grid_size_bits(jnp.asarray(bins))
    got = tocc.occupancy_grid_size_bits(torch.from_numpy(bins))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    assert got[2] == int(want[2])


def test_sh_and_sine_embed_match():
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.sh_encode(torch.from_numpy(d), 4).numpy(),
                               np.asarray(jsh.sh_encode(jnp.asarray(d), 4)), atol=1e-6)
    np.testing.assert_allclose(tsh.sine_embed(torch.from_numpy(d), 10).numpy(),
                               np.asarray(jsh.sine_embed(jnp.asarray(d), 10)), atol=1e-5)
