"""cnc_torch's training march (jittered) and render_rays_train against
cnc_tpu, with cnc_tpu's own jitter draws injected into the port.

The jittered sample sets must be identical (same ray ids, same t bits);
rendered rays agree to 1e-4 absolute, the margin test_torch_slice.py states
for images.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.config import ModelConfig, RenderConfig
from cnc_tpu.data import cameras as jcam
from cnc_tpu.models import radiance_field as jrf
from cnc_tpu.render import marching as jmarch
from cnc_tpu.render import renderer as jrenderer
from cnc_torch.config import ModelConfig as TModelConfig
from cnc_torch.config import RenderConfig as TRenderConfig
from cnc_torch.data import scenes as tscenes
from cnc_torch.models import radiance_field as trf
from cnc_torch.render import marching as tmarch
from cnc_torch.render import renderer as trenderer

SMALL = dict(n_features_per_level=2, n_neurons=32, resolutions_3d=(10, 18, 34),
             resolutions_2d=(18, 34), log2_hashmap_size=10, log2_hashmap_size_2D=10,
             pe_num_freqs=4)
RKW = dict(render_step_size=0.02, occ_resolution=64, sample_budget=8192)
AABB = np.asarray([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)


def _binaries():
    return tscenes.occupancy_from_scene(tscenes.make_scene("sphere"), 64, 0.02,
                                        device="cpu").numpy()


def _rays(n_side=24):
    poses = jcam.look_at_poses(1, radius=3.0)
    K = jnp.asarray([[30.0, 0, n_side / 2], [0, 30.0, n_side / 2], [0, 0, 1]])
    rays = jcam.image_rays(K, jnp.asarray(poses[0]), n_side, n_side)
    return (np.array(rays.origins).reshape(-1, 3), np.array(rays.viewdirs).reshape(-1, 3))


@pytest.mark.parametrize("capacity,with_start", [(1 << 15, False), (2048, False), (1 << 15, True)],
                         ids=["fits", "truncated", "with_cursor"])
def test_jittered_march_identical(capacity, with_start):
    o, d = _rays()
    binaries = _binaries()
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (o.shape[0],)))
    t_start = (np.random.default_rng(0).uniform(0, 3, o.shape[0]).astype(np.float32)
               if with_start else None)
    rcfg, trcfg = (dataclasses.replace(c(), **RKW) for c in (RenderConfig, TRenderConfig))
    # eager, as tests/test_torch_render.py compares the plain march: under jit
    # XLA's CPU backend contracts tmin + (step+0.5)*dt to an FMA, an ulp away
    js = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(binaries),
                           jnp.asarray(AABB), key, rcfg, capacity,
                           t_start=None if t_start is None else jnp.asarray(t_start))
    ts = tmarch.march_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(binaries),
                           torch.from_numpy(AABB), trcfg, capacity,
                           t_start=None if t_start is None else torch.from_numpy(t_start),
                           jitter=torch.from_numpy(u))
    np.testing.assert_array_equal(ts.ray_id.numpy(), np.asarray(js.ray_id))
    np.testing.assert_array_equal(ts.t_mid.numpy(), np.asarray(js.t_mid))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert int(ts.resume_ray) == int(js.resume_ray)
    assert int(ts.num_samples) == int(js.num_samples)
    assert bool(ts.truncated) == bool(js.truncated) == (capacity == 2048)
    assert int(ts.valid.sum()) > 500
    # the jitter really moved the lattice
    plain = tmarch.march_rays(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(binaries), torch.from_numpy(AABB), trcfg,
                              capacity,
                              t_start=None if t_start is None else torch.from_numpy(t_start))
    assert not torch.equal(plain.t_mid, ts.t_mid)


@pytest.fixture(scope="module")
def field_setup():
    mcfg = ModelConfig(**SMALL)
    params = jrf.init_radiance_field(jax.random.PRNGKey(0), mcfg)
    # a dense field, so transmittance falls below early_stop_eps inside the sphere
    params["mlp_base"]["l1"]["b"] = params["mlp_base"]["l1"]["b"].at[0].add(5.0)
    field = trf.params_from_jax(jax.tree.map(np.asarray, params), TModelConfig(**SMALL),
                                device="cpu")
    return params, field


# visible_frac: off; roomy (nothing pruned away); tight (the pruned buffer overflows)
@pytest.mark.parametrize("visible_frac", [None, 0.9, 0.02],
                         ids=["no_prefilter", "roomy", "overflow"])
def test_render_rays_train_matches_cnc_tpu(field_setup, visible_frac):
    params, field = field_setup
    o, d = _rays()
    binaries = _binaries()
    key = jax.random.PRNGKey(11)
    u = np.array(jax.random.uniform(key, (o.shape[0],)))
    kw = dict(RKW, visible_frac=visible_frac)
    rcfg, trcfg = (dataclasses.replace(c(), **kw) for c in (RenderConfig, TRenderConfig))
    # jitted: eager dispatch compiles each of cnc_tpu's ops on its own (27 s)
    want = jax.jit(lambda p, bb, oo, dd, k: jrenderer.render_rays_train(
        p, ModelConfig(**SMALL), rcfg, jnp.asarray(AABB), bb, oo, dd, k, jnp.ones(3)))(
            params, jnp.asarray(binaries), jnp.asarray(o), jnp.asarray(d), key)
    got = trenderer.render_rays_train(field, TModelConfig(**SMALL), trcfg,
                                      torch.from_numpy(AABB), torch.from_numpy(binaries),
                                      torch.from_numpy(o), torch.from_numpy(d), None,
                                      torch.ones(3), jitter=torch.from_numpy(u))
    assert int(got.n_marched_samples) == int(want.n_marched_samples) > 1000
    assert int(got.n_rendering_samples) == int(want.n_rendering_samples) > 100
    if visible_frac is None:
        assert got.resume_ray is None and want.resume_ray is None
        keep = np.ones(o.shape[0], bool)
    else:
        assert int(got.resume_ray) == int(want.resume_ray)
        overflow = int(want.n_rendering_samples) > trcfg.visible_capacity
        assert overflow == (visible_frac == 0.02)
        assert (int(got.resume_ray) < o.shape[0]) == overflow
        keep = np.arange(o.shape[0]) < int(want.resume_ray)
    for name in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), atol=1e-4, rtol=0,
                                   err_msg=name)
    assert float(np.asarray(want.opacity)[keep].max()) > 0.9
    # the generator path draws its own jitter and renders the same scene
    own = trenderer.render_rays_train(field, TModelConfig(**SMALL), trcfg,
                                      torch.from_numpy(AABB), torch.from_numpy(binaries),
                                      torch.from_numpy(o), torch.from_numpy(d),
                                      torch.Generator().manual_seed(0), torch.ones(3))
    assert own.rgb.requires_grad
    assert float((own.opacity.detach() - got.opacity.detach()).abs().mean()) < 0.05
