"""Unbounded scenes in cnc_torch: the gradient of the field through the
mip-NeRF 360 contraction against jax.grad of cnc_tpu's at
ModelConfig(unbounded=True), and a three-step trainer smoke as
tests/test_unbounded.py runs cnc_tpu's.

Tolerance: each parameter's gradient within 1e-5 of its largest jax.grad
entry (float32 sums in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.config import ModelConfig
from cnc_tpu.models import radiance_field as jrf
from cnc_torch import config as tconfig
from cnc_torch.config import ModelConfig as TModelConfig
from cnc_torch.data.scenes import ProceduralDataset
from cnc_torch.models import radiance_field as trf
from cnc_torch.train.trainer import Trainer

SMALL = dict(n_features_per_level=2, n_neurons=32, resolutions_3d=(10, 18, 34),
             resolutions_2d=(18, 34), log2_hashmap_size=10, log2_hashmap_size_2D=8,
             pe_num_freqs=4, unbounded=True)
AABB = np.asarray([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)


def test_unbounded_gradients_match_jax_grad():
    jcfg, tcfg = ModelConfig(**SMALL), TModelConfig(**SMALL)
    params = jrf.init_radiance_field(jax.random.PRNGKey(3), jcfg)
    # tables of +-1 entries, as the binarized field holds, so the density
    # is far from 0 and every branch carries gradient
    rng = np.random.default_rng(0)
    for k in ("xyz", "xy", "xz", "yz"):
        params[k] = jnp.asarray(rng.uniform(-1, 1, params[k].shape).astype(np.float32))
    field = trf.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    pos = rng.uniform(-5.0, 5.0, (400, 3)).astype(np.float32)   # most beyond the box
    pos[:40] = rng.uniform(-1.0, 1.0, (40, 3))                  # some inside the ball
    dirs = rng.normal(size=(400, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cot_rgb = rng.normal(size=(400, 3)).astype(np.float32)
    cot_sig = rng.normal(size=400).astype(np.float32)

    def loss(p):
        rgb, sig = jrf.forward(p, jcfg, jnp.asarray(AABB), jnp.asarray(pos), jnp.asarray(dirs))
        return jnp.sum(rgb * cot_rgb) + jnp.sum(sig * cot_sig)

    want = jax.grad(loss)(params)
    rgb, sig = field(torch.from_numpy(AABB), torch.from_numpy(pos), torch.from_numpy(dirs))
    ((rgb * torch.from_numpy(cot_rgb)).sum() + (sig * torch.from_numpy(cot_sig)).sum()).backward()
    got = dict(field.named_parameters())
    checked = 0
    for name, p in got.items():
        w = want
        for k in name.replace("tables.", "").split("."):
            w = w[k]
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-5 * scale, rtol=0, err_msg=name)
        checked += 1
    assert checked == 14


def test_unbounded_trainer_smoke():
    mcfg = tconfig.ModelConfig(n_features_per_level=2, n_neurons=32,
                               resolutions_3d=(10, 18, 34, 66), resolutions_2d=(18, 34),
                               log2_hashmap_size=10, log2_hashmap_size_2D=8, pe_num_freqs=4,
                               unbounded=True)
    cfg = tconfig.CNCConfig(
        model=mcfg,
        render=dataclasses.replace(tconfig.RenderConfig(), occ_resolution=16,
                                   render_step_size=0.05, sample_budget=1 << 12, march_block=16),
        train=dataclasses.replace(tconfig.TrainConfig(), lmbda=0.0, init_batch_size=256,
                                  min_ray_bucket=256, max_ray_bucket=1024))
    ds = ProceduralDataset("blocks", n_images=4, width=48, height=48, n_steps_gt=64,
                           device="cpu")
    tr = Trainer(cfg, ds, device="cpu")
    losses = []
    tr.fit(max_steps=3, log_every=0, step_callback=lambda s, aux: losses.append(float(aux["mse"])))
    assert tr.step == 4 and len(losses) == 4 and all(np.isfinite(losses))
    assert all(bool(p.isfinite().all()) for p in tr.field.parameters())
