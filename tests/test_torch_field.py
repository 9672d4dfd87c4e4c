"""cnc_torch's radiance field against cnc_tpu's, with the same params."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.config import ModelConfig
from cnc_tpu.models import radiance_field as jrf
from cnc_torch.config import ModelConfig as TModelConfig
from cnc_torch.models import radiance_field as trf
from cnc_torch.ops import ste

SMALL = dict(n_features_per_level=2, n_neurons=32, resolutions_3d=(10, 18, 34),
             resolutions_2d=(18, 34), log2_hashmap_size=10, log2_hashmap_size_2D=10,
             pe_num_freqs=4)
AABB = np.asarray([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("unbounded", [False, True], ids=["bounded", "unbounded"])
def test_forward_matches_cnc_tpu(unbounded):
    jcfg = ModelConfig(**SMALL, unbounded=unbounded)
    tcfg = TModelConfig(**SMALL, unbounded=unbounded)
    params = jrf.init_radiance_field(jax.random.PRNGKey(0), jcfg)
    field = trf.params_from_jax(_np_tree(params), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    span = 4.0 if unbounded else 1.45
    pos = rng.uniform(-span, span, (512, 3)).astype(np.float32)
    dirs = rng.normal(size=(512, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb_j, sig_j = jrf.forward(params, jcfg, jnp.asarray(AABB), jnp.asarray(pos),
                               jnp.asarray(dirs))
    with torch.no_grad():
        rgb_t, sig_t = field(torch.from_numpy(AABB), torch.from_numpy(pos),
                             torch.from_numpy(dirs))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=1e-5, rtol=1e-5)
    assert float(np.asarray(sig_j).max()) > 0


def test_param_layout_and_shape_check():
    tcfg = TModelConfig(**SMALL)
    field = trf.RadianceField(tcfg, torch.Generator().manual_seed(3), device="cpu")
    assert field.mlp_base["l0"].w.shape == trf.mlp_dims(tcfg)[:1] + (tcfg.n_neurons,)
    assert set(trf.split_mlp_params(field)) == {
        f"mlp_{m}.l{i}.{p}" for m, n in (("base", 2), ("head", 3)) for i in range(n)
        for p in "wb"}
    bad = {k: np.asarray(v.detach()) for k, v in field.tables.items()}
    bad["xyz"] = bad["xyz"][:-8]
    with pytest.raises(ValueError, match="xyz"):
        trf.params_from_jax({**bad, "mlp_base": {}, "mlp_head": {}}, tcfg, device="cpu")


def test_ste_gradients_match_cnc_tpu():
    x = np.array([-2.0, -1.0, -0.3, 0.0, 0.4, 1.0, 1.5], np.float32)
    tx = torch.tensor(x, requires_grad=True)
    ste.ste_binary(tx).sum().backward()
    from cnc_tpu.ops import ste as jste
    jg = jax.grad(lambda v: jnp.sum(jste.ste_binary(v)))(jnp.asarray(x))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ste.ste_binary(torch.tensor(x)).numpy(),
                                  np.asarray(jste.ste_binary(jnp.asarray(x))))
    tx = torch.tensor(x, requires_grad=True)
    ste.trunc_exp(tx * 10).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jste.trunc_exp(v * 10)))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(ste.ste_multistep(torch.tensor(x), 10.0).numpy(),
                               np.asarray(jste.ste_multistep(jnp.asarray(x), 10.0)))


def test_replace_tables_swaps_in_place():
    tcfg = TModelConfig(**SMALL)
    field = trf.RadianceField(tcfg, device="cpu")
    new = {k: torch.full_like(v, 0.5) for k, v in field.tables.items()}
    before = field.mlp_base["l0"].w.clone()
    trf.replace_tables(field, new)
    for k in trf.TABLES:
        assert torch.equal(field.tables[k], new[k])
    assert torch.equal(field.mlp_base["l0"].w, before)
    q = trf.quantized_tables(field, tcfg)
    assert all(bool((t == 1.0).all()) for t in q.values())
