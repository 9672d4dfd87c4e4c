"""cnc_torch's MLP fields (models/mlp_fields.py: vanilla NeRF, T-NeRF, NDR)
against cnc_tpu through weights carried over from a cnc_tpu init dict.

Tolerances: outputs within 1e-5 of the largest output magnitude (float32
products of 256-wide layers summed in another order); every parameter's
gradient within 1e-4 of that leaf's largest jax.grad entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.models import mlp_fields as jmlp
from cnc_torch.models import mlp_fields as tmlp
from cnc_torch.models import radiance_field as trf


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _split_meta(params):
    """(float leaves, a function putting the meta back): jax.grad takes
    float leaves only."""
    p = dict(params)
    if "nerf" in p:
        nerf = dict(p["nerf"])
        meta = nerf.pop("meta")
        p["nerf"] = nerf
        return p, lambda q: {**q, "nerf": {**q["nerf"], "meta": meta}}
    meta = p.pop("meta")
    return p, lambda q: {**q, "meta": meta}


def _flat(tree, prefix=""):
    """{"a": [{"w": x}]} -> {"a.0.w": x}, the module's parameter names."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _inputs(n, seed, with_t):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.random((n, 1)).astype(np.float32) if with_t else None
    return x, d, t


def _check(jfwd, jparams, module, tfwd, x, d, t, seed):
    cot_rgb = np.random.default_rng(seed).standard_normal((x.shape[0], 3)).astype(np.float32)
    cot_sig = np.random.default_rng(seed + 1).standard_normal(x.shape[0]).astype(np.float32)
    args_j = [jnp.asarray(x), jnp.asarray(d)] + ([jnp.asarray(t)] if t is not None else [])
    args_t = [torch.from_numpy(x), torch.from_numpy(d)] + (
        [torch.from_numpy(t)] if t is not None else [])
    rgb_j, sig_j = jfwd(jparams, *args_j)
    rgb_t, sig_t = tfwd(module, *args_t)
    for a, b in ((rgb_t, rgb_j), (sig_t, sig_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-5 * max(1.0, np.abs(b).max()),
                                   rtol=0)
    floats, put_back = _split_meta(jparams)

    def loss(q):
        rgb, sig = jfwd(put_back(q), *args_j)
        return jnp.sum(rgb * cot_rgb) + jnp.sum(sig * cot_sig)

    want = _flat(jax.grad(loss)(floats))
    ((rgb_t * torch.from_numpy(cot_rgb)).sum() + (sig_t * torch.from_numpy(cot_sig)).sum()
     ).backward()
    got = {k: p.grad.numpy() for k, p in module.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 * max(scale, 1e-6), rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("time_input", [False, True], ids=["nerf", "tnerf"])
def test_vanilla_and_tnerf_match_cnc_tpu(time_input):
    jp = jmlp.init_vanilla_nerf(jax.random.PRNGKey(1), net_depth=6, net_width=64,
                                skip_layer=2, time_input=time_input)
    module = trf.params_from_jax(_np_tree(jp), None, device="cpu")
    assert isinstance(module, tmlp.VanillaNeRF) and module.time_input == time_input
    x, d, t = _inputs(128, 2, time_input)
    _check(jmlp.forward, jp, module, tmlp.forward, x, d, t, 3)


def test_full_width_vanilla_forward():
    """The default 8x256 trunk with its skip, forward only."""
    jp = jmlp.init_vanilla_nerf(jax.random.PRNGKey(4))
    module = trf.params_from_jax(_np_tree(jp), None, device="cpu")
    assert len(module.trunk) == 8 and module.trunk[5].w.shape == (256 + 63, 256)
    x, d, _ = _inputs(64, 5, False)
    rgb_j, sig_j = jmlp.forward(jp, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        rgb_t, sig_t = module(torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j),
                               atol=1e-5 * max(1.0, float(np.abs(sig_j).max())), rtol=0)


def test_ndr_matches_cnc_tpu():
    jp = jmlp.init_ndr_nerf(jax.random.PRNGKey(6))
    module = trf.params_from_jax(_np_tree(jp), None, device="cpu")
    assert isinstance(module, tmlp.NDRField)
    x, d, t = _inputs(96, 7, True)
    np.testing.assert_allclose(
        tmlp.ndr_warp(module, torch.from_numpy(x), torch.from_numpy(t)).detach().numpy(),
        np.asarray(jmlp.ndr_warp(jp, jnp.asarray(x), jnp.asarray(t))), atol=1e-5, rtol=0)
    _check(jmlp.ndr_forward, jp, module, tmlp.ndr_forward, x, d, t, 8)


def test_ndr_query_opacity():
    jp = jmlp.init_ndr_nerf(jax.random.PRNGKey(9))
    module = trf.params_from_jax(_np_tree(jp), None, device="cpu")
    x, _, _ = _inputs(50, 10, False)
    # one timestamp repeated: the draw cannot matter, so the two packages agree
    stamps = np.full(4, 0.3, np.float32)
    want = np.asarray(jmlp.ndr_query_opacity(jp, jax.random.PRNGKey(0), jnp.asarray(x),
                                             jnp.asarray(stamps), 0.01))
    g = torch.Generator().manual_seed(0)
    got = tmlp.ndr_query_opacity(module, g, torch.from_numpy(x), torch.from_numpy(stamps), 0.01)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=1e-5 * max(1e-2, float(np.abs(want).max())), rtol=0)
    # distinct timestamps: each point's value is its density at one of them
    stamps = np.asarray([0.0, 0.5, 1.0], np.float32)
    got = tmlp.ndr_query_opacity(module, torch.Generator().manual_seed(1), torch.from_numpy(x),
                                 torch.from_numpy(stamps), 0.01).detach()
    xs = torch.from_numpy(x)
    each = torch.stack([tmlp.ndr_query_density(module, xs, torch.full((50, 1), float(s)))
                        for s in stamps], -1).detach() * 0.01
    assert bool(((each - got[:, None]).abs().min(-1).values <= 1e-6).all())


def test_random_init_and_shapes():
    g = torch.Generator().manual_seed(0)
    nerf = tmlp.VanillaNeRF(g, device="cpu")
    assert nerf.trunk[0].w.shape == (63, 256) and nerf.rgb0.w.shape == (256 + 27, 128)
    ndr = tmlp.NDRField(torch.Generator().manual_seed(0), device="cpu")
    out = ndr.blocks[0]["warp1"].out
    w = out.w.detach()
    assert w.shape == (128, 1) and float(w.min()) >= 0 and float(w.max()) <= 1e-4
    x = torch.rand(10, 3)
    # the warp starts at about the identity
    assert float((tmlp.ndr_warp(ndr, x, torch.rand(10, 1)).detach() - x).abs().max()) < 1e-2
