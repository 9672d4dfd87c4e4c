"""cnc_torch's Trainer with the rate term (lambda > 0) against cnc_tpu's:
one whole train step with injected rays, jitter and entry windows, the
rate-update interval, `reset_state`, and a short port-only run in which the
estimated rate falls."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu import config as jconfig
from cnc_tpu.data import cameras as jcam
from cnc_tpu.models import context_models as jcm
from cnc_tpu.train import trainer as jtrainer
from cnc_torch import config as tconfig
from cnc_torch.data import scenes as tscenes
from cnc_torch.models import context_models as tcm
from cnc_torch.train import optim as toptim
from cnc_torch.train import trainer as ttrainer

from test_torch_context_tables import EKW, SAMPLED, starts_from_key
from test_torch_train import _sphere_rays


def tiny_config(ns, **train):
    """The context tests' tiny grids (Rb = occupancy resolution = 16) under
    tests/test_train.py's tiny trainer, in either package's classes."""
    return ns.CNCConfig(
        model=ns.ModelConfig(n_features_per_level=2, n_neurons=32,
                             resolutions_3d=(10, 18, 34, 66), resolutions_2d=(18, 34),
                             log2_hashmap_size=10, log2_hashmap_size_2D=8, pe_num_freqs=4),
        render=dataclasses.replace(ns.RenderConfig(), render_step_size=0.02, occ_resolution=16,
                                   sample_budget=1 << 13, march_block=32),
        train=dataclasses.replace(ns.TrainConfig(), init_batch_size=256, min_ray_bucket=256,
                                  max_ray_bucket=2048, target_sample_batch_size=1 << 13,
                                  lmbda=2e-3, warmup_iters=20, lr_milestones=(60, 80), lr=6e-3,
                                  **train),
        entropy=ns.EntropyConfig(**{**EKW, **SAMPLED, "v_ctx_cap": 1 << 15}))


def _port_trainer(cfg, dataset=None, **kw):
    entropy = tcm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d, device="cpu")
    return ttrainer.Trainer(cfg, dataset, entropy=entropy, device="cpu", **kw)


def _param_names():
    names = {("rf", k): f"tables.{k}" for k in ("xyz", "xy", "xz", "yz")}
    for mlp, layers in (("mlp_base", ("l0", "l1")), ("mlp_head", ("l0", "l1", "l2"))):
        for layer in layers:
            for leaf in ("w", "b"):
                names[("rf", mlp, layer, leaf)] = f"{mlp}.{layer}.{leaf}"
    for layer in ("l0", "l1", "l2"):
        for leaf in ("w", "b"):
            names[("ent", "ctx3d", layer, leaf)] = f"ctx3d.{layer}.{leaf}"
    for leaf in ("w", "b"):
        names[("ent", "ctx2d", "1", leaf)] = f"ctx2d.1.{leaf}"
    return names


def test_one_rate_train_step_matches_cnc_tpu():
    """The same params, occupancy grid, cache, rays, pixels, jitter and entry
    windows through cnc_tpu's `_train_step` (render, 2D-rate and 3D-rate
    gradients, then both optimizers) and the port's one backward.

    Stated tolerances.  mse 1e-6 and bits_per_param 1e-4 relative.
    Gradients: 1e-4 of each parameter's largest gradient entry (the rate
    tests' tolerance; the render part alone holds 1e-5).  Updated
    parameters: Adam's first update is lr * sign(g), so an entry moves the
    same way in both packages (1e-7) wherever its gradient is above ten times
    the gradient tolerance, and by at most 2 * lr apart where it is not."""
    jcfg, tcfg = tiny_config(jconfig), tiny_config(tconfig)
    jctx = jcm.ContextModels(jcfg.entropy, jcfg.model.grid_3d, jcfg.model.grid_2d)
    jtr = jtrainer.Trainer(jcfg, dataset=None, entropy=jctx)
    ttr = _port_trainer(tcfg)
    ttr.field.load_state_dict(ttrainer.rf.params_from_jax(
        jax.tree.map(np.array, jtr.params), tcfg.model, device="cpu").state_dict())
    ttr.ent_params.load_state_dict(ttr.entropy.ent_params_from_jax(
        jax.tree.map(np.array, jtr.ent_params)).state_dict())
    binaries = tscenes.occupancy_from_scene(tscenes.make_scene("sphere"), 16, 0.02, device="cpu")
    binaries[:4] = False                           # asymmetric along x
    ttr.occ_state = ttr.occ_state._replace(binaries=binaries)
    jtr.occ_state = jtr.occ_state._replace(binaries=jnp.asarray(binaries.numpy()))
    jcache = jctx.refresh_cache(jtr.occ_state.binaries)
    tcache = ttr.entropy.refresh_cache(binaries)
    o, d, pix = _sphere_rays(16, np.random.default_rng(0))
    key = jax.random.PRNGKey(9)
    u = np.array(jax.random.uniform(key, (o.shape[0],)))
    rays = jcam.Rays(origins=jnp.asarray(o), viewdirs=jnp.asarray(d))

    # cnc_tpu's gradients, as `_train_step` sums them, then the step itself
    scale = jtr._rate_scale()
    g_rf, _ = jtr._render_grad_fn(o.shape[0])(
        jtr.params, jtr.occ_state.binaries, rays.origins, rays.viewdirs, jnp.asarray(pix),
        jnp.ones(3), key)
    (g2, ge2), _ = jtr._rate2d_grad_fn()(jtr.params, jtr.ent_params, scale, key, jcache,
                                         jctx.table_arrays)
    (g3, ge3), _ = jtr._rate3d_grad_fn()(jtr.params, jtr.ent_params, scale, key, jcache,
                                         jctx.table_arrays)
    jgrads = {"rf": jax.tree.map(lambda a, b, c: a + b + c, g_rf, g2, g3),
              "ent": jax.tree.map(jnp.add, ge2, ge3)}
    jaux = jtr._train_step(o.shape[0], rays, jnp.asarray(pix), jnp.ones(3), key, jcache)
    jnew = {"rf": jtr.params, "ent": jtr.ent_params}

    taux = ttr._train_step(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(pix),
                           torch.ones(3), jitter=torch.from_numpy(u), ent_cache=tcache,
                           starts=starts_from_key(ttr.entropy, key))
    assert int(taux["n_marched"]) == int(jaux["n_marched"]) > 500
    np.testing.assert_allclose(float(taux["mse"]), float(jaux["mse"]), rtol=1e-6)
    for k in ("bits_per_param", "embed_MB", "ctx_util"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, err_msg=k)
    assert 0.0 < float(taux["bits_per_param"]) < 4.0

    lr0 = toptim.reference_schedule(tcfg.train)(0)
    tparams = {"rf": dict(ttr.field.named_parameters()),
               "ent": dict(ttr.ent_params.named_parameters())}
    names = _param_names()
    assert len(names) == len(tparams["rf"]) + len(tparams["ent"]) == 22
    for jkey, tname in names.items():
        jg, jn = jgrads[jkey[0]], jnew[jkey[0]]
        for k in jkey[1:]:
            jg, jn = jg[k], jn[k]
        jg, jn = np.asarray(jg), np.asarray(jn)
        tol = 1e-4 * np.abs(jg).max()
        assert tol > 0, tname
        tparam = tparams[jkey[0]][tname]
        np.testing.assert_allclose(tparam.grad.numpy(), jg, atol=tol, rtol=0, err_msg=tname)
        tnew = tparam.detach().numpy()
        stable = np.abs(jg) > 10 * tol
        assert stable.any(), tname
        np.testing.assert_allclose(tnew[stable], jn[stable], atol=1e-7, rtol=0, err_msg=tname)
        np.testing.assert_allclose(tnew, jn, atol=2.001 * lr0, rtol=0, err_msg=tname)
    lr1 = toptim.reference_schedule(tcfg.train)(1)
    assert ttr.optimizer.param_groups[0]["lr"] == ttr.opt_ent.param_groups[0]["lr"] == lr1
    assert ttr.opt_ent.param_groups[0]["weight_decay"] == 0.0


def test_rate_update_interval_skips_the_entropy_optimizer():
    """With rate_update_interval = 2 the odd steps take no rate term: the
    context MLPs, their Adam state and their schedule stay untouched, and
    the rate weight doubles."""
    cfg = tiny_config(tconfig, rate_update_interval=2)
    ds = tscenes.ProceduralDataset("sphere", n_images=4, width=32, height=32, n_steps_gt=128,
                                   device="cpu")
    tr = _port_trainer(cfg, ds)
    base = tiny_config(tconfig)
    assert tr._rate_scale() == 2 * _port_trainer(base)._rate_scale() \
        == 2e-3 * 2 / tr.entropy.total_param_count
    seen = []

    def snapshot(step, aux):
        seen.append(("bits_per_param" in aux,
                     [p.detach().clone() for p in tr.ent_params.parameters()],
                     float(tr.opt_ent.state_dict()["state"][0]["step"]),
                     tr.opt_ent.param_groups[0]["lr"]))

    tr.fit(max_steps=3, log_every=0, step_callback=snapshot)
    assert [s[0] for s in seen] == [True, False, True, False]
    for even, odd in ((0, 1), (2, 3)):
        assert all(torch.equal(a, b) for a, b in zip(seen[even][1], seen[odd][1]))
        assert float(seen[even][2]) == float(seen[odd][2]) and seen[even][3] == seen[odd][3]
    assert not all(torch.equal(a, b) for a, b in zip(seen[1][1], seen[2][1]))
    assert [float(s[2]) for s in seen] == [1, 1, 2, 2]
    sched = toptim.reference_schedule(cfg.train)
    assert seen[3][3] == sched(2) and tr.optimizer.param_groups[0]["lr"] == sched(4)


def test_rate_falls_in_a_short_run_and_reset_state_restarts_it():
    """Port only: 40 steps on the sphere scene; the estimated rate falls, the
    render loss too, and the log line carries the rate."""
    cfg = tiny_config(tconfig)
    ds = tscenes.ProceduralDataset("sphere", n_images=8, width=48, height=48, n_steps_gt=256,
                                   device="cpu")
    tr = _port_trainer(cfg, ds)
    hist, lines = [], []
    tr.fit(max_steps=39, log_every=20, log_fn=lines.append,
           step_callback=lambda s, aux: hist.append(
               (float(aux["mse"]), float(aux["bits_per_param"]), float(aux["embed_MB"]),
                float(aux["ctx_util"]))))
    hist = np.asarray(hist)
    assert hist.shape == (40, 4) and np.all(np.isfinite(hist))
    assert hist[-5:, 1].mean() < hist[16, 1] < 0.5 * hist[0, 1]
    assert hist[-5:, 0].mean() < hist[:5, 0].mean()
    np.testing.assert_allclose(hist[:, 2], hist[:, 1] * tr.entropy.total_param_count / 8 / 2 ** 20,
                               rtol=1e-5)
    assert np.all(hist[:, 3] > 0)
    assert len(lines) == 2 and all("bits_per_param=" in m and "ctx_util=" in m for m in lines)
    cache = tr._last_ent_cache
    assert cache is not None and bool(cache["mask3d"].any())
    # the cache follows the occupancy grid of the last update
    fresh = tr.entropy.refresh_cache(tr.occ_state.binaries)
    assert torch.equal(cache["mask3d"], fresh["mask3d"])

    first = []
    tr.reset_state()
    assert tr.step == 0 and tr._last_ent_cache is None
    tr.fit(max_steps=0, log_every=0,
           step_callback=lambda s, aux: first.append(float(aux["bits_per_param"])))
    assert first == [hist[0, 1]]
    tr.reset_state(lmbda=0.0, rate_update_interval=4)
    assert tr.cfg.train.lmbda == 0.0 and tr.cfg.train.rate_update_interval == 4
    aux = []
    tr.fit(max_steps=0, log_every=0, step_callback=lambda s, a: aux.append(a))
    assert "bits_per_param" not in aux[0]            # lambda = 0: no rate term


def test_trainer_and_entropy_model_share_a_device():
    cfg = tiny_config(tconfig)
    tr = _port_trainer(cfg)
    assert tr.entropy.device == tr.device == torch.device("cpu")

    class Elsewhere:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="lives on"):
        ttrainer.Trainer(cfg, None, entropy=Elsewhere(), device="cpu")
