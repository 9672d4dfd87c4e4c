"""cnc_torch's checkpoint save/resume against cnc_tpu's: the key layout, a
cnc_tpu checkpoint loaded into the port (every leaf, moment, count and the
learning rate, then one whole step in each package), a port checkpoint
loaded into cnc_tpu, a resumed port run bit-equal to an unbroken one, the
periodic cadence and the load in place after `reset_state`.

The configurations are tests/test_pipeline.py:tiny_rd_config and
tests/test_utils.py:tiny_cfg, in either package's classes."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu import config as jconfig
from cnc_tpu.data import cameras as jcam
from cnc_tpu.data import scenes as jscenes
from cnc_tpu.train import driver as jdriver
from cnc_tpu.train import optim as joptim
from cnc_tpu.train import trainer as jtrainer
from cnc_tpu.utils import checkpoint as jckpt
from cnc_torch import config as tconfig
from cnc_torch.data import scenes as tscenes
from cnc_torch.models import context_models as tcm
from cnc_torch.train import optim as toptim
from cnc_torch.train import trainer as ttrainer
from cnc_torch.utils import checkpoint as tckpt

from test_torch_context_tables import starts_from_key
from test_torch_train import _sphere_rays

PORT_ONLY_KEYS = {"torch_generator", "torch_generator_device"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores: this
    module's many small torch ops run on one thread (restored after it), as
    tests/test_torch_codec_slice.py's do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_rd_config(ns, **train):
    """tests/test_pipeline.py:tiny_rd_config, in either package's classes."""
    return ns.CNCConfig(
        model=ns.ModelConfig(n_features_per_level=2, n_neurons=32,
                             resolutions_3d=(10, 18, 34, 66), resolutions_2d=(18, 34),
                             log2_hashmap_size=10, log2_hashmap_size_2D=8, pe_num_freqs=4),
        entropy=ns.EntropyConfig(n_features=2, sample_num=256, max_context_layer_num=2,
                                 Pg_level=4, Pg_level_2D=2, skip_levels_3d=(0, 1),
                                 skip_levels_2d=(0,), Rb=16, pn_coords_cap=1 << 14,
                                 pn_frac_sample_cap=None, sample_num_2d=128, v_ctx_cap=1 << 11,
                                 max_points_per_chunk=1 << 14),
        render=dataclasses.replace(ns.RenderConfig(), render_step_size=0.05, occ_resolution=16,
                                   occ_warmup_steps=8, sample_budget=1 << 10, march_block=16,
                                   eval_chunk_rays=1024),
        train=dataclasses.replace(ns.TrainConfig(), init_batch_size=128, min_ray_bucket=128,
                                  max_ray_bucket=512, target_sample_batch_size=1 << 10,
                                  lmbda=2e-3, warmup_iters=10, lr_milestones=(30,), lr=6e-3,
                                  **train))


def tiny_cfg(ns, **train):
    """tests/test_utils.py:tiny_cfg, in either package's classes."""
    return ns.CNCConfig(
        model=ns.ModelConfig(n_features_per_level=2, n_neurons=32, resolutions_3d=(10, 18),
                             resolutions_2d=(18,), log2_hashmap_size=9, log2_hashmap_size_2D=8,
                             pe_num_freqs=2),
        render=dataclasses.replace(ns.RenderConfig(), occ_resolution=16, render_step_size=0.05,
                                   sample_budget=1 << 10),
        train=dataclasses.replace(ns.TrainConfig(), lmbda=0.0, init_batch_size=64,
                                  min_ray_bucket=64, max_ray_bucket=256,
                                  target_sample_batch_size=1 << 10, **train))


def _with_lmbda(cfg, lmbda):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, lmbda=lmbda))


def _port_dataset(n=4, side=32):
    return tscenes.ProceduralDataset("sphere", n_images=n, width=side, height=side,
                                     n_steps_gt=64, device="cpu")


def _load(path):
    with np.load(path, allow_pickle=False) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.fixture(scope="module")
def port_ctx():
    cfg = tiny_rd_config(tconfig)
    return tcm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d, device="cpu")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """cnc_tpu's trainer after four lambda = 2e-3 steps, and its checkpoint."""
    cfg = tiny_rd_config(jconfig)
    ds = jscenes.ProceduralDataset("sphere", n_images=4, width=32, height=32, n_steps_gt=64)
    jctx = jdriver.build_entropy(cfg)
    jtr = jtrainer.Trainer(cfg, ds, entropy=jctx)
    jtr.fit(max_steps=3, log_every=0)
    path = str(tmp_path_factory.mktemp("jax") / "ck.npz")
    jckpt.save_checkpoint(path, jtr)
    return dict(cfg=cfg, jctx=jctx, jtr=jtr, path=path)


def _port_leaves(tr):
    """The port trainer's state by checkpoint key, as numpy."""
    out = {}
    for prefix, module, opt in (("params", tr.field, tr.optimizer),
                                ("ent", tr.ent_params, tr.opt_ent)):
        if module is None:
            continue
        i = 1 if opt.param_groups[0]["weight_decay"] else 0
        name = "opt_rf" if prefix == "params" else "opt_ent"
        for k, p in tckpt._named(module).items():
            out[f"{prefix}|{k}"] = p.detach().numpy()
            st = opt.state[p]
            out[f"{name}|[{i}].mu{k}"] = st["exp_avg"].numpy()
            out[f"{name}|[{i}].nu{k}"] = st["exp_avg_sq"].numpy()
            out[f"{name}|[{i}].count"] = np.asarray(int(st["step"]), np.int32)
    out["occs"] = tr.occ_state.occs.numpy()
    out["binaries"] = np.packbits(tr.occ_state.binaries.numpy().reshape(-1))
    out["step"], out["num_rays"] = np.asarray(tr.step), np.asarray(tr.num_rays)
    return out


@pytest.mark.parametrize("lmbda", [0.0, 2e-3], ids=["lmbda0", "lmbda2e-3"])
def test_keys_shapes_and_dtypes_equal_cnc_tpu(jax_run, port_ctx, tmp_path, lmbda):
    """A fresh trainer of each package, saved before its first step (the
    port writes zero moments and count 0 for torch's lazy Adam state): the
    same keys, shapes and dtypes, apart from the port's generator keys."""
    jcfg, tcfg = (_with_lmbda(tiny_rd_config(ns), lmbda) for ns in (jconfig, tconfig))
    jtr = jtrainer.Trainer(jcfg, None, entropy=jax_run["jctx"] if lmbda else None)
    ttr = ttrainer.Trainer(tcfg, None, entropy=port_ctx if lmbda else None, device="cpu")
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), jtr)
    tckpt.save_checkpoint(str(tmp_path / "t"), ttr)          # ".npz" is appended
    want, got = _load(tmp_path / "j.npz"), _load(tmp_path / "t.npz")
    assert set(got) - set(want) == PORT_ONLY_KEYS
    assert set(want) <= set(got)
    for k, v in want.items():
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k
    assert len(want) == (76 if lmbda else 50)
    np.testing.assert_array_equal(got["key"], np.asarray(jax.random.PRNGKey(42)))
    assert str(got["torch_generator_device"]) == "cpu"
    assert int(got["opt_rf|[1].count"]) == int(got["opt_rf|[2].count"]) == 0
    if lmbda:
        assert int(got["opt_ent|[0].count"]) == int(got["opt_ent|[1].count"]) == 0


def test_cnc_tpu_checkpoint_loads_and_the_next_step_agrees(jax_run, port_ctx):
    """cnc_tpu's checkpoint after four steps loads into the port with every
    leaf, moment, count and the learning rate equal.  Then the same rays,
    pixels, jitter and entry windows through cnc_tpu's gradient programs and
    apply, and through the port's `_train_step`: the gradients within
    tests/test_torch_train_rate.py's tolerance (1e-4 of each parameter's
    largest entry; mse 1e-6 and bits 1e-4 relative), and cnc_tpu's
    gradients through the port's loaded Adams give cnc_tpu's updated
    parameters (1e-6 relative plus 1e-7 absolute, as
    tests/test_torch_train.py's Adam test holds them)."""
    path, jtr, jctx = jax_run["path"], jax_run["jtr"], jax_run["jctx"]
    jckpt.load_checkpoint(path, jtr)          # the fixture's state, whatever ran before
    data = _load(path)
    tcfg = tiny_rd_config(tconfig)
    logs = []

    def loaded():
        tr = ttrainer.Trainer(tcfg, None, entropy=port_ctx, device="cpu")
        tckpt.load_checkpoint(path, tr, log_fn=logs.append)
        return tr

    ttr, ttr2 = loaded(), loaded()
    assert len(logs) == 2 and "reseeded from seed 42" in logs[0]
    leaves = _port_leaves(ttr)
    for k, v in leaves.items():
        np.testing.assert_array_equal(v, data[k], err_msg=k)
    assert int(data["opt_rf|[1].count"]) == 4 and ttr.step == 4
    for opt, sched, name in ((ttr.optimizer, ttr.scheduler, "opt_rf|[2]"),
                             (ttr.opt_ent, ttr.sched_ent, "opt_ent|[1]")):
        assert sched.last_epoch == int(data[f"{name}.count"]) == 4
        assert opt.param_groups[0]["lr"] == toptim.reference_schedule(tcfg.train)(4)
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(joptim.reference_schedule(jax_run["cfg"].train)(4)),
                                   rtol=1e-6)

    binaries = jtr.occ_state.binaries
    jcache = jctx.refresh_cache(binaries)
    tcache = port_ctx.refresh_cache(ttr.occ_state.binaries)
    o, d, pix = _sphere_rays(16, np.random.default_rng(0))
    key = jax.random.PRNGKey(9)
    u = np.array(jax.random.uniform(key, (o.shape[0],)))
    rays = jcam.Rays(origins=jnp.asarray(o), viewdirs=jnp.asarray(d))
    scale = jtr._rate_scale()
    g_rf, jaux = jtr._render_grad_fn(o.shape[0])(
        jtr.params, binaries, rays.origins, rays.viewdirs, jnp.asarray(pix), jnp.ones(3), key)
    (g2, ge2), bits2 = jtr._rate2d_grad_fn()(jtr.params, jtr.ent_params, scale, key, jcache,
                                             jctx.table_arrays)
    (g3, ge3), (bits3, _) = jtr._rate3d_grad_fn()(jtr.params, jtr.ent_params, scale, key,
                                                  jcache, jctx.table_arrays)
    g_rate = jax.tree.map(jnp.add, g2, g3)
    g_ent = jax.tree.map(jnp.add, ge2, ge3)
    new_rf, new_ent, _, _ = jtr._apply_fn(True)(jtr.params, jtr.ent_params, jtr.opt_state_rf,
                                                jtr.opt_state_ent, g_rf, g_rate, g_ent)
    jgrads = {"params": jax.tree.map(jnp.add, g_rf, g_rate), "ent": g_ent}
    jnew = {"params": new_rf, "ent": new_ent}

    taux = ttr._train_step(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(pix),
                           torch.ones(3), jitter=torch.from_numpy(u), ent_cache=tcache,
                           starts=starts_from_key(port_ctx, key))
    assert int(taux["n_marched"]) == int(jaux["n_marched"]) > 100
    np.testing.assert_allclose(float(taux["mse"]), float(jaux["mse"]), rtol=1e-6)
    np.testing.assert_allclose(float(taux["bits_per_param"]) * port_ctx.total_param_count,
                               float(bits2 + bits3), rtol=1e-4)

    lr = toptim.reference_schedule(tcfg.train)(4)
    for prefix, tr_mod, tr2_mod in (("params", ttr.field, ttr2.field),
                                    ("ent", ttr.ent_params, ttr2.ent_params)):
        named, named2 = tckpt._named(tr_mod), tckpt._named(tr2_mod)
        for k, p in named.items():
            path_ = [s for s in k.replace("['", "|").replace("']", "").split("|") if s]
            jg, jn = jgrads[prefix], jnew[prefix]
            for s in path_:
                jg, jn = jg[s], jn[s]
            jg, jn = np.asarray(jg), np.asarray(jn)
            tol = 1e-4 * np.abs(jg).max()
            assert tol > 0, k
            np.testing.assert_allclose(p.grad.numpy(), jg, atol=tol, rtol=0, err_msg=k)
            # an Adam update is at most about lr in size (|m_hat| / sqrt(v_hat)
            # <= 1.01 after five steps), so the two steps end within 2.05 lr
            np.testing.assert_allclose(p.detach().numpy(), jn, atol=2.05 * lr, rtol=0,
                                       err_msg=k)
            named2[k].grad = torch.from_numpy(jg.copy())
    for opt, sched in ((ttr2.optimizer, ttr2.scheduler), (ttr2.opt_ent, ttr2.sched_ent)):
        opt.step()
        sched.step()
    for prefix, mod in (("params", ttr2.field), ("ent", ttr2.ent_params)):
        for k, p in tckpt._named(mod).items():
            jn = jnew[prefix]
            for s in [s for s in k.replace("['", "|").replace("']", "").split("|") if s]:
                jn = jn[s]
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jn), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    assert ttr2.optimizer.param_groups[0]["lr"] == toptim.reference_schedule(tcfg.train)(5)


def test_port_checkpoint_loads_into_cnc_tpu_and_trains_on(jax_run, port_ctx, tmp_path):
    """A port run's checkpoint after four steps: the same keys as cnc_tpu's
    own, every leaf, moment and count equal once cnc_tpu loads it, and
    cnc_tpu trains two more steps from it."""
    tcfg = tiny_rd_config(tconfig)
    ttr = ttrainer.Trainer(tcfg, _port_dataset(), entropy=port_ctx, device="cpu")
    ttr.fit(max_steps=3, log_every=0)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, ttr)
    got = _load(path)
    assert set(got) - PORT_ONLY_KEYS == set(_load(jax_run["path"]))

    jtr = jax_run["jtr"]
    jckpt.load_checkpoint(path, jtr)
    want = dict(jckpt._flatten(jtr.params, "params"))
    want.update(jckpt._flatten(jtr.ent_params, "ent"))
    want.update(jckpt._flatten(jtr.opt_state_rf, "opt_rf"))
    want.update(jckpt._flatten(jtr.opt_state_ent, "opt_ent"))
    want["occs"] = np.asarray(jtr.occ_state.occs)
    want["binaries"] = np.packbits(np.asarray(jtr.occ_state.binaries).reshape(-1))
    assert set(want) | {"bin_res", "step", "num_rays", "key"} | PORT_ONLY_KEYS == set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    for k, v in _port_leaves(ttr).items():
        np.testing.assert_array_equal(v, want.get(k, got[k]), err_msg=k)
    assert (jtr.step, jtr.num_rays) == (ttr.step, ttr.num_rays) == (4, int(got["num_rays"]))
    jtr.fit(max_steps=jtr.step + 1, log_every=0)
    assert jtr.step == 6
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(jtr.params))


def _assert_same_state(a, b):
    for (na, pa), (nb, pb) in zip(a.field.named_parameters(), b.field.named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    mods = [(a.field, b.field, a.optimizer, b.optimizer)]
    if a.ent_params is not None:
        mods.append((a.ent_params, b.ent_params, a.opt_ent, b.opt_ent))
        for pa, pb in zip(a.ent_params.parameters(), b.ent_params.parameters()):
            assert torch.equal(pa, pb)
        assert a.sched_ent.last_epoch == b.sched_ent.last_epoch
    for ma, mb, oa, ob in mods:
        for pa, pb in zip(ma.parameters(), mb.parameters()):
            sa, sb = oa.state[pa], ob.state[pb]
            assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
        assert oa.param_groups[0]["lr"] == ob.param_groups[0]["lr"]
    assert a.scheduler.last_epoch == b.scheduler.last_epoch
    assert torch.equal(a.occ_state.occs, b.occ_state.occs)
    assert torch.equal(a.occ_state.binaries, b.occ_state.binaries)
    assert (a.step, a.num_rays) == (b.step, b.num_rays)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("lmbda", [0.0, 2e-3], ids=["lmbda0", "lmbda2e-3"])
def test_resumed_run_equals_an_unbroken_run(port_ctx, tmp_path, lmbda):
    """Saved after fit(max_steps=15) returns (step 16, a multiple of the
    occupancy interval) and resumed in a new Trainer to step 31: bit-equal to
    one run to step 31 (field, context MLPs, both Adams and schedules, the
    occupancy grid, the ray count and the generator)."""
    cfg = _with_lmbda(tiny_rd_config(tconfig), lmbda)
    ds = _port_dataset()
    ent = port_ctx if lmbda else None
    whole = ttrainer.Trainer(cfg, ds, entropy=ent, device="cpu")
    whole.fit(max_steps=31, log_every=0)

    first = ttrainer.Trainer(cfg, ds, entropy=ent, device="cpu")
    first.fit(max_steps=15, log_every=0)
    path = str(tmp_path / "mid.npz")
    tckpt.save_checkpoint(path, first)
    resumed_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                     checkpoint_path=path))
    resumed = ttrainer.Trainer(resumed_cfg, ds, entropy=ent, device="cpu")
    assert resumed.step == 16
    _assert_same_state(resumed, first)
    resumed.fit(max_steps=31, log_every=0)
    _assert_same_state(resumed, whole)


def test_periodic_checkpoint_resumes_at_its_step(tmp_path):
    """fit() saves every checkpoint_every steps, before the step counter
    moves on (cnc_tpu's count): after checkpoint_every = 5 and fit(6) the
    file records step 5 and a new Trainer resumes there, mid-run
    (tests/test_utils.py:112-135)."""
    cp = str(tmp_path / "ck.npz")
    cfg = tiny_cfg(tconfig, checkpoint_path=cp, checkpoint_every=5)
    ds = _port_dataset(2, 24)
    tr = ttrainer.Trainer(cfg, ds, device="cpu")
    tr.fit(max_steps=6, log_every=0)
    assert int(_load(cp)["step"]) == 5 and tr.step == 7
    tr2 = ttrainer.Trainer(cfg, ds, device="cpu")     # resumes in __init__
    assert tr2.step == 5
    np.testing.assert_allclose(tr2.field.tables["xyz"].detach().numpy(),
                               tr.field.tables["xyz"].detach().numpy(), atol=0.02)
    tr2.fit(max_steps=6, log_every=0)
    assert tr2.step == 7


def test_reset_state_then_load_in_place(tmp_path):
    """A sweep's per-point resume (tests/test_utils.py:138-167): the same
    trainer is reset_state-ed for the point, its cfg pointed at the point's
    checkpoint, and the checkpoint loaded in place; it restores the saved
    step and field and trains on."""
    cfg = tiny_cfg(tconfig)
    tr = ttrainer.Trainer(cfg, _port_dataset(2, 24), device="cpu")
    tr.fit(max_steps=4, log_every=0)
    cp = str(tmp_path / "ck_point.npz")
    tckpt.save_checkpoint(cp, tr)
    step_saved = tr.step
    saved = {k: v.detach().clone() for k, v in tr.field.named_parameters()}
    lr_saved = tr.optimizer.param_groups[0]["lr"]

    tr.reset_state(lmbda=0.001, rate_update_interval=2)
    assert tr.step == 0
    tr.cfg = dataclasses.replace(tr.cfg, train=dataclasses.replace(
        tr.cfg.train, checkpoint_path=cp, checkpoint_every=500))
    assert int(_load(cp)["step"]) == step_saved
    tckpt.load_checkpoint(cp, tr)
    assert tr.step == step_saved
    assert all(torch.equal(p, saved[k]) for k, p in tr.field.named_parameters())
    assert tr.optimizer.param_groups[0]["lr"] == lr_saved
    tr.fit(max_steps=7, log_every=0)
    assert tr.step == 8


def test_the_generator_carries_only_to_its_own_device_type(tmp_path):
    """A port checkpoint restores the generator drawn on the trainer's device
    type; one written on another device type is ignored, with one line saying
    so, and the generator is reseeded from the trainer's seed."""
    cfg = tiny_cfg(tconfig)
    tr = ttrainer.Trainer(cfg, _port_dataset(2, 24), device="cpu")
    tr.fit(max_steps=2, log_every=0)
    cp = str(tmp_path / "g.npz")
    tckpt.save_checkpoint(cp, tr)
    logs = []
    other = ttrainer.Trainer(cfg, None, device="cpu")
    tckpt.load_checkpoint(cp, other, log_fn=logs.append)
    assert not logs and torch.equal(other.generator.get_state(), tr.generator.get_state())
    data = _load(cp)
    data["torch_generator_device"] = np.asarray("cuda")
    np.savez(cp, **data)
    tckpt.load_checkpoint(cp, other, log_fn=logs.append)
    assert len(logs) == 1 and "drawn on cuda" in logs[0]
    assert torch.equal(other.generator.get_state(),
                       torch.Generator().manual_seed(cfg.train.seed).get_state())
