"""cnc_torch's optimizer, schedule and Trainer (the λ = 0 path) against
cnc_tpu: the schedule, Adam against optax, one whole train step with injected
rays and jitter, and a short port-only run on a procedural scene."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cnc_tpu.config import CNCConfig, ModelConfig, RenderConfig, TrainConfig
from cnc_tpu.data import cameras as jcam
from cnc_tpu.train import optim as joptim
from cnc_tpu.train import trainer as jtrainer
from cnc_torch import config as tconfig
from cnc_torch.data import scenes as tscenes
from cnc_torch.train import optim as toptim
from cnc_torch.train import trainer as ttrainer
from cnc_torch.utils import metrics as tmetrics


def tiny_config(ns):
    """tests/test_train.py:tiny_config's widths, in either package's classes."""
    return ns.CNCConfig(
        model=ns.ModelConfig(n_features_per_level=2, n_neurons=64,
                             resolutions_3d=(10, 18, 34, 66), resolutions_2d=(18, 34),
                             log2_hashmap_size=12, log2_hashmap_size_2D=10, pe_num_freqs=4),
        render=dataclasses.replace(ns.RenderConfig(), render_step_size=0.02, occ_resolution=32,
                                   sample_budget=1 << 13, march_block=32),
        train=dataclasses.replace(ns.TrainConfig(), init_batch_size=256, min_ray_bucket=256,
                                  max_ray_bucket=2048, target_sample_batch_size=1 << 13,
                                  lmbda=0.0, warmup_iters=20, lr_milestones=(60, 80), lr=6e-3))


class _JaxConfigs:
    CNCConfig, ModelConfig, RenderConfig, TrainConfig = (CNCConfig, ModelConfig, RenderConfig,
                                                         TrainConfig)


def test_schedule_matches_cnc_tpu():
    kw = dict(lr=1.0, warmup_iters=10, warmup_start_factor=0.1, lr_milestones=(20, 30),
              lr_gamma=0.5)
    ts = toptim.reference_schedule(dataclasses.replace(tconfig.TrainConfig(), **kw))
    js = joptim.reference_schedule(dataclasses.replace(TrainConfig(), **kw))
    for count, want in ((0, 0.1), (5, 0.55), (10, 1.0), (25, 0.5), (35, 0.25)):
        np.testing.assert_allclose(ts(count), want, rtol=1e-6)
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-6)
    # the scheduler object walks the same values
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = toptim.make_optimizer([p], dataclasses.replace(tconfig.TrainConfig(), **kw))
    for count in range(36):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], ts(count), rtol=1e-12)
        opt.step()
        sched.step()


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["no_decay", "l2_before_moments"])
def test_adam_steps_match_optax(weight_decay):
    """Three updates on the same gradients: eps 1e-15 and the additive L2 must
    act as cnc_tpu's optax chain does.  Tolerance 1e-6 relative plus 1e-7
    absolute (an ulp of the O(1) parameters): torch takes
    sqrt(v)/sqrt(1-b2^t), optax sqrt(v/(1-b2^t))."""
    rng = np.random.default_rng(0)
    shapes = {"table": (50, 4), "w": (7, 5), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-8, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    grads[0]["table"][:10] = 0.0            # untouched rows: only the decay moves them
    kw = dict(lr=6e-3, warmup_iters=2, lr_milestones=(2,))
    jopt = joptim.make_optimizer(dataclasses.replace(TrainConfig(), **kw), weight_decay)
    jp = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt, tsched = toptim.make_optimizer(tp.values(),
                                         dataclasses.replace(tconfig.TrainConfig(), **kw),
                                         weight_decay)
    for g in grads:
        upd, state = jopt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        topt.step()
        tsched.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert not np.allclose(tp["table"].detach().numpy(), params["table"], atol=1e-4)


_BUCKETS = [(1, 256, 2048), (256, 256, 2048), (257, 256, 2048), (5000, 256, 2048),
            (70000, 1024, 1 << 17)]


# multiple: the data-parallel group's size (1 keeps the single-process ids);
# 3 and 384 do not divide the buckets, 4096 exceeds the smaller ones
@pytest.mark.parametrize("n,lo,hi,multiple", [
    pytest.param(n, lo, hi, m, id="-".join(map(str, (n, lo, hi))) + ("" if m == 1 else f"-x{m}"))
    for m in (1, 2, 3, 8, 384, 4096) for n, lo, hi in _BUCKETS])
def test_next_bucket_matches(n, lo, hi, multiple):
    assert (ttrainer._next_bucket(n, lo, hi, multiple)
            == jtrainer._next_bucket(n, lo, hi, multiple))


def _sphere_rays(n_side, rng):
    """Rays of one view of the sphere scene, with their ground-truth pixels."""
    poses = jcam.look_at_poses(1, radius=3.2, seed=0, full_sphere=True)
    K = jnp.asarray([[0.8 * n_side, 0, n_side / 2], [0, 0.8 * n_side, n_side / 2], [0, 0, 1]])
    rays = jcam.image_rays(K, jnp.asarray(poses[0]), n_side, n_side)
    o = np.array(rays.origins).reshape(-1, 3)
    d = np.array(rays.viewdirs).reshape(-1, 3)
    pix, _ = tscenes.render_gt_rays(tscenes.make_scene("sphere"), torch.from_numpy(o),
                                    torch.from_numpy(d), 128)
    return o, d, pix.numpy()


def test_one_train_step_matches_cnc_tpu():
    """The same params, occupancy grid, rays, pixels and jitter through
    cnc_tpu's render-grad + apply programs and the port's `_train_step`.

    Stated tolerances.  Loss: 1e-6 relative.  Gradients: 1e-5 of each
    parameter's largest gradient entry.  Updated parameters: Adam's first
    update is lr * g / (|g| + 1e-15), i.e. lr * sign(g), so an entry moves
    the same way in both packages (1e-7) wherever its gradient is above the
    gradient tolerance, and by at most 2 * lr apart where it is not."""
    jcfg, tcfg = tiny_config(_JaxConfigs), tiny_config(tconfig)
    jtr = jtrainer.Trainer(jcfg, dataset=None)
    ttr = ttrainer.Trainer(tcfg, dataset=None, device="cpu")
    np_params = jax.tree.map(np.array, jtr.params)
    ttr.field.load_state_dict(
        ttrainer.rf.params_from_jax(np_params, tcfg.model, device="cpu").state_dict())
    binaries = tscenes.occupancy_from_scene(tscenes.make_scene("sphere"), 32, 0.02,
                                            device="cpu")
    ttr.occ_state = ttr.occ_state._replace(binaries=binaries)
    o, d, pix = _sphere_rays(16, np.random.default_rng(0))
    key = jax.random.PRNGKey(9)
    u = np.array(jax.random.uniform(key, (o.shape[0],)))

    g, aux = jtr._render_grad_fn(o.shape[0])(
        jtr.params, jnp.asarray(binaries.numpy()), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(pix), jnp.ones(3), key)
    new_params, _, _, _ = jtr._apply_fn(False)(
        jtr.params, jtr.ent_params, jtr.opt_state_rf, jtr.opt_state_ent, g, None,
        jtr.ent_params)

    taux = ttr._train_step(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(pix),
                           torch.ones(3), jitter=torch.from_numpy(u))
    assert int(taux["n_marched"]) == int(aux["n_marched"]) > 500
    assert int(taux["n_samples"]) == int(aux["n_samples"]) > 100
    np.testing.assert_allclose(float(taux["mse"]), float(aux["mse"]), rtol=1e-6)

    lr0 = toptim.reference_schedule(tcfg.train)(0)
    names = {"xyz": "tables.xyz", "xy": "tables.xy", "xz": "tables.xz", "yz": "tables.yz"}
    for mlp, layers in (("mlp_base", ("l0", "l1")), ("mlp_head", ("l0", "l1", "l2"))):
        for layer in layers:
            for leaf in ("w", "b"):
                names[(mlp, layer, leaf)] = f"{mlp}.{layer}.{leaf}"
    tparams = dict(ttr.field.named_parameters())
    assert len(names) == len(tparams) == 14
    for jkey, tname in names.items():
        jg, jnew = g, new_params
        for k in (jkey if isinstance(jkey, tuple) else (jkey,)):
            jg, jnew = jg[k], jnew[k]
        jg, jnew = np.asarray(jg), np.asarray(jnew)
        tol = 1e-5 * np.abs(jg).max()
        assert tol > 0, tname
        np.testing.assert_allclose(tparams[tname].grad.numpy(), jg, atol=tol, rtol=0,
                                   err_msg=tname)
        tnew = tparams[tname].detach().numpy()
        stable = np.abs(jg) > 10 * tol
        assert stable.any(), tname
        np.testing.assert_allclose(tnew[stable], jnew[stable], atol=1e-7, rtol=0, err_msg=tname)
        np.testing.assert_allclose(tnew, jnew, atol=2.001 * lr0, rtol=0, err_msg=tname)
    assert ttr.optimizer.param_groups[0]["lr"] == toptim.reference_schedule(tcfg.train)(1)


def test_training_improves_psnr():
    """Port only: 60 steps on the sphere scene reach the PSNR cnc_tpu's own
    training test asks for (tests/test_train.py: > 14)."""
    cfg = tiny_config(tconfig)
    ds = tscenes.ProceduralDataset("sphere", n_images=8, width=48, height=48, n_steps_gt=256,
                                   device="cpu")
    tr = ttrainer.Trainer(cfg, ds, device="cpu")
    losses = []
    took = tr.fit(max_steps=60, log_every=0,
                  step_callback=lambda s, aux: losses.append(float(aux["mse"])))
    assert took > 0 and tr.step == 61 and len(losses) == 61
    assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])
    assert int(tr.occ_state.binaries.sum()) > 0
    rgb, gt = tr.eval_image(0)
    p = float(tmetrics.psnr(rgb, gt))
    assert np.isfinite(p)
    assert p > 14.0, f"psnr after training too low: {p}"
    scores = tr.evaluate(max_images=2)
    assert scores["psnr"] > 14.0 and 0.0 < scores["ssim"] <= 1.0 and scores["lpips"] is None
    # a completed run is a no-op; reset_state starts the same run again
    tr.fit(max_steps=60, log_every=0)
    assert tr.step == 61
    first = []
    tr.reset_state()
    assert tr.step == 0 and not bool(tr.occ_state.binaries.any())
    tr.fit(max_steps=0, log_every=0, step_callback=lambda s, aux: first.append(float(aux["mse"])))
    assert first == losses[:1]


def test_trainer_refuses_what_is_not_ported(monkeypatch, tmp_path):
    """train.checkpoint_path resumes (it raised before checkpoints were
    ported): a missing file starts the run at step 0, an existing one
    resumes from it; and no card without device="cpu" raises."""
    cfg = tiny_config(tconfig)
    cp = str(tmp_path / "run" / "ckpt")
    with_cp = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_path=cp))
    tr = ttrainer.Trainer(with_cp, None, device="cpu")
    assert tr.step == 0
    tr.step, tr.num_rays = 7, 512
    with torch.no_grad():
        tr.field.tables["xyz"].add_(1.0)
    ttrainer.ckpt.save_checkpoint(cp, tr)
    resumed = ttrainer.Trainer(with_cp, None, device="cpu")
    assert (resumed.step, resumed.num_rays) == (7, 512)
    assert torch.equal(resumed.field.tables["xyz"], tr.field.tables["xyz"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.Trainer(cfg, None)
