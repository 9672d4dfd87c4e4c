"""cnc_tpu's initial state drawn by the port without JAX
(`cnc_torch.train.trainer.cnc_tpu_initial_state`, `Trainer.
start_from_cnc_tpu`): bit for bit cnc_tpu `Trainer.__init__`'s `params` and
`ent_params`, and one rate step from that state within the one-step test's
tolerances."""

import numpy as np
import pytest
import torch

import jax

from cnc_tpu import config as jconfig
from cnc_tpu.models import context_models as jcm
from cnc_tpu.train import trainer as jtrainer
from cnc_torch import config as tconfig
from cnc_torch.train import trainer as ttrainer

from test_torch_train_rate import _port_trainer, one_step_against_cnc_tpu, tiny_config


def _cnc_tpu_trainer(seed):
    jcfg = tiny_config(jconfig, seed=seed)
    jctx = jcm.ContextModels(jcfg.entropy, jcfg.model.grid_3d, jcfg.model.grid_2d)
    return jtrainer.Trainer(jcfg, None, entropy=jctx), jctx


def _assert_bit_equal(got, want):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        b = np.asarray(b)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=str(path))


@pytest.mark.parametrize("seed", [0, 42])
def test_initial_state_equals_cnc_tpu_trainers(seed):
    jtr, _ = _cnc_tpu_trainer(seed)
    tcfg = tiny_config(tconfig, seed=seed)
    ttr = _port_trainer(tcfg)
    params, ent = ttrainer.cnc_tpu_initial_state(tcfg, seed, ttr.entropy)
    _assert_bit_equal(params, jtr.params)
    _assert_bit_equal(ent, jtr.ent_params)
    assert ttrainer.cnc_tpu_initial_state(tcfg, seed)[1] == {}


@pytest.mark.parametrize("seed", [42])
def test_start_from_cnc_tpu_then_one_rate_step(seed):
    """The port's trainer at the seed, moved onto cnc_tpu's initial state in
    place (the optimizers keep their parameters), equals cnc_tpu's trainer
    leaf for leaf, and one whole rate step from there matches cnc_tpu's."""
    jtr, jctx = _cnc_tpu_trainer(seed)
    tcfg = tiny_config(tconfig, seed=seed)
    ttr = _port_trainer(tcfg)
    before = [p for g in ttr.optimizer.param_groups for p in g["params"]]
    ttr.start_from_cnc_tpu()
    assert [p for g in ttr.optimizer.param_groups for p in g["params"]] == before
    _assert_bit_equal({k: v.detach().numpy() for k, v in ttr.field.state_dict().items()},
                      {f"tables.{k}": jtr.params[k] for k in ("xyz", "xy", "xz", "yz")}
                      | {f"{m}.{l}.{x}": jtr.params[m][l][x]
                         for m in ("mlp_base", "mlp_head") for l in jtr.params[m]
                         for x in ("w", "b")})
    _assert_bit_equal(ttr.entropy.ent_params_to_numpy(ttr.ent_params), jtr.ent_params)
    one_step_against_cnc_tpu(jtr, jctx, ttr, tcfg)
    with pytest.raises(ValueError, match="before the first"):
        ttr.step = 1
        ttr.start_from_cnc_tpu()


def test_port_draws_differ_from_cnc_tpus_at_the_same_seed():
    """The port's own draws at a seed are not cnc_tpu's (a different
    generator), though both are U(-b, b) with the same bounds."""
    tcfg = tiny_config(tconfig, seed=0)
    ttr = _port_trainer(tcfg)
    params, _ = ttrainer.cnc_tpu_initial_state(tcfg, 0)
    port = ttr.field.mlp_base["l0"].w.detach().numpy()
    ref = params["mlp_base"]["l0"]["w"]
    assert port.shape == ref.shape and not np.array_equal(port, ref)
    bound = 1.0 / np.sqrt(port.shape[0])
    for a in (port, ref):
        assert np.abs(a).max() <= bound and np.abs(a).max() > 0.9 * bound
    assert torch.is_tensor(ttr.field.mlp_base["l0"].w)
