"""cnc_torch's Adam against cnc_tpu's optax chain over the lr warm-up, in the
regime a hash table lives in: rows whose gradients span 1e-12 to 1e-3, rows
that receive none for long runs of steps and then a small one, so that their
first moment has decayed while the second has not.  The three-update test in
test_torch_train.py cannot see a drift that builds over hundreds of steps;
these hold the parameters after every one of STEPS updates."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cnc_tpu.config import TrainConfig
from cnc_tpu.train import optim as joptim
from cnc_torch import config as tconfig
from cnc_torch.train import optim as toptim

STEPS = 400          # updates, all inside the 1,000-step warm-up
ROWS, FEATS = 512, 4
# Tolerance on the parameters after every update: 1e-5 relative plus 1e-7
# absolute.  The two chains agree in exact arithmetic; in float32 torch
# divides sqrt(v) by sqrt(1 - b2^t) (bias terms in float64) where optax takes
# sqrt(v / (1 - b2^t)) (bias terms in float32), so each update differs by a
# few ulps of itself.
RTOL, ATOL = 1e-5, 1e-7
KW = dict(lr=6e-3, adam_eps=1e-15, warmup_iters=1000)


def _table_gradients(rng):
    """STEPS gradients of the [ROWS, FEATS] table.

    Row r's magnitude is 10^u, u uniform in [-12, -3].  By r mod 4 the row is
    dense (a gradient every step), random (half the steps), bursty (zero for
    runs of 30 to 250 steps, then one gradient at a thousandth of its
    magnitude) or early (gradients in the first 20 steps only, then zero
    until one small gradient in the last 30)."""
    scale = 10.0 ** rng.uniform(-12.0, -3.0, size=(ROWS, 1))
    kind = np.arange(ROWS) % 4
    active = np.zeros((STEPS, ROWS), bool)
    small = np.zeros((STEPS, ROWS), bool)
    active[:, kind == 0] = True
    active[:, kind == 1] = rng.random((STEPS, int((kind == 1).sum()))) < 0.5
    for r in np.flatnonzero(kind == 2):
        t = int(rng.integers(0, 30))
        while t < STEPS:
            active[t, r] = small[t, r] = True
            t += int(rng.integers(30, 251))
    for r in np.flatnonzero(kind == 3):
        active[:20, r] = True
        t = int(rng.integers(STEPS - 30, STEPS))
        active[t, r] = small[t, r] = True
    out = []
    for t in range(STEPS):
        g = rng.standard_normal((ROWS, FEATS)) * scale
        out.append((np.where(small[t][:, None], g * 1e-3, g) * active[t][:, None])
                   .astype(np.float32))
    return out


def _problem(seed=17):
    """The table (U(-1e-4, 1e-4), the field's initialisation), a [16, 8]
    weight (U(-0.25, 0.25)) with dense 1e-3 gradients, and STEPS gradients."""
    rng = np.random.default_rng(seed)
    params = {"table": rng.uniform(-1e-4, 1e-4, (ROWS, FEATS)).astype(np.float32),
              "w": rng.uniform(-0.25, 0.25, (16, 8)).astype(np.float32)}
    grads = [{"table": g, "w": (rng.standard_normal((16, 8)) * 1e-3).astype(np.float32)}
             for g in _table_gradients(rng)]
    return params, grads


def _optimizers(params, weight_decay, foreach):
    """cnc_tpu's chain (a jitted update) and cnc_torch's Adam with its
    scheduler, at the reference's settings.  `foreach`: torch's multi-tensor
    implementation, the one it picks for parameters on the card, or the
    single-tensor one it picks on the CPU."""
    jcfg = dataclasses.replace(TrainConfig(), **KW)
    tcfg = dataclasses.replace(tconfig.TrainConfig(), **KW)
    assert tconfig.TrainConfig().adam_eps == TrainConfig().adam_eps == 1e-15
    assert (tconfig.TrainConfig().lr, tconfig.TrainConfig().warmup_iters) == (6e-3, 1000)
    jopt = joptim.make_optimizer(jcfg, weight_decay)

    @jax.jit
    def jstep(g, state, p):
        upd, state = jopt.update(g, state, p)
        return optax.apply_updates(p, upd), state

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt, tsched = toptim.make_optimizer(tp.values(), tcfg, weight_decay)
    topt.param_groups[0]["foreach"] = foreach
    return jopt, jstep, tp, topt, tsched


def _torch_step(tp, topt, tsched, g):
    for k in tp:
        tp[k].grad = torch.from_numpy(g[k].copy())
    topt.step()
    tsched.step()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


IMPLS = pytest.mark.parametrize("foreach", [False, True], ids=["single", "foreach"])


@IMPLS
def test_adam_table_over_the_warmup_matches_optax(foreach):
    """The table alone, each package on its own trajectory: STEPS updates at
    the reference's settings (lr 6e-3, eps 1e-15, warmup_iters 1000, no
    weight decay, as the context MLPs' optimizer), the parameters compared
    after each."""
    params, grads = _problem()
    params = {"table": params["table"]}
    jopt, jstep, tp, topt, tsched = _optimizers(params, 0.0, foreach)
    jp = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jp)
    for step, g in enumerate(grads):
        g = {"table": g["table"]}
        jp, state = jstep(jax.tree.map(jnp.asarray, g), state, jp)
        _torch_step(tp, topt, tsched, g)
        _close(tp["table"].detach().numpy(), np.asarray(jp["table"]),
               f"table after update {step + 1}")
    # every row took lr-sized steps, whatever its gradients' magnitude (the
    # early rows' 20 steps at the warm-up's start, lr 6e-5 to 7e-5, the least)
    moved = np.abs(tp["table"].detach().numpy() - params["table"]).max(axis=1)
    assert moved.min() > 1e-4


def _optax_state(state, tp, topt, count):
    """cnc_tpu's chain state holding cnc_torch's moments and step count."""
    st = {k: topt.state[p] for k, p in tp.items()}
    # copies: jax may alias a numpy buffer that torch then updates in place
    mu = {k: jnp.array(s["exp_avg"].numpy(), copy=True) for k, s in st.items()}
    nu = {k: jnp.array(s["exp_avg_sq"].numpy(), copy=True) for k, s in st.items()}
    count = jnp.asarray(count, jnp.int32)
    out = []
    for s in state:
        if isinstance(s, optax.ScaleByAdamState):
            s = s._replace(count=count, mu=mu, nu=nu)
        elif isinstance(s, optax.ScaleByScheduleState):
            s = s._replace(count=count)
        out.append(s)
    return tuple(out)


@IMPLS
@pytest.mark.parametrize("weight_decay", [0.0, 2e-6], ids=["no_decay", "field_decay"])
def test_adam_update_over_the_warmup_matches_optax(weight_decay, foreach):
    """Every one of STEPS updates, from a shared state: before each, cnc_tpu's
    chain is given cnc_torch's parameters, moments and count, and both take
    the update on the same gradient; the parameters after it are compared
    (the moments each package formed enter the next comparison's update).  Weight decay 2e-6 is the field's optimizer's.

    Each package is not held on its own trajectory here.  With the decay, a
    table row whose gradients are far under wd * p is driven by the decay
    alone, and Adam turns that into lr-sized steps that carry p across 0 and
    back; the sign of the next step then hangs on the last ulp of p, so two
    float32 runs part by lr-sized amounts within 200 updates (a float64 Adam
    parts from each package by 4e-4 to 7e-4 at update 300 on these
    gradients).  The dense weight's O(0.2) entries, rounded at every update,
    drift from a float64 Adam by 4e-7 to 6e-7 in either package within 400
    updates, above the absolute floor where they pass near 0."""
    params, grads = _problem()
    jopt, _, tp, topt, tsched = _optimizers(params, weight_decay, foreach)
    jupdate = jax.jit(jopt.update)
    state = jopt.init(jax.tree.map(jnp.asarray, params))
    for step, g in enumerate(grads):
        p_before = {k: jnp.array(v.detach().numpy(), copy=True) for k, v in tp.items()}
        if step:
            state = _optax_state(state, tp, topt, step)
        upd, state = jupdate(jax.tree.map(jnp.asarray, g), state, p_before)
        jp = optax.apply_updates(p_before, upd)
        _torch_step(tp, topt, tsched, g)
        for k in tp:
            _close(tp[k].detach().numpy(), np.asarray(jp[k]), f"{k} after update {step + 1}")
    assert int(topt.state[tp["table"]]["step"]) == STEPS
