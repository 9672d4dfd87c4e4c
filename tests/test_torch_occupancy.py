"""cnc_torch's occupancy-grid update against cnc_tpu's, with cnc_tpu's own
random draws injected into the port (`_update_from_draws`).

occs agree to 1e-6 (the density function is evaluated by two frameworks);
binaries must be identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.config import RenderConfig
from cnc_tpu.data import cameras as jcam
from cnc_tpu.grids import occupancy as jocc
from cnc_torch.config import RenderConfig as TRenderConfig
from cnc_torch.grids import occupancy as tocc

RES = 16
CELLS = RES ** 3
AABB = np.asarray([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)


def _density_np(x, xp):
    # a soft ball: about 0.5 at the centre, under the 0.01 threshold outside
    return 0.5 * xp.exp(-4.0 * (x * x).sum(-1))


def _states(occs, binaries):
    js = jocc.OccGridState(occs=jnp.asarray(occs), binaries=jnp.asarray(binaries),
                           aabb=jnp.asarray(AABB))
    ts = tocc.OccGridState(occs=torch.from_numpy(occs.copy()),
                           binaries=torch.from_numpy(binaries.copy()),
                           aabb=torch.from_numpy(AABB))
    return js, ts


def _jax_draws(key, warmup, count):
    """The draws cnc_tpu's update_occ_grid makes from `key` (occupancy.py:84-108)."""
    k_sel, k_jit = jax.random.split(key)
    if warmup:
        return dict(cell_jitter=np.array(jax.random.uniform(k_jit, (CELLS, 3))))
    n = CELLS // 4
    k_u, k_o = jax.random.split(k_sel)
    return dict(cell_jitter=np.array(jax.random.uniform(k_jit, (2 * n, 3))),
                uniform_idx=np.array(jax.random.randint(k_u, (n,), 0, CELLS)),
                occ_draw=np.array(jax.random.randint(k_o, (n,), 0, max(count, 1))))


def _initial(kind):
    rng = np.random.default_rng(0)
    occs = np.zeros(CELLS, np.float32)
    binaries = np.zeros((RES,) * 3, bool)
    if kind != "warmup_from_zero":
        occs = rng.uniform(0.0, 0.05, CELLS).astype(np.float32)
        occs[rng.random(CELLS) < 0.1] = -1.0           # camera-invisible cells
    if kind == "occupied_draws":
        binaries = (occs > 0.03).reshape((RES,) * 3)
    return occs, binaries


@pytest.mark.parametrize("kind,warmup", [("warmup_from_zero", True), ("warmup", True),
                                         ("occupied_draws", False), ("empty_grid", False)])
def test_update_occ_grid_matches_with_injected_draws(kind, warmup):
    occs, binaries = _initial(kind)
    js, ts = _states(occs, binaries)
    cfg, tcfg = RenderConfig(occ_resolution=RES), TRenderConfig(occ_resolution=RES)
    key = jax.random.PRNGKey(5)
    want = jocc.update_occ_grid(js, key, lambda x: _density_np(x, jnp), warmup, cfg)
    draws = {k: torch.from_numpy(v) for k, v in
             _jax_draws(key, warmup, int(binaries.sum())).items()}
    got = tocc._update_from_draws(ts, lambda x: _density_np(x, torch), tcfg, **draws)
    np.testing.assert_allclose(got.occs.numpy(), np.asarray(want.occs), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.binaries.numpy(), np.asarray(want.binaries))
    assert got.binaries.shape == (RES,) * 3 and got.binaries.dtype == torch.bool
    assert 10 < int(got.binaries.sum()) < CELLS
    assert not np.array_equal(got.occs.numpy(), occs)
    if kind != "warmup_from_zero":
        # invisible cells stay invisible
        assert (got.occs.numpy()[occs < 0] == -1.0).all()


@pytest.mark.parametrize("warmup", [True, False], ids=["warmup", "steady"])
def test_update_occ_grid_from_a_generator(warmup):
    occs, binaries = _initial("occupied_draws")
    _, ts = _states(occs, binaries)
    tcfg = TRenderConfig(occ_resolution=RES)
    g = torch.Generator().manual_seed(0)
    got = tocc.update_occ_grid(ts, g, lambda x: _density_np(x, torch), warmup, tcfg)
    again = tocc.update_occ_grid(ts, torch.Generator().manual_seed(0),
                                 lambda x: _density_np(x, torch), warmup, tcfg)
    assert torch.equal(got.occs, again.occs)            # the draws come from the generator
    centre = got.binaries[RES // 2 - 2:RES // 2 + 2, RES // 2 - 2:RES // 2 + 2,
                          RES // 2 - 2:RES // 2 + 2]
    if warmup:
        visible = (occs >= 0).reshape((RES,) * 3)[RES // 2 - 2:RES // 2 + 2,
                                                  RES // 2 - 2:RES // 2 + 2,
                                                  RES // 2 - 2:RES // 2 + 2]
        assert bool(centre[torch.from_numpy(visible)].all())
    assert (got.occs.numpy()[occs < 0] == -1.0).all()
    assert not got.occs.requires_grad


def test_mark_invisible_cells_matches():
    poses = jcam.look_at_poses(3, radius=3.0, seed=0).copy()
    poses[:, :3, 1:3] *= -1.0     # the projection expects cameras that look along +z
    K = np.asarray([[80.0, 0, 16.0], [0, 80.0, 16.0], [0, 0, 1]], np.float32)
    js, ts = _states(np.zeros(CELLS, np.float32), np.zeros((RES,) * 3, bool))
    want = jocc.mark_invisible_cells(js, jnp.asarray(K)[None], jnp.asarray(poses), 32, 32, 2.0)
    got = tocc.mark_invisible_cells(ts, torch.from_numpy(K), torch.from_numpy(poses), 32, 32,
                                    2.0)
    w = np.asarray(want.occs)
    assert 0 < (w < 0).sum() < CELLS
    # cells projecting exactly onto an image edge may flip between frameworks
    assert (got.occs.numpy() != w).sum() <= 2
