"""The rate census (`tools/torch_basin_census.py`) against a numpy recount of
cnc_tpu's own pools, and both packages' training steps in lockstep
(`tools/cnc_tpu_lockstep.py`) at the tiny rate configuration."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu import config as jconfig
from cnc_tpu.data import scenes as jscenes
from cnc_tpu.models import context_models as jcm
from cnc_tpu.models import radiance_field as jrf
from cnc_tpu.ops import entropy as jent
from cnc_tpu.train import trainer as jtrainer
from cnc_torch import config as tconfig
from cnc_torch.codec.codec import CNCCodec
from cnc_torch.data import scenes as tscenes
from cnc_torch.models import radiance_field as trf

from test_torch_train_rate import _port_trainer, tiny_config

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import cnc_tpu_lockstep as lockstep_mod  # noqa: E402
import torch_basin_census as census_mod  # noqa: E402

# the codec's chunk budget cut so that the port's census pools the tiny 3D
# levels in several chunks (the last one's start clamped), the recount each
# level in one window
CHUNKED = dict(max_points_per_chunk=700)


def _pair(seed=0):
    """cnc_tpu's trainer and the port's on one state: cnc_tpu's initial
    draws, an asymmetric sphere grid, the context MLPs' output layers'
    weights scaled 40x and their biases set to 0.5, so that pooled
    probabilities leave [1e-6, 1 - 1e-6] on both sides, on both symbols."""
    jcfg = tiny_config(jconfig, seed=seed)
    jcfg = dataclasses.replace(jcfg, entropy=dataclasses.replace(jcfg.entropy, **CHUNKED))
    tcfg = tiny_config(tconfig, seed=seed)
    tcfg = dataclasses.replace(tcfg, entropy=dataclasses.replace(tcfg.entropy, **CHUNKED))
    jctx = jcm.ContextModels(jcfg.entropy, jcfg.model.grid_3d, jcfg.model.grid_2d)
    jtr = jtrainer.Trainer(jcfg, None, entropy=jctx)
    ttr = _port_trainer(tcfg)
    ttr.start_from_cnc_tpu()
    ent = jax.tree.map(np.array, jtr.ent_params)
    for layer in [ent["ctx3d"]["l2"]] + list(ent["ctx2d"].values()):
        layer["w"] *= 40.0
        layer["b"][:] = 0.5
    jtr.ent_params = jax.tree.map(jnp.asarray, ent)
    ttr.ent_params.load_state_dict(ttr.entropy.ent_params_from_jax(ent).state_dict())
    binaries = tscenes.occupancy_from_scene(tscenes.make_scene("sphere"), 16, 0.02, device="cpu")
    binaries[:4] = False
    return jtr, ttr, binaries


def _symbols_and_probs(jtr, binaries):
    """Every covered entry-feature's symbol and pooled p, from cnc_tpu's
    pools of whole levels."""
    jctx = jtr.entropy
    jcache = jctx.refresh_cache(jnp.asarray(binaries.numpy()))
    tabs = jrf.quantized_tables(jtr.params, jtr.cfg.model)
    xs, ps = [], []
    for l in jctx.ctx_levels_3d:
        t = jctx.tables3d[l]
        o = jctx.spec3.offsets[l]
        pg = jent.global_pg_bits(tabs["xyz"][o:o + jctx.spec3.level_sizes[l]])[0]
        p, c, x = jctx.pool_3d_level(jtr.ent_params, tabs["xyz"], jcache, l, pg, jnp.int32(0),
                                     t.n_entries, t.n_vertices)
        ps.append(np.asarray(p)[np.asarray(c)])
        xs.append(np.asarray(x)[np.asarray(c)])
    return np.concatenate(xs), np.concatenate(ps)


def test_census_counts_equal_a_recount_of_cnc_tpus_pools():
    jtr, ttr, binaries = _pair()
    jctx, tctx = jtr.entropy, ttr.entropy
    chunks = CNCCodec(tctx).chunks3d
    assert max(n for _, n, _ in chunks.values()) >= 3     # several chunks, the last clamped
    got = census_mod.census(tctx, ttr.ent_params, trf.quantized_tables(ttr.field, ttr.cfg.model),
                            binaries)
    jtabs = {k: np.asarray(v) for k, v in jrf.quantized_tables(jtr.params, jtr.cfg.model).items()}
    jcache = jctx.refresh_cache(jnp.asarray(binaries.numpy()))
    want = lockstep_mod.cnc_tpu_census(jctx, jtr.ent_params, jtabs, jcache)
    assert lockstep_mod.compare_census(got, want, rtol=1e-5) is None

    ctx = [lv for lv in got["levels"] if lv["kind"] == "ctx"]
    assert [(lv["table"], lv["level"]) for lv in ctx] == (
        [("xyz", l) for l in tctx.ctx_levels_3d]
        + [(ax, l) for ax in ("xy", "xz", "yz") for l in tctx.ctx_levels_2d])
    for lv, wl in zip(ctx, [lv for lv in want["levels"] if lv["kind"] == "ctx"]):
        assert len(lv["features"]) == tctx.cfg.n_features
        for f, wf in zip(lv["features"], wl["features"]):
            assert f["n"] > 0
            assert f["n_out"] == f["n_lo"] + f["n_hi"]
            assert sum(f[f"n_{b}"] for b in census_mod.BANDS) == f["n"]
            bands = sum(f[f"bits_{b}"] for b in census_mod.BANDS)
            np.testing.assert_allclose(bands, f["bits"], rtol=1e-12)
            # the level's bits against cnc_tpu's own bernoulli_bits
            np.testing.assert_allclose(bands, wf["bits"], rtol=1e-5)
            # 19.93 bits at p = 1e-6 on +1; 19.91 at float32's 1 - 1e-6 on -1
            assert (19.91 * f["n_against"] <= f["bits_against"]
                    <= 19.932 * f["n_against"])

    # the state leaves the range both ways, on both symbols
    x, p = _symbols_and_probs(jtr, binaries)
    lo, hi = p < 1e-6, p > 1 - 1e-6
    for m in (lo & (x > 0), lo & (x < 0), hi & (x > 0), hi & (x < 0), ~(lo | hi)):
        assert m.sum() > 20
    t3 = [lv for lv in ctx if lv["table"] == "xyz"]
    assert sum(f["n_lo"] for lv in t3 for f in lv["features"]) == int(lo.sum())
    assert sum(f["n_hi"] for lv in t3 for f in lv["features"]) == int(hi.sum())
    assert sum(f["n_against"] for lv in t3 for f in lv["features"]) == int(
        (lo & (x > 0)).sum() + (hi & (x < 0)).sum())

    tot = got["totals"]
    assert tot["n_against"] > 0 and tot["bits_against"] > 0.5 * tot["bits"]
    pg = sum(lv["bits"] for lv in got["levels"] if lv["kind"] == "pg")
    np.testing.assert_allclose(tot["bits_total"], tot["bits"] + pg, rtol=1e-12)
    np.testing.assert_allclose(tot["total_MB"] * 8 * 2 ** 20 / tctx.total_param_count,
                               tot["bits_per_param"], rtol=1e-12)
    assert "clipped" in census_mod.summary_line(got)


def test_census_of_a_fresh_state_clips_the_negative_outputs():
    """At cnc_tpu's initial draws each context feature's raw output sits near
    its output layer's bias, U(-1/sqrt(fan_in), 1/sqrt(fan_in)): where that
    is negative the pooled p is clipped at 1e-6 on most entries, and each
    such +1 costs 19.93 bits.  Nothing is clipped high."""
    ttr = _port_trainer(tiny_config(tconfig, seed=3))
    ttr.start_from_cnc_tpu()
    binaries = tscenes.occupancy_from_scene(tscenes.make_scene("sphere"), 16, 0.02, device="cpu")
    ttr.occ_state = ttr.occ_state._replace(binaries=binaries)
    got = census_mod.census_of_trainer(ttr)
    tot = got["totals"]
    assert tot["n_hi"] == 0 and tot["n_out"] == tot["n_lo"] > 0
    assert 0 < tot["n_against"] < tot["n_lo"]
    assert 19.91 * tot["n_against"] <= tot["bits_against"] <= 19.932 * tot["n_against"]
    b3 = ttr.ent_params.ctx3d["l2"].b.detach().numpy()
    assert (b3 < 0).any() and (b3 > 0).any()
    for lv in got["levels"]:
        if lv["table"] == "xyz" and lv["kind"] == "ctx":
            for f, b in zip(lv["features"], b3):
                assert (f["n_lo"] > f["n"] / 2) == (b < -0.05), (lv["level"], f, b)


def test_lockstep_eight_steps_two_rate_steps():
    """Both packages from one cnc_tpu state over 8 steps at interval 4 (rate
    steps 0 and 4, the occupancy update at 0 with cnc_tpu's draws): every
    step's samples and mse, and at each rate step the rate, every gradient
    and the census, within the one-step tolerances."""
    jcfg = tiny_config(jconfig, seed=5, rate_update_interval=4)
    tcfg = tiny_config(tconfig, seed=5, rate_update_interval=4)
    ds = jscenes.ProceduralDataset("sphere", n_images=4, width=32, height=32, n_steps_gt=128)
    jtr = jtrainer.Trainer(jcfg, ds, entropy=jcm.ContextModels(
        jcfg.entropy, jcfg.model.grid_3d, jcfg.model.grid_2d))
    ttr = _port_trainer(tcfg)
    lines = []
    records, first = lockstep_mod.lockstep(jtr, ttr, 8, log=lines.append)
    assert first is None, first
    assert [r["step"] for r in records] == list(range(8)) and len(lines) == 8
    assert [r["rate_step"] for r in records] == [True, False, False, False] * 2
    assert "occ_err" in records[0] and all("occ_err" not in r for r in records[1:])
    for r in records:
        assert np.isfinite(r["grad_err"]) and r["n_marched"][0] > 100
        if r["rate_step"]:
            assert r["grad_err"] <= lockstep_mod.GRAD_TOL
            assert r["census_against"][0] == r["census_against"][1]
            np.testing.assert_allclose(*r["census_MB"], rtol=1e-5)
            np.testing.assert_allclose(*r["bits_per_param"], rtol=1e-4)
    assert jtr.step == 8
    assert torch.is_tensor(ttr.field.tables["xyz"])


def test_census_of_a_packed_state_equals_the_trainers(tmp_path):
    """`pack_state` keeps a checkpoint's table signs (x >= 0 is +1, zeros
    included), context MLPs and occupancy grid; the census read back from it,
    or from the checkpoint itself, equals the trainer's."""
    from cnc_torch.utils import checkpoint as tckpt

    ttr = _port_trainer(tiny_config(tconfig, seed=1))
    ttr.start_from_cnc_tpu()
    with torch.no_grad():
        ttr.field.tables["xyz"][::7] = 0.0
        ttr.ent_params.ctx3d["l2"].b.add_(0.3)
    binaries = tscenes.occupancy_from_scene(tscenes.make_scene("sphere"), 16, 0.02, device="cpu")
    ttr.occ_state = ttr.occ_state._replace(binaries=binaries)
    ttr.step = 12
    ck, st = tmp_path / "ck.npz", tmp_path / "state.npz"
    tckpt.save_checkpoint(str(ck), ttr)
    census_mod.pack_state(str(ck), str(st))
    assert st.stat().st_size < ck.stat().st_size / 4
    want = census_mod.census_of_trainer(ttr)
    tabs = trf.quantized_tables(ttr.field, ttr.cfg.model)
    for src in (st, ck):
        ent, tables, grid, step = census_mod.load_state(str(src), ttr.entropy)
        assert step == 12 and torch.equal(grid, binaries)
        for k in tabs:
            assert torch.equal(tables[k], tabs[k]), k
        assert census_mod.census(ttr.entropy, ent, tables, grid) == want


def test_a_feature_clipped_on_every_entry_learns_nothing_in_either_package():
    """The upper basin's mechanism, the same in both packages: a 3D context
    output feature whose pooled p lies below 1e-6 on every entry gets
    exactly no gradient from the rate (the clip in `bernoulli_bits` passes
    none), so its weights and bias never move; the other features' do."""
    from test_torch_context_tables import starts_from_key

    jtr, ttr, binaries = _pair()
    ent = jax.tree.map(np.array, jtr.ent_params)
    ent["ctx3d"]["l2"]["b"][0] = -10.0                # feature 0 dead everywhere
    jp = jax.tree.map(jnp.asarray, ent)
    tp = ttr.entropy.ent_params_from_jax(ent)
    jctx, tctx = jtr.entropy, ttr.entropy
    jcache = jctx.refresh_cache(jnp.asarray(binaries.numpy()))
    tcache = tctx.refresh_cache(binaries)
    tbl = np.asarray(jrf.quantized_tables(jtr.params, jtr.cfg.model)["xyz"])
    key = jax.random.PRNGKey(11)
    jg = jax.grad(lambda p: jctx.rate_bits_3d(p, jnp.asarray(tbl), key, jcache))(jp)
    tctx.rate_bits_3d(tp, torch.from_numpy(tbl), starts_from_key(tctx, key)["3d"],
                      tcache).backward()
    for w, b in ((np.asarray(jg["ctx3d"]["l2"]["w"]), np.asarray(jg["ctx3d"]["l2"]["b"])),
                 (tp.ctx3d["l2"].w.grad.numpy(), tp.ctx3d["l2"].b.grad.numpy())):
        assert b[0] == 0.0 and not w[:, 0].any()
        assert (b[1:] != 0).all() and w[:, 1:].any()
