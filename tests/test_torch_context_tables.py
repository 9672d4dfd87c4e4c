"""cnc_torch's context tables and occupancy cache against cnc_tpu's.

The static vertex->entry tables, their metadata and the pn coord lists are
integers and must be equal; the masks are bools and must be equal; the
overlap weights are float32 and agree within 1e-6 (the twin keeps cnc_tpu's
order of operations).  The helpers here are shared by the other context-model
tests of the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.config import EntropyConfig, GridSpec
from cnc_tpu.models import context_models as jcm
from cnc_torch import config as tconfig
from cnc_torch.models import context_models as tcm
from cnc_torch.ops import context_ops as cops

# tests/test_context_models.py:tiny_setup's sizes
KW3 = dict(num_dim=3, n_features=2, resolutions=(10, 18, 34, 66), log2_hashmap_size=10)
KW2 = dict(num_dim=2, n_features=2, resolutions=(18, 34), log2_hashmap_size=8)
EKW = dict(n_features=2, sample_num=500, max_context_layer_num=2, Pg_level=4, Pg_level_2D=2,
           skip_levels_3d=(0, 1), skip_levels_2d=(0,), Rb=16, pn_coords_cap=1 << 17,
           pn_frac_sample_cap=None, sample_num_2d=None, v_ctx_cap=1 << 15)
# the sampling and budget knobs set, the 3D budget small enough to overflow
SAMPLED = dict(pn_frac_sample_cap=1 << 10, sample_num_2d=100, v_ctx_cap_2d=256,
               v_ctx_cap=1 << 11)
VARIANTS = {"full": {}, "sampled": SAMPLED}


def make_pair(**overrides):
    """The same tiny model in both packages: (cnc_tpu's, the port's on the CPU)."""
    ekw = dict(EKW, **overrides)
    jctx = jcm.ContextModels(EntropyConfig(**ekw), GridSpec(**KW3), GridSpec(**KW2))
    tctx = tcm.ContextModels(tconfig.EntropyConfig(**ekw), tconfig.GridSpec(**KW3),
                             tconfig.GridSpec(**KW2), device="cpu")
    return jctx, tctx


def asymmetric_occupancy(seed=0, rb=16):
    """An occupancy grid that differs along every axis, so a swapped axis or
    index order cannot pass."""
    rng = np.random.default_rng(seed)
    b = rng.random((rb, rb, rb)) < 0.15
    b[:, :, rb // 2:] &= rng.random((rb, rb, rb // 2)) < 0.3
    b[: rb // 4] = False
    b[rb // 2, 3, 1] = True
    return b


def random_sign_tables(tctx, seed=1):
    rng = np.random.default_rng(seed)
    f = tctx.cfg.n_features
    return {k: np.where(rng.standard_normal((s.total_entries, f)) > 0.3, 1.0,
                        -1.0).astype(np.float32)
            for k, s in (("xyz", tctx.spec3), ("xy", tctx.spec2), ("xz", tctx.spec2),
                         ("yz", tctx.spec2))}


def starts_from_key(tctx, key):
    """The window starts cnc_tpu draws from `key`, as the port's `starts`."""
    k3 = jax.random.fold_in(key, 7)
    u = lambda k: np.asarray(jax.random.uniform(k))
    s3 = {l: tctx.start_from_uniform(tctx.tables3d[l], u(jax.random.fold_in(k3, l)))
          for l in tctx.ctx_levels_3d}
    s2 = {(ai, l): tctx.start_from_uniform(tctx.tables2d[l],
                                           u(jax.random.fold_in(key, 100 + 10 * ai + l)))
          for ai in range(3) for l in tctx.ctx_levels_2d}
    return {"3d": s3, "2d": s2}


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return make_pair(**VARIANTS[request.param])


@pytest.fixture(scope="module")
def caches(pair):
    jctx, tctx = pair
    b = asymmetric_occupancy()
    return jctx.refresh_cache(jnp.asarray(b)), tctx.refresh_cache(torch.from_numpy(b))


def test_table_arrays_equal(pair):
    jctx, tctx = pair
    for kind in ("3d", "2d"):
        ja, ta = jctx.table_arrays[kind], tctx.table_arrays[kind]
        assert set(ja) == set(ta)
        for k in ja:
            assert ta[k].dtype == torch.int32
            np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]), err_msg=f"{kind} {k}")


def test_level_metadata_equal(pair):
    jctx, tctx = pair
    assert tctx.ctx_levels_3d == jctx.ctx_levels_3d and tctx.ctx_levels_2d == jctx.ctx_levels_2d
    for jt, tt in ((jctx.tables3d, tctx.tables3d), (jctx.tables2d, tctx.tables2d)):
        assert set(jt) == set(tt)
        for l in jt:
            # every field: n_entries, sample_n, max_win_pts and the offsets
            assert tuple(tt[l]) == tuple(jt[l]) and tt[l]._fields == jt[l]._fields
    for name in ("ttl_entries_valid_3d", "ttl_sample_valid_3d", "v_window_total", "fine_res",
                 "fine_offset", "fine_size", "pn_res", "total_param_count", "mask3d_offsets",
                 "mask2d_resolutions", "mask2d_offsets", "pn_mask_offset", "pg_level",
                 "pg_level_2d"):
        assert getattr(tctx, name) == getattr(jctx, name), name


def test_level_views_and_window_sizes_equal(pair):
    jctx, tctx = pair
    for kind, levels in (("3d", jctx.ctx_levels_3d), ("2d", jctx.ctx_levels_2d)):
        for l in levels:
            ja, ta = jctx.level_arrays_np(kind, l), tctx.level_arrays_np(kind, l)
            assert set(ja) == set(ta)
            for k in ja:
                np.testing.assert_array_equal(ta[k], ja[k])
            np.testing.assert_array_equal(tctx.entry_values_np(kind, l),
                                          jctx.entry_values_np(kind, l))
    sns = [3, 50, 7, 11][:len(jctx.ctx_levels_3d) + len(jctx.ctx_levels_2d)]
    np.testing.assert_array_equal(tctx.max_window_pts(sns), jctx.max_window_pts(sns))


def test_sort_is_stable_within_an_entry(pair):
    """Within one entry the vertices stay in ascending vertex id."""
    _, tctx = pair
    for l in tctx.ctx_levels_3d:
        a = tctx.level_arrays_np("3d", l)
        same = a["vert_entry"][1:] == a["vert_entry"][:-1]
        assert np.all(np.diff(a["pos_flat"].astype(np.int64))[same] > 0)


def test_cache_masks_and_pn_lists_equal(pair, caches):
    jc, tc = caches
    for k in ("bin2d", "mask3d", "mask2d"):
        assert tc[k].dtype == torch.bool
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    assert tc["mask3d"].any() and not tc["mask3d"].all()
    for ax in ("xy", "xz", "yz"):
        assert set(tc["pn"][ax]) == set(jc["pn"][ax])
        for k in jc["pn"][ax]:
            np.testing.assert_array_equal(tc["pn"][ax][k].numpy(), np.asarray(jc["pn"][ax][k]),
                                          err_msg=f"pn {ax} {k}")
    # the three projections differ on this grid: a swapped axis would show
    assert not np.array_equal(tc["pn"]["xy"]["bounds"].numpy(), tc["pn"]["xz"]["bounds"].numpy())


def test_cache_overlap_within_1e6(pair, caches):
    jc, tc = caches
    assert set(tc["ovl"]) == set(jc["ovl"])
    for l in jc["ovl"]:
        want = np.asarray(jc["ovl"][l])
        assert want.max() > 0
        np.testing.assert_allclose(tc["ovl"][l].numpy(), want, rtol=0, atol=1e-6)


def test_init_cache_has_the_refreshed_shapes(pair, caches):
    _, tctx = pair
    _, tc = caches
    zero = tctx.init_cache()

    def shapes(c):
        return {k: (shapes(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype))
                for k, v in c.items()}

    assert shapes(zero) == shapes(tc)


@pytest.mark.parametrize("resolution", [10, 18, 34, 66])
@pytest.mark.parametrize("d", [2, 3])
def test_footprint_twin_matches_cnc_tpu(resolution, d):
    b = asymmetric_occupancy(seed=resolution)
    occ = b if d == 3 else b.any(axis=1)
    mask, ovl = cops.footprint_grids(torch.from_numpy(occ), resolution, with_overlap=d == 3)
    if d == 3:
        jm, jo = jcm._dense_mask_overlap_grids(jnp.asarray(occ), resolution, 16)
        np.testing.assert_allclose(ovl.numpy(), np.asarray(jo).reshape(-1), rtol=0, atol=1e-6)
    else:
        jm = jcm._dense_mask_grid(jnp.asarray(occ), resolution, 16)
        assert ovl is None
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm).reshape(-1))


def test_refresh_refuses_another_grid_size(pair):
    _, tctx = pair
    with pytest.raises(ValueError, match="Rb"):
        tctx.refresh_cache(torch.zeros(8, 8, 8, dtype=torch.bool))


def test_context_level_below_its_context_depth_is_refused():
    with pytest.raises(ValueError, match="skip_levels_3d"):
        make_pair(skip_levels_3d=(0,))[1]


def test_models_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcm.ContextModels(tconfig.EntropyConfig(**EKW), tconfig.GridSpec(**KW3),
                          tconfig.GridSpec(**KW2))
