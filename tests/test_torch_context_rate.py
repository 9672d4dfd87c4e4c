"""cnc_torch's rate estimate against cnc_tpu's, piece by piece and whole:
the masked, mixed-level and given-table encodes, the context pooling, the
frac plane, the per-level pools and the rate with its gradients.  cnc_tpu
draws its entry windows from a PRNG key; the port takes the same starts
injected (`starts_from_key`).  Each tolerance is stated where it is used.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.models import context_models as jcm
from cnc_tpu.ops import encoding as jenc
from cnc_tpu.ops import entropy as jent
from cnc_torch.models import context_models as tcm
from cnc_torch.ops import context_ops as cops
from cnc_torch.ops import encoding as tenc
from cnc_torch.ops import entropy as tent

from test_torch_context_tables import (VARIANTS, asymmetric_occupancy, make_pair,
                                       random_sign_tables, starts_from_key)


@pytest.fixture(scope="module", params=list(VARIANTS))
def setup(request):
    jctx, tctx = make_pair(**VARIANTS[request.param])
    b = asymmetric_occupancy()
    jc, tc = jctx.refresh_cache(jnp.asarray(b)), tctx.refresh_cache(torch.from_numpy(b))
    tabs = random_sign_tables(tctx)
    jp = jctx.init_params(jax.random.PRNGKey(5))
    tp = tctx.ent_params_from_jax(jax.tree.map(np.asarray, jp))
    return dict(jctx=jctx, tctx=tctx, jc=jc, tc=tc, tabs=tabs, jp=jp, tp=tp)


# ------------------------------------------------------------ the encodes
def _encode_inputs(setup, d, seed):
    """Asymmetric float tables and points, some on the border and outside."""
    rng = np.random.default_rng(seed)
    spec = setup["tctx"].spec3 if d == 3 else setup["tctx"].spec2
    table = rng.standard_normal((spec.total_entries, 2)).astype(np.float32)
    pts = rng.random((400, d)).astype(np.float32)
    pts[:20] = np.round(pts[:20])
    pts[20:40] = pts[20:40] * 1.4 - 0.2
    return spec, table, pts


@pytest.mark.parametrize("d", [2, 3])
def test_masked_encode_matches(setup, d):
    """Values within 1e-5 max abs, d_table within 1e-5 of its largest entry."""
    jctx, tctx = setup["jctx"], setup["tctx"]
    spec, table, pts = _encode_inputs(setup, d, 10 + d)
    jspec = jctx.spec3 if d == 3 else jctx.spec2
    jmask = setup["jc"]["mask3d"] if d == 3 else setup["jc"]["mask2d"][1]
    tmask = setup["tc"]["mask3d"] if d == 3 else setup["tc"]["mask2d"][1]
    moffs = tctx.mask3d_offsets if d == 3 else tctx.mask2d_offsets
    lo, hi = (1, 3) if d == 3 else (0, 2)
    cot = np.random.default_rng(0).standard_normal((400, (hi - lo) * 2)).astype(np.float32)

    def jfn(t):
        return jenc.grid_encode(jnp.asarray(pts), t, jspec, lo, hi, occ_mask=jmask,
                                mask_offsets=moffs)

    want = np.asarray(jfn(jnp.asarray(table)))
    jg = np.asarray(jax.grad(lambda t: jnp.sum(jfn(t) * cot))(jnp.asarray(table)))
    leaf = torch.from_numpy(table).requires_grad_()
    got = tenc.grid_encode(torch.from_numpy(pts), leaf, spec, lo, hi, occ_mask=tmask,
                           mask_offsets=moffs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    unmasked = tenc.grid_encode(torch.from_numpy(pts), leaf, spec, lo, hi)
    assert not np.allclose(unmasked.detach().numpy(), want, atol=1e-3)   # the mask bites
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(leaf.grad.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_mixed_level_encode_matches(setup, masked):
    """`grid_encode_diff_levels`, first levels from -1 (clipped to 0) to L-1
    (the last calc level clipped to L-1): 1e-5 max abs, d_table 1e-5 of max."""
    jctx, tctx = setup["jctx"], setup["tctx"]
    spec, table, pts = _encode_inputs(setup, 3, 20)
    ids = np.random.default_rng(2).integers(-1, spec.n_levels, 400).astype(np.int32)
    kw_j = dict(occ_mask=setup["jc"]["mask3d"], mask_offsets=tctx.mask3d_offsets) if masked else {}
    kw_t = dict(occ_mask=setup["tc"]["mask3d"], mask_offsets=tctx.mask3d_offsets) if masked else {}
    cot = np.random.default_rng(1).standard_normal((400, 4)).astype(np.float32)

    def jfn(t):
        return jenc.grid_encode_diff_levels(jnp.asarray(pts), t, jctx.spec3, jnp.asarray(ids), 2,
                                            **kw_j)

    want = np.asarray(jfn(jnp.asarray(table)))
    jg = np.asarray(jax.grad(lambda t: jnp.sum(jfn(t) * cot))(jnp.asarray(table)))
    leaf = torch.from_numpy(table).requires_grad_()
    got = tenc.grid_encode_diff_levels(torch.from_numpy(pts), leaf, spec, torch.from_numpy(ids),
                                       2, **kw_t)
    assert got.shape == (400, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(leaf.grad.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())


def test_given_table_encode_matches(setup):
    """An asymmetric plane, x-fastest, under the pn mask: 1e-5 max abs."""
    tctx = setup["tctx"]
    r = tctx.pn_res
    rng = np.random.default_rng(4)
    plane = (rng.random((r * r, 2)) + np.arange(r * r)[:, None] / (r * r)).astype(np.float32)
    pts = rng.random((300, 2)).astype(np.float32)
    want = np.asarray(jenc.grid_encode_given_table(
        jnp.asarray(pts), jnp.asarray(plane), r, occ_mask=setup["jc"]["mask2d"][2],
        mask_offset=tctx.pn_mask_offset))
    leaf = torch.from_numpy(plane).requires_grad_()
    got = tenc.grid_encode_given_table(torch.from_numpy(pts), leaf, r,
                                       occ_mask=setup["tc"]["mask2d"][2],
                                       mask_offset=tctx.pn_mask_offset)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    # transposed, the plane reads differently: the orientation is pinned
    swapped = torch.from_numpy(plane.reshape(r, r, 2).transpose(1, 0, 2).reshape(-1, 2).copy())
    other = tenc.grid_encode_given_table(torch.from_numpy(pts), swapped, r)
    assert not np.allclose(other.numpy(), want, atol=1e-3)
    got.sum().backward()
    assert float(leaf.grad.abs().sum()) > 0


def test_encode_mask_needs_offsets(setup):
    spec, table, pts = _encode_inputs(setup, 3, 1)
    with pytest.raises(ValueError, match="mask_offsets"):
        tenc.grid_encode(torch.from_numpy(pts), torch.from_numpy(table), spec,
                         occ_mask=setup["tc"]["mask3d"])


# ------------------------------------------------------------- K6 and K7
@pytest.mark.parametrize("rank", [1, 2])
def test_segment_pool_matches(rank):
    """Masked sums over sorted ids with invalid rows in between: 1e-6 of the
    largest sum; the gradient (a gather) exactly."""
    rng = np.random.default_rng(6)
    n, num = 3000, 77
    seg = np.sort(rng.integers(0, num, n)).astype(np.int32)
    valid = rng.random(n) < 0.6
    valid[seg == 5] = False                      # a segment without a valid row
    x = rng.standard_normal((n,) if rank == 1 else (n, 2)).astype(np.float32)
    want = np.asarray(jcm._segment_tail_values(jnp.asarray(x), jnp.asarray(seg),
                                               jnp.asarray(valid), num))
    leaf = torch.from_numpy(x).requires_grad_()
    got = cops._segment_pool_plain(leaf, torch.from_numpy(seg), torch.from_numpy(valid), num)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert not got.detach().numpy()[5].any()
    cot = rng.standard_normal(want.shape).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jcm._segment_tail_values(
        v, jnp.asarray(seg), jnp.asarray(valid), num) * cot))(jnp.asarray(x)))
    np.testing.assert_array_equal(leaf.grad.numpy(), jg)


def test_segment_gather_is_the_transpose_of_the_pooling():
    """out[i] = values[seg[i]] where valid, and its gradient is the pooling
    of the row gradients (1e-6 of the largest sum)."""
    rng = np.random.default_rng(9)
    n, num = 2000, 12
    seg = torch.from_numpy(np.sort(rng.integers(0, num, n)).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.7)
    vals = torch.from_numpy(rng.standard_normal(num).astype(np.float32)).requires_grad_()
    out = cops.segment_gather(vals, seg, valid)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.where(valid.numpy(), vals.detach().numpy()[seg.numpy()], 0))
    cot = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    out.backward(cot)
    want = cops._segment_pool_plain(cot, seg, valid, num)
    np.testing.assert_allclose(vals.grad.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("sample_cap", [None, 1 << 10, 1 << 8])
def test_pn_frac_plane_matches(setup, sample_cap):
    """Unsampled and stride-sampled planes within 1e-6, on every axis, and
    the straight-through gradient to the finest level within 1e-5 of max."""
    jctx, tctx = setup["jctx"], setup["tctx"]
    tbl = setup["tabs"]["xyz"]
    for ax in ("xy", "xz", "yz"):
        want = np.asarray(jctx.pn_frac_plane(jnp.asarray(tbl), setup["jc"]["pn"][ax],
                                             sample_cap=sample_cap))
        got = tctx.pn_frac_plane(torch.from_numpy(tbl), setup["tc"]["pn"][ax],
                                 sample_cap=sample_cap)
        assert got.shape == (tctx.pn_res ** 2, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert want.max() > 0.2
    cot = np.random.default_rng(8).standard_normal(want.shape).astype(np.float32)
    jg = np.asarray(jax.grad(lambda t: jnp.sum(jctx.pn_frac_plane(
        t, setup["jc"]["pn"]["yz"], sample_cap=sample_cap) * cot))(jnp.asarray(tbl)))
    leaf = torch.from_numpy(tbl).requires_grad_()
    tctx.pn_frac_plane(leaf, setup["tc"]["pn"]["yz"], sample_cap=sample_cap).backward(
        torch.from_numpy(cot))
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(leaf.grad.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())


# --------------------------------------------------------- windows and pools
def test_window_slices_are_end_clamped():
    """A window that starts near the end of the last level is shifted back
    and masked, exactly as cnc_tpu's (whose dynamic_slice clamps the start)."""
    x = np.arange(100, dtype=np.int32)
    for start_v, end_v in ((0, 30), (5, 20), (10, 40), (25, 40), (39, 40)):
        (jx,), jvalid = jcm._window_slices({"x": jnp.asarray(x)}, ("x",), 60, jnp.int32(start_v),
                                           jnp.int32(end_v), 30, 40)
        (tx,), tvalid = tcm._window_slices({"x": torch.from_numpy(x)}, ("x",), 60, start_v,
                                           end_v, 30, 40)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        # the valid rows are exactly the level's vertices [start_v, end_v)
        np.testing.assert_array_equal(tx.numpy()[tvalid.numpy()],
                                      np.arange(60 + start_v, 60 + end_v))


def _window_cases(t):
    """Entry windows at the start, in the middle and at the very end of a
    level: (start_e, n_e)."""
    n_e = max(1, t.n_entries // 5)
    return [(0, n_e), ((t.n_entries - n_e) // 2, n_e), (t.n_entries - n_e, n_e)]


def test_pool_3d_level_matches(setup):
    """Every context level, windows up to the last vertex of the last level:
    pooled within 1e-5, covered and values exactly."""
    jctx, tctx = setup["jctx"], setup["tctx"]
    tbl = setup["tabs"]["xyz"]
    for l in tctx.ctx_levels_3d:
        t = tctx.tables3d[l]
        for start_e, n_e in _window_cases(t):
            w = int(tctx.max_window_pts(
                [n_e if x == l else 1 for x in tctx.ctx_levels_3d]
                + [1] * len(tctx.ctx_levels_2d))[tctx.ctx_levels_3d.index(l)])
            jo = t.offset
            pg_j = jent.global_pg_bits(jnp.asarray(tbl[jo:jo + tctx.spec3.level_sizes[l]]))[0]
            want = jctx.pool_3d_level(setup["jp"], jnp.asarray(tbl), setup["jc"], l, pg_j,
                                      jnp.int32(start_e), n_e, w)
            pg_t = tent.global_pg_bits(torch.from_numpy(tbl[jo:jo + tctx.spec3.level_sizes[l]]))[0]
            with torch.no_grad():
                got = tctx.pool_3d_level(setup["tp"], torch.from_numpy(tbl), setup["tc"], l, pg_t,
                                         start_e, n_e, w)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
            assert got[1].any()
    last = tctx.tables3d[tctx.ctx_levels_3d[-1]]
    assert last.v_off + last.n_vertices == tctx.table_arrays["3d"]["pos_flat"].shape[0]


def test_pool_2d_level_matches(setup):
    """Both branches (with and without v_ctx_cap_2d, by the fixture's
    variant), every axis, windows to the level's end: 1e-5, covered exact."""
    jctx, tctx = setup["jctx"], setup["tctx"]
    fine = setup["tabs"]["xyz"]
    for ai, ax in enumerate(("xy", "xz", "yz")):
        tbl = setup["tabs"][ax]
        jplane = jctx.pn_frac_plane(jnp.asarray(fine), setup["jc"]["pn"][ax])
        tplane = tctx.pn_frac_plane(torch.from_numpy(fine), setup["tc"]["pn"][ax])
        for l in tctx.ctx_levels_2d:
            t = tctx.tables2d[l]
            o = tctx.spec2.offsets[l]
            pg_j = jent.global_pg_bits(jnp.asarray(tbl[o:o + tctx.spec2.level_sizes[l]]))[0]
            pg_t = tent.global_pg_bits(torch.from_numpy(tbl[o:o + tctx.spec2.level_sizes[l]]))[0]
            for start_e, n_e in _window_cases(t) + [(0, t.n_entries)]:
                w = t.n_points if n_e == t.n_entries else int(tctx.max_window_pts(
                    [1] * len(tctx.ctx_levels_3d)
                    + [n_e if x == l else 1 for x in tctx.ctx_levels_2d]
                )[len(tctx.ctx_levels_3d) + tctx.ctx_levels_2d.index(l)])
                want = jctx.pool_2d_level(setup["jp"], jnp.asarray(tbl), l, pg_j, jplane,
                                          setup["jc"]["bin2d"][ai], setup["jc"]["mask2d"][ai],
                                          jnp.int32(start_e), n_e, w)
                with torch.no_grad():
                    got = tctx.pool_2d_level(setup["tp"], torch.from_numpy(tbl), l, pg_t, tplane,
                                             setup["tc"]["bin2d"][ai], setup["tc"]["mask2d"][ai],
                                             start_e, n_e, w)
                np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
                np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
                np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# ------------------------------------------------------------------ the rate
def _rate_both(jctx, tctx, jc, tc, tabs, jp, tp, key):
    starts = starts_from_key(tctx, key)
    jt = {k: jnp.asarray(v) for k, v in tabs.items()}

    def jloss(p, t):
        return jctx.rate_bits_2d(p, t, key, jc) + jctx.rate_bits_3d(p, t["xyz"], key, jc)

    with jax.disable_jit():
        jb2 = float(jctx.rate_bits_2d(jp, jt, key, jc))
        jb3, jutil = jctx.rate_bits_3d(jp, jt["xyz"], key, jc, with_util=True)
    jg = jax.grad(jloss, argnums=(0, 1))(jp, jt)
    tt = {k: torch.from_numpy(v).requires_grad_() for k, v in tabs.items()}
    tp.zero_grad(set_to_none=True)
    tb2 = tctx.rate_bits_2d(tp, tt, starts["2d"], tc)
    tb3, tutil = tctx.rate_bits_3d(tp, tt["xyz"], starts["3d"], tc, with_util=True)
    (tb2 + tb3).backward()
    return (jb2, float(jb3), float(jutil), jg), (float(tb2.detach()), float(tb3.detach()), float(tutil), tt)


def _assert_rate_matches(jres, tres, tp):
    """Bits within 1e-4 relative; the gradient of every table and of every
    context-MLP parameter within 1e-4 of its largest entry."""
    (jb2, jb3, jutil, jg), (tb2, tb3, tutil, tt) = jres, tres
    np.testing.assert_allclose(tb2, jb2, rtol=1e-4)
    np.testing.assert_allclose(tb3, jb3, rtol=1e-4)
    assert tutil == jutil
    for k, leaf in tt.items():
        want = np.asarray(jg[1][k])
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    n = 0
    for name, p in tp.named_parameters():
        want = jg[0]
        for part in name.split("."):
            want = want[part]
        want = np.asarray(want)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
        n += 1
    assert n == 8                    # w and b of three 3D layers and one 2D level


@pytest.mark.parametrize("key_seed", [5, 11])
def test_rate_bits_and_gradients_match(setup, key_seed):
    s = setup
    key = jax.random.PRNGKey(key_seed)
    jres, tres = _rate_both(s["jctx"], s["tctx"], s["jc"], s["tc"], s["tabs"], s["jp"], s["tp"],
                            key)
    _assert_rate_matches(jres, tres, s["tp"])
    if s["tctx"].cfg.v_ctx_cap < 1 << 15:
        assert tres[2] > 1.0           # the small budget overflows: rows are dropped
    else:
        assert 0.0 < tres[2] < 1.0


@pytest.mark.parametrize("flags", [dict(ctx_grad=False), dict(pn_frac_grad=True),
                                   dict(use_overlap_area_pool=False),
                                   dict(use_dimension_wise=False)],
                         ids=lambda f: next(iter(f)))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rate_options_match(variant, flags):
    jctx, tctx = make_pair(**VARIANTS[variant], **flags)
    b = asymmetric_occupancy(seed=2)
    jc, tc = jctx.refresh_cache(jnp.asarray(b)), tctx.refresh_cache(torch.from_numpy(b))
    jp = jctx.init_params(jax.random.PRNGKey(1))
    tp = tctx.ent_params_from_jax(jax.tree.map(np.asarray, jp))
    jres, tres = _rate_both(jctx, tctx, jc, tc, random_sign_tables(tctx, 3), jp, tp,
                            jax.random.PRNGKey(21))
    _assert_rate_matches(jres, tres, tp)


def test_rate_estimate_and_drawn_starts(setup):
    """`rate_estimate` is the two halves over the parameter count; the
    port's own draws are valid window starts and repeat with the seed."""
    s = setup
    tctx = s["tctx"]
    a = tctx.draw_starts(torch.Generator().manual_seed(3))
    assert a == tctx.draw_starts(torch.Generator().manual_seed(3))
    assert a != tctx.draw_starts(torch.Generator().manual_seed(4))
    for l, st in a["3d"].items():
        assert 0 <= st <= tctx.tables3d[l].n_entries - tctx.tables3d[l].sample_n
    assert set(a["2d"]) == {(ai, l) for ai in range(3) for l in tctx.ctx_levels_2d}
    tt = {k: torch.from_numpy(v) for k, v in s["tabs"].items()}
    with torch.no_grad():
        bpp, mb = tctx.rate_estimate(s["tp"], tt, a, s["tc"])
        bits = tctx.rate_bits_2d(s["tp"], tt, a["2d"], s["tc"]) + tctx.rate_bits_3d(
            s["tp"], tt["xyz"], a["3d"], s["tc"])
    np.testing.assert_allclose(float(bpp), float(bits) / tctx.total_param_count, rtol=1e-6)
    np.testing.assert_allclose(float(mb), float(bits) / 8 / 2 ** 20, rtol=1e-6)
    with pytest.raises(ValueError, match="window start"):
        tctx.rate_bits_3d(s["tp"], tt["xyz"], {l: 10 ** 6 for l in a["3d"]}, s["tc"])


def test_start_rounding_is_float32_half_even():
    t = tcm.Level3DTable(0, 10, 0, 1001, 1000, 996, 0, 0, 0, 0, 1001)    # span 5
    want = [int(jnp.round((t.n_entries - t.sample_n) * jnp.float32(u)).astype(jnp.int32))
            for u in (0.1, 0.3, 0.5, 0.7, 0.9)]
    assert [tcm.ContextModels.start_from_uniform(t, u) for u in (0.1, 0.3, 0.5, 0.7, 0.9)] == want
    assert want == [0, 2, 2, 4, 4]


def test_ent_params_carry_and_init(setup):
    s = setup
    tctx = s["tctx"]
    for name, p in s["tp"].named_parameters():
        want = s["jp"]
        for part in name.split("."):
            want = want[part]
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(want))
    assert tctx.param_count(s["tp"]) == s["jctx"].param_count(s["jp"])
    fresh = tctx.init_params(torch.Generator().manual_seed(1))
    assert {n: tuple(p.shape) for n, p in fresh.named_parameters()} == \
        {n: tuple(p.shape) for n, p in s["tp"].named_parameters()}
    w = fresh.ctx3d["l0"].w
    assert float(w.abs().max()) <= 1.0 / np.sqrt(w.shape[0])
    bad = jax.tree.map(np.asarray, s["jp"])
    bad["ctx3d"]["l1"]["w"] = bad["ctx3d"]["l1"]["w"][:, :5]
    with pytest.raises(ValueError, match="ctx3d/l1"):
        tctx.ent_params_from_jax(bad)
    x = np.random.default_rng(0).standard_normal((9, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tctx.apply_ctx3d(s["tp"].ctx3d, torch.from_numpy(x)).detach().numpy(),
        np.asarray(s["jctx"].apply_ctx3d(s["jp"]["ctx3d"], jnp.asarray(x))), rtol=1e-5,
        atol=1e-6)
