"""The codec's fused pool (`intctx.int_ctx_pool`, one launch a pool on the
card) on the CPU, at tests/test_context_models.py:tiny_setup's size.

  * Its twin, `int_ctx_pool_plain` (the kept rows alone through the encode,
    the MLP and the pooling), equals the whole-window twins it replaced
    (`int_encode` and `int_mlp_pool` over a `_window_slices` window) and
    cnc_tpu's `pool_3d_level_int` / `pool_2d_level_int` (msum, wsum,
    covered, values): at an end-clamped window whose head rows are shifted
    in, at windows with no row kept and with every row kept, and in 2D with
    and without the prior plane.
  * The kernel's row handling mirrored in numpy (tests/ctx_pool_cases.py):
    its tile compaction, batches and run-segmented sums equal
    `segment_sum_int`, and its order check equals a direct check of the
    precondition, at tile, warp, batch and block edges.
  * The kernel's interpolation table equals `_axis_interp` (and cnc_tpu's)
    at every coordinate of every (rf, rc) pair of the flagship grids.
  * The precondition holds on the codec's windows: the kept rows' entries
    do not decrease.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.codec import intctx as jint
from cnc_torch.codec import codec as tcodec
from cnc_torch.codec import intctx as tint
from cnc_torch.config import EntropyConfig, ModelConfig
from cnc_torch.models import context_models as tcm

import ctx_pool_cases as pc
from test_torch_context_tables import asymmetric_occupancy, make_pair, random_sign_tables


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores: many small
    integer ops spread over every core's thread only contend, so this
    module's ops run on one thread (restored after it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**overrides):
    jctx, tctx = make_pair(max_points_per_chunk=1 << 13, **overrides)
    b = asymmetric_occupancy(seed=4)
    tabs = {k: v.astype(np.int32) for k, v in random_sign_tables(tctx, seed=6).items()}
    jp = jctx.init_params(jax.random.PRNGKey(3))
    jp_np = {g: {k: {n: np.asarray(a) for n, a in lin.items()} for k, lin in tree.items()}
             for g, tree in jp.items()}
    tc = tcodec.CNCCodec(tctx)
    ip_t = tc._int_params(tctx.ent_params_from_jax(jp_np))
    ip_j = {g: {k: {n: jnp.asarray(a.numpy()) for n, a in lin.items()} for k, lin in tree.items()}
            for g, tree in ip_t.items()}
    return dict(jctx=jctx, tctx=tctx, tc=tc, b=b, tabs=tabs, ip_t=ip_t, ip_j=ip_j,
                tcache=tctx.refresh_cache_int(torch.from_numpy(b)),
                jcache=jctx.refresh_cache_int(jnp.asarray(b)))


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def pair_no_plane():
    """Without the dimension-wise prior: the 2D Linear takes no plane."""
    return _pair(use_dimension_wise=False)


def _window_twins(tctx, kind, level, start_e, n_e, w, int_params, sign, mask_flat, m_shift,
                  pg_q, plane=None, ovl=None):
    """The whole-window composition the pool replaced: a `_window_slices`
    window of capacity w, its rows' mask bytes and validity, `int_encode`
    over every row, `int_mlp_pool` with the unkept rows weighed 0."""
    t = (tctx.tables3d if kind == "3d" else tctx.tables2d)[level]
    a = tctx._arrays3d if kind == "3d" else tctx._arrays2d
    cum = tctx._cum_np[kind]
    start_v, end_v = int(cum[t.c_off + start_e]), int(cum[t.c_off + start_e + n_e])
    name = "pos_flat" if kind == "3d" else "coords"
    total = t.n_vertices if kind == "3d" else t.n_points
    (ids, slots), valid = tcm._window_slices(a, (name, "vert_entry"), t.v_off, start_v, end_v, w,
                                             total)
    slots = torch.clamp(slots - start_e, 0, n_e - 1)
    d = 3 if kind == "3d" else 2
    offs = tctx.mask3d_offsets if kind == "3d" else tctx.mask2d_offsets
    mask = mask_flat[offs[level] + tint.lattice_index(ids, d, t.resolution)] & valid
    spec = tctx.spec3 if kind == "3d" else tctx.spec2
    k = tctx.cfg.max_context_layer_num if kind == "3d" else min(level,
                                                                tctx.cfg.max_context_layer_num)
    levels = tctx._ctx_levels_meta(spec, offs, level - k, level)
    feats = tint.int_encode(ids, d, t.resolution, sign, levels, mask_flat, plane)
    return tint.int_mlp_pool(int_params, None if kind == "3d" else level, feats, pg_q, m_shift,
                             mask, slots, n_e, ovl, ids if ovl is not None else None), \
        start_v - max(0, min(start_v, total - w))


def _has_rows(tctx, kind, level, start_e, n_e):
    """[n_e] bool: the entries of the window that hold at least one row."""
    t = (tctx.tables3d if kind == "3d" else tctx.tables2d)[level]
    cum = tctx._cum_np[kind][t.c_off + start_e:t.c_off + start_e + n_e + 1]
    return torch.from_numpy(np.diff(cum) > 0)


def _level_mask(cache, tctx, kind, level, fill, ax=0):
    """A copy of the cache's mask with one level's own segment set to fill."""
    offs = tctx.mask3d_offsets if kind == "3d" else tctx.mask2d_offsets
    t = (tctx.tables3d if kind == "3d" else tctx.tables2d)[level]
    m = (cache["mask3d"] if kind == "3d" else cache["mask2d"][ax]).clone()
    m[offs[level]:offs[level] + t.resolution ** (3 if kind == "3d" else 2)] = fill
    return m


@pytest.mark.parametrize("window", ["end-clamped", "none kept", "all kept", "every chunk"])
def test_pool_3d_equals_the_window_twins_and_cnc_tpu(pair, window):
    """3D: the pool's twin against the whole-window twins and cnc_tpu's
    pool_3d_level_int (msum, wsum, covered, values), overlap pooling on."""
    tctx, jctx, tc = pair["tctx"], pair["jctx"], pair["tc"]
    sign = torch.from_numpy(pair["tabs"]["xyz"])
    level = tctx.ctx_levels_3d[-1]
    t = tctx.tables3d[level]
    chunk_e, n_chunks, w = tc.chunks3d[level]
    assert n_chunks > 2
    windows = [(start, chunk_e, w) for (_, _, start) in tc._chunk_bounds(level)]
    cache, jcache = pair["tcache"], pair["jcache"]
    if window == "end-clamped":     # the last entries in a window with 50 rows shifted in
        cum = tctx._cum_np["3d"]
        n_e = chunk_e
        rows = int(cum[t.c_off + t.n_entries] - cum[t.c_off + t.n_entries - n_e])
        windows = [(t.n_entries - n_e, n_e, rows + 50)]
    elif window in ("none kept", "all kept"):
        mask = _level_mask(cache, tctx, "3d", level, window == "all kept")
        cache = dict(cache, mask3d=mask)
        jcache = dict(jcache, mask3d=jnp.asarray(mask.numpy()))
        windows = windows[n_chunks // 2:n_chunks // 2 + 1]
    ovl = cache["ovl_int"][str(level)]
    for start, n_e, w in windows:
        got = tctx.pool_3d_level_int(pair["ip_t"], sign, cache, level, 131, start, n_e, w,
                                     tc.m_shift3[level])
        want = jctx.pool_3d_level_int(pair["ip_j"], jnp.asarray(pair["tabs"]["xyz"]), jcache,
                                      level, jnp.int32(131), jnp.int32(start), n_e, w,
                                      tc.m_shift3[level])
        for name, a, b in zip(("msum", "wsum", "covered", "values"), got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{start} {name}")
        (msum, wsum), shift = _window_twins(tctx, "3d", level, start, n_e, w, pair["ip_t"],
                                            sign, cache["mask3d"], tc.m_shift3[level], 131,
                                            ovl=ovl)
        assert torch.equal(got[0], msum) and torch.equal(got[1], wsum)
        if window == "end-clamped":
            assert shift == 50
        if window == "none kept":
            assert not got[1].any() and not got[0].any()
        if window == "all kept":
            assert torch.equal(got[2], _has_rows(tctx, "3d", level, start, n_e))


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "no plane"])
@pytest.mark.parametrize("fill", [None, False, True], ids=["cache", "none kept", "all kept"])
def test_pool_2d_equals_the_window_twins_and_cnc_tpu(request, plane, fill):
    """2D, every plane: the pool's twin against the whole-window twins and
    cnc_tpu's pool_2d_level_int (msum, cnt, covered, values), with the
    integer frac plane and, in a model without the dimension-wise prior,
    without it."""
    pair = request.getfixturevalue("pair" if plane else "pair_no_plane")
    tctx, jctx, tc = pair["tctx"], pair["jctx"], pair["tc"]
    sign3 = torch.from_numpy(pair["tabs"]["xyz"])
    for ai, ax in enumerate(tcm.AXES):
        sign2 = torch.from_numpy(pair["tabs"][ax])
        plane_q = tctx.frac_plane_int(sign3, pair["tcache"]["pn"][ax]) if plane else None
        jplane = jnp.asarray(plane_q.numpy()) if plane else None
        for level in tctx.ctx_levels_2d:
            t = tctx.tables2d[level]
            mask = pair["tcache"]["mask2d"][ai] if fill is None else \
                _level_mask(pair["tcache"], tctx, "2d", level, fill, ai)
            got = tctx.pool_2d_level_int(pair["ip_t"], sign2, level, 77, plane_q, mask, 0,
                                         t.n_entries, t.n_points, tc.m_shift2[level])
            want = jctx.pool_2d_level_int(pair["ip_j"], jnp.asarray(pair["tabs"][ax]), level,
                                          jnp.int32(77), jplane, jnp.asarray(mask.numpy()),
                                          jnp.int32(0), t.n_entries, t.n_points,
                                          tc.m_shift2[level])
            for name, a, b in zip(("msum", "cnt", "covered", "values"), got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{ax}{level} {name}")
            pl = (plane_q, tctx.pn_res, tctx.pn_mask_offset) if plane else None
            (msum, cnt), _ = _window_twins(tctx, "2d", level, 0, t.n_entries, t.n_points,
                                           pair["ip_t"], sign2, mask, tc.m_shift2[level], 77,
                                           plane=pl)
            assert torch.equal(got[0], msum) and torch.equal(got[1], cnt)
            if fill is False:
                assert not got[1].any()
            if fill is True:
                assert torch.equal(got[2], _has_rows(tctx, "2d", level, 0, t.n_entries))


@pytest.mark.parametrize("name", pc.CASES)
@pytest.mark.parametrize("resident", [1, 3, 264])
def test_kernel_rows_mirror_equals_segment_sum(name, resident):
    """The kernel's compaction, batches and run sums (numpy mirror) equal
    segment_sum_int over the kept rows; every kept row is taken once, in
    order, and a run costs one add per warp it touches."""
    rng = np.random.default_rng(len(name) * 7 + resident)
    keep, slots, n_e = pc.case(name, rng)
    vals = np.stack([rng.integers(-(1 << 10), 1 << 10, keep.size),
                     rng.integers(1, 64, keep.size)], -1)
    taken = np.concatenate([b for r0, r1 in pc.block_spans(keep.size, resident)
                            for b in pc.block_batches(keep, r0, r1)] or [np.zeros(0, int)])
    np.testing.assert_array_equal(taken, np.nonzero(keep)[0])
    got, adds = pc.pool_sums(keep, slots, vals, n_e, resident)
    want = tint.segment_sum_int(torch.from_numpy(vals.astype(np.int32)),
                                torch.from_numpy(slots.astype(np.int32)), torch.from_numpy(keep),
                                n_e)
    np.testing.assert_array_equal(got, want.numpy())
    assert adds <= keep.sum()
    if name == "entry with no kept row":
        assert not got[17].any()
    assert not pc.order_fault(keep, slots, n_e, resident)


def test_block_spans_cover_the_rows():
    for n in (1, pc.TILE - 1, pc.TILE, pc.TILE + 1, 2_044_350, 1_638_400):
        for resident in (1, 3, 264, 528):
            spans = pc.block_spans(n, resident)
            assert spans[0][0] == 0 and spans[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert all((r0 % pc.TILE) == 0 for r0, _ in spans)
            assert len(spans) <= min(2 * resident, pc.MAX_BLOCKS)


@pytest.mark.parametrize("resident", [1, 3, 264])
def test_kernel_order_check_mirror(resident):
    """The mirror of the kernel's fault word equals a direct check of the
    precondition (the kept rows' entries in range and not decreasing) on
    sorted entries broken at one row: inside a warp, between warps, batches
    and blocks, across blocks with no kept row, out of range, or at an
    unkept row (no fault)."""
    rng = np.random.default_rng(resident)
    n = 12 * pc.TILE
    base = np.arange(n) // 16 + 1
    n_e = int(base[-1]) + 1
    for at in (5, 32, 256, pc.TILE, 4 * pc.TILE, 4 * pc.TILE + 3, n - 1):
        for kind in ("decrease", "out of range", "unkept", "empty tiles"):
            keep = rng.random(n) < 0.8
            keep[at] = kind != "unkept"
            slots = base.copy()
            if kind == "out of range":
                slots[at] = n_e
            else:
                slots[at] = max(slots[at - 1] - 1, 0) if at else 0
            if kind == "empty tiles" and at >= pc.TILE:
                keep[at - pc.TILE:at] = False
                slots[at] = max(slots[at - pc.TILE - 1] - 1, 0)
            live = slots[keep]
            want = bool((live >= n_e).any() or (live < 0).any() or (np.diff(live) < 0).any())
            assert pc.order_fault(keep, slots, n_e, resident) == want, (at, kind)


def _flagship_pairs():
    """Every (rf, rc) the flagship codec interpolates: each 3D context
    level against its k coarser levels, each 2D level against its coarser
    levels and the prior plane (the finest 3D resolution)."""
    m, e = ModelConfig(), EntropyConfig()
    r3, r2 = m.resolutions_3d, m.resolutions_2d
    k = e.max_context_layer_num
    pairs = {(r3[l], r3[c]) for l in range(len(r3)) if l not in e.skip_levels_3d
             for c in range(max(0, l - k), l)}
    pairs |= {(r2[l], r2[c]) for l in range(len(r2)) if l not in e.skip_levels_2d
              for c in range(max(0, l - min(l, k)), l)}
    pairs |= {(r2[l], r3[-1]) for l in range(len(r2)) if l not in e.skip_levels_2d}
    return sorted(pairs)


def test_interp_table_equals_axis_interp_on_the_flagship_grids():
    """The kernel's table (pgc * 64 + fq, unpacked by `>> 6` and `& 63`)
    equals `_axis_interp`, the port's and cnc_tpu's, at every coordinate."""
    pairs = _flagship_pairs()
    assert len(pairs) >= 30
    by_rf = {}
    for rf, rc in pairs:
        by_rf.setdefault(rf, []).append(rc)
    for rf, rcs in by_rf.items():
        tab = tint.interp_table(rf, rcs, "cpu").numpy().reshape(len(rcs), rf)
        c = np.arange(rf)
        for i, rc in enumerate(rcs):
            pgc, fq = (np.asarray(a) for a in jint._axis_interp(jnp.asarray(c, jnp.int32), rf, rc))
            tpgc, tfq = (a.numpy() for a in tint._axis_interp(torch.from_numpy(c), rf, rc))
            np.testing.assert_array_equal(tab[i] >> 6, pgc, err_msg=f"{rf} {rc}")
            np.testing.assert_array_equal(tab[i] & 63, fq, err_msg=f"{rf} {rc}")
            np.testing.assert_array_equal(tpgc, pgc)
            np.testing.assert_array_equal(tfq, fq)
            assert fq.min() >= 0 and fq.max() <= tint.Q_AXIS and pgc.min() >= -1


def test_kept_entries_do_not_decrease_in_the_codec_windows(pair):
    """The kernel's precondition on every window the tiny codec pools: each
    3D chunk and each plane's 2D level."""
    tctx, tc, cache = pair["tctx"], pair["tc"], pair["tcache"]
    checked = 0
    for level in tctx.ctx_levels_3d:
        chunk_e, _, w = tc.chunks3d[level]
        for (_, _, start) in tc._chunk_bounds(level):
            ids, slots, _ = tctx._entry_rows("3d", level, start, chunk_e, w, "pos_flat")
            keep = cache["mask3d"][tctx.mask3d_offsets[level] + ids.long()]
            live = slots[keep] - start
            assert bool((live >= 0).all()) and bool((live < chunk_e).all())
            assert bool((live[1:] >= live[:-1]).all())
            checked += 1
    for ai in range(3):
        for level in tctx.ctx_levels_2d:
            t = tctx.tables2d[level]
            ids, slots, _ = tctx._entry_rows("2d", level, 0, t.n_entries, t.n_points, "coords")
            keep = cache["mask2d"][ai][tctx.mask2d_offsets[level]
                                       + tint.lattice_index(ids, 2, t.resolution)]
            live = slots[keep]
            assert bool((live[1:] >= live[:-1]).all())
            checked += 1
    assert checked > 5


def test_twin_raises_on_unsorted_entries(pair):
    tctx, tc, cache = pair["tctx"], pair["tc"], pair["tcache"]
    level = tctx.ctx_levels_3d[-1]
    t = tctx.tables3d[level]
    ids, slots, _ = tctx._entry_rows("3d", level, 0, t.n_entries, t.n_vertices, "pos_flat")
    levels = tctx._ctx_levels_meta(tctx.spec3, tctx.mask3d_offsets,
                                   level - tctx.cfg.max_context_layer_num, level)
    args = (pair["ip_t"], None, ids, slots.flip(0).contiguous(), 0, t.n_entries, t.resolution,
            cache["mask3d"], tctx.mask3d_offsets[level], torch.from_numpy(pair["tabs"]["xyz"]),
            levels, 131, 0)
    with pytest.raises(ValueError, match="must not decrease"):
        tint.int_ctx_pool(*args)
