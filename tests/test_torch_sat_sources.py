"""The mask sources of K1s/K2s (the SAT-masked encode kernels) against
cnc_tpu's `occupancy_mask`, on the CPU.

K1s/K2s do not read the summed-area table per corner: one launch makes
their sources from it (`encoding.sat_mask_sources`, plain twin
`_sat_sources_plain`), the packed corner bits of the coarse levels (R - 2
<= Rb) and the occupancy one bit a cell for the fine ones, and the encode
decides a fine level's 2^D corners from one window of at most 4 (2D) or
4x4 (3D) occupancy rows (csrc/grid_encode.cu `fine_mask`).  Here:

  * the split of a level description (`_sat_layout`), with a level sent
    coarse where its windows would not fit (`_windows_fit`);
  * the twin's coarse bits, unpacked, equal to `cnc_tpu.ops.sat.
    occupancy_mask` over each level's whole lattice, and its occupancy rows
    equal to the grid, window by window;
  * the sources kernel's index math (a warp a word, the jobs' words
    numbered one after the other, the lattice decoded last axis fastest,
    each row word written as the low half of its window and the high half
    of the one before) mirrored in numpy against the twin;
  * the encode's per-corner decision mirrored in numpy (a coarse level's
    bit at mask_off + flat, a fine level's window ORs and masks, in
    float32 without FMA as the kernel forms the boxes) against
    `occupancy_mask` at every corner of points inside, on the faces of and
    near the corners of the cube, on both sides of the split.

Every comparison is exact (the masks are boolean).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnc_tpu.ops import sat as jsat
from cnc_torch.ops import encoding as tenc
from cnc_torch.ops import sat as tsat

GRIDS = ["random", "empty", "full", "single"]
# on both sides of the split (R - 2 = Rb is coarse, Rb + 1 fine)
LEVELS = {3: (32, (10, 18, 34, 35, 66, 130)), 2: (64, (18, 66, 67, 130, 258, 1026))}


def _grid(d, rb, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random((rb,) * d) < 0.03
    if kind == "empty":
        return np.zeros((rb,) * d, bool)
    if kind == "full":
        return np.ones((rb,) * d, bool)
    g = np.zeros((rb,) * d, bool)
    g[tuple(rng.integers(0, rb, size=d))] = True
    return g


def _points(d, n, rng):
    pts = rng.random((n, d)).astype(np.float32)
    pts[:40] = np.round(pts[:40])                           # the cube's corners
    pts[40:80, 0] = rng.choice([0.0, 1.0], size=40)         # and faces
    pts[80:120] = np.where(pts[80:120] < 0.5, pts[80:120] * 1e-3, 1 - pts[80:120] * 1e-3)
    return pts


def _unpack(words, n):
    """Bits 0..n-1 of little-endian int32 words."""
    u = words.numpy().astype(np.int64) & 0xFFFFFFFF
    return ((u[:, None] >> np.arange(32)) & 1).astype(bool).reshape(-1)[:n]


def _lattice_np(r, d):
    return np.stack(np.meshgrid(*[np.arange(r)] * d, indexing="ij"), -1).reshape(-1, d)


def _ends(c, res, rb):
    """The kernel's footprint_ends: float32 steps, no FMA, truncation."""
    scale = np.float32(1.0 / (res - 2.0))
    pn = (c.astype(np.float32) - np.float32(0.5)) * scale
    lo = np.clip((pn - scale) * np.float32(rb), 0, rb - 1).astype(np.int64)
    hi = np.clip((pn + scale) * np.float32(rb), 0, rb - 1).astype(np.int64)
    return lo, hi


def _box_any(sat, lo, hi):
    """box_count > 0 over [lo, hi] ([N, D]) through the table, in numpy."""
    d = lo.shape[1]
    total = np.zeros(lo.shape[0], np.int64)
    for s in range(1 << d):
        idx = tuple(lo[:, ax] if (s >> ax) & 1 else hi[:, ax] + 1 for ax in range(d))
        total += (-1) ** bin(s).count("1") * sat[idx].astype(np.int64)
    return total > 0


def _boxes(pg, res, rb):
    """Each axis's two footprint boxes (corner coordinates pg and pg + 1)
    of points in lattice cells pg [N, D]: lo, hi [N, D, 2]."""
    n, d = pg.shape
    lo = np.zeros((n, d, 2), np.int64)
    hi = np.zeros((n, d, 2), np.int64)
    for ax in range(d):
        for u in range(2):
            c = pg[:, ax] if u == 0 else np.minimum(pg[:, ax] + 1, res - 1)
            lo[:, ax, u], hi[:, ax, u] = _ends(c, res, rb)
    return lo, hi


def _fine_window(rows, pg, res, rb):
    """The kernel's fine_mask for points in lattice cells pg [N, D]:
    [N, 2^D] bool; every window must span at most 4 cells an axis."""
    n, d = pg.shape
    lo, hi = _boxes(pg, res, rb)
    base = lo.min(-1)
    span = hi.max(-1) - base
    assert (span < 4).all()
    last = d - 1
    word, shift = base[:, last] >> 5, (base[:, last] & 31).astype(np.uint64)
    win = np.zeros((n, 4), np.uint64)
    for a in range(4):
        for b in range(4 if d == 3 else 1):
            ok = (a <= span[:, 0]) & ((b <= span[:, 1]) if d == 3 else True)
            row = (base[:, 0] + a) * rb + base[:, 1] + b if d == 3 else base[:, 0] + a
            v = (rows[np.where(ok, row, 0), np.where(ok, word, 0)] >> shift) & np.uint64(0xF)
            win[:, a] |= np.where(ok, v << np.uint64(4 * b), np.uint64(0))
    r = np.zeros((n, 2), np.uint64)
    for a in range(4):
        for u in range(2):
            inside = (a >= lo[:, 0, u] - base[:, 0]) & (a <= hi[:, 0, u] - base[:, 0])
            r[:, u] |= np.where(inside, win[:, a], np.uint64(0))

    def cells(l, h, width):
        return (((1 << (width * (h - l + 1))) - 1) << (width * l)).astype(np.uint64)

    live = np.zeros((n, 1 << d), bool)
    for k in range(1 << d):
        u0, ul = k & 1, (k >> last) & 1
        sel = cells(lo[:, last, ul] - base[:, last], hi[:, last, ul] - base[:, last], 1)
        if d == 3:
            u1 = (k >> 1) & 1
            sel = (sel * np.uint64(0x1111)) & cells(lo[:, 1, u1] - base[:, 1],
                                                     hi[:, 1, u1] - base[:, 1], 4)
        live[:, k] = (r[:, u0] & sel) != 0
    return live


def _cells_and_corners(pts, res):
    """K1's lattice cell of each point and its 2^D corners [N, 2^D, D]."""
    pos = pts * np.float32(res - 2) + np.float32(0.5)
    pg = np.floor(pos).astype(np.int64)
    d = pts.shape[1]
    corners = np.stack([np.stack([pg[:, ax] if not (k >> ax) & 1
                                  else np.minimum(pg[:, ax] + 1, res - 1) for ax in range(d)], -1)
                        for k in range(1 << d)], 1)
    return pg, corners


def test_sat_layout_splits_at_the_grid():
    """grid_3d against the [train] grid's Rb = 128: levels 0-6 coarse (their
    2,117,868 vertices get bits), 7-11 fine; grid_2d: its first level coarse
    (R - 2 = Rb), the rest fine; the bit offsets word-aligned and packed."""
    from cnc_torch.config import CNCConfig
    cfg = CNCConfig().model
    moffs, coarse, words, fine = tenc._sat_layout(3, tuple(cfg.grid_3d.resolutions), 128)
    assert [m >= 0 for m in moffs] == [True] * 7 + [False] * 5 and fine
    assert sum(r ** 3 for r, _ in coarse) == 2117868
    assert words == sum(-(-r ** 3 // 32) for r, _ in coarse)
    assert [m for m in moffs if m >= 0] == [32 * w for _, w in coarse]
    moffs2, coarse2, _, fine2 = tenc._sat_layout(2, tuple(cfg.grid_2d.resolutions), 128)
    assert moffs2 == (0, -1, -1, -1) and coarse2 == ((130, 0),) and fine2
    assert tenc._sat_layout(2, (18, 34), 64)[3] is False


@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("d", [2, 3])
def test_coarse_bits_and_rows_match_cnc_tpu(d, kind):
    rb, res = LEVELS[d]
    grid = _grid(d, rb, kind, 10 * d + GRIDS.index(kind))
    sat_j = jsat.build_sat(jnp.asarray(grid))
    sat_t = tsat.build_sat(torch.from_numpy(grid))
    src = tenc._sat_sources_plain(sat_t, res)
    moffs, coarse, _, _ = tenc._sat_layout(d, res, rb)
    for r, w0 in coarse:
        lat = _lattice_np(r, d)
        want = np.asarray(jsat.occupancy_mask(sat_j, jnp.asarray(lat.astype(np.int32)), r, rb))
        got = _unpack(src.bits[w0:w0 + -(-r ** d // 32)], r ** d)
        np.testing.assert_array_equal(got, want)
        if kind == "empty":
            assert not got.any()
        if kind == "full":
            assert got.all()
    # the rows: window k = word k | word k+1 << 32 of the grid's row
    rows = src.rows.numpy().view(np.uint64)
    nw = (rb + 31) // 32
    assert rows.shape == (rb ** (d - 1), nw)
    flat = grid.reshape(-1, rb)
    for k in range(nw):
        lo_bits = ((rows[:, k] >> np.arange(32, dtype=np.uint64)[:, None]) & np.uint64(1)).T
        want = flat[:, 32 * k:32 * k + 32]
        np.testing.assert_array_equal(lo_bits[:, :want.shape[1]].astype(bool), want)
        assert not lo_bits[:, want.shape[1]:].any()
        hi_word = rows[:, k] >> np.uint64(32)
        nxt = rows[:, k + 1] & np.uint64(0xFFFFFFFF) if k + 1 < nw else np.zeros_like(hi_word)
        np.testing.assert_array_equal(hi_word, nxt)


@pytest.mark.parametrize("rb", [40, 64])
@pytest.mark.parametrize("d", [2, 3])
def test_sources_kernel_index_math(d, rb):
    """A warp a word, the words of every job numbered one after the other
    (the coarse levels, then the occupancy rows) and a warp's job found
    from their ends; a coarse lattice decoded last axis fastest, occupancy
    cells from (row, word); each row word stored as the low half of its
    window, the high half of the window before, the last window's high
    half 0."""
    res = (10, 26, 42, 130)
    grid = _grid(d, rb, "random", 50 + d + rb)
    sat = tsat.build_sat(torch.from_numpy(grid))
    want = tenc._sat_sources_plain(sat, res)
    sat_np = sat.numpy()
    _, coarse, words, fine = tenc._sat_layout(d, res, rb)
    assert fine
    nw, n_rows = (rb + 31) // 32, rb ** (d - 1)
    job_end = np.cumsum([-(-r ** d // 32) for r, _ in coarse] + [n_rows * nw])
    bits = np.zeros(max(words, 1), np.uint32)
    rows32 = np.full(2 * n_rows * nw, 0xDEADBEEF, np.uint32)
    lanes = np.arange(32)
    for w_all in range(int(job_end[-1])):
        job = int(np.searchsorted(job_end, w_all, side="right"))
        w = w_all - (int(job_end[job - 1]) if job > 0 else 0)
        if job < len(coarse):
            r, w0 = coarse[job]
            flat = w * 32 + lanes
            cc = np.zeros((32, d), np.int64)
            f = flat.copy()
            for ax in range(d - 1, -1, -1):
                cc[:, ax] = f % r
                f //= r
            lo, hi = _ends(cc, r, rb)
            bit = (flat < r ** d) & _box_any(sat_np, lo, hi)
            bits[w0 + w] = int((bit.astype(np.uint64) << lanes.astype(np.uint64)).sum())
            continue
        row, k = divmod(w, nw)
        i_last = k * 32 + lanes
        cell = np.zeros((32, d), np.int64)
        rr = row
        for ax in range(d - 2, -1, -1):
            cell[:, ax], rr = rr % rb, rr // rb
        cell[:, d - 1] = np.minimum(i_last, rb - 1)
        bit = (i_last < rb) & _box_any(sat_np, cell, cell)
        word = int((bit.astype(np.uint64) << lanes.astype(np.uint64)).sum())
        at = 2 * (row * nw + k)
        rows32[at] = word
        if k > 0:
            rows32[at - 1] = word
        if k == nw - 1:
            rows32[at + 1] = 0
    np.testing.assert_array_equal(bits[:words].view(np.int32), want.bits.numpy()[:words])
    np.testing.assert_array_equal(rows32.view(np.int64).reshape(n_rows, nw), want.rows.numpy())


@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("d", [2, 3])
def test_corner_decision_matches_cnc_tpu(d, kind):
    """Every corner of 3,000 points at every level: the coarse levels' bit
    at mask_off + flat (last axis fastest), the fine levels' window,
    against cnc_tpu's occupancy_mask."""
    rb, res = LEVELS[d]
    grid = _grid(d, rb, kind, 30 * d + GRIDS.index(kind))
    sat_j = jsat.build_sat(jnp.asarray(grid))
    sat_t = tsat.build_sat(torch.from_numpy(grid))
    src = tenc._sat_sources_plain(sat_t, res)
    moffs, _, words, _ = tenc._sat_layout(d, res, rb)
    all_bits = _unpack(src.bits, 32 * max(words, 1))
    rows = src.rows.numpy().view(np.uint64)
    pts = _points(d, 3000, np.random.default_rng(d + 7 * GRIDS.index(kind)))
    kept = 0
    for r, moff in zip(res, moffs):
        pg, corners = _cells_and_corners(pts, r)
        want = np.asarray(jsat.occupancy_mask(sat_j, jnp.asarray(corners.astype(np.int32)), r,
                                              rb))
        if moff >= 0:
            flat = corners[..., 0]
            for ax in range(1, d):
                flat = flat * r + corners[..., ax]
            got = all_bits[moff + flat]
        else:
            got = _fine_window(rows, pg, r, rb)   # R - 2 > Rb: every window fits
        np.testing.assert_array_equal(got, want, err_msg=f"R={r}")
        kept += int(got.sum())
    if kind == "empty":
        assert kept == 0
    elif kind == "full":
        assert kept == 3000 * len(res) * 2 ** d
    else:
        assert 0 < kept < 3000 * len(res) * 2 ** d


def test_windows_fit_above_the_split():
    """At R - 2 > Rb the two boxes of an axis cover less than 3 cells'
    length, so every window fits in 4 cells (`_windows_fit`) over a sweep of
    grids and levels; below the split the boxes are a cell or wider and the
    windows do not fit."""
    for rb in (1, 2, 5, 16, 31, 32, 64, 100, 128, 256, 512):
        assert all(tenc._windows_fit(r, rb) for r in range(rb + 3, 4 * rb + 8))
    assert not any(tenc._windows_fit(r, 32) for r in (10, 12, 18, 26))


@pytest.mark.parametrize("d", [2, 3])
def test_wide_windows_make_a_level_coarse(d, monkeypatch):
    """A level whose windows do not fit goes coarse even at R - 2 > Rb: the
    windows of R = 12 on Rb = 32 are wider than 4 cells (the numpy boxes
    agree with `_windows_fit`), and a fine R = 66 declared unfit gets
    vertex bits equal to cnc_tpu's occupancy_mask over its lattice, and no
    occupancy rows."""
    rb = 32
    lo, hi = _boxes(np.arange(11)[:, None].repeat(d, 1), 12, rb)
    assert (hi.max(-1) - lo.min(-1) >= 4).any() and not tenc._windows_fit(12, rb)
    grid = _grid(d, rb, "random", 90 + d)
    sat_j = jsat.build_sat(jnp.asarray(grid))
    sat_t = tsat.build_sat(torch.from_numpy(grid))
    fits = tenc._windows_fit
    for cache in (tenc._sat_layout, tenc._sat_ctypes):
        monkeypatch.setattr(tenc, cache.__name__, functools.lru_cache(cache.__wrapped__))
    monkeypatch.setattr(tenc, "_windows_fit", lambda r, rb: r != 66 and fits(r, rb))
    moffs, coarse, _, fine = tenc._sat_layout(d, (12, 66), rb)
    assert moffs[1] >= 0 and not fine and coarse[1][0] == 66
    src = tenc._sat_sources_plain(sat_t, (12, 66))
    assert src.rows is None
    for r, w0 in coarse:
        lat = jnp.asarray(_lattice_np(r, d).astype(np.int32))
        want = np.asarray(jsat.occupancy_mask(sat_j, lat, r, rb))
        np.testing.assert_array_equal(_unpack(src.bits[w0:w0 + -(-r ** d // 32)], r ** d), want)


@pytest.mark.parametrize("d", [2, 3])
def test_sat_mask_sources_on_cpu_is_the_twin(d):
    """The public entry point takes the twin on a CPU tensor; without a fine
    level it makes no rows, and a coarse-free description gives one word."""
    rb = 16
    sat = tsat.build_sat(torch.from_numpy(_grid(d, rb, "random", 3)))
    got = tenc.sat_mask_sources(sat, (10, 18, 34))
    want = tenc._sat_sources_plain(sat, (10, 18, 34))
    assert torch.equal(got.bits, want.bits) and torch.equal(got.rows, want.rows)
    assert tenc.sat_mask_sources(sat, (10, 18)).rows is None
    fine_only = tenc.sat_mask_sources(sat, (34, 66))
    assert fine_only.bits.shape == (1,) and fine_only.rows is not None
