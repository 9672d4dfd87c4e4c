"""The stream compaction (K3) and the mask packing of cnc_torch at the edges of
their kernels, on the CPU.

Both kernels (csrc/compact.cu, csrc/grid_encode.cu `pack_mask_bits_kernel`)
read masks 16 bytes at a time and turn bytes into bits with a compare and a
multiply; K3 walks tiles of 8,192 bytes with a decoupled look-back.  Their
arithmetic is mirrored step for step in tests/compact_pack_cases.py, and each
step is held here to numpy: the byte-to-bit constant over every pattern of 8
bytes, the split into 16-byte loads and byte-by-byte edges, the look-back over
tiles that have and have not yet published their prefix, the status word, the
stage's padded slots, the zero fill's split.  The plain twins are held to
cnc_tpu's compact_mask_indices (through JAX on the CPU) and to numpy's
packbits at the same edges.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnc_tpu.ops import scatter_ops as jscatter
from cnc_torch.ops import encoding as enc
from cnc_torch.ops import scatter_ops as tscatter
from compact_pack_cases import (AGGREGATE, COMPACT_CASES, K3_BYTES, K3_TILE, PACK_CASES,
                                PREFIX, TAG_MOD, byte_bits32, byte_bits4, compact_case,
                                fill_split, k3_emulate, k3_split, launch_tag, look_back,
                                pack_case, pack_emulate, pack_split, stage_slot,
                                status_fields, status_word, vcmpne4)


def numpy_compact(mask: np.ndarray, cap: int):
    pos = np.flatnonzero(mask).astype(np.int32)
    src = np.zeros(cap, np.int32)
    src[:min(pos.size, cap)] = pos[:cap]
    return src, pos.size


def packbits_words(mask: np.ndarray) -> np.ndarray:
    m = mask.shape[-1]
    pad = np.zeros(mask.shape[:-1] + ((-m) % 32,), bool)
    packed = np.packbits(np.concatenate([mask != 0, pad], axis=-1), axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<i4")


def torch_view(buf: np.ndarray, offset: int, shape):
    """The mask as a bool view at `offset` bytes into a torch buffer."""
    n = int(np.prod(shape))
    return torch.from_numpy(buf).view(torch.bool)[offset:offset + n].view(shape)


@pytest.mark.parametrize("name", list(COMPACT_CASES))
def test_compact_twin_equals_cnc_tpu(name):
    buf, off, n, cap = compact_case(name)
    mask = buf[off:off + n].astype(bool)
    view = torch_view(buf, off, (n,))
    assert view.storage_offset() == off
    got_src, got_count = tscatter.compact_mask_indices(view, cap)
    want_src, want_count = numpy_compact(mask, cap)
    if n:   # cnc_tpu's count is cumsum[-1], which an empty mask does not have
        jsrc, jcount = jscatter.compact_mask_indices(jnp.asarray(mask), cap)
        np.testing.assert_array_equal(np.asarray(jsrc), want_src)
        assert int(jcount) == want_count
    np.testing.assert_array_equal(got_src.numpy(), want_src)
    assert int(got_count) == want_count and got_src.dtype == torch.int32
    if name == "cap_below_count":
        assert want_count > cap
    if name == "cap_above_n":
        assert cap > n


@pytest.mark.parametrize("name", list(COMPACT_CASES))
def test_k3_emulation_equals_numpy(name):
    buf, off, n, cap = compact_case(name)
    mask = buf[off:off + n]
    src, count = k3_emulate(mask, off % 16, cap)
    want_src, want_count = numpy_compact(mask, cap)
    np.testing.assert_array_equal(src, want_src)
    assert count == want_count


def test_k3_emulation_with_tiles_still_publishing():
    """Each tile's look-back meets a random mix of counts and prefixes (every
    tile before it has published at least its count), over windows that
    cross 32 tiles: the positions stay the same."""
    rng = np.random.default_rng(3)
    mask = (rng.random(70 * K3_TILE + 9) < 0.01).astype(np.uint8)
    published = lambda tile, agg, prefix: np.where(rng.random(tile) < 0.15, PREFIX, AGGREGATE)
    for a in (0, 5):
        src, count = k3_emulate(mask, a, 200_000, published)
        want_src, want_count = numpy_compact(mask, 200_000)
        np.testing.assert_array_equal(src, want_src)
        assert count == want_count


def test_look_back_sums_every_tile_before():
    rng = np.random.default_rng(4)
    agg = rng.integers(0, K3_TILE + 1, size=700)
    prefix = np.cumsum(agg)
    tag = launch_tag(12345)
    for p_prefix in (0.0, 0.02, 0.5, 1.0):
        flags = np.where(rng.random(agg.size) < p_prefix, PREFIX, AGGREGATE)
        flags[0] = PREFIX
        words = [status_word(tag, int(f), int(prefix[j] if f == PREFIX else agg[j]))
                 for j, f in enumerate(flags)]
        for tile in (1, 2, 31, 32, 33, 64, 65, 256, 257, 699):
            assert look_back(words, tile, tag) == prefix[tile - 1], (p_prefix, tile)


def test_status_word_fields_and_tags():
    for tag, flag, value in [(1, AGGREGATE, 0), (TAG_MOD, PREFIX, 2 ** 31 - 1),
                             (launch_tag(2 ** 32 - 1), PREFIX, 2 ** 32 - 1)]:
        w = status_word(tag, flag, value)
        assert w < 2 ** 64 and status_fields(w) == (tag, flag, value)
    # the epoch word is a uint32 that wraps: every tag lies in 1 .. 2^30 - 1, so
    # a word that was never written (all zero) is never ready
    for epoch in (0, 1, TAG_MOD - 1, TAG_MOD, TAG_MOD + 1, 2 ** 32 - 1):
        assert 1 <= launch_tag(epoch) < 2 ** 30
    assert status_fields(0)[0] != launch_tag(0)


@pytest.mark.parametrize("a", range(16))
def test_k3_split_covers_each_byte_once(a):
    for n in (0, 1, 15, 16, 17, K3_TILE - a - 1, K3_TILE - a, K3_TILE - a + 1, 3 * K3_TILE + 7):
        tiles, v0, vector = k3_split(n, a)
        assert tiles == (0 if n == 0 else -(-(n + a) // K3_TILE))
        idx = (v0[:, None] + np.arange(K3_BYTES)) - a
        inside = (idx >= 0) & (idx < n)
        np.testing.assert_array_equal(idx[inside], np.arange(n))
        # vector groups: 16-byte aligned from the aligned base, whole, in range
        assert (v0[vector] % 16 == 0).all() and inside[vector].all()
        # only the groups an unaligned base or the end cuts go byte by byte
        np.testing.assert_array_equal(vector, inside.all(1))
        assert int((~vector & inside.any(1)).sum()) <= 2


def test_stage_slots_are_distinct_and_free_of_bank_conflicts():
    r = np.arange(K3_TILE)
    slots = stage_slot(r)
    assert len(np.unique(slots)) == K3_TILE and slots.max() < K3_TILE + K3_TILE // 32
    bank = lambda slot: (slot // 2) % 32          # 4-byte banks of 16-bit slots
    # a warp over an all-set run: lane t stages rank 64 t + i at step i
    for i in range(K3_BYTES):
        for w in range(4):
            ranks = 64 * (32 * w + np.arange(32)) + i
            assert len(np.unique(bank(stage_slot(ranks[ranks < K3_TILE])))) == 32
    # the store loop: lanes read consecutive ranks, two to a word, 16 words
    for start in range(0, K3_TILE - 32, 32):
        words = stage_slot(start + np.arange(32)) // 2
        assert len(np.unique(bank(2 * words))) == len(np.unique(words)) == 16


def test_fill_split_covers_the_range_once():
    for cap in range(0, 41):
        for lo in range(0, cap + 1):
            head, body, tail = fill_split(lo, cap)
            slots = list(range(lo, head)) + list(range(head, tail)) + list(range(tail, cap))
            assert slots == list(range(lo, cap))
            assert head - lo <= 3 and cap - tail <= 3
            if body:
                assert head % 4 == 0


def test_byte_bits_over_every_pattern_of_8_bytes():
    rng = np.random.default_rng(5)
    patterns = ((np.arange(256)[:, None] >> np.arange(8)) & 1).astype(bool)
    # set bytes hold any value 1..255: the kernels test != 0, not == 1
    values = np.where(patterns, rng.integers(1, 256, size=patterns.shape), 0).astype(np.uint8)
    words = values.view("<u4")                                       # [256, 2]
    want = np.packbits(patterns, axis=-1, bitorder="little")[:, 0]
    got = byte_bits4(words[:, 0]) | byte_bits4(words[:, 1]) << 4
    np.testing.assert_array_equal(got, want)
    direct = np.where(values.reshape(256, 2, 4) != 0, 0xFF, 0)
    np.testing.assert_array_equal(
        vcmpne4(words), (direct << (8 * np.arange(4))).sum(-1).astype(np.uint32))
    # a thread's 32 bytes: the same bits as packbits' four bytes
    groups = rng.integers(0, 3, size=(64, 32)).astype(np.uint8)
    np.testing.assert_array_equal(byte_bits32(groups).view("<i4"), packbits_words(groups)[:, 0])


@pytest.mark.parametrize("name", list(PACK_CASES))
def test_pack_twin_equals_packbits(name):
    buf, off, rows, cols = pack_case(name)
    mask = buf[off:off + rows * cols].reshape(rows, cols)
    view = torch_view(buf, off, (rows, cols))
    want = packbits_words(mask)
    got = enc.pack_mask_bits(view)
    assert got.shape == (rows, -(-cols // 32)) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pack_emulate(mask, off % 16), want)
    vector = pack_split(rows, cols, off % 16)
    if name == "unaligned_rows":      # rows 1 and 3 start 8 bytes past a boundary
        assert vector[0, :-1].all() and not vector[1].any()
    if name.startswith("cols_mod"):   # whole words load 16 bytes, a ragged last word not
        assert vector[0, :cols // 32].all() and not vector[:, cols // 32:].any()
