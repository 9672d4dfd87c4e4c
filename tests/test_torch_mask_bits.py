"""The packed occupancy masks that the port's CUDA encodes read.

`pack_mask_bits` keeps one bit per lattice vertex where the rate's cache
keeps one bool: bit i of a flat mask at bit i % 32 of int32 word i // 32.
Here, on the CPU (the plain twin of the pack kernel): the packing against
numpy's little-endian `packbits`, a bit lookup at the CUDA kernels' index
against cnc_tpu's bool masks across every level boundary of a small model's
cache, the packed copies `refresh_cache` keeps, and the cached level
description of the CUDA wrapper.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnc_torch.ops import encoding as enc
from test_torch_context_tables import asymmetric_occupancy, make_pair


def packbits_words(mask: np.ndarray) -> np.ndarray:
    """numpy's reference: little-endian bytes of each row, padded to whole
    int32 words."""
    m = mask.shape[-1]
    pad = np.zeros(mask.shape[:-1] + ((-m) % 32,), bool)
    packed = np.packbits(np.concatenate([mask, pad], axis=-1), axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<i4")


def bit_lookup(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """What the kernels read: bit idx % 32 of word idx // 32."""
    return ((bits.to(torch.int64)[idx >> 5] >> (idx & 31)) & 1).bool()


@pytest.mark.parametrize("shape", [(1,), (31,), (32,), (33,), (1000,), (3, 77), (2, 64)])
def test_pack_twin_equals_numpy_packbits(shape):
    mask = np.random.default_rng(sum(shape)).random(shape) < 0.4
    if mask.size > 40:
        mask.reshape(-1)[:32] = True           # a word with its sign bit set
    got = enc.pack_mask_bits(torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == shape[:-1] + ((shape[-1] + 31) // 32,)
    np.testing.assert_array_equal(got.numpy(), packbits_words(mask))


def test_pack_refuses_what_is_not_a_flat_bool_mask():
    with pytest.raises(ValueError, match="bool"):
        enc.pack_mask_bits(torch.zeros(40, dtype=torch.uint8))
    with pytest.raises(ValueError, match="bool"):
        enc.pack_mask_bits(torch.zeros(2, 2, 40, dtype=torch.bool))


@pytest.fixture(scope="module")
def pair_and_caches():
    jctx, tctx = make_pair()
    b = asymmetric_occupancy(seed=3)
    return tctx, jctx.refresh_cache(jnp.asarray(b)), tctx.refresh_cache(torch.from_numpy(b))


def _across_boundaries(offsets, total):
    """Every index within 40 of a level's start or of the end, and a spread
    of others."""
    near = [np.arange(max(o - 40, 0), min(o + 40, total)) for o in list(offsets) + [total]]
    return torch.from_numpy(np.unique(np.concatenate(near + [np.arange(0, total, 7)])))


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_bit_lookup_equals_cnc_tpu_bool_lookup(pair_and_caches, kind):
    tctx, jc, tc = pair_and_caches
    if kind == "3d":
        rows = [(np.asarray(jc["mask3d"]), tc["mask3d_bits"], tctx.mask3d_offsets)]
    else:
        rows = [(np.asarray(jc["mask2d"])[ai], tc["mask2d_bits"][ai], tctx.mask2d_offsets)
                for ai in range(3)]
    for want, bits, offsets in rows:
        assert any(o % 32 for o in offsets[1:])   # level starts inside a word
        idx = _across_boundaries(offsets, want.size)
        got = bit_lookup(bits, idx).numpy()
        np.testing.assert_array_equal(got, want[idx.numpy()])
        assert got.any() and not got.all()


def test_refresh_cache_keeps_the_packed_masks(pair_and_caches):
    tctx, _, tc = pair_and_caches
    np.testing.assert_array_equal(tc["mask3d_bits"].numpy(), packbits_words(tc["mask3d"].numpy()))
    np.testing.assert_array_equal(tc["mask2d_bits"].numpy(), packbits_words(tc["mask2d"].numpy()))
    zero = tctx.init_cache()
    for k in ("mask3d_bits", "mask2d_bits"):
        assert zero[k].shape == tc[k].shape and zero[k].dtype == tc[k].dtype == torch.int32


def test_plain_encode_reads_the_bools_with_or_without_the_packed_copy(pair_and_caches):
    tctx, _, tc = pair_and_caches
    pts = torch.from_numpy(np.random.default_rng(5).random((300, 3)).astype(np.float32))
    table = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (tctx.spec3.total_entries, 2)).astype(np.float32))
    kw = dict(occ_mask=tc["mask3d"], mask_offsets=tctx.mask3d_offsets)
    want = enc.grid_encode(pts, table, tctx.spec3, 1, 4, **kw)
    got = enc.grid_encode(pts, table, tctx.spec3, 1, 4, occ_bits=tc["mask3d_bits"], **kw)
    assert torch.equal(got, want) and want.abs().sum() > 0


LEVELS = ((10, 18, 34), (0, 1000, 2024, 3048), (0, 1000, 6832))


def test_level_description_is_checked_once_per_key():
    enc._levels.cache_clear()
    first = enc._levels("t", 3, 4, *LEVELS, None)
    assert enc._levels("t", 3, 4, *LEVELS, None) is first
    assert enc._levels.cache_info().currsize == 1
    n_out, n_levels, res, offs, sizes, moffs, mask_end = first
    assert (n_out, n_levels) == (3, 3) and list(sizes) == [1000, 1024, 1024]
    assert list(moffs) == [0, 1000, 6832] and mask_end == 6832 + 34 ** 3
    mixed = enc._levels("t", 3, 4, *LEVELS, 2)
    assert mixed is not first and mixed[0] == 2


@pytest.mark.parametrize("args,match", [
    ((3, 3, *LEVELS, None), "F in"),
    ((4, 4, *LEVELS, None), "D in"),
    ((3, 4, LEVELS[0], LEVELS[1], (0, -1, 9), None), "negative"),
    ((3, 4, LEVELS[0], LEVELS[1], (0, 1), None), "one offset per level"),
    ((3, 4, LEVELS[0], (0, 1000, 2024, 2 ** 31), None, None), "2\\^31"),
    ((3, 4, *LEVELS, 4), "n_levels_calc"),
])
def test_a_new_level_description_is_checked_afresh(args, match):
    enc._levels("t", 3, 4, *LEVELS, None)
    with pytest.raises(ValueError, match=match):
        enc._levels("t", *args)
