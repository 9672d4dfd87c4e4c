"""cnc_torch.utils.threefry against jax.random: the port's own copy of the
threefry draws behind the entry permutations must equal JAX's bit for bit
(a decoder rebuilds the entry order from the seed alone)."""

import numpy as np
import pytest

import jax

from cnc_torch.utils import threefry


def _raw(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


def test_the_partitionable_scheme_is_the_one_copied():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1237, 4322, 2 ** 31 + 5])
def test_key_split_and_bits_match(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(v) for v in threefry.prng_key(seed)) == _raw(key)
    a, b = jax.random.split(key)
    ta, tb = threefry.split(threefry.prng_key(seed))
    assert (tuple(map(int, ta)), tuple(map(int, tb))) == (_raw(a), _raw(b))
    want = np.asarray(jax.random.bits(b, (1001,), np.uint32))
    np.testing.assert_array_equal(threefry.random_bits32(tb, 1001), want)


@pytest.mark.parametrize("seed", [1234 + 3, 4321 + 1])
@pytest.mark.parametrize("n", [7, 1000, 66568, 131072, 512000, 524288])
def test_permutation_matches_jax(seed, n):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    got = threefry.permutation(seed, n)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


SEEDS = [0, 1, 42, 2 ** 40 + 7]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 3, 10])
def test_split_n_matches_jax(seed, n):
    """`split(key, n)` against `jax.random.split(key, n)`: n keys, each the
    cipher of its counter (the 64-bit seed wraps to 32 bits, as JAX's default
    makes the key)."""
    key = jax.random.PRNGKey(seed)
    assert tuple(int(v) for v in threefry.prng_key(seed)) == _raw(key)
    want = [_raw(k) for k in jax.random.split(key, n)]
    got = [tuple(map(int, k)) for k in threefry.split(threefry.prng_key(seed), n)]
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(7,), (1001,), (3, 5, 2), (33, 160)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-1e-4, 1e-4), (-2.5, 3.0), "linear159"])
def test_uniform_matches_jax_bit_for_bit(seed, shape, bounds):
    """`uniform` against `jax.random.uniform` in float32: the same bits, at
    odd and multi-dimensional shapes and several ranges (the field's table
    range, a Linear's float32 bound as cnc_tpu computes it, a skewed one)."""
    if bounds == "linear159":
        b = 1.0 / jax.numpy.sqrt(159)
        lo, hi = -b, b
    else:
        lo, hi = bounds
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
    got = threefry.uniform(threefry.prng_key(seed), shape, np.asarray(lo), np.asarray(hi))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fma_rounds_once_where_float64_lands_on_a_float32_midpoint():
    """1 + 2^-24 is halfway between two float32; (1 + 2^-10) * 2^-24 (1 -
    2^-10 + 2^-20) + 1 is 1 + 2^-24 + 2^-54, which float64 rounds to the
    midpoint and float32 then to 1 (even).  Rounded once it is 1 + 2^-23;
    its mirror below the midpoint stays 1."""
    a = np.array([1 + 2.0 ** -10, 1 + 2.0 ** -10, 0.5], np.float32)
    b = np.float32(2.0 ** -24 * (1 - 2.0 ** -10 + 2.0 ** -20))
    got = threefry._fma32(a, b, np.float32(1.0))
    assert got[0] == np.float32(1 + 2.0 ** -23)
    b_lo = np.float32(2.0 ** -24 * (1 + 2.0 ** -10 + 2.0 ** -20))
    p_lo = np.array([1 - 2.0 ** -10], np.float32)
    assert np.float64(p_lo[0]) * np.float64(b_lo) + 1.0 == 1 + 2.0 ** -24   # on the midpoint
    assert threefry._fma32(p_lo, b_lo, np.float32(1.0))[0] == np.float32(1.0)  # from below
    assert got[2] == np.float32(1.0)
