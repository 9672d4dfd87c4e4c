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
