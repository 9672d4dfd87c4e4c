"""The port's own copy of the threefry draws behind the entry permutations.

cnc_tpu shuffles the entry order of its dense context levels with
`jax.random.permutation(jax.random.PRNGKey(seed), n)`.  The codec codes
entries in that order, so a bundle interchanges between the packages only if
the port draws the same permutation.  This module reproduces it in numpy
uint32 arithmetic: the Threefry-2x32 block cipher (Salmon et al., SC 2011,
20 rounds), JAX's partitionable key split and 32-bit random bits (a 64-bit
counter per element, hi and lo words as the cipher's two inputs, the two
output words XORed), and its sort-based shuffle (`ceil(3 ln n / ln(2^32-1))`
rounds, each a stable sort by fresh 32-bit keys).

It runs once when the context tables are built, on the host.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 of the counter words (x0, x1) under the key pair."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(1, 6):
            for r in _ROTATIONS[(i - 1) % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[i % 3]
            x1 = x1 + ks[(i + 1) % 3] + np.uint32(i)
    return x0, x1


def prng_key(seed: int):
    """`jax.random.PRNGKey(seed)`'s two words for a seed in [0, 2^63)."""
    return np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF)


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key):
    """`jax.random.split(key)` (two keys) under the partitionable scheme."""
    b0, b1 = threefry2x32(key, *_counters(2))
    return (b0[0], b1[0]), (b0[1], b1[1])


def random_bits32(key, n: int) -> np.ndarray:
    """`jax.random.bits(key, (n,), uint32)` under the partitionable scheme."""
    b0, b1 = threefry2x32(key, *_counters(n))
    return b0 ^ b1


def permutation(seed: int, n: int) -> np.ndarray:
    """`jax.random.permutation(jax.random.PRNGKey(seed), n)` as int64 [n]."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1)))
    key = prng_key(seed)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits32(sub, n), kind="stable")]
    return x
