"""The port's own copy of the threefry draws behind the entry permutations
and cnc_tpu's initial weights.

cnc_tpu shuffles the entry order of its dense context levels with
`jax.random.permutation(jax.random.PRNGKey(seed), n)`.  The codec codes
entries in that order, so a bundle interchanges between the packages only if
the port draws the same permutation.  This module reproduces it in numpy
uint32 arithmetic: the Threefry-2x32 block cipher (Salmon et al., SC 2011,
20 rounds), JAX's partitionable key split and 32-bit random bits (a 64-bit
counter per element, hi and lo words as the cipher's two inputs, the two
output words XORed), and its sort-based shuffle (`ceil(3 ln n / ln(2^32-1))`
rounds, each a stable sort by fresh 32-bit keys).  `uniform` is
`jax.random.uniform`'s float32 draw, which cnc_tpu's initial field and
context MLPs come from (`train.trainer.cnc_tpu_initial_state`).

It runs on the host: once when the context tables are built, and where a
run starts from cnc_tpu's initial state.
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
    """`jax.random.PRNGKey(seed)`'s two words with JAX's 64-bit types off,
    its default and cnc_tpu's: the seed wraps to 32 bits, so the high word
    is 0 and the low word is the seed modulo 2^32."""
    return np.uint32(0), np.uint32(seed & 0xFFFFFFFF)


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key, n: int = 2):
    """`jax.random.split(key, n)` under the partitionable scheme: n keys,
    key i the cipher of counter i."""
    b0, b1 = threefry2x32(key, *_counters(n))
    return tuple((b0[i], b1[i]) for i in range(n))


def random_bits32(key, n: int) -> np.ndarray:
    """`jax.random.bits(key, (n,), uint32)` under the partitionable scheme."""
    b0, b1 = threefry2x32(key, *_counters(n))
    return b0 ^ b1


def _fma32(a: np.ndarray, b: np.float32, c: np.float32) -> np.ndarray:
    """a * b + c rounded once to float32, as XLA's CPU backend contracts it.

    The product of two floats is exact in float64; the float64 sum s and its
    error e (s + e = a * b + c exactly) then decide the one case where
    rounding s to float32 would round twice: s on a float32 midpoint."""
    p = a.astype(np.float64) * np.float64(b)
    s = p + np.float64(c)
    t = s - p
    e = (p - (s - t)) + (np.float64(c) - t)
    r = s.astype(np.float32)
    d = s - r.astype(np.float64)                  # exact
    other = np.nextafter(r, np.where(d > 0, np.float32(np.inf), np.float32(-np.inf)))
    tie = (d != 0) & (np.abs(d) * 2 == np.abs(other.astype(np.float64) - r.astype(np.float64)))
    return np.where(tie & (np.sign(e) == np.sign(d)), other, r)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)` as XLA's CPU
    backend computes it: the top 23 of each element's 32 random bits as the
    mantissa of a float in [1, 2), less 1, times (maxval - minval) plus
    minval in one fused multiply-add, held at or above minval."""
    shape = tuple(int(d) for d in shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits32(key, int(np.prod(shape, dtype=np.int64)))
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma32(floats, hi - lo, lo)).reshape(shape)


def permutation(seed: int, n: int) -> np.ndarray:
    """`jax.random.permutation(jax.random.PRNGKey(seed), n)` as int64 [n]."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1)))
    key = prng_key(seed)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits32(sub, n), kind="stable")]
    return x
