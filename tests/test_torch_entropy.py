"""cnc_torch.ops.entropy against cnc_tpu.ops.entropy: the Bernoulli bits and
the level-wise global-probability rate, values and gradients, within 1e-6
relative (the same float32 formulas; log and log1p may differ in the last
bit between the two libraries)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.ops import entropy as jent
from cnc_torch.ops import entropy as tent


@pytest.mark.parametrize("seed", [0, 1])
def test_bernoulli_bits_matches(seed):
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((500, 4)) > 0.5, 1.0, -1.0).astype(np.float32)
    # probabilities inside, at and beyond the clamp on both sides
    p = rng.uniform(-0.1, 1.1, size=(500, 4)).astype(np.float32)
    p[:2, 0] = (0.0, 1.0)
    want = np.asarray(jent.bernoulli_bits(jnp.asarray(x), jnp.asarray(p)))
    tp = torch.from_numpy(p).requires_grad_()
    got = tent.bernoulli_bits(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.all(got.detach().numpy() >= 0)
    got.sum().backward()
    jg = np.asarray(jax.grad(lambda q: jent.bernoulli_bits(jnp.asarray(x), q).sum())(
        jnp.asarray(p)))
    np.testing.assert_allclose(tp.grad.numpy(), jg, rtol=1e-6, atol=1e-6 * np.abs(jg).max())


@pytest.mark.parametrize("share", [0.0, 0.3, 0.5, 1.0], ids=lambda s: f"positive_{s}")
def test_global_pg_bits_matches(share):
    rng = np.random.default_rng(3)
    q = np.where(rng.random((777, 2)) < share, 1.0, -1.0).astype(np.float32)
    jpg, jbits, jn = jent.global_pg_bits(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    pg, bits, n = tent.global_pg_bits(tq)
    assert n == jn == q.size
    np.testing.assert_allclose(float(pg), float(jpg), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(bits), float(jbits), rtol=1e-6, atol=1e-3)
    assert np.isfinite(float(bits))          # a one-sided level costs ~0 bits, not NaN
    bits.backward()
    jg = np.asarray(jax.grad(lambda t: jent.global_pg_bits(t)[1])(jnp.asarray(q)))
    np.testing.assert_allclose(tq.grad.numpy(), jg, rtol=1e-5, atol=1e-6 * max(np.abs(jg).max(),
                                                                                1.0))
