"""cnc_torch's PDF ops (ops/pdf.py) and proposal sampler (grids/prop_net.py)
against cnc_tpu on the same numpy inputs; the stratified paths take the
very uniforms jax.random drew for cnc_tpu.

Tolerances: indices exactly; the edges of one resampling within 1e-5
absolute (the cumulative sums run in another order; the edges lie in
[0, 6]); the proposal sampler's edges and weights within 3e-4 absolute,
6e-5 of the far plane (each level's inverse CDF divides the CDF's float32
rounding by a bin's mass and multiplies it by the bin's width, and the
weights follow the edges: with lindisp and stratified draws cnc_tpu's
float32 sampler itself lies up to 9.8e-5 (edges) and 5.4e-5 (weights)
from the same computation in float64, the port up to 3.6e-5 and 1.8e-5;
with uniform sampling both lie within 3e-6); `pdf_loss` within 1e-5
relative, `prop_loss` over the sampler's own levels within 2e-4 relative
(it follows those edges: 8e-5 seen).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.grids import prop_net as jprop
from cnc_tpu.ops import pdf as jpdf
from cnc_torch.grids import prop_net as tprop
from cnc_torch.ops import pdf as tpdf


def _hist(r, s, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(lo, hi, (r, s + 1)), -1).astype(np.float32)
    w = rng.random((r, s)).astype(np.float32)
    w[:, : s // 4] = 0.0                     # empty bins
    return t, w


def test_searchsorted_matches_cnc_tpu():
    rng = np.random.default_rng(0)
    sv = np.sort(rng.random((6, 17)), -1).astype(np.float32)
    vals = rng.uniform(-0.2, 1.2, (6, 40)).astype(np.float32)
    vals[:, :5] = sv[:, :5]                  # ties fall to the left side
    want = jpdf.searchsorted(jnp.asarray(sv), jnp.asarray(vals))
    got = tpdf.searchsorted(torch.from_numpy(sv), torch.from_numpy(vals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_from_weighted_deterministic():
    t, w = _hist(8, 32, 1)
    want = np.asarray(jpdf.sample_from_weighted(jnp.asarray(t), jnp.asarray(w), 24))
    got = tpdf.sample_from_weighted(torch.from_numpy(t), torch.from_numpy(w), 24).numpy()
    assert got.shape == (8, 25)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_sample_from_weighted_stratified_on_jax_draws():
    t, w = _hist(8, 32, 2)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jpdf.sample_from_weighted(jnp.asarray(t), jnp.asarray(w), 24,
                                                stratified=True, key=key))
    noise = np.array(jax.random.uniform(key, (8, 25)))
    u = tpdf.stratified_u(torch.from_numpy(noise))
    got = tpdf._sample_at(torch.from_numpy(t), torch.from_numpy(w), u).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the generator path draws its own uniforms: same shape, ascending, in range
    g = torch.Generator().manual_seed(0)
    own = tpdf.sample_from_weighted(torch.from_numpy(t), torch.from_numpy(w), 24,
                                    stratified=True, generator=g)
    assert own.shape == (8, 25) and bool((own[:, 1:] >= own[:, :-1]).all())
    assert bool((own >= torch.from_numpy(t[:, :1])).all())
    with pytest.raises(ValueError):
        tpdf.sample_from_weighted(torch.from_numpy(t), torch.from_numpy(w), 24, stratified=True)


def test_outer_measure_and_pdf_loss():
    t0, w0 = _hist(5, 12, 3)
    t1, w1 = _hist(5, 20, 4, -0.1, 1.1)
    want = np.asarray(jpdf.outer_measure(jnp.asarray(t0), jnp.asarray(w0), jnp.asarray(t1)))
    got = tpdf.outer_measure(torch.from_numpy(t0), torch.from_numpy(w0),
                             torch.from_numpy(t1)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    want = np.asarray(jpdf.pdf_loss(jnp.asarray(t1), jnp.asarray(w1), jnp.asarray(t0),
                                    jnp.asarray(w0)))
    got = tpdf.pdf_loss(torch.from_numpy(t1), torch.from_numpy(w1), torch.from_numpy(t0),
                        torch.from_numpy(w0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _sigma_fns(lib):
    """Two analytic proposal densities, peaked at t = 2 and t = 3.5."""
    def a(t0, t1):
        mid = (t0 + t1) / 2
        return lib.exp(-((mid - 2.0) ** 2) * 4.0) * 5.0

    def b(t0, t1):
        mid = (t0 + t1) / 2
        return lib.exp(-((mid - 3.5) ** 2) * 2.0) * 8.0 + 0.1
    return [a, b]


def _jax_draws(key, r, prop_samples, num_samples):
    """The uniforms cnc_tpu's stratified propnet_sampling draws, in order."""
    draws = []
    for lvl, n in enumerate(prop_samples):
        key, sub = jax.random.split(key)
        draws.append(np.array(jax.random.uniform(sub, (r, n + 1))))
    key, sub = jax.random.split(key)
    draws.append(np.array(jax.random.uniform(sub, (r, num_samples + 1))))
    return draws


@pytest.mark.parametrize("sampling_type", ["uniform", "lindisp"])
@pytest.mark.parametrize("stratified", [False, True], ids=["fixed", "stratified"])
def test_propnet_sampling_and_loss_match_cnc_tpu(sampling_type, stratified):
    r, prop_samples, num_samples = 32, (24, 16), 8
    key = jax.random.PRNGKey(3)
    o = np.zeros((r, 3), np.float32)
    t0j, t1j, auxj = jprop.propnet_sampling(
        key, jnp.asarray(o), jnp.asarray(o), _sigma_fns(jnp), prop_samples, num_samples,
        0.1, 5.0, sampling_type=sampling_type, stratified=stratified)
    draws = _jax_draws(key, r, prop_samples, num_samples)
    replay = lambda shape: torch.from_numpy(draws.pop(0))
    t0t, t1t, auxt = tprop._propnet_sampling(
        replay, torch.from_numpy(o), _sigma_fns(torch), prop_samples, num_samples, 0.1, 5.0,
        sampling_type, stratified, True)
    assert not stratified or not draws           # every draw consumed
    t_tol = 6e-5 * 5.0
    np.testing.assert_allclose(t0t.numpy(), np.asarray(t0j), atol=t_tol, rtol=0)
    np.testing.assert_allclose(t1t.numpy(), np.asarray(t1j), atol=t_tol, rtol=0)
    for (tj, wj), (tt, wt) in zip(auxj["levels"], auxt["levels"]):
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=t_tol, rtol=0)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=t_tol, rtol=0)
    t_rf = np.concatenate([np.asarray(t0j), np.asarray(t1j)[:, -1:]], -1)
    w_rf = np.random.default_rng(5).random((r, num_samples)).astype(np.float32) / num_samples
    want = float(jprop.prop_loss(auxj, jnp.asarray(t_rf), jnp.asarray(w_rf)))
    got = float(tprop.prop_loss(auxt, torch.from_numpy(t_rf), torch.from_numpy(w_rf)))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=2e-4, abs=1e-7)


def test_propnet_sampling_public_entry_point():
    r = 16
    o = torch.zeros(r, 3)
    t0, t1, aux = tprop.propnet_sampling(None, o, o, _sigma_fns(torch)[:1], [16], 8, 0.1, 5.0,
                                         sampling_type="uniform")
    assert t0.shape == (r, 8) and bool((t1 >= t0 - 1e-6).all())
    mid = (t0 + t1) / 2
    assert float(((mid > 1.0) & (mid < 3.0)).float().mean()) > 0.5
    g = torch.Generator().manual_seed(1)
    t0s, _, _ = tprop.propnet_sampling(g, o, o, _sigma_fns(torch), [16, 8], 8, 0.1, 5.0,
                                       stratified=True)
    assert t0s.shape == (r, 8) and bool(t0s.isfinite().all())
    with pytest.raises(ValueError):
        tprop.propnet_sampling(None, o, o, _sigma_fns(torch), [16, 8], 8, 0.1, 5.0,
                               stratified=True)
