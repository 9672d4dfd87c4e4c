"""cnc_torch's composite (K5's and K5b's plain twins) against cnc_tpu's on
sample buffers at the edges of the kernels' per-ray walk: rays of 1, 33,
1,100 and 2,500 samples, empty rays, padding on the last ray after its
samples or alone, a buffer of padding only, one ray holding the buffer
(tests/volrend_buffers.py).  Also the twin of the kernels' walk table against
cnc_tpu's `pack_info`, and the twin of their fault word on buffers that
keep and that break their precondition.

Tolerances: the forward to rtol 1e-5 / atol 1e-6 and the visible counts
equal, the gradients to 1e-5 of the largest entry: the margin of cnc_tpu's
float32 scans and segment sums against the twin's float64 prefix sums.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.ops import scan as jscan
from cnc_tpu.render import marching as jmarch
from cnc_tpu.render import volrend as jvol
from cnc_torch.render import marching as tmarch
from cnc_torch.render import volrend as tvol
from volrend_buffers import BROKEN, DT, LAYOUTS, broken_buffer, segment_buffer

VARIANTS = {"plain": (False, 0.0), "prefix_trans": (True, 0.0), "alpha_thre": (True, 0.05)}


def _both(layout, variant):
    ray_id, valid, t_mid, sig, rgb, n_rays = segment_buffer(layout)
    prefix, alpha_thre = VARIANTS[variant]
    pt = np.random.default_rng(5).uniform(0.1, 1.0, n_rays).astype(np.float32)
    js = jmarch.RaySamples(ray_id=jnp.asarray(ray_id), t_mid=jnp.asarray(t_mid), dt=DT,
                           valid=jnp.asarray(valid), num_samples=jnp.int32(valid.sum()))
    ts = tmarch.RaySamples(ray_id=torch.from_numpy(ray_id), t_mid=torch.from_numpy(t_mid),
                           dt=float(DT), valid=torch.from_numpy(valid),
                           num_samples=torch.tensor(int(valid.sum())))
    jargs = (n_rays, None, 1e-4, jnp.asarray(pt) if prefix else None, alpha_thre)
    targs = (n_rays, None, 1e-4, torch.from_numpy(pt) if prefix else None, alpha_thre)
    return js, ts, jargs, targs, sig, rgb, n_rays


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_composite_matches_cnc_tpu_on_segment_edges(layout, variant):
    js, ts, jargs, targs, sig, rgb, _ = _both(layout, variant)
    jo = jvol.composite(jnp.asarray(rgb), jnp.asarray(sig), js, *jargs)
    to = tvol.composite(torch.from_numpy(rgb), torch.from_numpy(sig), ts, *targs)
    for name in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert int(to.n_rendering_samples) == int(jo.n_rendering_samples)
    if layout == "all_padding":
        assert int(to.n_rendering_samples) == 0 and not to.opacity.any()
    else:
        assert float(to.opacity.max()) > 0.25       # the transmittance really falls


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_composite_grads_match_jax_grad_on_segment_edges(layout, variant):
    js, ts, jargs, targs, sig, rgb, n_rays = _both(layout, variant)
    rng = np.random.default_rng(7)
    cots = [rng.normal(size=shape).astype(np.float32)
            for shape in ((n_rays, 3), (n_rays, 1), (n_rays, 1))]

    def jloss(rgbs, sigmas):
        o = jvol.composite(rgbs, sigmas, js, *jargs)
        return sum(jnp.sum(x * c) for x, c in zip((o.rgb, o.opacity, o.depth), cots))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(rgb), jnp.asarray(sig))
    trgb = torch.from_numpy(rgb).requires_grad_()
    tsig = torch.from_numpy(sig).requires_grad_()
    o = tvol.composite(trgb, tsig, ts, *targs)
    sum((x * torch.from_numpy(c)).sum() for x, c in zip((o.rgb, o.opacity, o.depth),
                                                         cots)).backward()
    for got, w in zip((trgb.grad, tsig.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)
        if layout == "all_padding":
            assert not w.any() and not got.any()
        else:
            assert np.abs(w).max() > 1e-3
    assert not tsig.grad.numpy()[~ts.valid.numpy()].any()     # padding gets no gradient


@pytest.mark.parametrize("layout", LAYOUTS)
def test_walk_ranges_twin_matches_pack_info(layout):
    ray_id, valid, _, _, _, n_rays = segment_buffer(layout)
    table = tvol._walk_ranges_plain(torch.from_numpy(ray_id), torch.from_numpy(valid),
                                    n_rays).numpy()
    info = np.asarray(jscan.pack_info(jnp.asarray(ray_id), jnp.asarray(valid), n_rays))
    start, end = table[:, 0], table[:, 1]
    # the walk covers each ray's valid samples, which with the padding at the
    # buffer's tail sit where pack_info packs them
    np.testing.assert_array_equal(end - start, info[:, 1])
    walked = info[:, 1] > 0
    np.testing.assert_array_equal(start[walked], info[walked, 0])
    # a ray without a segment walks [0, 0); ray n_rays - 1's padding is not walked
    has_segment = np.isin(np.arange(n_rays), ray_id)
    assert not table[~has_segment].any()
    assert end.max(initial=0) <= valid.sum()


@pytest.mark.parametrize("layout", LAYOUTS + BROKEN)
def test_walk_order_faults_twin(layout):
    """The fault word's twin is clear on every buffer the march and the
    prefilter can emit, and set on each kind of broken one."""
    ray_id, valid, *_, n_rays = (broken_buffer if layout in BROKEN else segment_buffer)(layout)
    got = tvol._walk_order_faults_plain(torch.from_numpy(ray_id), torch.from_numpy(valid),
                                        n_rays)
    assert got == (layout in BROKEN)
    assert tvol._walk_order_faults_plain(torch.zeros(0, dtype=torch.int32),
                                         torch.zeros(0, dtype=torch.bool), n_rays) == 0
