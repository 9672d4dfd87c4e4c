"""The one-launch pooled mean (segment_mean, K6m's twin) and the march's
per-ray outputs (K4's twin) against cnc_tpu.

segment_mean's twin is held to cnc_tpu's composition at its call sites: two
`_segment_tail_values` (the den sum and the numerator sum), a clamp and a
divide (cnc_tpu/models/context_models.py:1025-1043 for the 2D count pooling,
:1346-1357 for the 3D overlap-weighted one), on the row layouts the sites
give it: an end-clamped window with shifted-in head and tail rows, empty
segments at the start, middle and end, all rows invalid, and a compacted
multi-level buffer whose padding rows carry a smaller id.  Forward within
1e-6 of the largest pooled value (the same sums in the same order),
`covered` exact, the gradient to the rows within 1e-6 of jax.grad's.  The
twin raises where live ids decrease.

The march's per-ray hit counts and last t_mid are held to the
`index_add_` / `scatter_reduce_` of cnc_tpu's march buffer, which is how the
eval loop used to derive them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.config import RenderConfig
from cnc_tpu.data import cameras as jcam
from cnc_tpu.data import scenes as jscenes
from cnc_tpu.models import context_models as jcm
from cnc_tpu.render import marching as jmarch
from cnc_torch.config import RenderConfig as TRenderConfig
from cnc_torch.data import scenes as tscenes
from cnc_torch.ops import context_ops as cops
from cnc_torch.render import marching as tmarch


def _window_rows(rng, n_e, w, head, tail):
    """A window of w rows over n_e entries as `_window_slices` cuts it: `head`
    rows of earlier entries shifted in before it and `tail` rows of later
    ones after it, both invalid and clamped to entries 0 and n_e - 1."""
    inner = np.sort(rng.integers(0, n_e, w - head - tail))
    seg = np.concatenate([np.full(head, -5), inner, np.full(tail, n_e + 3)])
    valid = np.concatenate([np.zeros(head, bool), rng.random(inner.shape[0]) < 0.7,
                            np.zeros(tail, bool)])
    return np.clip(seg, 0, n_e - 1).astype(np.int32), valid


def _case(name, f, weighted, seed=0):
    """(x, den, seg, valid, num_segments) for one layout."""
    rng = np.random.default_rng(seed)
    n_e = 97
    if name == "window":
        seg, valid = _window_rows(rng, n_e, 1500, 37, 53)
    elif name == "empty_segments":
        seg = np.sort(rng.integers(6, n_e - 9, 1500)).astype(np.int32)
        valid = (rng.random(1500) < 0.8) & ((seg < 40) | (seg > 47))
    elif name == "all_invalid":
        seg = np.sort(rng.integers(0, n_e, 800)).astype(np.int32)
        valid = np.zeros(800, bool)
    elif name == "multi_level":
        # three levels' windows concatenated (ids offset by each level's
        # entries), compacted to a budget whose padding repeats slot[0]
        parts, base = [], 0
        for n_l in (31, 40, 26):
            s, v = _window_rows(rng, n_l, 600, 11, 7)
            parts.append((s + base, v))
            base += n_l
        full_seg = np.concatenate([p[0] for p in parts])
        mask = np.concatenate([p[1] for p in parts])
        cap = 1400
        src = np.flatnonzero(mask)[:cap]
        n_live = src.shape[0]
        src = np.concatenate([src, np.zeros(cap - n_live, np.int64)])
        seg = full_seg[src].astype(np.int32)
        valid = np.arange(cap) < n_live
        assert n_e == base and (seg[n_live:] < seg[n_live - 1]).all()
    else:
        raise ValueError(name)
    n = seg.shape[0]
    x = rng.standard_normal((n, f)).astype(np.float32)
    if weighted:   # floor(overlap * 1000) clamped to 1, zero off the mask
        den = np.where(valid, np.maximum(np.floor(rng.random(n) * 1000.0), 1.0), 0.0)
    else:
        den = valid.astype(np.float64)
    return x, den.astype(np.float32), seg, valid, n_e


def _jax_site(x, den, seg, valid, n_e, min_den, weighted):
    """cnc_tpu's composition at a pooling site."""
    dsum = jcm._segment_tail_values(den, seg, valid, n_e)
    num = x * den[:, None] if weighted else x
    pooled = jcm._segment_tail_values(num, seg, valid, n_e)
    return pooled / jnp.clip(dsum, min_den, None)[:, None], dsum > 0


CASES = ["window", "empty_segments", "all_invalid", "multi_level"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("f", [1, 4])
@pytest.mark.parametrize("weighted", [False, True], ids=["count", "overlap"])
def test_segment_mean_matches_cnc_tpu(case, f, weighted):
    x, den, seg, valid, n_e = _case(case, f, weighted)
    min_den = 1e-9 if weighted else 1.0
    jx = jnp.asarray(x)
    want, want_cov = _jax_site(jx, jnp.asarray(den), jnp.asarray(seg), jnp.asarray(valid), n_e,
                               np.float32(min_den), weighted)
    leaf = torch.from_numpy(x).requires_grad_()
    got, cov = cops.segment_mean(leaf, torch.from_numpy(den), torch.from_numpy(seg),
                                 torch.from_numpy(valid), n_e, min_den, weighted)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6 * scale)
    np.testing.assert_array_equal(cov.numpy(), np.asarray(want_cov))
    if case == "empty_segments":
        assert not cov[:6].any() and not cov[40:48].any() and not cov[-9:].any()
        assert not bool(got[40:48].any())
    if case == "all_invalid":
        assert not cov.any() and not bool(got.any())
    cot = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(_jax_site(
        v, jnp.asarray(den), jnp.asarray(seg), jnp.asarray(valid), n_e, np.float32(min_den),
        weighted)[0] * cot))(jx))
    gscale = max(float(np.abs(jg).max()), 1e-30)
    np.testing.assert_allclose(leaf.grad.numpy(), jg, rtol=0, atol=1e-6 * gscale)


@pytest.mark.parametrize("where", ["inside", "at_a_padding_row"])
def test_segment_mean_twin_checks_the_order_of_live_ids(where):
    """A live id below the one before it raises; a dead row may carry any
    id (the compacted buffer's padding does)."""
    x, den, seg, valid, n_e = _case("multi_level", 4, True)
    args = lambda s, v: (torch.from_numpy(x), torch.from_numpy(den), torch.from_numpy(s),
                         torch.from_numpy(v), n_e, 1e-9, True)
    cops.segment_mean(*args(seg, valid))           # padding ids fall: fine
    seg2, valid2 = seg.copy(), valid.copy()
    if where == "inside":
        live = np.flatnonzero(valid2)
        k = next(i for i in range(1, live.shape[0]) if seg2[live[i - 1]] > 0)
        seg2[live[k]] = seg2[live[k - 1]] - 1
    else:
        valid2[-1] = True                          # a padding row made live
    with pytest.raises(ValueError, match="decrease"):
        cops.segment_mean(*args(seg2, valid2))


def test_segment_mean_refuses_a_den_with_a_gradient():
    x, den, seg, valid, n_e = _case("window", 4, False)
    with pytest.raises(ValueError, match="den"):
        cops.segment_mean(torch.from_numpy(x), torch.from_numpy(den).requires_grad_(),
                          torch.from_numpy(seg), torch.from_numpy(valid), n_e, 1.0)


# ------------------------------------------------------ the march's per-ray outputs
KW = dict(render_step_size=0.02, occ_resolution=64, sample_budget=8192)
RCFG, TRCFG = dataclasses.replace(RenderConfig(), **KW), dataclasses.replace(TRenderConfig(), **KW)
AABB = np.asarray(jscenes.make_scene("sphere").aabb, np.float32)


def _rays(n_side=32, stride=3):
    poses = jcam.look_at_poses(1, radius=3.0)
    K = jnp.asarray([[40.0, 0, n_side / 2], [0, 40.0, n_side / 2], [0, 0, 1]])
    rays = jcam.image_rays(K, jnp.asarray(poses[0]), n_side, n_side)
    o = np.asarray(rays.origins).reshape(-1, 3)[::stride]
    d = np.asarray(rays.viewdirs).reshape(-1, 3)[::stride]
    return np.ascontiguousarray(o), np.ascontiguousarray(d)


@pytest.mark.parametrize("capacity,masked", [(1 << 15, False), (2048, False), (700, True),
                                             (4096, True)],
                         ids=["fits", "truncated", "truncated_cursor_mask", "cursor_and_mask"])
def test_march_per_ray_outputs_match_cnc_tpu(capacity, masked):
    o, d = _rays()
    binaries = tscenes.occupancy_from_scene(tscenes.make_scene("sphere"), 64,
                                            RCFG.render_step_size, device="cpu").numpy()
    rng = np.random.default_rng(3)
    ray_mask = rng.random(o.shape[0]) < 0.7 if masked else None
    t_start = rng.uniform(0.0, 3.0, o.shape[0]).astype(np.float32) if masked else None
    js = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(binaries),
                           jnp.asarray(AABB), None, RCFG, capacity,
                           ray_mask=None if ray_mask is None else jnp.asarray(ray_mask),
                           t_start=None if t_start is None else jnp.asarray(t_start))
    ts = tmarch.march_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(binaries),
                           torch.from_numpy(AABB), TRCFG, capacity,
                           ray_mask=None if ray_mask is None else torch.from_numpy(ray_mask),
                           t_start=None if t_start is None else torch.from_numpy(t_start))
    seg = torch.from_numpy(np.array(js.ray_id)).long()
    jvalid = torch.from_numpy(np.array(js.valid))
    jt = torch.from_numpy(np.array(js.t_mid))
    r = o.shape[0]
    hits = torch.zeros(r, dtype=torch.int32).index_add_(0, seg, jvalid.to(torch.int32))
    last_t = torch.full((r,), -torch.inf).scatter_reduce_(
        0, seg, torch.where(jvalid, jt, -torch.inf), reduce="amax")
    assert torch.equal(ts.ray_hits, hits)
    assert torch.equal(ts.ray_last_t, last_t)
    assert int(hits.sum()) == min(capacity, int(jvalid.sum())) > 0
    assert bool(js.truncated) == (capacity in (2048, 700))
