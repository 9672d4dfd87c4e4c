"""cnc_torch's CUDA kernels against their plain twins, on the card.

Marked `gpu`: they need an NVIDIA GPU and nvcc, and skip without them.  They
import neither JAX nor cnc_tpu, so on a GPU machine without JAX they run
without the suite's conftest (which imports JAX):

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -m gpu -q

`chip_smoke.py` checks the kernels at the main path's full-width shapes;
these cover the edge cases: other feature widths and dimensions, hashed
levels of non-power-of-two size, the forward bit-equal to its twin in every
variant, empty and boundary-sized masks, both
truncation regimes of the march, padding in the composite; for the backward
kernels: both feature widths, one level, points all out of range, rays
without samples, an all-padding buffer, a carried transmittance; the
scatter-add with every row dropped; a few training steps on the card.  For
the rate estimate's kernels: the pooling (segment_gather's backward) with
all rows invalid, one segment, a segment without a valid row and the 3D
context's dozen runs over 2^21 rows; the sign histogram with
empty bins and more rows than the cap; the footprint grids on an empty and a
full occupancy in 2D and 3D; the masked encode with every corner masked and
the mixed-level encode with its first level at both ends; the encode's edge
cases (whole warps on one row, lanes alternating between two rows, a level
change within a warp, 1, 31, 33 and a tile plus one points, every corner
masked, mask offsets inside a word, points outside [0,1], zero gradient
rows; the forward bit-equal) and the mask packing; the table build on
a dense, a hashed and a 2D level; a few rate steps on the card.  For the
codec's integer kernels (K9a-K9c, K7i), held to their twins with
torch.equal: odd widths, an empty chunk, a chunk of uncovered rows, weights
at +-W_MAX with inputs at the clip, saturated and zero probabilities; the
wrappers' refusals; and a tiny encode on the card whose streams equal the
same encode through the twins on the CPU, decoded back on the card.  For the
per-ray march (every field equal to the twin's, the per-ray hit counts and
last t_mid and the padding slots included): a coarse cut inside a ray, a
capacity cut inside a ray, no candidate block, candidate blocks without a
hit, more than 32 blocks a ray, every ray masked, a jittered training march
at 327,680 slots, two runs bit-equal.  For the one-launch pooled mean
(segment_mean): runs across one and several tile edges, one segment over
the whole input, no rows, several tiles per block with an empty tail after
a live last row, F of 1, 2 and 4, both weightings, empty segments
at the start, middle and end, padding rows with smaller ids, two runs
bit-equal, launches on two streams at once, and the fault word set by ids
that decrease.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cnc_torch import kernels
from cnc_torch.codec import codec as codec_mod
from cnc_torch.codec import intctx
from cnc_torch.config import (CNCConfig, EntropyConfig, GridSpec, ModelConfig, RenderConfig,
                              TrainConfig)
from cnc_torch.data import cameras, scenes
from cnc_torch.models import context_models as cm
from cnc_torch.models import radiance_field as rf
from cnc_torch.ops import context_ops as cops
from cnc_torch.ops import encoding as enc
from cnc_torch.ops import scatter_ops
from cnc_torch.render import marching, renderer, volrend
from cnc_torch.train.trainer import Trainer

pytestmark = pytest.mark.gpu

RCFG = dataclasses.replace(RenderConfig(), render_step_size=0.02, occ_resolution=64,
                           eval_chunk_rays=512, eval_samples_per_iter=4)
SMALL = ModelConfig(n_features_per_level=2, n_neurons=32, resolutions_3d=(10, 18, 34),
                    resolutions_2d=(18, 34), log2_hashmap_size=10, log2_hashmap_size_2D=10,
                    pe_num_freqs=4)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.lib()          # build once; a build failure fails every test
    return torch.device("cuda")


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [2, 4])
def test_grid_encode_kernel(dev, d, f):
    # levels: dense, hashed at a power-of-two size, hashed at 1000 entries
    res = (6, 40, 40) if d == 3 else (20, 200, 200)
    sizes = (res[0] ** d, 1024, 1000)
    offsets = tuple(int(x) for x in np.cumsum((0,) + sizes))
    g = torch.Generator(device=dev).manual_seed(d * 10 + f)
    pts = torch.rand(5000, d, generator=g, device=dev)
    pts[:50] = torch.round(pts[:50])
    pts[50:100] = pts[50:100] * 1.6 - 0.3
    table = torch.randn(offsets[-1], f, generator=g, device=dev)
    got = enc._encode_cuda(pts, table, res, offsets)
    want = enc._encode_plain(pts, table, res, offsets)
    assert got.shape == (5000, 3 * f)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,cap,p", [(0, 16, 0.5), (1, 16, 1.0), (2047, 300, 0.2),
                                     (2048, 300, 0.2), (2049, 4096, 0.9),
                                     (2_097_157, 65_536, 0.02), (2_097_157, 65_536, 0.5)])
def test_compact_kernel(dev, n, cap, p):
    g = torch.Generator(device=dev).manual_seed(n)
    mask = torch.rand(n, generator=g, device=dev) < p
    src, count = scatter_ops.compact_mask_indices(mask, cap)
    want_src, want_count = scatter_ops._compact_plain(mask, cap)
    assert torch.equal(src, want_src)
    assert int(count) == int(want_count) == int(mask.sum())


def _march_inputs(dev):
    binaries = scenes.occupancy_from_scene(scenes.make_scene("sphere"), 64,
                                           RCFG.render_step_size, device=dev)
    K = torch.tensor([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1]], device=dev)
    c2w = torch.from_numpy(cameras.look_at_poses(1, radius=3.0)[0]).to(dev)
    rays = cameras.image_rays(K, c2w, 32, 32)
    return (binaries, rays.origins.reshape(-1, 3).contiguous(),
            rays.viewdirs.reshape(-1, 3).contiguous())


MARCH_FIELDS = ("ray_id", "t_mid", "valid", "truncated", "resume_ray", "num_samples", "ray_hits",
                "ray_last_t")


def _assert_march_equal(got, want):
    for name in MARCH_FIELDS:
        assert torch.equal(getattr(got, name).to(getattr(want, name).dtype),
                           getattr(want, name)), name


@pytest.mark.parametrize("capacity,masked", [(1 << 16, False), (2048, False), (1 << 16, True)],
                         ids=["fits", "truncated", "cursor_and_mask"])
def test_march_kernel(dev, capacity, masked):
    binaries, o, d = _march_inputs(dev)
    aabb = torch.tensor(RCFG.aabb, device=dev)
    mip = marching.build_march_mip(binaries)
    g = torch.Generator(device=dev).manual_seed(0)
    ray_mask = torch.rand(o.shape[0], generator=g, device=dev) < 0.7 if masked else None
    t_start = torch.rand(o.shape[0], generator=g, device=dev) * 3 if masked else None
    got = marching._march_cuda(o, d, binaries, aabb, RCFG, capacity, ray_mask, t_start, None,
                               mip)
    want = marching._march_plain(o, d, binaries, aabb, RCFG, capacity, ray_mask, t_start,
                                 None, mip)
    _assert_march_equal(got, want)
    assert int(got.valid.sum()) > 100
    assert bool(got.truncated) == (capacity == 2048)


def _march_pair(o, d, binaries, aabb, rcfg, capacity, ray_mask=None, t_start=None, mip=None,
                jitter=None):
    mip = marching.build_march_mip(binaries) if mip is None else mip
    args = (o, d, binaries, aabb, rcfg, capacity, ray_mask, t_start, None, mip, jitter)
    return marching._march_cuda(*args), marching._march_plain(*args)


def _cut_inside_a_ray(o, d, binaries, aabb, rcfg, cut):
    """A capacity whose cut falls inside a ray with samples on both sides of
    it.  cut "coarse": the candidate budget (capacity // 4) after the ray's
    first candidate block, the buffer holding the kept hits; "capacity": with
    every candidate kept, the buffer after the ray's first sample; "both":
    the buffer there and the candidate budget short too (the buffer's cut
    names resume_ray)."""
    mip = marching.build_march_mip(binaries)
    full = marching._march_plain(o, d, binaries, aabb, rcfg, 1 << 20, None, None, None, mip)
    pl = marching._plan(rcfg, 1 << 20, mip.shape[0], None)
    n_cand = marching._coarse_candidates(o, d, aabb, pl, None, None, mip)[2].sum(1)
    c_start = torch.cumsum(n_cand, 0) - n_cand
    f_start = torch.cumsum(full.ray_hits, 0) - full.ray_hits
    total_c = int(n_cand.sum())
    for r in range(o.shape[0]):
        if full.ray_hits[r] < 2 or n_cand[r] < 2:
            continue
        cap = 4 * (int(c_start[r]) + 1) if cut == "coarse" else int(f_start[r]) + 1
        budget = max(256, cap // 4)
        if cap // 4 < 256 or (cut == "capacity") != (budget >= total_c):
            continue
        got = marching._march_plain(o, d, binaries, aabb, rcfg, cap, None, None, None, mip)
        fits = int(got.valid.sum()) < cap
        if (int(got.resume_ray) == r and fits == (cut == "coarse")
                and 0 < int(got.ray_hits[r]) < int(full.ray_hits[r])):
            return cap
    raise AssertionError(f"no capacity cuts inside a ray ({cut})")


@pytest.mark.parametrize("cut", ["coarse", "capacity", "both"])
def test_march_kernel_cut_inside_a_ray(dev, cut):
    """The ray that straddles the candidate budget keeps only a prefix of its
    candidate blocks (and only their hits count); the one that straddles the
    buffer keeps a prefix of its samples, and resume_ray names it, before a
    coarse cut."""
    binaries, o, d = _march_inputs(dev)
    aabb = torch.tensor(RCFG.aabb, device=dev)
    # steps of 0.01: more hits per candidate block, so the buffer can
    # overflow with every candidate kept
    rcfg = RCFG if cut == "coarse" else dataclasses.replace(RCFG, render_step_size=0.01)
    cap = _cut_inside_a_ray(o, d, binaries, aabb, rcfg, cut)
    got, want = _march_pair(o, d, binaries, aabb, rcfg, cap)
    _assert_march_equal(got, want)
    assert bool(got.truncated)


@pytest.mark.parametrize("case", ["empty_grid", "no_hits", "all_masked"])
def test_march_kernel_padding(dev, case):
    """No sample to write: every slot is padding, parked on the last ray with
    cnc_tpu's t_mid (ray 0's first step without a candidate block, the first
    candidate block's first step with candidates but no hit)."""
    binaries, o, d = _march_inputs(dev)
    aabb = torch.tensor(RCFG.aabb, device=dev)
    mip, mask = None, None
    if case == "empty_grid":
        binaries = torch.zeros_like(binaries)
    elif case == "no_hits":
        mip = torch.ones_like(marching.build_march_mip(binaries))
        binaries = torch.zeros_like(binaries)
    else:
        mask = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
    got, want = _march_pair(o, d, binaries, aabb, RCFG, 4096, ray_mask=mask, mip=mip)
    _assert_march_equal(got, want)
    assert not bool(got.valid.any()) and not bool(got.ray_hits.any())
    assert bool((got.ray_id == o.shape[0] - 1).all())


def test_march_kernel_more_than_32_blocks(dev):
    """At a step of 0.002 a ray has 41 blocks of 64 steps: the warp loops."""
    binaries, o, d = _march_inputs(dev)
    aabb = torch.tensor(RCFG.aabb, device=dev)
    rcfg = dataclasses.replace(RCFG, render_step_size=0.002)
    assert marching._plan(rcfg, 1 << 16, 16, None).nb > 32
    for cap in (1 << 16, 5000):
        got, want = _march_pair(o, d, binaries, aabb, rcfg, cap)
        _assert_march_equal(got, want)
        assert int(got.valid.sum()) > 100


def test_march_kernel_training_size(dev):
    """A jittered march of 16,384 rays into 327,680 slots at the flagship's
    render config on the blocks scene; run twice, bit-equal."""
    rcfg = RenderConfig()
    binaries = scenes.occupancy_from_scene(scenes.make_scene("blocks"), rcfg.occ_resolution,
                                           rcfg.render_step_size, device=dev)
    ds = scenes.ProceduralDataset("blocks", n_images=4, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    rays, _ = ds.fetch_rays(g, 16384)
    o, d = rays.origins.contiguous(), rays.viewdirs.contiguous()
    u = torch.rand(16384, generator=g, device=dev)
    aabb = torch.tensor(rcfg.aabb, device=dev)
    got, want = _march_pair(o, d, binaries, aabb, rcfg, rcfg.sample_capacity, jitter=u)
    _assert_march_equal(got, want)
    assert int(got.valid.sum()) > rcfg.sample_capacity // 4
    again, _ = _march_pair(o, d, binaries, aabb, rcfg, rcfg.sample_capacity, jitter=u)
    _assert_march_equal(again, got)
    kernels.reset_launches()
    marching.march_rays(o, d, binaries, aabb, rcfg, rcfg.sample_capacity, jitter=u)
    assert kernels.launches["march"] == 3 and kernels.launches["compact"] == 0


@pytest.mark.parametrize("prefix,alpha_thre", [(False, 0.0), (True, 0.0), (True, 0.05)])
def test_composite_kernel(dev, prefix, alpha_thre):
    binaries, o, d = _march_inputs(dev)
    aabb = torch.tensor(RCFG.aabb, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    alive = torch.rand(o.shape[0], generator=g, device=dev) < 0.5   # padding-heavy buffer
    s = marching.march_rays(o, d, binaries, aabb, RCFG, 1 << 15, ray_mask=alive)
    n = s.ray_id.shape[0]
    sig = torch.empty(n, device=dev).exponential_(1 / 30.0, generator=g)
    rgb = torch.rand(n, 3, generator=g, device=dev)
    pt = torch.rand(o.shape[0], generator=g, device=dev) if prefix else None
    got = volrend._composite_cuda(rgb, sig, s, o.shape[0], 1e-4, pt, alpha_thre)
    want = volrend._composite_plain(rgb, sig, s, o.shape[0], 1e-4, pt, alpha_thre)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert int(got[3]) == int(want[3]) > 0


def test_march_kernel_with_jitter(dev):
    binaries, o, d = _march_inputs(dev)
    aabb = torch.tensor(RCFG.aabb, device=dev)
    mip = marching.build_march_mip(binaries)
    g = torch.Generator(device=dev).manual_seed(2)
    u = torch.rand(o.shape[0], generator=g, device=dev)
    for capacity in (1 << 16, 2048):
        got = marching._march_cuda(o, d, binaries, aabb, RCFG, capacity, None, None, None, mip,
                                   u)
        want = marching._march_plain(o, d, binaries, aabb, RCFG, capacity, None, None, None,
                                     mip, u)
        _assert_march_equal(got, want)
    plain = marching.march_rays(o, d, binaries, aabb, RCFG, 2048)
    assert not torch.equal(plain.t_mid, got.t_mid)


def _encode_grads(pts, table, res, offsets, cot):
    """(kernel d_table, twin d_table) for the output gradient `cot`."""
    got = enc._encode_backward_cuda(pts, cot, table.shape[0], res, offsets)
    t = table.clone().requires_grad_()
    (enc._encode_plain(pts, t, res, offsets) * cot).sum().backward()
    return got, t.grad


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [2, 4])
def test_grid_encode_backward_kernel(dev, d, f):
    # levels: dense, hashed at a power-of-two size, hashed at 1000 entries
    res = (6, 40, 40) if d == 3 else (20, 200, 200)
    sizes = (res[0] ** d, 1024, 1000)
    offsets = tuple(int(x) for x in np.cumsum((0,) + sizes))
    g = torch.Generator(device=dev).manual_seed(d * 10 + f)
    pts = torch.rand(5000, d, generator=g, device=dev)
    pts[:50] = torch.round(pts[:50])
    pts[50:100] = pts[50:100] * 1.6 - 0.3
    table = torch.randn(offsets[-1], f, generator=g, device=dev)
    cot = torch.randn(5000, 3 * f, generator=g, device=dev)
    got, want = _encode_grads(pts, table, res, offsets, cot)
    assert got.shape == table.shape and float(want.abs().max()) > 1.0
    # float atomics: the sum order varies; 1e-5 of the largest entry
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)
    # through autograd, as the field calls it
    t = table.clone().requires_grad_()
    (enc.encode_explicit(pts, t, res, offsets) * cot).sum().backward()
    torch.testing.assert_close(t.grad, want, atol=1e-5 * float(want.abs().max()), rtol=0)


def test_grid_encode_backward_one_level_and_all_points_outside(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(4096, 4, generator=g, device=dev)
    pts = torch.rand(3000, 3, generator=g, device=dev)
    cot = torch.randn(3000, 4, generator=g, device=dev)
    got, want = _encode_grads(pts, table, (40,), (0, 4096), cot)
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)
    outside = pts + 1.5
    got, want = _encode_grads(outside, table, (40,), (0, 4096), cot)
    assert not got.any() and not want.any()
    got = enc._encode_backward_cuda(pts[:0].contiguous(), cot[:0].contiguous(), 4096, (40,),
                                    (0, 4096))
    assert got.shape == (4096, 4) and not got.any()


def _composite_grads(rgb, sig, s, n_rays, pt, alpha_thre, cots):
    got = volrend._composite_backward_cuda(rgb, sig, s, n_rays, 1e-4, pt, alpha_thre, *cots)
    r, g = rgb.clone().requires_grad_(), sig.clone().requires_grad_()
    out = volrend._composite_plain(r, g, s, n_rays, 1e-4, pt, alpha_thre)
    sum((o * c).sum() for o, c in zip(out[:3], cots)).backward()
    return got, (r.grad, g.grad)


@pytest.mark.parametrize("prefix,alpha_thre", [(False, 0.0), (True, 0.0), (True, 0.05)])
def test_composite_backward_kernel(dev, prefix, alpha_thre):
    binaries, o, d = _march_inputs(dev)
    aabb = torch.tensor(RCFG.aabb, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    alive = torch.rand(o.shape[0], generator=g, device=dev) < 0.5   # rays without samples
    s = marching.march_rays(o, d, binaries, aabb, RCFG, 1 << 15, ray_mask=alive,
                            jitter=torch.rand(o.shape[0], generator=g, device=dev))
    n, r = s.ray_id.shape[0], o.shape[0]
    assert 0 < int(s.valid.sum()) < n
    sig = torch.empty(n, device=dev).exponential_(1 / 30.0, generator=g)
    rgb = torch.rand(n, 3, generator=g, device=dev)
    pt = torch.rand(r, generator=g, device=dev) if prefix else None
    cots = (torch.randn(r, 3, generator=g, device=dev), torch.randn(r, generator=g, device=dev),
            torch.randn(r, generator=g, device=dev))
    got, want = _composite_grads(rgb, sig, s, r, pt, alpha_thre, cots)
    for a, b in zip(got, want):
        assert float(b.abs().max()) > 1e-3
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()), rtol=0)
    assert not got[1][~s.valid].any()
    # through autograd, with the background term outside the kernel
    rr, gg = rgb.clone().requires_grad_(), sig.clone().requires_grad_()
    out = volrend.composite(rr, gg, s, r, torch.ones(3, device=dev), 1e-4, pt, alpha_thre)
    out.rgb.square().sum().backward()
    r2, g2 = rgb.clone().requires_grad_(), sig.clone().requires_grad_()
    p_rgb, p_op, _, _ = volrend._composite_plain(r2, g2, s, r, 1e-4, pt, alpha_thre)
    (p_rgb + (1.0 - p_op[:, None])).square().sum().backward()
    torch.testing.assert_close(gg.grad, g2.grad, atol=1e-5 * float(g2.grad.abs().max()), rtol=0)
    torch.testing.assert_close(rr.grad, r2.grad, atol=1e-5 * float(r2.grad.abs().max()), rtol=0)


def test_composite_backward_all_padding_and_no_rays(dev):
    n, r = 4096, 64
    s = marching.RaySamples(ray_id=torch.full((n,), r - 1, dtype=torch.int32, device=dev),
                            t_mid=torch.zeros(n, device=dev), dt=0.02,
                            valid=torch.zeros(n, dtype=torch.bool, device=dev),
                            num_samples=torch.zeros((), dtype=torch.int32, device=dev))
    sig, rgb = torch.rand(n, device=dev), torch.rand(n, 3, device=dev)
    cots = (torch.ones(r, 3, device=dev), torch.ones(r, device=dev), torch.ones(r, device=dev))
    d_rgbs, d_sig = volrend._composite_backward_cuda(rgb, sig, s, r, 1e-4, None, 0.0, *cots)
    assert not d_rgbs.any() and not d_sig.any()
    empty = marching.RaySamples(ray_id=s.ray_id[:0], t_mid=s.t_mid[:0], dt=0.02,
                                valid=s.valid[:0], num_samples=s.num_samples)
    out = volrend.composite(rgb[:0].requires_grad_(), sig[:0].requires_grad_(), empty, r,
                            torch.ones(3, device=dev))
    out.rgb.sum().backward()
    assert torch.equal(out.rgb, torch.ones(r, 3, device=dev))
    with pytest.raises(ValueError, match="prefix_trans"):
        volrend.composite(rgb, sig, s, r, prefix_trans=torch.ones(r, device=dev,
                                                                  requires_grad=True))


@pytest.mark.parametrize("f,dtype", [(1, torch.int32), (4, torch.int64), (8, torch.int32)])
def test_scatter_add_kernel(dev, f, dtype):
    g = torch.Generator(device=dev).manual_seed(f)
    size, n = 1000, 200_000
    idx = torch.randint(-50, size + 300, (n,), generator=g, device=dev).to(dtype)
    vals = torch.randn(n, f, generator=g, device=dev)
    got = scatter_ops.scatter_add(vals, idx, size)
    want = scatter_ops._scatter_add_plain(vals, idx, size)
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)
    # every row out of range: nothing is added
    far = torch.full((n,), size, dtype=dtype, device=dev)
    assert not scatter_ops.scatter_add(vals, far, size).any()
    assert scatter_ops.scatter_add(vals[:0], idx[:0], size).shape == (size, f)


def test_lane_gather_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    tbl_t = torch.randn(8, 5000, generator=g, device=dev)
    idx = torch.randint(0, 5000, (100_003,), generator=g, device=dev, dtype=torch.int32)
    assert torch.equal(scatter_ops.lane_gather(tbl_t, idx), tbl_t[:, idx.long()])
    idx[:10] = torch.tensor([-3, 5000, 7000, -1, 0, 4999, 1, 2, 3, 4], device=dev)
    assert torch.equal(scatter_ops.lane_gather(tbl_t, idx),
                       scatter_ops._lane_gather_plain(tbl_t, idx))


def test_trainer_steps_on_the_card(dev):
    cfg = CNCConfig(model=SMALL,
                    render=dataclasses.replace(RCFG, occ_resolution=32, sample_budget=1 << 13,
                                               march_block=32),
                    train=dataclasses.replace(TrainConfig(), init_batch_size=256,
                                              min_ray_bucket=256, max_ray_bucket=2048,
                                              target_sample_batch_size=1 << 13, lmbda=0.0,
                                              warmup_iters=20, lr_milestones=(60, 80)))
    ds = scenes.ProceduralDataset("sphere", n_images=4, width=32, height=32, n_steps_gt=128,
                                  device=dev)
    tr = Trainer(cfg, ds)
    assert tr.device.type == "cuda" and next(tr.field.parameters()).is_cuda
    kernels.reset_launches()
    losses = []
    tr.fit(40, log_every=0, step_callback=lambda s, aux: losses.append(float(aux["mse"])))
    # (the march compacts its own samples; K3 serves the occupancy update,
    # which draws from the compacted grid only after its warm-up)
    for name in ("grid_encode", "grid_encode_bwd", "march", "volrend", "volrend_bwd"):
        assert kernels.launches[name] > 0, kernels.launches
    assert np.isfinite(losses).all() and np.mean(losses[-5:]) < np.mean(losses[:5])
    # the same step through the plain twins on the CPU gives the same gradients
    rays, pixels = ds.fetch_rays(tr.generator, 512)
    u = torch.rand(512, device=dev)
    tr.optimizer.zero_grad()
    mse, _ = tr._render_loss(rays.origins, rays.viewdirs, pixels, torch.ones(3, device=dev), u)
    mse.backward()
    cpu = Trainer(cfg, None, device="cpu")
    cpu.field.load_state_dict({k: v.cpu() for k, v in tr.field.state_dict().items()})
    cpu.occ_state = cpu.occ_state._replace(binaries=tr.occ_state.binaries.cpu())
    mse_cpu, _ = cpu._render_loss(rays.origins.cpu(), rays.viewdirs.cpu(), pixels.cpu(),
                                  torch.ones(3), u.cpu())
    mse_cpu.backward()
    torch.testing.assert_close(mse.cpu(), mse_cpu, rtol=1e-4, atol=1e-7)
    for (name, a), b in zip(tr.field.named_parameters(), cpu.field.parameters()):
        scale = float(b.grad.abs().max())
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-3 * scale + 1e-12, rtol=0,
                                   msg=lambda m, name=name: f"{name}: {m}")


def test_render_image_card_matches_cpu(dev):
    binaries, o, d = _march_inputs(dev)
    field = rf.RadianceField(SMALL, torch.Generator().manual_seed(0), device=dev)
    with torch.no_grad():
        field.mlp_base["l1"].b[0] += 4.0       # dense enough for rays to stop early
    args = (SMALL, RCFG, RCFG.aabb)
    kernels.reset_launches()
    gpu = renderer.render_image(field, *args, binaries, o.reshape(32, 32, 3),
                                d.reshape(32, 32, 3), torch.ones(3), device=dev)
    assert all(kernels.launches[k] > 0 for k in ("grid_encode", "march",
                                                 "volrend")), kernels.launches
    # the march compacts its own samples: a view needs no K3
    assert kernels.launches["compact"] == 0, kernels.launches
    field_cpu = rf.RadianceField(SMALL, device="cpu")
    field_cpu.load_state_dict({k: v.cpu() for k, v in field.state_dict().items()})
    cpu = renderer.render_image(field_cpu, *args, binaries.cpu(), o.cpu().reshape(32, 32, 3),
                                d.cpu().reshape(32, 32, 3), torch.ones(3), device="cpu")
    for a, b in zip(gpu, cpu):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    assert float(gpu[1].max()) > 0.5


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    pts = torch.rand(16, 3, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        enc.encode_explicit(pts, torch.zeros(8, 4, device=dev), (10,), (0, 8))
    for f in (1, 3, 8):    # the kernel is built for F = 2 and 4 only
        with pytest.raises(ValueError, match="F in"):
            enc.encode_explicit(pts.float(), torch.zeros(8, f, device=dev), (10,), (0, 8))
    with pytest.raises(ValueError):
        enc.encode_explicit(pts.float(), torch.zeros(8, 4, device=dev), (10,), (0, 16))
    with pytest.raises(ValueError, match="aligned"):
        enc.encode_explicit(pts.float(), torch.zeros(33, device=dev)[1:].view(8, 4), (10,),
                            (0, 8))


# ------------------------------------------------ the rate estimate's kernels
def _sorted_segments(n, num_segments, g, dev):
    seg, _ = torch.sort(torch.randint(0, num_segments, (n,), generator=g, device=dev))
    return seg.to(torch.int32)


@pytest.mark.parametrize("case", ["mixed", "all_invalid", "one_segment", "empty_segment",
                                  "out_of_range", "level_runs"])
def test_segment_pool_kernel(dev, case):
    """K6 (segment_gather's backward) within 1e-5 of the largest sum of the
    twin in float64 (f32 adds in another order; the f32 twin adds a long
    run's rows one at a time and lands further off) and the gather (its
    forward) exactly, each one launch.  "level_runs": the 3D context's
    layout, 2^21 rows in a dozen runs, most of them in the last, then
    padding that repeats the first id."""
    g = torch.Generator(device=dev).manual_seed(7)
    n, num = 10_007, 1 if case == "one_segment" else 311
    if case == "level_runs":
        n, num = 1 << 21, 12
    seg = _sorted_segments(n, num, g, dev)
    valid = torch.rand(n, generator=g, device=dev) < 0.7
    if case == "all_invalid":
        valid[:] = False
    if case == "empty_segment":
        valid &= seg != 17
    if case == "out_of_range":
        seg[:40] = -3
        seg[-40:] = num + 2
    if case == "level_runs":
        # three quarters of the rows on the finest level, as the context's
        seg = torch.where(torch.rand(n, generator=g, device=dev) < 0.75, num - 1, seg)
        seg = torch.sort(seg).values.to(torch.int32)
        seg[-100_000:] = seg[0]
        valid[:] = True
    x = torch.randn(n, generator=g, device=dev)
    want = cops._segment_pool_plain(x.double(), seg, valid, num)
    vals = torch.randn(num, generator=g, device=dev)
    gather_leaf = vals.clone().requires_grad_()
    kernels.reset_launches()
    rows = cops.segment_gather(gather_leaf, seg, valid)
    assert kernels.launches["segment_pool_bwd"] == 1
    live = cops._live_rows(seg, valid, num)
    assert torch.equal(rows, torch.where(live, vals[torch.where(live, seg.long(), 0)], 0.0))
    rows.backward(x)
    assert kernels.launches["segment_pool"] == 1
    torch.testing.assert_close(gather_leaf.grad.double(), want, rtol=0,
                               atol=1e-5 * max(1.0, float(want.abs().max())))
    if case == "empty_segment":
        assert not bool(gather_leaf.grad[17].any())


def test_segment_pool_kernel_takes_one_float_a_row(dev):
    seg = torch.zeros(8, dtype=torch.int32, device=dev)
    valid = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="one float"):
        cops._segment_pool_cuda(torch.zeros(8, 2, device=dev), seg, valid, 4)
    with pytest.raises(ValueError, match="one float"):
        cops.segment_gather(torch.zeros(4, 2, device=dev), seg, valid)


def _mean_inputs(dev, case, f, weighted):
    """Rows sorted by id with dead rows between (and some padding at the end
    carrying a small id, as the compacted 3D site's), integer den as every
    call site has."""
    g = torch.Generator(device=dev).manual_seed(11)
    n, num = 20_011, 523
    seg = _sorted_segments(n, num, g, dev)
    if case == "cut_at_budget":
        # several tiles per block, the ids stopping short of the last segment
        # with the last row live: the empty tail is written by every block
        n, num = 1_200_000, 150_000
        seg = _sorted_segments(n, 100_000, g, dev)
    if case == "tile_edges":
        # one run across the edge at 2048, one across the edges 4096..16384
        seg = torch.cat([torch.full((2000,), 3), torch.full((100,), 4), torch.full((1900,), 5),
                         torch.full((13000,), 9), torch.full((n - 17000,), 400)]).to(dev)
    elif case == "one_segment":
        seg = torch.full((n,), 7, device=dev)
    elif case == "empty":
        n = 0
        seg = seg[:0]
    elif case == "edges_empty":
        seg = seg.clamp(30, num - 40)
    seg = seg.to(torch.int32)
    valid = torch.rand(n, generator=g, device=dev) < 0.7
    if case == "edges_empty":
        valid &= (seg < 200) | (seg > 260)       # an empty stretch in the middle
    if case == "all_invalid":
        valid[:] = False
    if case == "padded":
        valid[-3000:] = False
        seg[-3000:] = 2
    if case == "cut_at_budget":
        valid[-1] = True
    den = torch.randint(1, 1000, (n,), generator=g, device=dev).float()
    if not weighted:
        den = valid.float()
    x = torch.randn(n, f, generator=g, device=dev)
    return x, den, seg, valid, num


MEAN_CASES = ["mixed", "tile_edges", "one_segment", "empty", "edges_empty", "all_invalid",
              "padded", "cut_at_budget"]


@pytest.mark.parametrize("case", MEAN_CASES)
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_mean_kernel(dev, case, f, weighted):
    """K6m against its twin: pooled within 1e-5 of max |pooled| (sums in
    another order), covered exact, the gradient within 1e-6; two runs of the
    kernel bit-equal (no atomics); one launch each way."""
    x, den, seg, valid, num = _mean_inputs(dev, case, f, weighted)
    min_den = 1e-9 if weighted else 1.0
    cops.clear_segment_order_faults(dev)
    leaf = x.clone().requires_grad_()
    kernels.reset_launches()
    got, cov = cops.segment_mean(leaf, den, seg, valid, num, min_den, weighted)
    assert kernels.launches["segment_mean"] == 1 and kernels.launches["segment_pool"] == 0
    twin_leaf = x.clone().requires_grad_()
    want, want_cov = cops._segment_mean_plain(twin_leaf, den, seg, valid, num,
                                              float(np.float32(min_den)), weighted)
    assert got.shape == want.shape == (num, f)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * max(1e-30, float(want.abs().max())))
    assert torch.equal(cov, want_cov)
    again, cov2 = cops.segment_mean(x, den, seg, valid, num, min_den, weighted)
    assert torch.equal(again, got) and torch.equal(cov2, cov)
    cot = torch.randn(num, f, device=dev)
    got.backward(cot)
    want.backward(cot)
    assert kernels.launches["segment_mean_bwd"] == 1
    torch.testing.assert_close(leaf.grad, twin_leaf.grad, rtol=1e-6, atol=0)
    assert cops.segment_order_faults(dev) == 0
    if case == "edges_empty":
        assert not bool(cov[:30].any()) and not bool(cov[-39:].any())
        assert not bool(cov[201:260].any()) and not bool(got[201:260].any())
    if case == "cut_at_budget":
        assert not bool(cov[100_000:].any()) and not bool(got[100_000:].any())


def test_segment_mean_on_two_streams(dev):
    """Launches queued on two streams at once each take their stream's block
    records and finish counter: every result equals the default stream's,
    bit for bit."""
    x, den, seg, valid, num = _mean_inputs(dev, "cut_at_budget", 4, True)
    want, want_cov = cops.segment_mean(x, den, seg, valid, num, 1e-9, True)
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    torch.cuda.synchronize(dev)
    outs = []
    for s in streams * 4:
        with torch.cuda.stream(s):
            outs.append(cops.segment_mean(x, den, seg, valid, num, 1e-9, True))
    torch.cuda.synchronize(dev)
    for got, cov in outs:
        assert torch.equal(got, want) and torch.equal(cov, want_cov)
    works = {id(cops._mean_work[(x.device, s.cuda_stream)]) for s in streams}
    assert len(works) == 2


def test_march_kernel_on_two_streams(dev):
    """Marches queued on two streams at once each take their stream's
    workspace: every field equals the twin's."""
    binaries, o, d = _march_inputs(dev)
    aabb = torch.tensor(RCFG.aabb, device=dev)
    mip = marching.build_march_mip(binaries)
    args = (o, d, binaries, aabb, RCFG, 1 << 16, None, None, None, mip)
    want = marching._march_plain(*args)
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    torch.cuda.synchronize(dev)
    outs = []
    for s in streams * 4:
        with torch.cuda.stream(s):
            outs.append(marching._march_cuda(*args))
    torch.cuda.synchronize(dev)
    for got in outs:
        _assert_march_equal(got, want)


def test_segment_mean_flags_ids_that_decrease(dev):
    """Live ids that fall (inside a tile, and across a tile's edge) set the
    fault word; the twin raises."""
    for where in (100, 2048, 6000):
        x, den, seg, valid, num = _mean_inputs(dev, "mixed", 4, False)
        valid[where] = True
        seg[where] = 0
        seg[where - 1] = num - 1
        valid[where - 1] = True
        cops.clear_segment_order_faults(dev)
        cops.segment_mean(x, den, seg, valid, num, 1.0)
        assert cops.segment_order_faults(dev) == 1, where
        with pytest.raises(ValueError, match="decrease"):
            cops._segment_mean_plain(x, den, seg, valid, num, 1.0, False)
    cops.clear_segment_order_faults(dev)
    assert cops.segment_order_faults(dev) == 0


def test_segment_mean_refuses_what_the_kernel_does_not_take(dev):
    x, den, seg, valid, num = _mean_inputs(dev, "mixed", 4, False)
    with pytest.raises(ValueError):
        cops.segment_mean(torch.zeros(seg.shape[0], 3, device=dev), den, seg, valid, num, 1.0)
    with pytest.raises(ValueError, match="den"):
        cops.segment_mean(x, den.clone().requires_grad_(), seg, valid, num, 1.0)


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("case", ["dense", "empty_bins", "masked_tail"])
def test_pn_hist_kernel(dev, f, case):
    """K7 (exact: counts of 0/1 in f32) and its backward, within 1e-4 of the
    largest entry: the kernel adds each row's bin gradient directly, the
    twin's autograd differences reverse cumulative sums over all rows."""
    g = torch.Generator(device=dev).manual_seed(11)
    rows, bins, fine_offset, fine_size = 50_000, 4096, 1000, 1 << 12
    table = torch.where(torch.rand(fine_offset + fine_size, f, generator=g, device=dev) > 0.4,
                        1.0, -1.0)
    sel = torch.randint(0, fine_size, (rows,), generator=g, device=dev, dtype=torch.int32)
    cuts, _ = torch.sort(torch.randint(0, rows + 1, (bins - 1,), generator=g, device=dev))
    if case == "empty_bins":         # 200 distinct cuts: most bins hold no row
        cuts = (cuts // (rows // 200)) * (rows // 200)
    bnd = torch.cat([torch.zeros(1, device=dev, dtype=torch.int64), cuts,
                     torch.full((1,), rows, device=dev)]).to(torch.int32)
    row_valid = torch.ones(rows, dtype=torch.bool, device=dev)
    if case == "masked_tail":        # more rows than the count: the tail is not valid
        row_valid[rows // 2:] = False
    leaf, twin_leaf = table.clone().requires_grad_(), table.clone().requires_grad_()
    got = cops.pn_hist(leaf, fine_offset, sel, row_valid, bnd)
    want = cops._pn_hist_plain(twin_leaf, fine_offset, sel, row_valid, bnd)
    assert got.shape == (bins, f) and torch.equal(got, want)
    cot = torch.randn(bins, f, generator=g, device=dev)
    got.backward(cot)
    want.backward(cot)
    torch.testing.assert_close(leaf.grad, twin_leaf.grad, rtol=0,
                               atol=1e-4 * float(twin_leaf.grad.abs().max()))


@pytest.mark.parametrize("d,r", [(3, 10), (3, 34), (3, 66), (2, 18), (2, 130)])
@pytest.mark.parametrize("fill", ["random", "empty", "full"])
def test_footprint_kernel(dev, d, r, fill):
    """K8: the mask exactly; the overlap within 1e-5 of its largest value
    (the kernel sums cell by cell, the twin differences cumulative sums)."""
    rb = 16
    g = torch.Generator(device=dev).manual_seed(r)
    occ = {"random": torch.rand((rb,) * d, generator=g, device=dev) < 0.15,
           "empty": torch.zeros((rb,) * d, dtype=torch.bool, device=dev),
           "full": torch.ones((rb,) * d, dtype=torch.bool, device=dev)}[fill]
    if fill == "random":
        occ[..., rb // 2:] &= torch.rand((rb,) * (d - 1) + (rb // 2,), generator=g,
                                         device=dev) < 0.3
    buf = torch.zeros(r ** d + 8, dtype=torch.bool, device=dev)
    mask, ovl = cops.footprint_grids(occ, r, with_overlap=d == 3, mask_out=buf[4:4 + r ** d])
    want_mask, want_ovl = cops._footprint_plain(occ, r, d == 3)
    assert torch.equal(mask, want_mask) and torch.equal(buf[4:4 + r ** d], want_mask)
    assert not bool(buf[:4].any()) and not bool(buf[-4:].any())
    assert bool(mask.any()) == (fill != "empty")
    if d == 3:
        torch.testing.assert_close(ovl, want_ovl, rtol=0,
                                   atol=1e-5 * max(float(want_ovl.max()), 1e-3))
    else:
        assert ovl is None


def _masked_encode_inputs(dev, d, f, all_masked=False):
    res = (6, 12, 40, 40) if d == 3 else (20, 60, 200, 200)
    sizes = (res[0] ** d, res[1] ** d, 1024, 1024)
    offsets = tuple(int(x) for x in np.cumsum((0,) + sizes))
    moffs = tuple(int(x) for x in np.cumsum((0,) + tuple(r ** d for r in res)))
    g = torch.Generator(device=dev).manual_seed(d * 100 + f)
    pts = torch.rand(6000, d, generator=g, device=dev)
    pts[:50] = torch.round(pts[:50])
    pts[50:100] = pts[50:100] * 1.6 - 0.3
    table = torch.randn(offsets[-1], f, generator=g, device=dev)
    mask = torch.rand(moffs[-1], generator=g, device=dev) < (0.0 if all_masked else 0.6)
    return res, offsets, moffs[:-1], pts, table, mask, g


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("variant", ["masked", "all_masked", "diff_lo", "diff_hi", "diff_mixed"])
def test_grid_encode_variants(dev, d, f, variant):
    """K1v against the twin (1e-5 max abs) and K2v against the twin's
    autograd (1e-4 of the largest entry: float atomics)."""
    res, offsets, moffs, pts, table, mask, g = _masked_encode_inputs(
        dev, d, f, all_masked=variant == "all_masked")
    n, n_calc = pts.shape[0], 2
    ids = {"diff_lo": torch.zeros(n, dtype=torch.int32, device=dev),
           "diff_hi": torch.full((n,), len(res) - n_calc, dtype=torch.int32, device=dev),
           "diff_mixed": torch.randint(-1, len(res), (n,), generator=g, device=dev,
                                       dtype=torch.int32)}.get(variant)
    kw = dict(occ_mask=mask, mask_offsets=moffs, occ_bits=enc.pack_mask_bits(mask))
    if ids is not None:
        kw.update(min_level_ids=ids, n_levels_calc=n_calc)
    got = enc._encode_cuda(pts, table, res, offsets, **kw)
    leaf = table.clone().requires_grad_()
    want = enc._encode_plain(pts, leaf, res, offsets, **kw)
    assert got.shape == want.shape == (n, (n_calc if ids is not None else len(res)) * f)
    torch.testing.assert_close(got, want.detach(), atol=1e-5, rtol=0)
    if variant == "all_masked":      # no corner survives: 0 / 1e-9
        assert not bool(got.any())
    cot = torch.randn(got.shape, generator=g, device=dev)
    d_table = enc._encode_backward_cuda(pts, cot, table.shape[0], res, offsets, **kw)
    (want_d,) = torch.autograd.grad(want, leaf, cot)
    torch.testing.assert_close(d_table, want_d, rtol=0,
                               atol=1e-4 * max(float(want_d.abs().max()), 1e-6))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("variant", ["plain", "masked", "mixed"])
def test_grid_encode_forward_is_bit_equal_to_its_twin(dev, d, f, variant):
    """K1's forward (built without FMA, corners summed in the twin's order)
    equals the twin exactly, points on the border and outside included."""
    res, offsets, moffs, pts, table, mask, g = _masked_encode_inputs(dev, d, f)
    kw = {}
    if variant != "plain":
        kw = dict(occ_mask=mask, mask_offsets=moffs, occ_bits=enc.pack_mask_bits(mask))
    if variant == "mixed":
        kw.update(min_level_ids=torch.randint(-1, len(res), (pts.shape[0],), generator=g,
                                              device=dev, dtype=torch.int32), n_levels_calc=2)
    got = enc._encode_cuda(pts, table, res, offsets, **kw)
    want = enc._encode_plain(pts, table, res, offsets, **kw)
    assert torch.equal(got, want)


# the kernels' tile is 256 / wpt points: 64 points at four levels, 128 at two
EDGE_N = {"n1": 1, "n31": 31, "n33": 33, "tile_plus_1": 65, "tile_plus_1_mixed": 129}
EDGE_CASES = ["one_row", "one_row_plain", "two_rows", "two_rows_plain", "levels_in_warp",
              "all_masked", "outside", "zero_grad_rows", *EDGE_N]


def _edge_inputs(dev, d, f, case):
    """Four levels (dense, dense, hashed at 1024 and at 1000 entries), their
    mask grids at offsets that are not multiples of 32, and the points of one
    edge case."""
    mixed = case in ("levels_in_warp", "tile_plus_1_mixed")
    res = (6, 12, 40, 40) if d == 3 else (20, 60, 200, 200)
    # the mixed-level twin masks the hash with size - 1, as cnc_tpu's does
    # (hashed tables are powers of two in every config), so 1000 only with
    # static levels
    sizes = (res[0] ** d, res[1] ** d, 1024, 1024 if mixed else 1000)
    offsets = tuple(int(x) for x in np.cumsum((0,) + sizes))
    moffs = tuple(int(x) for x in 3 + np.cumsum((0,) + tuple(r ** d + 2 for r in res[:-1])))
    assert all(m % 32 for m in moffs)
    g = torch.Generator(device=dev).manual_seed(d * 1000 + f * 10 + EDGE_CASES.index(case))
    n = EDGE_N.get(case, 3000)
    pts = torch.rand(n, d, generator=g, device=dev)
    if case.startswith("one_row"):         # every lane on the same rows
        pts[:] = pts[0]
    elif case.startswith("two_rows"):      # lanes alternating between two points
        pts[1::2] = pts[1]
        pts[0::2] = pts[0]
    elif case == "outside":
        pts = pts * 1.6 - 0.3
    table = torch.randn(offsets[-1], f, generator=g, device=dev)
    mask = torch.rand(moffs[-1] + res[-1] ** d + 7, generator=g, device=dev) < (
        0.0 if case == "all_masked" else 0.6)
    kw = {}
    if not case.endswith("_plain"):
        kw = dict(occ_mask=mask, mask_offsets=moffs, occ_bits=enc.pack_mask_bits(mask))
    if mixed:
        # a level change at every lane, and runs of one level breaking mid-warp
        ids = torch.arange(n, device=dev) % 5 - 1
        ids[n // 2:] = (torch.arange(n - n // 2, device=dev) // 7) % 4
        kw.update(min_level_ids=ids.to(torch.int32), n_levels_calc=2)
    cot = torch.randn(n, (2 if "min_level_ids" in kw else 4) * f, generator=g, device=dev)
    if case == "zero_grad_rows":
        cot[torch.rand(n, generator=g, device=dev) < 0.5] = 0.0
    return res, offsets, pts, table, kw, cot


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_grid_encode_edge_cases(dev, d, f, case):
    """K1 and K1v bit-equal to the twin, K2 and K2v within 1e-4 of the
    largest entry of the twin's gradient (chip_smoke's K2_REL_TOL): whole
    warps on one row and lanes alternating between two (the backward's
    aggregation), a level change within a warp, point counts around a warp
    and a tile, every corner masked out, points outside [0,1], zero rows of
    the output gradient, each with mask offsets inside a word."""
    res, offsets, pts, table, kw, cot = _edge_inputs(dev, d, f, case)
    got = enc._encode_cuda(pts, table, res, offsets, **kw)
    leaf = table.clone().requires_grad_()
    want = enc._encode_plain(pts, leaf, res, offsets, **kw)
    assert torch.equal(got, want.detach())
    if case in ("all_masked", "outside"):
        assert (not bool(got.any())) if case == "all_masked" else bool(got.any())
    d_table = enc._encode_backward_cuda(pts, cot, table.shape[0], res, offsets, **kw)
    (want_d,) = torch.autograd.grad(want, leaf, cot)
    torch.testing.assert_close(d_table, want_d, rtol=0,
                               atol=1e-4 * max(float(want_d.abs().max()), 1e-6))
    if case.startswith("one_row"):
        assert int((want_d != 0).any(dim=1).sum()) <= 4 * (1 << d)


@pytest.mark.parametrize("shape", [(1,), (31,), (33,), (3, 1000), (2_000_003,)])
def test_pack_mask_bits_kernel(dev, shape):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    mask = torch.rand(shape, generator=g, device=dev) < 0.3
    before = kernels.launches["pack_mask_bits"]
    got = enc.pack_mask_bits(mask)
    assert kernels.launches["pack_mask_bits"] == before + 1
    assert torch.equal(got, enc._pack_bits_plain(mask))


def test_cuda_encode_refuses_a_mask_without_its_packed_copy(dev):
    res, offsets, pts, table, kw, _ = _edge_inputs(dev, 3, 4, "n33")
    with pytest.raises(ValueError, match="occ_bits"):
        enc._encode_cuda(pts, table, res, offsets, occ_mask=kw["occ_mask"],
                         mask_offsets=kw["mask_offsets"])
    with pytest.raises(ValueError, match="occ_bits"):
        enc._encode_cuda(pts, table, res, offsets, occ_mask=kw["occ_mask"],
                         mask_offsets=kw["mask_offsets"], occ_bits=kw["occ_bits"][1:])


def test_grid_encode_given_table_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    r = 66
    plane = torch.rand(r * r, 4, generator=g, device=dev).requires_grad_()
    mask = torch.rand(100 + r * r, generator=g, device=dev) < 0.7
    pts = torch.rand(3000, 2, generator=g, device=dev)
    got = enc.grid_encode_given_table(pts, plane, r, occ_mask=mask, mask_offset=100,
                                      occ_bits=enc.pack_mask_bits(mask))
    want = enc._encode_plain(pts, plane, [r], [0, r * r], mask, [100])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    cot = torch.randn(got.shape, generator=g, device=dev)
    (a,), (b,) = torch.autograd.grad(got, plane, cot), torch.autograd.grad(want, plane, cot)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))


TINY3 = GridSpec(num_dim=3, n_features=2, resolutions=(10, 18, 34, 66), log2_hashmap_size=10)
TINY2 = GridSpec(num_dim=2, n_features=2, resolutions=(18, 34), log2_hashmap_size=8)
TINY_E = EntropyConfig(n_features=2, sample_num=500, max_context_layer_num=2, Pg_level=4,
                       Pg_level_2D=2, skip_levels_3d=(0, 1), skip_levels_2d=(0,), Rb=16,
                       pn_coords_cap=1 << 17, pn_frac_sample_cap=1 << 10, sample_num_2d=100,
                       v_ctx_cap=1 << 15)


def test_vertex_table_kernels(dev):
    """K10: the keys, the fill and the dense level equal their twins exactly,
    on a dense 3D level (10^3 <= 1024), a hashed one (34^3) and a 2D level."""
    perm = torch.randperm(1000, generator=torch.Generator().manual_seed(1)).to(torch.int32)
    got, want = cops.dense_level(perm.to(dev), 10), cops._dense_level_plain(perm, 10)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    perm2 = torch.randperm(256, generator=torch.Generator().manual_seed(2)).to(torch.int32)
    inv2 = torch.empty_like(perm2)
    inv2[perm2.long()] = torch.arange(256, dtype=torch.int32)
    for d, r, size, tile, rb, p, inv in ((3, 34, 1024, 0, 0, None, None),
                                         (2, 34, 256, 2, 16, perm2, inv2)):
        v = r ** 3 if d == 3 else rb * rb * (tile + 2) ** 2
        on = lambda t: None if t is None else t.to(dev)
        keys = cops.vertex_keys(v, d, r, size, dev, tile, rb, on(p))
        want_keys = cops._vertex_keys_plain(v, d, r, size, tile, rb, p, torch.device("cpu"))
        assert torch.equal(keys.cpu(), want_keys)
        skey, loc = torch.sort(keys, stable=True)
        e_max = min(size, v)
        got = cops.entry_fill(skey, loc, e_max, d, tile, rb, on(inv))
        want = cops._entry_fill_plain(skey.cpu(), loc.cpu(), e_max, d, tile, rb, inv)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k].cpu().reshape(-1), want[k].reshape(-1)), (d, k)


def test_context_models_on_the_card_match_the_cpu(dev):
    """The whole model at the tiny size: tables and cache exact, the rate
    within 1e-4 relative, its table gradients within 1e-4 of their largest
    entry."""
    on_gpu, on_cpu = (cm.ContextModels(TINY_E, TINY3, TINY2, device=d) for d in (dev, "cpu"))
    for kind in ("3d", "2d"):
        for k, v in on_cpu.table_arrays[kind].items():
            assert torch.equal(on_gpu.table_arrays[kind][k].cpu(), v), (kind, k)
    assert on_gpu.tables3d == on_cpu.tables3d and on_gpu.tables2d == on_cpu.tables2d
    rng = np.random.default_rng(0)
    occ = torch.from_numpy(rng.random((16, 16, 16)) < 0.15)
    cache_g, cache_c = on_gpu.refresh_cache(occ.to(dev)), on_cpu.refresh_cache(occ)
    for k in ("bin2d", "mask3d", "mask2d", "mask3d_bits", "mask2d_bits"):
        assert torch.equal(cache_g[k].cpu(), cache_c[k]), k
    for ax in cm.AXES:
        for k, v in cache_c["pn"][ax].items():
            assert torch.equal(cache_g["pn"][ax][k].cpu(), v), (ax, k)
    for l, v in cache_c["ovl"].items():
        torch.testing.assert_close(cache_g["ovl"][l].cpu(), v, rtol=0, atol=1e-5 * float(v.max()))
    params_c = on_cpu.init_params(torch.Generator().manual_seed(3))
    params_g = on_gpu.init_params(torch.Generator().manual_seed(3))
    tabs = {k: torch.from_numpy(np.where(rng.standard_normal((s.total_entries, 2)) > 0.3, 1.0,
                                         -1.0).astype(np.float32))
            for k, s in (("xyz", TINY3), ("xy", TINY2), ("xz", TINY2), ("yz", TINY2))}
    starts = on_cpu.draw_starts(torch.Generator().manual_seed(4))
    grads = []
    for model, params, cache, device in ((on_gpu, params_g, cache_g, dev),
                                         (on_cpu, params_c, cache_c, "cpu")):
        t = {k: v.to(device).requires_grad_() for k, v in tabs.items()}
        # the float overlap differs in its last bits between kernel and twin,
        # and floor(ovl * 1000) may then differ: pool both with the twin's
        cache = dict(cache, ovl={l: v.to(device) for l, v in cache_c["ovl"].items()})
        bpp, mb = model.rate_estimate(params, t, starts, cache)
        bpp.backward()
        grads.append((float(bpp), {k: v.grad.cpu() for k, v in t.items()}))
    (bpp_g, g_g), (bpp_c, g_c) = grads
    assert np.isfinite(bpp_g) and abs(bpp_g - bpp_c) <= 1e-4 * abs(bpp_c)
    for k in g_c:
        torch.testing.assert_close(g_g[k], g_c[k], rtol=0, atol=1e-4 * float(g_c[k].abs().max()))


def test_trainer_rate_steps_on_the_card(dev):
    """A few lambda > 0 steps through Trainer.fit on the card: finite loss
    and rate, every rate kernel launched."""
    cfg = CNCConfig(
        model=ModelConfig(n_features_per_level=2, n_neurons=32, resolutions_3d=(10, 18, 34, 66),
                          resolutions_2d=(18, 34), log2_hashmap_size=10, log2_hashmap_size_2D=8,
                          pe_num_freqs=4),
        render=dataclasses.replace(RenderConfig(), render_step_size=0.02, occ_resolution=16,
                                   sample_budget=1 << 13, march_block=32),
        train=dataclasses.replace(TrainConfig(), init_batch_size=256, min_ray_bucket=256,
                                  max_ray_bucket=2048, target_sample_batch_size=1 << 13,
                                  lmbda=2e-3, warmup_iters=20, lr_milestones=(60, 80)),
        entropy=TINY_E)
    ds = scenes.ProceduralDataset("sphere", n_images=4, width=32, height=32, n_steps_gt=128,
                                  device=dev)
    entropy = cm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d)
    assert entropy.device.type == "cuda"
    tr = Trainer(cfg, ds, entropy=entropy)
    kernels.reset_launches()
    seen = []
    tr.fit(max_steps=19, log_every=0, step_callback=lambda s, aux: seen.append(
        (float(aux["mse"]), float(aux["bits_per_param"]), float(aux["ctx_util"]))))
    assert len(seen) == 20 and np.all(np.isfinite(np.asarray(seen)))
    for k in ("grid_encode_v", "grid_encode_v_bwd", "segment_pool", "segment_pool_bwd", "pn_hist",
              "footprint", "compact", "segment_mean", "segment_mean_bwd"):
        assert kernels.launches[k] > 0, k


# ----------------------------------------------------------- the codec (K9)
def _int_levels(d, f, g):
    """Context levels of a small lattice: dense, hashed at a power-of-two
    size and hashed at 1000 entries; a sign table and a random mask."""
    res = (6, 40, 40) if d == 3 else (20, 200, 200)
    sizes = (res[0] ** d, 1024, 1000)
    offs = np.cumsum((0,) + sizes)
    moffs = np.cumsum((0,) + tuple(r ** d for r in res))
    levels = [(res[i], int(offs[i]), sizes[i], int(moffs[i])) for i in range(3)]
    sign = torch.where(torch.rand(int(offs[-1]), f, generator=g) > 0.4, 1, -1).to(torch.int32)
    mask = torch.rand(int(moffs[-1]), generator=g) < 0.7
    return levels, sign, mask


@pytest.mark.parametrize("d,plane", [(3, False), (2, False), (2, True)])
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("n", [0, 1, 1001])
def test_int_encode_kernel(dev, d, plane, f, n):
    """K9a equals its twin exactly, coords on the border included (coord 0
    on a finer target grid gives the negative numerators)."""
    g = torch.Generator().manual_seed(d * 100 + f * 10 + n)
    levels, sign, mask = _int_levels(d, f, g)
    rf = 66 if d == 3 else 258
    c = torch.randint(0, rf, (n, d), generator=g, dtype=torch.int32)
    c[: n // 10] = 0
    packed = (c[:, 0] * rf + c[:, 1]) * rf + c[:, 2] if d == 3 else (c[:, 0] << 16) | c[:, 1]
    pl = None
    if plane:
        pn_res = 34
        mask = torch.cat([mask, torch.rand(pn_res * pn_res, generator=g) < 0.8])
        plane_q = torch.randint(0, 257, (pn_res * pn_res, f), generator=g, dtype=torch.int32)
        pl = (plane_q, pn_res, mask.shape[0] - pn_res * pn_res)
    want = intctx.int_encode(packed, d, rf, sign, levels, mask, pl)
    got = intctx.int_encode(packed.to(dev), d, rf, sign.to(dev), levels, mask.to(dev),
                            None if pl is None else (pl[0].to(dev), pl[1], pl[2]))
    assert got.shape == want.shape == (n, 3 * f + (f if plane else 0))
    assert torch.equal(got.cpu(), want)


def _int_params(g, n_in, f, three_d, extreme=False):
    def lin(i, o):
        if extreme:
            w = torch.where(torch.rand(i, o, generator=g) > 0.5, 1, -1) * int(intctx.W_MAX * 512)
            b = torch.where(torch.rand(o, generator=g) > 0.5, 1, -1) * int(intctx.W_MAX * 256 * 512)
        else:
            w = torch.randint(-400, 400, (i, o), generator=g)
            b = torch.randint(-50000, 50000, (o,), generator=g)
        return {"w": w.to(torch.int32), "b": b.to(torch.int32)}

    if three_d:
        return {"ctx3d": {"l0": lin(n_in, 32), "l1": lin(32, 32), "l2": lin(32, f)}, "ctx2d": {}}
    return {"ctx3d": {}, "ctx2d": {"2": lin(n_in, f)}}


def _on(tree, dev):
    return {k: (_on(v, dev) if isinstance(v, dict) else v.to(dev)) for k, v in tree.items()}


@pytest.mark.parametrize("three_d", [True, False])
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("case", ["random", "extreme", "uncovered", "empty", "odd_overlap"])
def test_int_mlp_pool_kernel(dev, three_d, f, case):
    """K9b equals its twin exactly: the fixed-point MLP (with weights at
    +-W_MAX and inputs at the clip, where the LeakyReLU's product wraps),
    the floor shift and the integer pooling, with and without overlap
    weights; a chunk of uncovered rows and an empty chunk give zeros."""
    g = torch.Generator().manual_seed(int(three_d) * 7 + f + len(case))
    w = 0 if case == "empty" else 2049
    n_in = 3 * f + 1 if three_d else 2 * f + 1
    ip = _int_params(g, n_in, f, three_d, extreme=case == "extreme")
    lim = intctx.H_CLIP if case == "extreme" else 257
    feats = torch.randint(-lim, lim + 1, (w, n_in - 1), generator=g, dtype=torch.int32)
    mask = torch.rand(w, generator=g) < (0.0 if case == "uncovered" else 0.7)
    n_e = 97
    slots = torch.sort(torch.randint(0, n_e, (w,), generator=g))[0].to(torch.int32)
    ovl = pos = None
    if case in ("odd_overlap", "extreme") or three_d:
        ovl = torch.randint(0, 64, (5000,), generator=g, dtype=torch.int32)
        pos = torch.randint(0, 5000, (w,), generator=g, dtype=torch.int32)
    level = None if three_d else 2
    for m_shift in (0, 3):
        want = intctx.int_mlp_pool(ip, level, feats, 131, m_shift, mask, slots, n_e, ovl, pos)
        got = intctx.int_mlp_pool(_on(ip, dev), level, feats.to(dev), 131, m_shift, mask.to(dev),
                                  slots.to(dev), n_e, None if ovl is None else ovl.to(dev),
                                  None if pos is None else pos.to(dev))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        if case in ("uncovered", "empty"):
            assert not want[0].any() and not want[1].any()


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("n_e", [0, 1, 4099])
def test_int_pq_kernel(dev, f, n_e):
    """K9c equals its twin (cnc_tpu's long division) and host_pq over the
    whole operand range, with zero and negative sums, zero weights, exact
    saturation and the row just below it; coverage and sign bits exact."""
    rng = np.random.default_rng(n_e + f)
    for m_scale in (1, 37, 2048):
        wmax = (1 << 27) // m_scale
        msum = rng.integers(-(1 << 30), 1 << 30, (n_e, f), dtype=np.int32)
        wsum = rng.integers(0, wmax, (n_e,), dtype=np.int32)
        if n_e > 8:
            msum[0] = 0
            msum[1] = -1
            wsum[2] = 0
            msum[3] = int(wsum[3]) * m_scale
            msum[4] = int(wsum[4]) * m_scale - 1
        sign = torch.where(torch.from_numpy(rng.random((5000, f))) > 0.5, 1, -1).to(torch.int32)
        evals = torch.from_numpy(rng.integers(0, 4000, n_e).astype(np.int32))
        args = (torch.from_numpy(msum), torch.from_numpy(wsum), m_scale)
        want = intctx.int_pq(*args, sign, 1000, evals)
        got = intctx.int_pq(*(a.to(dev) for a in args[:2]), m_scale, sign.to(dev), 1000,
                            evals.to(dev))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        np.testing.assert_array_equal(got[0].cpu().numpy(), intctx.host_pq(msum, wsum, m_scale))
        pq_only = intctx.int_pq(*(a.to(dev) for a in args[:2]), m_scale)
        assert pq_only[2] is None and torch.equal(pq_only[0], got[0])


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("listed", ["some", "all", "none"])
def test_pn_hist_int_kernel(dev, f, listed):
    """K7i equals its twin: bins of every length, empty ones included, with
    the valid rows cut by the listed count."""
    g = torch.Generator().manual_seed(f)
    pn_res, cap = 34, 3000
    scale = pn_res - 2
    bins = torch.sort(torch.randint(0, scale * scale + 1, (cap,), generator=g))[0]
    bounds = torch.searchsorted(bins, torch.arange(scale * scale + 1)).to(torch.int32)
    n = {"some": 2100, "all": 5000, "none": 0}[listed]
    pn = {"entry_idx": torch.randint(0, 700, (cap,), generator=g, dtype=torch.int32),
          "n": torch.tensor(n, dtype=torch.int32), "bounds": bounds}
    sign = torch.where(torch.rand(900, f, generator=g) > 0.45, 1, -1).to(torch.int32)
    want = intctx.frac_plane(sign, pn, 150, pn_res, f)
    got = intctx.frac_plane(sign.to(dev), {k: v.to(dev) for k, v in pn.items()}, 150, pn_res, f)
    assert torch.equal(got.cpu(), want)


def test_int_wrappers_reject_what_the_kernels_do_not_take(dev):
    g = torch.Generator().manual_seed(0)
    levels, sign, mask = _int_levels(3, 4, g)
    packed = torch.zeros(10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        intctx.int_encode(packed, 3, 66, sign.to(dev), levels, mask)          # mask on the CPU
    with pytest.raises(ValueError, match="int32"):
        intctx.int_encode(packed, 3, 66, sign.to(dev).float(), levels, mask.to(dev))
    with pytest.raises(ValueError, match="levels"):
        intctx.int_encode(packed, 3, 66, sign.to(dev), levels * 2, mask.to(dev))
    with pytest.raises(ValueError, match="contiguous CUDA"):
        intctx.int_pq(torch.zeros(4, 4, dtype=torch.int32, device=dev),
                      torch.zeros(4, dtype=torch.int32), 2048)


def test_codec_on_the_card_matches_the_cpu(dev, tmp_path):
    """A tiny encode on the card writes the same streams as through the twins
    on the CPU; decoding them on the card gives the trained signs on every
    covered entry, and the frac planes of the decoded table equal the
    trained table's."""
    import filecmp
    import os
    rng = np.random.default_rng(3)
    occ = torch.from_numpy(rng.random((16, 16, 16)) < 0.2)
    tabs = {k: torch.from_numpy(np.where(rng.standard_normal((s.total_entries, 2)) > -0.3, 1.0,
                                         -1.0).astype(np.float32))
            for k, s in (("xyz", TINY3), ("xy", TINY2), ("xz", TINY2), ("yz", TINY2))}
    ecfg = dataclasses.replace(TINY_E, max_points_per_chunk=1 << 13)
    out = []
    for i, device in enumerate(("cpu", dev)):
        model = cm.ContextModels(ecfg, TINY3, TINY2, device=device)
        params = model.init_params(torch.Generator().manual_seed(5))
        codec = codec_mod.CNCCodec(model)
        d = tmp_path / f"run{i}"
        kernels.reset_launches()
        cache = model.refresh_cache_int(occ.to(device))
        res = codec.encode(params, {k: v.to(device) for k, v in tabs.items()}, occ.to(device),
                           str(d), cache=cache)
        out.append((model, params, codec, cache, res, d))
    assert all(kernels.launches[k] > 0 for k in ("int_encode", "int_mlp_pool", "int_pq",
                                                  "pn_hist_int"))
    names = sorted(os.listdir(out[0][5]))
    assert names == sorted(os.listdir(out[1][5])) and len(names) > 5
    for name in names:
        assert filecmp.cmp(out[0][5] / name, out[1][5] / name, shallow=False), name
    assert out[0][4] == out[1][4]
    model, params, codec, cache, (pgs, _, _), d = out[1]
    rec = codec.decode(params, occ.to(dev), pgs, str(d), cache=cache)
    sign3 = intctx.sign_table(tabs["xyz"].to(dev))
    for ax in cm.AXES:
        assert torch.equal(model.frac_plane_int(intctx.sign_table(rec["xyz"]), cache["pn"][ax]),
                           model.frac_plane_int(sign3, cache["pn"][ax]))
    for l in model.ctx_levels_3d:
        t = model.tables3d[l]
        _, wsum, evals = model.pool_3d_sums_int(codec._int_params(params), sign3, cache, l, 0, 0,
                                                t.n_entries, t.n_vertices, 0)
        rows = t.offset + evals.long()
        cov = wsum > 0
        assert torch.equal(rec["xyz"][rows][cov], tabs["xyz"].to(dev)[rows][cov])
        assert bool((rec["xyz"][rows][~cov] == 1).all())
