"""cnc_torch's CUDA kernels against their plain twins, on the card.

Marked `gpu`: they need an NVIDIA GPU and nvcc, and skip without them.  They
import neither JAX nor cnc_tpu, so on a GPU machine without JAX they run
without the suite's conftest (which imports JAX):

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -m gpu -q

`chip_smoke.py` checks the kernels at the main path's full-width shapes;
these cover the edge cases: other feature widths and dimensions, hashed
levels of non-power-of-two size, empty and boundary-sized masks, both
truncation regimes of the march, padding in the composite; for the backward
kernels: both feature widths, one level, points all out of range, rays
without samples, an all-padding buffer, a carried transmittance; the
scatter-add with every row dropped; a few training steps on the card.  For
the rate estimate's kernels: the pooling with all rows invalid, one segment,
a segment without a valid row and both ranks of x; the sign histogram with
empty bins and more rows than the cap; the footprint grids on an empty and a
full occupancy in 2D and 3D; the masked encode with every corner masked and
the mixed-level encode with its first level at both ends; the table build on
a dense, a hashed and a 2D level; a few rate steps on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cnc_torch import kernels
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
    for name in ("ray_id", "t_mid", "valid", "truncated", "resume_ray", "num_samples"):
        assert torch.equal(getattr(got, name).to(getattr(want, name).dtype),
                           getattr(want, name)), name
    assert int(got.valid.sum()) > 100
    assert bool(got.truncated) == (capacity == 2048)


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
        for name in ("ray_id", "t_mid", "valid", "truncated", "resume_ray", "num_samples"):
            assert torch.equal(getattr(got, name).to(getattr(want, name).dtype),
                               getattr(want, name)), name
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
    for name in ("grid_encode", "grid_encode_bwd", "compact", "march", "volrend",
                 "volrend_bwd"):
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
    assert all(kernels.launches[k] > 0 for k in ("grid_encode", "compact", "march",
                                                 "volrend")), kernels.launches
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
                                  "out_of_range"])
@pytest.mark.parametrize("f", [None, 2, 4])
def test_segment_pool_kernel(dev, case, f):
    """K6 and its backward: 1e-5 of the largest sum (f32 adds in another
    order), the backward (a gather) exactly."""
    g = torch.Generator(device=dev).manual_seed(7)
    n, num = 10_007, 1 if case == "one_segment" else 311
    seg = _sorted_segments(n, num, g, dev)
    valid = torch.rand(n, generator=g, device=dev) < 0.7
    if case == "all_invalid":
        valid[:] = False
    if case == "empty_segment":
        valid &= seg != 17
    if case == "out_of_range":
        seg[:40] = -3
        seg[-40:] = num + 2
    x = torch.randn((n,) if f is None else (n, f), generator=g, device=dev)
    leaf = x.clone().requires_grad_()
    got = cops.segment_pool(leaf, seg, valid, num)
    twin_leaf = x.clone().requires_grad_()
    want = cops._segment_pool_plain(twin_leaf, seg, valid, num)
    assert got.shape == want.shape == ((num,) if f is None else (num, f))
    torch.testing.assert_close(got, want, atol=1e-5 * max(1.0, float(want.abs().max())), rtol=0)
    if case == "empty_segment":
        assert not bool(got[17].any())
    cot = torch.randn(want.shape, generator=g, device=dev)
    got.backward(cot)
    want.backward(cot)
    assert torch.equal(leaf.grad, twin_leaf.grad)
    # the transpose: a gather forward (exact), K6 in the backward
    vals = torch.randn(want.shape, generator=g, device=dev)
    gather_leaf = vals.clone().requires_grad_()
    rows = cops.segment_gather(gather_leaf, seg, valid)
    live = cops._live_rows(seg, valid, num)
    picked = vals[torch.where(live, seg.long(), 0)]
    assert torch.equal(rows, torch.where(live if f is None else live[:, None], picked, 0.0))
    rows.backward(x)
    torch.testing.assert_close(gather_leaf.grad, want.detach(), rtol=0,
                               atol=1e-5 * max(1.0, float(want.abs().max())))


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
    kw = dict(occ_mask=mask, mask_offsets=moffs)
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


def test_grid_encode_given_table_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    r = 66
    plane = torch.rand(r * r, 4, generator=g, device=dev).requires_grad_()
    mask = torch.rand(100 + r * r, generator=g, device=dev) < 0.7
    pts = torch.rand(3000, 2, generator=g, device=dev)
    got = enc.grid_encode_given_table(pts, plane, r, occ_mask=mask, mask_offset=100)
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
    for k in ("bin2d", "mask3d", "mask2d"):
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
              "footprint", "compact"):
        assert kernels.launches[k] > 0, k
