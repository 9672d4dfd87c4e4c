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
scatter-add with every row dropped; a few training steps on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cnc_torch import kernels
from cnc_torch.config import CNCConfig, ModelConfig, RenderConfig, TrainConfig
from cnc_torch.data import cameras, scenes
from cnc_torch.models import radiance_field as rf
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
