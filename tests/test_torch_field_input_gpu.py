"""K1f, the field's input row in one launch (`encoding.field_input`,
csrc/grid_encode.cu), against the composition it replaces, on the card.

Marked `gpu`: they need an NVIDIA GPU and nvcc, and skip without them.  They
import neither JAX nor cnc_tpu:

    python -m pytest tests/test_torch_field_input_gpu.py --noconftest -m gpu -q

At the published widths (159 columns) on a view round's 524,288 points, on
a count that is not a multiple of the kernel's 32-point tile and on none,
with points outside [0,1], on 0 and 1, outside in one axis only, and a NaN:
the 96 grid columns equal the four K1 calls bit for bit, and the plain
twins' too, but where a point with a NaN coordinate reads as outside (K1's
zeros; the twin carries the NaN); the 63 sine columns lie within 2e-7 of
`sine_embed`'s (sinf and cosf of the same exact product, built with
-fmad=false, may round the last bit of a value of magnitude up to 1
otherwise than torch.sin and torch.cos: 1 ulp at 1 is 6e-8, so 2e-7
allows a few); one query is one device operation and one
`field_input` launch, and makes no host sync.  A training render under
autograd still composes: four K1 launches, no K1f.
"""

import dataclasses

import pytest
import torch

from cnc_torch import kernels
from cnc_torch.config import CNCConfig, ModelConfig, RenderConfig, TrainConfig
from cnc_torch.data import scenes
from cnc_torch.models import radiance_field as rf
from cnc_torch.ops import encoding as enc
from cnc_torch.ops import sh as sh_ops
from cnc_torch.train.trainer import Trainer

pytestmark = pytest.mark.gpu

CFG = ModelConfig()
SINE_TOL = 2e-7
SMALL = ModelConfig(n_features_per_level=2, n_neurons=32, resolutions_3d=(10, 18, 34),
                    resolutions_2d=(18, 34), log2_hashmap_size=10, log2_hashmap_size_2D=10,
                    pe_num_freqs=4)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.lib()
    return torch.device("cuda")


def _field(cfg, dev, seed=0):
    field = rf.RadianceField(cfg, torch.Generator().manual_seed(seed), device=dev)
    with torch.no_grad():
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        for k in rf.TABLES:
            field.tables[k].normal_(generator=g)
    return field


@pytest.fixture(scope="module")
def field(dev):
    return _field(CFG, dev)


def _points(n, dev, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(n, 3, generator=g, device=dev)
    edge = torch.tensor([[0.0, 1.0, 0.5], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0],
                         [-0.25, 0.5, 0.5], [0.5, 1.5, 0.5], [0.5, 0.5, -1e-7],
                         [float("nan"), 0.5, 0.5], [2.0, -3.0, 7.5]], device=dev)
    k = min(n, edge.shape[0])
    x[:k] = edge[:k]
    if n > 1000:
        x[1000:1500] = x[1000:1500] * 1.6 - 0.3           # a spread outside [0,1]
        x[1500:1600] = torch.round(x[1500:1600])          # the cube's corners
    return x


def _check_row(got, want, cfg):
    n_grid = cfg.grid_3d.output_dim + 3 * cfg.grid_2d.output_dim
    assert got.shape == want.shape
    assert torch.equal(got[:, :n_grid], want[:, :n_grid])
    torch.testing.assert_close(got[:, n_grid:], want[:, n_grid:], rtol=0, atol=SINE_TOL,
                               equal_nan=True)


def _plain_row(cfg, x01, t):
    """The row through the plain twins: `_encode_plain` on each table's
    points, then `sine_embed`."""
    planes = [x01] + [x01[:, dims].contiguous() for dims in ([0, 1], [0, 2], [1, 2])]
    specs = [cfg.grid_3d] + [cfg.grid_2d] * 3
    return torch.cat([enc._encode_plain(p, t[k], s.resolutions, s.offsets)
                      for p, k, s in zip(planes, rf.TABLES, specs)]
                     + [sh_ops.sine_embed(x01, cfg.pe_num_freqs)], dim=-1)


def _check_against_the_twin(got, x01, t, cfg):
    """Bit-equal grid columns but for K1's rule that a point with a NaN
    coordinate reads as outside (zeros), where the twin carries the NaN."""
    twin = _plain_row(cfg, x01, t)
    n_grid = cfg.grid_3d.output_dim + 3 * cfg.grid_2d.output_dim
    nan_rows = twin[:, :n_grid].isnan().any(dim=1)
    assert not bool((nan_rows & ~x01.isnan().any(dim=1)).any())
    twin[:, :n_grid] = twin[:, :n_grid].nan_to_num(nan=0.0)
    _check_row(got, twin, cfg)


@pytest.mark.parametrize("n", [524_288, 1_000, 33, 0])
def test_field_input_equals_the_composition(dev, field, n):
    x01 = _points(n, dev)
    with torch.no_grad():
        t = rf.quantized_tables(field, CFG)
        want = rf.composed_position(CFG, x01, t)
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = rf.encode_position(field, CFG, x01, t)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launched = {k: v for k, v in kernels.launches.items() if v}
    assert launched == {"field_input": 1}, launched
    assert got.shape == (n, 159)
    _check_row(got, want, CFG)
    if n:
        with torch.no_grad():
            _check_against_the_twin(got, x01, t, CFG)
        # the NaN point reads as outside: no grid feature; the yz plane reads
        o3, o2 = CFG.grid_3d.output_dim, CFG.grid_2d.output_dim
        assert bool((got[6, :o3 + 2 * o2] == 0).all()) and bool((got[6, o3 + 2 * o2:o3 + 3 * o2]
                                                                 != 0).any())
        assert bool(got[6, o3 + 3 * o2].isnan())


@pytest.mark.parametrize("n", [4_099, 1])
def test_field_input_at_other_widths(dev, n):
    """F = 2, 3 + 2 levels, 4 frequencies: 9 tasks, 45 columns."""
    field = _field(SMALL, dev, seed=5)
    x01 = _points(n, dev, seed=6)
    with torch.no_grad():
        t = rf.quantized_tables(field, SMALL)
        got = rf.encode_position(field, SMALL, x01, t)
        want = rf.composed_position(SMALL, x01, t)
    assert got.shape == (n, 45)
    _check_row(got, want, SMALL)
    with torch.no_grad():
        _check_against_the_twin(got, x01, t, SMALL)


def test_field_input_is_one_device_operation(dev, field):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x01 = _points(65_536, dev)
    with torch.no_grad():
        t = rf.quantized_tables(field, CFG)
        rf.encode_position(field, CFG, x01, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rf.encode_position(field, CFG, x01, t)
            torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(ops) == 1 and "grid_encode_forward_kernel_field" in ops[0], ops


def test_the_wrapper_refuses_what_the_kernel_does_not_take(dev, field):
    with torch.no_grad():
        t = [v for v in rf.quantized_tables(field, CFG).values()]
    x01 = _points(64, dev)
    args = (CFG.grid_3d, CFG.grid_2d, CFG.pe_num_freqs)
    with pytest.raises(ValueError):
        enc.field_input(x01.double(), t, *args)
    with pytest.raises(ValueError):
        enc.field_input(x01[:, :2].contiguous(), t, *args)
    with pytest.raises(ValueError):
        enc.field_input(x01, t[:3], *args)
    with pytest.raises(ValueError, match="past the table"):
        enc.field_input(x01, [t[0][:100]] + t[1:], *args)
    with pytest.raises(ValueError):
        enc.field_input(x01.t(), t, *args)                  # not contiguous


def test_a_training_render_still_composes(dev):
    cfg = CNCConfig(model=SMALL,
                    render=dataclasses.replace(RenderConfig(), render_step_size=0.02,
                                               occ_resolution=32, sample_budget=1 << 13,
                                               march_block=32),
                    train=dataclasses.replace(TrainConfig(), init_batch_size=256,
                                              min_ray_bucket=256, max_ray_bucket=2048,
                                              target_sample_batch_size=1 << 13, lmbda=0.0))
    ds = scenes.ProceduralDataset("sphere", n_images=4, width=32, height=32, n_steps_gt=128,
                                  device=dev)
    tr = Trainer(cfg, ds)
    rays, pixels = ds.fetch_rays(tr.generator, 512)
    u = torch.rand(512, device=dev)
    kernels.reset_launches()
    mse, _ = tr._render_loss(rays.origins, rays.viewdirs, pixels, torch.ones(3, device=dev), u)
    assert kernels.launches["grid_encode"] == 4 and kernels.launches["field_input"] == 0
    mse.backward()
    assert kernels.launches["grid_encode_bwd"] == 4
    assert all(p.grad is not None for p in tr.field.tables.values())
