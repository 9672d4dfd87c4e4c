"""cnc_torch's CUDA kernels against their plain twins, on the card.

Marked `gpu`: they need an NVIDIA GPU and nvcc, and skip without them.  They
import neither JAX nor cnc_tpu, so on a GPU machine without JAX they run
without the suite's conftest (which imports JAX):

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -m gpu -q

`chip_smoke.py` checks the kernels at the main path's full-width shapes;
these cover the edge cases: other feature widths and dimensions, hashed
levels of non-power-of-two size, the forward bit-equal to its twin in every
variant, empty and boundary-sized masks (K3 also at its tile edges, at
views 1-15 bytes off a 16-byte boundary, at the 3D context's and the pn
coord lists' sizes and on two streams at once; one compaction and one
mask packing each one device operation), both
truncation regimes of the march, padding in the composite; for the backward
kernels: both feature widths, one level, points all out of range, rays
without samples, an all-padding buffer, a carried transmittance; the
scatter-add with every row dropped; a few training steps on the card.  For
the rate estimate's kernels: the pooling (segment_gather's backward) with
all rows invalid, one segment, a segment without a valid row and the 3D
context's dozen runs over 2^21 rows; the frac plane in one launch and one
allocation, bit-equal to its twin at the edges of tests/pn_frac_cases.py
(nothing listed, one row, fewer rows than the sample, full and overflowed
lists, sample caps at and above the list's, empty bins at both ends, many
rows a bin, most bins empty), its backward against the twin in float64,
and K7b alone (the fill and one launch) against its plain function in
float64 at the same edges, two runs;
the footprint grids on an empty and a full occupancy in 2D and 3D, and at
Rb = 128 with rows of 18 to 2,050 corners, boxes several threads share and
mask_out at byte offsets 1-3; the masked encode with every corner masked and
the mixed-level encode with its first level at both ends; the encode's edge
cases (whole warps on one row, lanes alternating between two rows, a level
change within a warp, 1, 31, 33 and a tile plus one points, every corner
masked, mask offsets inside a word, points outside [0,1], zero gradient
rows; the forward bit-equal) and the mask packing (ragged last words, rows
that start unaligned, views at byte offsets, the planes' and the whole 3D
mask's sizes; tests/compact_pack_cases.py); the table build's dense level
and its counting sort at tests/vertex_sort_cases.py's levels (a key holding
every vertex, above the shared-memory cap, segments on both sides of the
cap, empty keys, a table size that is not a power of two, 2D levels
through perm and inv; no torch.sort, launches counted); a few rate steps
on the card.  For the
codec's integer kernels (the fused pool int_ctx_pool, the pool finished by
K9c in its launch, K7i, also at tests/pn_frac_cases.py's edges), held to
their twins with torch.equal: the
finished pool at n_e of 0, 1 and 4,099, an entry over many blocks, F of 2
and 4, 3D and 2D with and without the plane, with and without the sign
bits, and its fault word; the pool with no row kept, every row kept,
one entry over many blocks, weights at +-W_MAX where the LeakyReLU's
product wraps, overlap weights of 0, F of 2 and 4, 2D with and without the
plane and with no context level, two runs equal, and its fault word on
entries that decrease inside a warp, between warps, batches and blocks,
across a block with no kept row, or leave their range; the wrappers'
refusals (the frac planes': dtype, alignment, F, the shapes of bounds and
of the gradient); K7p and K7pb, a data-parallel rank's share of a plane,
over W = 2, 3 and 8 splits and tests/pn_part_cases.py's row ranges (a bin's
edge and inside one bin, size 0, past the row space, an uneven W = 3
split, one bin of more rows than a warp's group); and a tiny encode on the card whose
streams equal the same encode through the twins on the CPU, decoded back on
the card.  For the
per-ray march (every field equal to the twin's, the per-ray hit counts and
last t_mid and the padding slots included): a coarse cut inside a ray, a
capacity cut inside a ray, no candidate block, candidate blocks without a
hit, more than 32 blocks a ray, every ray masked, a jittered training march
at 327,680 slots, two runs bit-equal.  For the one-launch pooled mean
(segment_mean): runs across one and several tile edges, one segment over
the whole input, no rows, several tiles per block with an empty tail after
a live last row, F of 1, 2 and 4, both weightings, empty segments
at the start, middle and end, padding rows with smaller ids (the mean held
to the twin run in float64), two runs bit-equal, launches on two streams at
once, and the fault word set by ids
that decrease.  For the composite's per-ray warp scans (K5, K5b;
tests/volrend_buffers.py): rays longer than a pass and than 1,024 samples,
empty rays between full ones, a buffer of padding only, one ray holding the
buffer, padding alone on the last ray; prefix_trans and alpha_thre; the walk
table left zero; K5b's two runs bit-equal and its null output gradients; the
fault word set by buffers that break the precondition, and the walk table
dropped by a call that raises.  For K1s/K2s, the encode kernels masked by
a summed-area table: both D and both F, a random, an empty, a full grid and
one occupied only at its edges, footprints clipped at 0 and Rb - 1, an
R = 3 level, dense and hashed levels (at 1024 and 1000 entries), points on
and outside the border; the forward bit-equal to its twin and the backward
within 1e-4 of the largest entry, each counted as K1s/K2s; the public
encodes with `occ_binary` and `occ_sat` (mixed levels, a given table,
autograd through K2s, `occ_mask` winning over the table) and the
wrapper's refusals of a malformed table; the sources K1s/K2s read (one
launch a forward: the coarse levels' corner bits and the occupancy rows)
equal to their twin at Rb = 128 and a ragged Rb = 40 on random, empty,
full, single-cell and edge grids, the encodes bit-equal (K2s within 1e-4)
at Rb = 128 over levels on both sides of the coarse/fine split (R - 2 =
Rb and Rb + 1), F 2 and 4, points on the cube's faces, corners and
outside it, mixed levels, the backward on the forward's sources (no
second sources launch through autograd), and a fine level whose windows
the layout declares unfit encoded through the coarse path.
"""

import dataclasses
import functools

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
from cnc_torch.ops import sat as sat_ops
from cnc_torch.ops import scatter_ops
from cnc_torch.render import marching, renderer, volrend
from cnc_torch.train.trainer import Trainer
import vertex_sort_cases as vc
from compact_pack_cases import COMPACT_CASES, PACK_CASES, compact_case, pack_case
from pn_frac_cases import CASES as PN_CASES
from pn_frac_cases import pn_case
from pn_part_cases import PART_MODES, part_case, part_ranges
from volrend_buffers import BROKEN, DT, LAYOUTS, broken_buffer, segment_buffer

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


# (n, cap, density): the earlier three-launch kernel's block edges, the edges
# of 8,192 and of 16,384 bytes (the look-back kernel's tile), cap above n, a
# count above cap, all set and none set, and the main path's sites: the 3D
# rate context (a count below and above cap) and the pn coord lists (512^3
# bools, cap 2^24)
@pytest.mark.parametrize("n,cap,p", [(0, 16, 0.5), (1, 16, 1.0), (2047, 300, 0.2),
                                     (2048, 300, 0.2), (2049, 4096, 0.9),
                                     (2_097_157, 65_536, 0.02), (2_097_157, 65_536, 0.5),
                                     (8191, 9000, 0.5), (8192, 9000, 0.5), (8193, 9000, 0.5),
                                     (16383, 9000, 0.5), (16384, 9000, 0.5), (16385, 9000, 0.5),
                                     (5000, 8192, 0.5), (100_003, 1000, 1.0),
                                     (100_003, 1000, 0.0), (3 * 8192 + 5, 4 * 8192, 1.0),
                                     (11_352_091, 1 << 21, 0.1), (11_352_091, 1 << 21, 0.25),
                                     (512 ** 3, 1 << 24, 0.05), (512 ** 3, 1 << 24, 0.2)])
def test_compact_kernel(dev, n, cap, p):
    g = torch.Generator(device=dev).manual_seed(n)
    mask = torch.rand(n, generator=g, device=dev) < p
    before = kernels.launches["compact"]
    src, count = scatter_ops.compact_mask_indices(mask, cap)
    assert kernels.launches["compact"] == before + 1
    want_src, want_count = scatter_ops._compact_plain(mask, cap)
    assert torch.equal(src, want_src)
    assert int(count) == int(want_count) == int(mask.sum())


@pytest.mark.parametrize("name", list(COMPACT_CASES))
def test_compact_kernel_at_the_tile_edges(dev, name):
    """tests/compact_pack_cases.py's masks, views at byte offsets 0-15 of a
    buffer on the card: equal to the twin and to numpy."""
    buf, off, n, cap = compact_case(name)
    whole = torch.from_numpy(buf).to(dev).view(torch.bool)
    mask = whole[off:off + n]
    assert mask.data_ptr() % 16 == off % 16
    src, count = scatter_ops.compact_mask_indices(mask, cap)
    want_src, want_count = scatter_ops._compact_plain(mask, cap)
    assert torch.equal(src, want_src) and int(count) == int(want_count)
    pos = np.flatnonzero(buf[off:off + n])[:cap]
    assert np.array_equal(src.cpu().numpy()[:pos.size], pos)


def test_compact_on_two_streams(dev):
    """Compactions queued on two streams at once each take their stream's
    status words, counter and epoch: every result equals the twin's."""
    g = torch.Generator(device=dev).manual_seed(9)
    masks = [torch.rand(n, generator=g, device=dev) < 0.3 for n in (3_000_017, 2_500_001)]
    wants = [scatter_ops._compact_plain(m, 1 << 20) for m in masks]
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    torch.cuda.synchronize(dev)
    outs = []
    for _ in range(4):
        for s, m in zip(streams, masks):
            with torch.cuda.stream(s):
                outs.append(scatter_ops.compact_mask_indices(m, 1 << 20))
    torch.cuda.synchronize(dev)
    for i, (src, count) in enumerate(outs):
        want_src, want_count = wants[i % 2]
        assert torch.equal(src, want_src) and int(count) == int(want_count)
    works = {id(scatter_ops._compact_works[(masks[0].device, s.cuda_stream)]) for s in streams}
    assert len(works) == 2


def test_compact_and_pack_are_one_device_operation(dev):
    """One compaction and one packing each run one device operation (no
    memset, no copy), in one profile of this process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    g = torch.Generator(device=dev).manual_seed(10)
    mask = torch.rand(11_352_091, generator=g, device=dev) < 0.2
    planes = torch.rand(3, 1_400_336, generator=g, device=dev) < 0.2
    calls = {"k3": lambda: scatter_ops.compact_mask_indices(mask, 1 << 21),
             "pack": lambda: enc.pack_mask_bits(planes)}
    for fn in calls.values():      # the stream's scratch is made by a first call
        fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in calls.items():
            with record_function("ab_" + name):
                fn()
                torch.cuda.synchronize(dev)
    events = prof.events()
    split = min(e.time_range.start for e in events if e.name == "ab_pack")
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("ab_")]
    k3 = [e.name for e in device if e.time_range.start < split]
    pack = [e.name for e in device if e.time_range.start >= split]
    assert len(k3) == 1 and "compact" in k3[0], k3
    assert len(pack) == 1 and "pack" in pack[0], pack


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


def _segment_samples(layout, dev):
    ray_id, valid, t_mid, sig, rgb, n_rays = segment_buffer(layout)
    s = marching.RaySamples(ray_id=torch.from_numpy(ray_id).to(dev),
                            t_mid=torch.from_numpy(t_mid).to(dev), dt=float(DT),
                            valid=torch.from_numpy(valid).to(dev),
                            num_samples=torch.tensor(int(valid.sum()), device=dev))
    return s, torch.from_numpy(sig).to(dev), torch.from_numpy(rgb).to(dev), n_rays


@pytest.mark.parametrize("layout", LAYOUTS)
def test_composite_kernels_on_segment_edges(dev, layout):
    """K5 and K5b on rays longer than a pass and than 1,024 samples, empty
    rays, padding alone or after the last ray's samples, one ray holding the
    buffer; with and without prefix_trans and alpha_thre.  The walk table is
    left zero, the fault word clear; K5b's two runs are bit-equal."""
    s, sig, rgb, r = _segment_samples(layout, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    pt = torch.rand(r, generator=g, device=dev) * 0.9 + 0.1
    cots = (torch.randn(r, 3, generator=g, device=dev), torch.randn(r, generator=g, device=dev),
            torch.randn(r, generator=g, device=dev))
    volrend.clear_walk_order_faults(dev)
    for prefix, alpha_thre in ((None, 0.0), (pt, 0.0), (pt, 0.05)):
        got = volrend._composite_cuda(rgb, sig, s, r, 1e-4, prefix, alpha_thre)
        want = volrend._composite_plain(rgb, sig, s, r, 1e-4, prefix, alpha_thre)
        for a, b in zip(got[:3], want[:3]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert int(got[3]) == int(want[3])
        grads = [volrend._composite_backward_cuda(rgb, sig, s, r, 1e-4, prefix, alpha_thre,
                                                  *cots) for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*grads))
        rr, ss = rgb.clone().requires_grad_(), sig.clone().requires_grad_()
        out = volrend._composite_plain(rr, ss, s, r, 1e-4, prefix, alpha_thre)
        want = torch.autograd.grad(out[:3], (rr, ss), cots)
        for a, b in zip(grads[0], want):
            torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()), rtol=0)
        assert not grads[0][1][~s.valid].any() and not grads[0][0][~s.valid].any()
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert not volrend._walk_tables[(sig.device, stream)].any()
    assert volrend.walk_order_faults(dev) == 0


@pytest.mark.parametrize("kind", BROKEN)
def test_composite_fault_word_on_broken_buffers(dev, kind):
    """A buffer that breaks the precondition sets the fault word, in the
    forward and in the backward, as the twin says; the walk table is still
    left zero."""
    ray_id, valid, t_mid, sig, rgb, r = broken_buffer(kind)
    s = marching.RaySamples(ray_id=torch.from_numpy(ray_id).to(dev),
                            t_mid=torch.from_numpy(t_mid).to(dev), dt=float(DT),
                            valid=torch.from_numpy(valid).to(dev), num_samples=None)
    sig, rgb = torch.from_numpy(sig).to(dev), torch.from_numpy(rgb).to(dev)
    assert volrend._walk_order_faults_plain(s.ray_id, s.valid, r) == 1
    cots = (torch.ones(r, 3, device=dev), None, None)
    for run in (lambda: volrend._composite_cuda(rgb, sig, s, r, 1e-4, None, 0.0),
                lambda: volrend._composite_backward_cuda(rgb, sig, s, r, 1e-4, None, 0.0,
                                                         *cots)):
        volrend.clear_walk_order_faults(dev)
        run()
        assert volrend.walk_order_faults(dev) == 1
    volrend.clear_walk_order_faults(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert not volrend._walk_tables[(sig.device, stream)].any()


def test_composite_drops_its_walk_table_when_a_call_raises(dev, monkeypatch):
    s, sig, rgb, r = _segment_samples("long_rays", dev)
    volrend._composite_cuda(rgb, sig, s, r, 1e-4, None, 0.0)
    key = (sig.device, torch.cuda.current_stream(dev).cuda_stream)
    assert key in volrend._walk_tables

    def fail(*args, **kw):
        raise RuntimeError("cnc_volrend_forward failed")

    monkeypatch.setattr(volrend.kernels, "call", fail)
    with pytest.raises(RuntimeError):
        volrend._composite_cuda(rgb, sig, s, r, 1e-4, None, 0.0)
    assert key not in volrend._walk_tables
    monkeypatch.undo()
    got = volrend._composite_cuda(rgb, sig, s, r, 1e-4, None, 0.0)
    want = volrend._composite_plain(rgb, sig, s, r, 1e-4, None, 0.0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)


def test_composite_backward_with_absent_output_gradients(dev):
    """Through autograd with only the rgb used: K5b gets null pointers for
    d_opacity and d_depth."""
    s, sig, rgb, r = _segment_samples("long_rays", dev)
    rr, ss = rgb.clone().requires_grad_(), sig.clone().requires_grad_()
    volrend.composite(rr, ss, s, r).rgb.square().sum().backward()
    r2, s2 = rgb.clone().requires_grad_(), sig.clone().requires_grad_()
    volrend._composite_plain(r2, s2, s, r, 1e-4, None, 0.0)[0].square().sum().backward()
    for a, b in ((rr.grad, r2.grad), (ss.grad, s2.grad)):
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()), rtol=0)


# the atomics' width the kernel takes for a row of F floats at aligned starts
_SCATTER_WIDTH = {1: 1, 2: 2, 3: 1, 4: 4, 8: 4}
SCATTER_REL_TOL = 1e-5      # chip_smoke.py's: max |kernel - twin| over max |twin|


@pytest.mark.parametrize("f,dtype", [(1, torch.int32), (2, torch.int32), (3, torch.int64),
                                     (4, torch.int64), (8, torch.int32)])
def test_scatter_add_kernel(dev, f, dtype):
    g = torch.Generator(device=dev).manual_seed(f)
    size, n = 1000, 200_000
    idx = torch.randint(-50, size + 300, (n,), generator=g, device=dev).to(dtype)
    vals = torch.randn(n, f, generator=g, device=dev)
    kernels.reset_launches()
    got = scatter_ops.scatter_add(vals, idx, size)
    assert kernels.launches["scatter_add"] == 1
    assert scatter_ops.scatter_add_width(vals, got) == _SCATTER_WIDTH[f]
    want = scatter_ops._scatter_add_plain(vals, idx, size)
    torch.testing.assert_close(got, want, atol=SCATTER_REL_TOL * float(want.abs().max()), rtol=0)
    # every row out of range: nothing is added
    far = torch.full((n,), size, dtype=dtype, device=dev)
    assert not scatter_ops.scatter_add(vals, far, size).any()
    assert not scatter_ops.scatter_add(vals, far - size - 1, size).any()
    kernels.reset_launches()
    assert scatter_ops.scatter_add(vals[:0], idx[:0], size).shape == (size, f)
    assert kernels.launches["scatter_add"] == 0


@pytest.mark.parametrize("f,offset,width", [(4, 1, 1), (4, 2, 2), (8, 2, 2), (8, 3, 1),
                                            (2, 1, 1), (8, 4, 4)])
def test_scatter_add_kernel_on_an_offset_view(dev, f, offset, width):
    """vals a contiguous view `offset` floats into its storage: the atomics
    narrow to what the view's start allows (4 floats at offset 4 = 16 bytes)."""
    g = torch.Generator(device=dev).manual_seed(10 * f + offset)
    size, n = 777, 50_001
    base = torch.randn(n * f + offset, generator=g, device=dev)
    vals = base[offset:].view(n, f)
    assert vals.is_contiguous() and vals.storage_offset() == offset
    idx = torch.randint(-3, size + 3, (n,), generator=g, device=dev, dtype=torch.int32)
    got = scatter_ops.scatter_add(vals, idx, size)
    assert scatter_ops.scatter_add_width(vals, got) == width
    want = scatter_ops._scatter_add_plain(vals.double(), idx, size)
    assert float((got.double() - want).abs().max()) <= SCATTER_REL_TOL * float(want.abs().max())


@pytest.mark.parametrize("f", [1, 3, 4, 8])
@pytest.mark.parametrize("hit", [1, 4])
def test_scatter_add_kernel_under_full_contention(dev, f, hit):
    """Every row on one index (or on 4): all atomics on the same row(s),
    against the sums in float64.  Positive values, so the float32 sums'
    rounding stays far under the tolerance."""
    g = torch.Generator(device=dev).manual_seed(f + hit)
    size, n = 64, 8192
    vals = torch.rand(n, f, generator=g, device=dev)
    idx = (torch.arange(n, device=dev, dtype=torch.int32) % hit) + 17
    got = scatter_ops.scatter_add(vals, idx, size)
    want = scatter_ops._scatter_add_plain(vals.double(), idx, size)
    assert float((got.double() - want).abs().max()) <= SCATTER_REL_TOL * float(want.abs().max())
    assert not got[:17].any() and not got[17 + hit:].any()


@pytest.mark.parametrize("rows,t_cols", [(1, 5003), (3, 5001), (3, 1), (8, 5000), (12, 4097),
                                         (16, 4099)])
@pytest.mark.parametrize("n", [0, 1, 100_003])
def test_lane_gather_kernel(dev, rows, t_cols, n):
    """rows 1 and 3 take one 4-wide group, 8 one 8-wide, 12 and 16 two (12's
    second padded); T not a multiple of 4; indices outside the table on both
    sides are clamped.  Equal to the twin bit for bit."""
    g = torch.Generator(device=dev).manual_seed(rows + n)
    tbl_t = torch.randn(rows, t_cols, generator=g, device=dev)
    idx = torch.randint(0, t_cols, (n,), generator=g, device=dev, dtype=torch.int32)
    if n > 10:
        idx[:10] = torch.tensor([-3, t_cols, t_cols + 7000, -1, 0, t_cols - 1, 1, 2, 3, 4],
                                device=dev)
    elif n == 1:
        idx[0] = -5
    kernels.reset_launches()
    got = scatter_ops.lane_gather(tbl_t, idx)
    assert kernels.launches["lane_gather"] == (1 if n else 0)
    assert got.shape == (rows, n)
    assert torch.equal(got, scatter_ops._lane_gather_plain(tbl_t, idx))
    if n > 10:
        assert torch.equal(got[:, 10:], tbl_t[:, idx[10:].long()])


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
    # a view's field queries take no gradient: K1f builds each one's row
    assert all(kernels.launches[k] > 0 for k in ("field_input", "march",
                                                 "volrend")), kernels.launches
    assert kernels.launches["grid_encode"] == 0, kernels.launches
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
    """K6m against its twin: pooled within 1e-5 of max |pooled| against the
    twin run in float64 (on the card the twin sums with index_add's float
    atomics, whose order varies: in float32 a segment of ~14,000 rows that
    cancels to a small mean rounds by as much as the bound itself), covered
    exact, the gradient within 1e-6; two runs of the kernel bit-equal (no
    atomics); one launch each way."""
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
    exact, _ = cops._segment_mean_plain(x.double(), den.double(), seg, valid, num, min_den,
                                        weighted)
    torch.testing.assert_close(got.double(), exact, rtol=0,
                               atol=1e-5 * max(1e-30, float(exact.abs().max())))
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
@pytest.mark.parametrize("name", list(PN_CASES))
def test_pn_frac_plane_kernel(dev, f, name):
    """K7, the whole frac plane in one launch and one allocation, equal to
    the plain plane bit for bit (tests/pn_frac_cases.py: nothing listed, one
    row, fewer rows than the sample, full and overflowed lists, sample caps at
    and above the list's, a sample that does not divide it, empty bins at both
    ends, many rows a bin, most bins empty, a listed count below the cap); its
    backward within 1e-4 of the largest entry of the twin's run in float64
    (the kernel adds each row's bin gradient directly; the twin's autograd
    differences reverse cumulative sums over all rows, where an empty bin's
    gradient, divided by its 0 + 1e-6 rows, is 1e6 times the plane's and
    cancels: in float32 that leaves errors of 1e-2 of the result)."""
    case = pn_case(name, f)
    table = torch.from_numpy(case["table"]).to(dev)
    eidx, bounds = (torch.from_numpy(case[k]).to(dev) for k in ("entry_idx", "bounds"))
    n = torch.tensor(case["n"], dtype=torch.int32, device=dev)
    args = (case["fine_offset"], eidx, bounds, n, case["pn_res"], case["sample_cap"])
    leaf, twin_leaf = table.clone().requires_grad_(), table.double().requires_grad_()
    torch.cuda.synchronize(dev)
    kernels.reset_launches()
    before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    got = cops.pn_frac_plane(leaf, *args)
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] - before == 1
    assert kernels.launches["pn_frac_plane"] == 1 and sum(kernels.launches.values()) == 1
    want = cops._pn_frac_plane_plain(table, *args)
    assert got.shape == (case["pn_res"] ** 2, f) and torch.equal(got, want)
    cot = torch.randn(got.shape, generator=torch.Generator(device=dev).manual_seed(11),
                      device=dev)
    got.backward(cot)
    cops._pn_frac_plane_plain(twin_leaf, *args).backward(cot.double())
    assert kernels.launches["pn_hist_bwd"] == 1
    torch.testing.assert_close(leaf.grad.double(), twin_leaf.grad, rtol=0,
                               atol=1e-4 * max(float(twin_leaf.grad.abs().max()), 1e-30))


def test_pn_frac_plane_refuses_what_the_kernel_does_not_take(dev):
    case = pn_case("unsampled", 4)
    table = torch.from_numpy(case["table"]).to(dev)
    eidx, bounds = (torch.from_numpy(case[k]).to(dev) for k in ("entry_idx", "bounds"))
    n = torch.tensor(case["n"], dtype=torch.int32, device=dev)
    res = case["pn_res"]
    with pytest.raises(ValueError):
        cops.pn_frac_plane(table, 37, eidx, bounds[:-1], n, res)
    with pytest.raises(ValueError):
        cops.pn_frac_plane(table, 37, eidx, bounds, n.long(), res)
    with pytest.raises(ValueError):
        cops.pn_frac_plane(table[:, :3].contiguous(), 37, eidx, bounds, n, res)
    with pytest.raises(ValueError):
        cops.pn_frac_plane(table, 37, eidx, bounds, n, res, sample_cap=0)


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


def _overlap_float64(occ, r):
    """The overlap summed in float64 (the twin's separable pools)."""
    bd = cops.footprint_bounds(r, occ.shape[0])
    o = occ.double()
    for _ in range(3):
        s = torch.cat([torch.zeros_like(o[:1]), torch.cumsum(o, dim=0)])

        def lerp(i0, fr):
            i0 = torch.from_numpy(i0).long().to(o.device)
            fr = torch.from_numpy(fr).double().to(o.device).reshape(-1, 1, 1)
            return s[i0] * (1.0 - fr) + s[i0 + 1] * fr

        o = torch.movedim(lerp(bd.b_i, bd.b_fr) - lerp(bd.a_i, bd.a_fr), 0, -1)
    return o.reshape(-1)


@pytest.mark.parametrize("d,r,rb,off", [
    (3, 18, 128, 1), (3, 44, 128, 2), (3, 148, 128, 3), (3, 514, 128, 1), (3, 34, 48, 2),
    (2, 18, 128, 3), (2, 130, 128, 3), (2, 1026, 128, 2), (2, 2050, 128, 1)])
def test_footprint_kernel_at_rb_128(dev, d, r, rb, off):
    """K8 at the flagship's occupancy resolution: rows of 18 to 2,050
    corners (shorter than a block's 1,024 and longer), boxes that several
    warps share (r = 18, 44) and one warp each, mask_out at byte offsets 1-3,
    an Rb that is not a multiple of 32.  The mask exactly, the overlap within
    1e-5 of the level's largest value against the twin summed in float64 and
    within 1e-4 against the float32 twin (whose differences of cumulative
    sums over 128 cells round more coarsely); two runs bit-equal."""
    g = torch.Generator(device=dev).manual_seed(r)
    occ = torch.rand((rb,) * d, generator=g, device=dev) < 0.15
    occ[..., rb // 2:] &= torch.rand((rb,) * (d - 1) + (rb - rb // 2,), generator=g,
                                     device=dev) < 0.3
    occ[: rb // 4] = False
    n = r ** d
    buf = torch.zeros(n + 8, dtype=torch.bool, device=dev)
    mask, ovl = cops.footprint_grids(occ, r, with_overlap=d == 3, mask_out=buf[off:off + n])
    want_mask, want_ovl = cops._footprint_plain(occ, r, d == 3)
    assert torch.equal(mask, want_mask) and 0 < int(mask.sum()) < n
    assert not bool(buf[:off].any()) and not bool(buf[off + n:].any())
    if d == 3:
        top = float(want_ovl.max())
        assert (ovl.double() - _overlap_float64(occ, r)).abs().max() <= 1e-5 * top
        torch.testing.assert_close(ovl, want_ovl, rtol=0, atol=1e-4 * top)
        again = cops.footprint_grids(occ, r, with_overlap=True)[1]
        assert torch.equal(again, ovl)


def test_footprint_refuses_what_the_kernel_does_not_take(dev):
    """Grids whose side is not a multiple of 16 cells, or not 16-byte aligned."""
    with pytest.raises(ValueError, match="multiple of 16"):
        cops.footprint_grids(torch.zeros(24, 24, 24, dtype=torch.bool, device=dev), 18)
    flat = torch.zeros(16 ** 3 + 1, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        cops.footprint_grids(flat[1:].reshape(16, 16, 16), 18)


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


# the earlier shapes, rows of 1,000 (every other row starts 8 bytes past a
# 16-byte boundary), the planes (3 x 1,400,336: a half-full last word) and
# the whole 3D mask of the full-width model (223,231,256 bools)
@pytest.mark.parametrize("shape", [(1,), (31,), (33,), (3, 1000), (2_000_003,), (5, 1000),
                                   (3, 1_400_336), (223_231_256,)])
def test_pack_mask_bits_kernel(dev, shape):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    mask = torch.rand(shape, generator=g, device=dev) < 0.3
    before = kernels.launches["pack_mask_bits"]
    got = enc.pack_mask_bits(mask)
    assert kernels.launches["pack_mask_bits"] == before + 1
    assert torch.equal(got, enc._pack_bits_plain(mask))


@pytest.mark.parametrize("name", list(PACK_CASES))
def test_pack_mask_bits_kernel_on_views(dev, name):
    """tests/compact_pack_cases.py's masks (ragged last words, unaligned rows,
    views at byte offsets 1 and 7) on the card: equal to the twin and to
    numpy's packbits."""
    buf, off, rows, cols = pack_case(name)
    whole = torch.from_numpy(buf).to(dev).view(torch.bool)
    mask = whole[off:off + rows * cols].view(rows, cols)
    assert mask.data_ptr() % 16 == off % 16
    got = enc.pack_mask_bits(mask)
    assert torch.equal(got, enc._pack_bits_plain(mask))
    bits = np.packbits(np.pad(buf[off:off + rows * cols].reshape(rows, cols),
                              ((0, 0), (0, (-cols) % 32))), axis=-1, bitorder="little")
    assert np.array_equal(got.cpu().numpy(), np.ascontiguousarray(bits).view("<i4"))


def test_pack_mask_bits_kernel_on_a_one_byte_offset_view_of_the_3d_mask(dev):
    g = torch.Generator(device=dev).manual_seed(11)
    whole = torch.rand(223_231_256 + 1, generator=g, device=dev) < 0.3
    mask = whole[1:]
    assert torch.equal(enc.pack_mask_bits(mask), enc._pack_bits_plain(mask))


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
    """K10's dense level equals its twin exactly (10^3 <= 1024)."""
    perm = torch.randperm(1000, generator=torch.Generator().manual_seed(1)).to(torch.int32)
    got, want = cops.dense_level(perm.to(dev), 10), cops._dense_level_plain(perm, 10)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("name", vc.TABLE_CASES)
def test_vertex_count_sort_kernel(dev, name, monkeypatch):
    """The counting sort by entry equals the twin (keys, a stable torch.sort,
    the fill) exactly, with no torch.sort on the card: segments above the
    shared-memory cap (one key holding every vertex, 3 merge passes), empty
    keys, a table size that is not a power of two, 2D levels through perm and
    inv; four launches a level (six and the merge passes with long
    segments); two runs equal."""
    v, d, r, size, e_max, tile, rb, perm, inv = vc.table_case(name)
    on = lambda a, device: None if a is None else torch.from_numpy(a.astype(np.int32)).to(device)
    want = cops.level_tables(v, d, r, size, e_max, "cpu", tile, rb, on(perm, "cpu"),
                             on(inv, "cpu"))
    monkeypatch.setattr(torch, "sort", None)        # the card's build sorts nothing with it
    kernels.reset_launches()
    got = cops.level_tables(v, d, r, size, e_max, dev, tile, rb, on(perm, dev), on(inv, dev))
    again = cops.level_tables(v, d, r, size, e_max, dev, tile, rb, on(perm, dev), on(inv, dev))
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert torch.equal(got[k].cpu(), w) and torch.equal(again[k], got[k]), k
        else:
            assert got[k] == w, k
    cap = kernels.lib().cnc_vertex_segment_cap()
    passes = max(0, int(np.ceil(np.log2(want["longest"] / cap))))
    per_call = 4 + (2 + passes if want["longest"] > cap else 0)
    assert kernels.launches["vertex_tables"] == 2 * per_call
    if name == "one key holds every vertex":
        assert passes == 3


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
    for k in ("grid_encode_v", "grid_encode_v_bwd", "segment_pool", "segment_pool_bwd",
              "pn_frac_plane", "footprint", "compact", "segment_mean", "segment_mean_bwd"):
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


def _pool_case(d, f, plane, case, seed):
    """One pool's arguments on the CPU (`intctx.int_ctx_pool` after `ip`):
    rows of an rf-lattice (a twentieth on the border) sorted by entry, kept
    where the pool level's mask (appended to the context levels' masks)
    is set; `case` picks the kept share, the entries' sizes, the weights,
    the overlap grid and the context levels."""
    g = torch.Generator().manual_seed(seed)
    levels, sign, mask = _int_levels(d, f, g)
    if case == "no_levels":
        levels = []
    rf = 66 if d == 3 else 258
    n = {"big_entry": 20000, "random": 5000}.get(case, 3000)
    c = torch.randint(0, rf, (n, d), generator=g, dtype=torch.int32)
    c[: n // 20] = 0
    ids = (c[:, 0] * rf + c[:, 1]) * rf + c[:, 2] if d == 3 else (c[:, 0] << 16) | c[:, 1]
    start_e, n_e = 11, 97
    if case == "big_entry":      # entry 1 holds more kept rows than a block scans
        n_e = 3
        rows = torch.tensor([0] * 100 + [1] * (n - 200) + [2] * 100)
    else:
        rows = torch.sort(torch.randint(0, n_e, (n,), generator=g))[0]
    slots = (rows + start_e).to(torch.int32)
    kept = {"none_kept": 0.0, "all_kept": 1.1, "big_entry": 1.1}.get(case, 0.4)
    mask_off = mask.shape[0]
    mask = torch.cat([mask, torch.rand(rf ** d, generator=g) < kept])
    pl = ovl = None
    if plane:
        pn_res = 34
        mask = torch.cat([mask, torch.rand(pn_res * pn_res, generator=g) < 0.8])
        lim = intctx.H_CLIP if case == "extreme" else 256
        plane_q = torch.randint(-lim, lim + 1, (pn_res * pn_res, f), generator=g,
                                dtype=torch.int32)
        pl = (plane_q, pn_res, mask.shape[0] - pn_res * pn_res)
    if d == 3:
        ovl = (torch.zeros(rf ** 3, dtype=torch.int32) if case == "ovl_zero"
               else torch.randint(0, 64, (rf ** 3,), generator=g, dtype=torch.int32))
    n_in = len(levels) * f + (f if plane else 0) + 1
    ip = _int_params(g, n_in, f, d == 3, extreme=case == "extreme")
    return ip, (None if d == 3 else 2), ids, slots, start_e, n_e, rf, mask, mask_off, sign, \
        levels, 131, 3 if case == "random" else 0, pl, ovl


def _pool_on(args, dev):
    on = lambda t: None if t is None else t.to(dev)
    ip, level, ids, slots, start_e, n_e, rf, mask, mask_off, sign, levels, pg_q, m_shift, pl, \
        ovl = args
    return (_on(ip, dev), level, on(ids), on(slots), start_e, n_e, rf, on(mask), mask_off,
            on(sign), levels, pg_q, m_shift,
            None if pl is None else (on(pl[0]), pl[1], pl[2]), on(ovl))


POOL_CASES = ([(3, False, f, c) for f in (2, 4)
               for c in ("random", "none_kept", "all_kept", "big_entry", "extreme", "ovl_zero")]
              + [(2, p, f, c) for p in (False, True) for f in (2, 4)
                 for c in ("random", "none_kept", "all_kept", "big_entry", "extreme",
                           "no_levels")])


@pytest.mark.parametrize("d,plane,f,case", POOL_CASES)
def test_int_ctx_pool_kernel(dev, d, plane, f, case):
    """The fused pool (context encode, MLP and pooling of the kept rows, one
    launch) equals its twin exactly, and two runs equal each other: no row
    kept, every row kept, one entry over many blocks, weights at +-W_MAX
    where the LeakyReLU's product wraps (plane values at the clip in 2D),
    overlap weights of 0, no context level."""
    args = _pool_case(d, f, plane, case, seed=d * 100 + f * 10 + len(case) + plane)
    want = intctx.int_ctx_pool(*args)
    kernels.reset_launches()
    got = intctx.int_ctx_pool(*_pool_on(args, dev))
    again = intctx.int_ctx_pool(*_pool_on(args, dev))
    intctx.raise_on_pool_faults(dev)
    assert kernels.launches["int_ctx_pool"] == 2
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    kept = int(want[1].sum()) if d == 2 else None
    if case == "none_kept":
        assert not want[0].any() and not want[1].any()
    if case == "big_entry" and d == 2:
        assert kept > 4096 and int(want[1][1]) > 4096
    if case in ("all_kept", "random"):
        assert want[1].any()


def _fault_case(where):
    """A 3D pool of 64 tiles of rows, every row kept, 16 rows an entry, whose
    entries decrease (or leave their range) at one row: inside a warp,
    between warps, between 256-row batches, between blocks (a block a tile
    here), across a block with no kept row, or out of range."""
    g = torch.Generator().manual_seed(17)
    levels, sign, mask = _int_levels(3, 4, g)
    rf, n = 66, 1024 * 64
    c = torch.randint(1, rf - 1, (n, 3), generator=g, dtype=torch.int32)
    ids = (c[:, 0] * rf + c[:, 1]) * rf + c[:, 2]
    start_e, n_e = 5, n // 16
    slots = (torch.arange(n, dtype=torch.int32) // 16) + start_e
    mask_off = mask.shape[0]
    level_mask = torch.ones(rf ** 3, dtype=torch.bool)
    level_mask[0] = False                      # id 0 is never kept
    mask = torch.cat([mask, level_mask])
    r = 1024 * 10
    if where is not None:
        slots = slots.clone()
        if where == "across an empty block":
            ids = ids.clone()
            ids[r:r + 1024] = 0
            slots[r + 1024] = slots[r - 1] - 1
        elif where == "out of range":
            slots[-1] = start_e + n_e
        else:
            at = r + {"inside a warp": 5, "between warps": 32, "between batches": 256,
                      "between blocks": 0}[where]
            slots[at] = slots[at - 1] - 1
    ip = _int_params(g, 13, 4, True)
    return ip, None, ids, slots, start_e, n_e, rf, mask, mask_off, sign, levels, 131, 0, None, \
        torch.randint(0, 64, (rf ** 3,), generator=g, dtype=torch.int32)


@pytest.mark.parametrize("where", ["inside a warp", "between warps", "between batches",
                                   "between blocks", "across an empty block", "out of range"])
def test_int_ctx_pool_faults_on_unsorted_entries(dev, where):
    """Kept rows whose entries decrease or leave [start_e, start_e + n_e)
    raise, in the twin at once and on the card through the fault word that
    raise_on_pool_faults reads, which is clear again after the raise; the
    sorted pool leaves it clear and equals its twin."""
    bad = _fault_case(where)
    with pytest.raises(ValueError, match="must not decrease"):
        intctx.int_ctx_pool(*bad)
    intctx.int_ctx_pool(*_pool_on(bad, dev))
    with pytest.raises(ValueError, match="must not decrease"):
        intctx.raise_on_pool_faults(dev)
    good = _fault_case(None)
    got = intctx.int_ctx_pool(*_pool_on(good, dev))
    intctx.raise_on_pool_faults(dev)
    for a, b in zip(got, intctx.int_ctx_pool(*good)):
        assert torch.equal(a.cpu(), b)


def _finish_case(d, f, plane, case, seed):
    """One finished pool's arguments on the CPU (`intctx.int_ctx_pool_pq`):
    every entry with a row or more, a share of the rows kept; `case` picks
    the entries: n_e of 0, 1 or 4,099 (1 to 9 rows each), or three with the
    middle one over many blocks."""
    g = torch.Generator().manual_seed(seed)
    levels, sign, mask = _int_levels(d, f, g)
    rf = 66 if d == 3 else 258
    counts = {"n_e 0": [], "n_e 1": [5], "n_e 4099": torch.randint(1, 10, (4099,), generator=g)
              .tolist(), "straddle": [3, 40 * 1024 + 11, 2]}[case]
    start_e, n_e = 11, len(counts)
    slots = torch.repeat_interleave(torch.arange(n_e, dtype=torch.int32) + start_e,
                                    torch.tensor(counts, dtype=torch.int64))
    n = slots.shape[0]
    c = torch.randint(0, rf, (n, d), generator=g, dtype=torch.int32)
    ids = (c[:, 0] * rf + c[:, 1]) * rf + c[:, 2] if d == 3 else (c[:, 0] << 16) | c[:, 1]
    mask_off = mask.shape[0]
    mask = torch.cat([mask, torch.rand(rf ** d, generator=g) < 0.4])
    pl = ovl = None
    if plane:
        pn_res = 34
        mask = torch.cat([mask, torch.rand(pn_res * pn_res, generator=g) < 0.8])
        pl = (torch.randint(-256, 257, (pn_res * pn_res, f), generator=g, dtype=torch.int32),
              pn_res, mask.shape[0] - pn_res * pn_res)
    if d == 3:
        ovl = torch.randint(0, 64, (rf ** 3,), generator=g, dtype=torch.int32)
    n_in = len(levels) * f + (f if plane else 0) + 1
    ip = _int_params(g, n_in, f, d == 3)
    evals = torch.randint(0, sign.shape[0] - 100, (n_e,), generator=g, dtype=torch.int32)
    return (ip, (None if d == 3 else 2), ids, slots, start_e, n_e, rf, mask, mask_off, sign,
            levels, 131, 1, 37), pl, ovl, evals


FINISH_CASES = ([(3, False, f, c) for f in (2, 4) for c in ("n_e 0", "n_e 1", "n_e 4099",
                                                              "straddle")]
                + [(2, p, f, c) for p in (False, True) for f in (2, 4)
                   for c in ("n_e 1", "n_e 4099", "straddle")])


@pytest.mark.parametrize("d,plane,f,case", FINISH_CASES)
@pytest.mark.parametrize("bits", [True, False])
def test_int_ctx_pool_pq_kernel(dev, d, plane, f, case, bits):
    """The pool finished in its own launch (K9c as its epilogue) equals the
    twins (`int_ctx_pool_plain`, then `_int_pq_plain`) exactly, with and
    without the sign bits: n_e of 0, 1 and 4,099, an entry over many
    blocks (finished by the last block), F of 2 and 4, 3D and 2D with and
    without the plane; two runs equal, one launch each (counted by
    int_ctx_pool and int_pq), one copy to the host equal."""
    args, pl, ovl, evals = _finish_case(d, f, plane, case, seed=d * 100 + f * 10 + len(case))
    ev = evals if bits else None
    want = intctx.int_ctx_pool_pq(*args, pl, ovl, 100, ev)
    on_dev = _pool_on(args[:12] + (args[12], pl, ovl), dev)
    kernels.reset_launches()
    got = intctx.int_ctx_pool_pq(*on_dev[:13], args[13], *on_dev[13:], 100,
                                 evals.to(dev) if bits else None)
    again = intctx.int_ctx_pool_pq(*on_dev[:13], args[13], *on_dev[13:], 100,
                                   evals.to(dev) if bits else None)
    intctx.raise_on_pool_faults(dev)
    n_launch = 0 if case == "n_e 0" else 2
    assert kernels.launches["int_ctx_pool"] == kernels.launches["int_pq"] == n_launch
    for a, b, c in zip(got, again, want):
        assert (a is None) == (c is None) == (b is None) == (not bits and c is None)
        if c is not None:
            assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    for a, c in zip(intctx.pull_probs(got), intctx.pull_probs(want)):
        assert (a is None and c is None) or np.array_equal(a, c)
    if case == "straddle":
        assert bool(want[1][1])                     # the long entry has kept rows


@pytest.mark.parametrize("broken", ["decrease", "out of range"])
def test_int_ctx_pool_pq_faults_on_broken_windows(dev, broken):
    """A window whose kept rows' entries decrease or leave the window sets
    the fault word on the card; the twin raises."""
    args, pl, ovl, evals = _finish_case(3, 4, False, "n_e 4099", seed=5)
    args = list(args)
    args[7] = torch.ones_like(args[7])          # every row kept
    slots = args[3].clone()
    if broken == "decrease":
        slots[5000], slots[5001] = slots[5001].item() + 1, slots[5000].item()
    else:
        slots[-1] = 11 + 4099
    args[3] = slots
    with pytest.raises(ValueError, match="exactly those of entries"):
        intctx.int_ctx_pool_pq(*args, pl, ovl, 100, evals)
    on_dev = _pool_on(tuple(args[:13]) + (pl, ovl), dev)
    intctx.int_ctx_pool_pq(*on_dev[:13], args[13], *on_dev[13:], 100, evals.to(dev))
    with pytest.raises(ValueError, match="must not decrease"):
        intctx.raise_on_pool_faults(dev)


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


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("name", list(PN_CASES))
def test_pn_hist_int_kernel_at_the_pn_cases(dev, f, name):
    """K7i at the edges of tests/pn_frac_cases.py (the sign table of the
    case's table; K7i reads no sample cap): one launch, one allocation,
    equal to its twin."""
    case = pn_case(name, f)
    sign = intctx.sign_table(torch.from_numpy(case["table"]))
    pn = {"entry_idx": torch.from_numpy(case["entry_idx"]),
          "bounds": torch.from_numpy(case["bounds"]),
          "n": torch.tensor(case["n"], dtype=torch.int32)}
    args = (case["fine_offset"], case["pn_res"], f)
    want = intctx.frac_plane(sign, pn, *args)
    sign_d, pn_d = sign.to(dev), {k: v.to(dev) for k, v in pn.items()}
    torch.cuda.synchronize(dev)
    kernels.reset_launches()
    before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    got = intctx.frac_plane(sign_d, pn_d, *args)
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] - before == 1
    assert kernels.launches["pn_hist_int"] == 1 and sum(kernels.launches.values()) == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("name", list(PN_CASES))
def test_pn_hist_backward_kernel(dev, f, name):
    """K7b alone (the fill and one launch) at the edges of
    tests/pn_frac_cases.py, against its plain function run in float64 within
    K7B_REL_TOL (1e-5, chip_smoke.py) of the largest entry, two runs within
    the same bound (float atomics: the sums' order varies)."""
    case = pn_case(name, f)
    table = torch.from_numpy(case["table"]).to(dev)
    eidx, bounds = (torch.from_numpy(case[k]).to(dev) for k in ("entry_idx", "bounds"))
    n = torch.tensor(case["n"], dtype=torch.int32, device=dev)
    res, sample_cap = case["pn_res"], case["sample_cap"]
    g = torch.randn(res * res, f, generator=torch.Generator(device=dev).manual_seed(f),
                    device=dev)
    want = cops.pn_hist_backward_plain(table.double(), case["fine_offset"], eidx, bounds, n, res,
                                       sample_cap, g.double())
    tol = 1e-5 * max(float(want.abs().max()), 1e-30)
    for _ in range(2):
        kernels.reset_launches()
        got = cops._pn_hist_backward_cuda(table, case["fine_offset"], eidx, bounds, n, res,
                                          sample_cap, g)
        assert kernels.launches["pn_hist_bwd"] == 1 and sum(kernels.launches.values()) == 1
        torch.testing.assert_close(got.double(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("name", list(PN_CASES))
def test_pn_hist_part_kernel(dev, f, name):
    """K7p, a data-parallel rank's share of the plane, over W = 2, 3 and 8
    row chunks at the edges of tests/pn_frac_cases.py: each partial and its
    divisors equal to the twin's (integer counts), the partials summed and
    finished equal to K7's plane; one launch a share.  K7pb on each share
    within 1e-5 of the largest entry of the twin's gradient in float64 (the
    partial's gradient is per bin, no 1e6 divisor to cancel), one launch."""
    case = pn_case(name, f)
    table = torch.from_numpy(case["table"]).to(dev)
    eidx, bounds = (torch.from_numpy(case[k]).to(dev) for k in ("entry_idx", "bounds"))
    n = torch.tensor(case["n"], dtype=torch.int32, device=dev)
    res, cap, off = case["pn_res"], case["sample_cap"], case["fine_offset"]
    whole = cops.pn_frac_plane(table, off, eidx, bounds, n, res, cap)
    rows = cops.pn_row_count(eidx, cap)
    gen = torch.Generator(device=dev).manual_seed(f)
    for w in (2, 3, 8):
        chunk = -(-rows // w)
        total = None
        for r in range(w):
            leaf = table.clone().requires_grad_()
            kernels.reset_launches()
            part, den = cops.pn_hist_part(leaf, off, eidx, bounds, n, res, cap, r * chunk, chunk)
            assert kernels.launches["pn_hist_part"] == 1 and sum(kernels.launches.values()) == 1
            want, want_den = cops._pn_part_plain(table, off, eidx, bounds, n, cap, r * chunk,
                                                 chunk)
            assert torch.equal(part, want) and torch.equal(den, want_den), (w, r)
            total = part.detach() if total is None else total + part.detach()
            cot = torch.randn(part.shape, generator=gen, device=dev)
            part.backward(cot)
            assert kernels.launches["pn_hist_part_bwd"] == 1
            leaf64 = table.double().requires_grad_()
            cops._pn_part_plain(leaf64, off, eidx, bounds, n, cap, r * chunk,
                                chunk)[0].backward(cot.double())
            torch.testing.assert_close(leaf.grad.double(), leaf64.grad, rtol=0,
                                       atol=1e-5 * max(float(leaf64.grad.abs().max()), 1e-30))
        assert torch.equal(cops.pn_frac_finish(total, den, res), whole), w


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("name,mode", PART_MODES)
def test_pn_hist_part_at_the_walk_edges(dev, f, name, mode):
    """K7p and K7pb on tests/pn_part_cases.py's row ranges (a bin's edge and
    inside one bin, size 0, past the row space, an uneven W = 3 split), in
    each case's modes and on one bin of more rows than a warp's group: K7p
    torch.equal to `_pn_part_plain`, one launch; K7pb within 1e-5 of the
    largest entry of the twin's gradient in float64, one launch; at W = 2,
    3 and 8 every rank's partial summed and finished equal to K7's plane."""
    case = part_case(name, f)
    table = torch.from_numpy(case["table"]).to(dev)
    eidx, bounds = (torch.from_numpy(case[k]).to(dev) for k in ("entry_idx", "bounds"))
    n = torch.tensor(case["n"], dtype=torch.int32, device=dev)
    res, off = case["pn_res"], case["fine_offset"]
    cap = case["sample_cap"] if mode == "sampled" else None
    args = (off, eidx, bounds, n, res, cap)
    gen = torch.Generator(device=dev).manual_seed(f)
    for rname, (lo, size) in part_ranges(case["bounds"], case["n"], eidx.shape[0],
                                         cap).items():
        leaf = table.clone().requires_grad_()
        kernels.reset_launches()
        part, den = cops.pn_hist_part(leaf, *args, lo, size)
        assert kernels.launches["pn_hist_part"] == 1 and sum(kernels.launches.values()) == 1
        want, want_den = cops._pn_part_plain(table, off, eidx, bounds, n, cap, lo, size)
        assert torch.equal(part, want) and torch.equal(den, want_den), rname
        cot = torch.randn(part.shape, generator=gen, device=dev)
        part.backward(cot)
        assert kernels.launches["pn_hist_part_bwd"] == 1, rname
        leaf64 = table.double().requires_grad_()
        cops._pn_part_plain(leaf64, off, eidx, bounds, n, cap, lo, size)[0].backward(
            cot.double())
        torch.testing.assert_close(leaf.grad.double(), leaf64.grad, rtol=0,
                                   atol=1e-5 * max(float(leaf64.grad.abs().max()), 1e-30),
                                   msg=rname)
    whole = cops.pn_frac_plane(table, *args)
    rows = cops.pn_row_count(eidx, cap)
    for w in (2, 3, 8):
        chunk = -(-rows // w)
        parts = [cops._pn_part_cuda(table, *args, r * chunk, chunk) for r in range(w)]
        total = sum(p for p, _ in parts)
        assert torch.equal(cops.pn_frac_finish(total, parts[0][1], res), whole), w


def test_pn_hist_part_refuses_what_the_kernel_does_not_take(dev):
    case = pn_case("masked_tail", 4)
    table = torch.from_numpy(case["table"]).to(dev)
    eidx, bounds = (torch.from_numpy(case[k]).to(dev) for k in ("entry_idx", "bounds"))
    n = torch.tensor(case["n"], dtype=torch.int32, device=dev)
    args = (table, case["fine_offset"], eidx, bounds, n, case["pn_res"], case["sample_cap"])
    with pytest.raises(ValueError, match="row range"):
        cops.pn_hist_part(*args, -1, 10)
    with pytest.raises(ValueError, match="row range"):
        cops.pn_hist_part(*args, 0, 1 << 31)
    with pytest.raises(ValueError, match="pn_hist_part"):
        cops.pn_hist_part(table.double(), *args[1:], 0, 10)


def test_pn_walk_wrappers_refuse_what_the_kernels_do_not_take(dev):
    case = pn_case("masked_tail", 4)
    table = torch.from_numpy(case["table"]).to(dev)
    eidx, bounds = (torch.from_numpy(case[k]).to(dev) for k in ("entry_idx", "bounds"))
    n = torch.tensor(case["n"], dtype=torch.int32, device=dev)
    res, cap = case["pn_res"], case["sample_cap"]
    pn = {"entry_idx": eidx, "bounds": bounds, "n": n}
    sign = intctx.sign_table(table)
    odd = torch.empty(sign.numel() + 1, dtype=torch.int32, device=dev)[1:].view(sign.shape)
    odd.copy_(sign)                                             # rows 4 bytes off 16
    for bad, kw in ((sign.float(), {}), (odd, {}), (sign[:, :3].contiguous(), {"f": 3}),
                    (sign, {"bounds": bounds[:-1]}), (sign, {"n": n.long()})):
        with pytest.raises(ValueError):
            intctx.frac_plane(bad, {**pn, **{k: v for k, v in kw.items() if k != "f"}}, 37, res,
                              kw.get("f", 4))
    g = torch.zeros(res * res, 4, device=dev)
    odd_g = torch.empty(g.numel() + 1, device=dev)[1:].view(g.shape)
    odd_g.zero_()
    bwd = lambda t=table, b=bounds, gg=g: cops._pn_hist_backward_cuda(t, 37, eidx, b, n, res,
                                                                       cap, gg)
    for bad in (dict(gg=g.double()), dict(gg=odd_g), dict(gg=g[:-1].contiguous()),
                dict(gg=g[:, :2].contiguous()), dict(b=bounds[:-1]),
                dict(t=table[:, :3].contiguous(), gg=g[:, :3].contiguous())):
        with pytest.raises(ValueError):
            bwd(**bad)
    with pytest.raises(ValueError):
        cops._pn_hist_backward_cuda(table, 37, eidx, bounds, n, res, 0, g)   # sample_cap 0


def test_int_wrappers_reject_what_the_kernels_do_not_take(dev):
    args = _pool_on(_pool_case(3, 4, False, "random", seed=0), dev)
    with_ = lambda i, v: args[:i] + (v,) + args[i + 1:]
    with pytest.raises(ValueError, match="contiguous CUDA"):
        intctx.int_ctx_pool(*with_(7, args[7].cpu()))                     # mask on the CPU
    with pytest.raises(ValueError, match="int32"):
        intctx.int_ctx_pool(*with_(9, args[9].float()))
    with pytest.raises(ValueError, match="context levels"):
        intctx.int_ctx_pool(*with_(10, args[10] * 2))
    with pytest.raises(ValueError, match="widths"):
        intctx.int_ctx_pool(*with_(10, args[10][:2]))
    g = torch.Generator().manual_seed(0)
    levels, sign, mask = _int_levels(3, 4, g)
    packed = torch.zeros(10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="plain twin"):
        intctx.int_encode(packed, 3, 66, sign.to(dev), levels, mask.to(dev))
    with pytest.raises(ValueError, match="plain twin"):
        intctx.int_mlp_pool(args[0], None, torch.zeros(10, 12, dtype=torch.int32, device=dev),
                            131, 0, torch.ones(10, dtype=torch.bool, device=dev), packed, 4)
    with pytest.raises(ValueError, match="plain twin"):
        intctx.int_pq(torch.zeros(4, 4, dtype=torch.int32, device=dev),
                      torch.zeros(4, dtype=torch.int32, device=dev), 2048)
    with pytest.raises(ValueError, match="a row or more an entry"):
        intctx.int_ctx_pool_pq(*args[:5], args[2].shape[0] + 1, *args[6:13], 37, *args[13:])


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
    assert all(kernels.launches[k] > 0 for k in ("int_ctx_pool", "int_pq", "pn_hist_int"))
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


# ------------------------------- K1s/K2s: the encode masked by a summed-area table
SAT_GRIDS = ["random", "empty", "full", "edges_only"]


def _sat_inputs(dev, d, f, grid_kind, rb):
    """Four levels (R = 3, whose one interior corner's footprint is the
    whole grid; dense; hashed at 1024 and at 1000 entries), points on and
    outside the border, and an Rb^D occupancy grid: random, empty, full, or
    occupied only in its first and last cells along every axis (footprints
    clipped at 0 and Rb - 1 reach them)."""
    res = (3, 6, 40, 40) if d == 3 else (3, 20, 200, 200)
    sizes = (3 ** d, res[1] ** d, 1024, 1000)
    offsets = tuple(int(x) for x in np.cumsum((0,) + sizes))
    g = torch.Generator(device=dev).manual_seed(d * 100 + f * 10 + SAT_GRIDS.index(grid_kind))
    pts = torch.rand(5000, d, generator=g, device=dev)
    pts[:60] = torch.round(pts[:60])                  # corners on the border
    pts[60:120] = pts[60:120] * 1.6 - 0.3             # outside [0, 1]
    pts[120:200] = pts[120:200] * 0.02                # footprints clipped at 0
    pts[200:280] = 1.0 - pts[200:280] * 0.02          # and at Rb - 1
    table = torch.randn(offsets[-1], f, generator=g, device=dev)
    grid = {"random": lambda: torch.rand((rb,) * d, generator=g, device=dev) < 0.05,
            "empty": lambda: torch.zeros((rb,) * d, dtype=torch.bool, device=dev),
            "full": lambda: torch.ones((rb,) * d, dtype=torch.bool, device=dev)}.get(grid_kind)
    if grid is None:
        occ = torch.zeros((rb,) * d, dtype=torch.bool, device=dev)
        idx = torch.arange(rb, device=dev)
        edge = (idx == 0) | (idx == rb - 1)
        for ax in range(d):
            shape = [1] * d
            shape[ax] = rb
            occ |= edge.reshape(shape).expand((rb,) * d)
        occ = occ & (torch.rand((rb,) * d, generator=g, device=dev) < 0.5)
    else:
        occ = grid()
    return res, offsets, pts, table, occ, g


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("grid_kind", SAT_GRIDS)
def test_sat_masked_encode_kernels(dev, d, f, grid_kind):
    """K1s bit-equal to its twin; K2s within 1e-4 of the largest entry of the
    twin's autograd (float atomics); launches counted as K1s / K2s."""
    rb = 16 if d == 3 else 32
    res, offsets, pts, table, occ, g = _sat_inputs(dev, d, f, grid_kind, rb)
    sat = sat_ops.build_sat(occ)
    assert torch.equal(sat.cpu(), sat_ops.build_sat(occ.cpu()))
    before = dict(kernels.launches)
    got = enc._encode_cuda(pts, table, res, offsets, occ_sat=sat)
    assert kernels.launches["grid_encode_s"] == before["grid_encode_s"] + 1
    assert kernels.launches["grid_encode_v"] == before["grid_encode_v"]
    leaf = table.clone().requires_grad_()
    want = enc._encode_plain(pts, leaf, res, offsets, occ_sat=sat)
    assert torch.equal(got, want.detach())
    unmasked = enc._encode_plain(pts, table, res, offsets)
    if grid_kind == "empty":
        assert not bool(got.any())
    elif grid_kind == "full":
        assert torch.equal(got, unmasked)
    else:
        assert not torch.equal(got, unmasked) and bool(got.any())
    cot = torch.randn(got.shape, generator=g, device=dev)
    d_table = enc._encode_backward_cuda(pts, cot, table.shape[0], res, offsets, occ_sat=sat)
    assert kernels.launches["grid_encode_s_bwd"] == before["grid_encode_s_bwd"] + 1
    (want_d,) = torch.autograd.grad(want, leaf, cot)
    torch.testing.assert_close(d_table, want_d, rtol=0,
                               atol=1e-4 * max(float(want_d.abs().max()), 1e-6))


@pytest.mark.parametrize("d", [2, 3])
def test_sat_masked_public_entry_points(dev, d):
    """grid_encode(occ_binary=), the mixed-level and given-table encodes
    with a table, autograd through K2s, and occ_mask winning over the table
    (the K1v launch, not K1s)."""
    from cnc_torch.config import GridSpec
    rb = 128 if d == 3 else 64
    res, offsets, pts, table, occ, g = _sat_inputs(dev, d, 4, "random", rb)
    spec = GridSpec(num_dim=d, n_features=4, resolutions=(10, 18, 34, 66), log2_hashmap_size=10)
    tbl = torch.randn(spec.total_entries, 4, generator=g, device=dev)
    leaf = tbl.clone().requires_grad_()
    before = dict(kernels.launches)
    out = enc.grid_encode(pts, leaf, spec, occ_binary=occ)
    # against the plain path on the CPU (another device: within 1e-5) and
    # bit for bit against the twin on the card
    want = enc.grid_encode(pts.cpu(), tbl.cpu(), spec, occ_binary=occ.cpu())
    torch.testing.assert_close(out.detach().cpu(), want, atol=1e-5, rtol=0)
    assert torch.equal(out.detach(), enc._encode_plain(pts, tbl, spec.resolutions, spec.offsets,
                                                       occ_sat=sat_ops.build_sat(occ)))
    cot = torch.randn(out.shape, generator=g, device=dev)
    out.backward(cot)
    ref = tbl.cpu().clone().requires_grad_()
    enc.grid_encode(pts.cpu(), ref, spec, occ_binary=occ.cpu()).backward(cot.cpu())
    torch.testing.assert_close(leaf.grad.cpu(), ref.grad, rtol=0,
                               atol=1e-4 * float(ref.grad.abs().max()))
    assert kernels.launches["grid_encode_s"] == before["grid_encode_s"] + 1
    assert kernels.launches["grid_encode_s_bwd"] == before["grid_encode_s_bwd"] + 1
    sat = sat_ops.build_sat(occ)
    ids = torch.randint(-1, 4, (pts.shape[0],), generator=g, device=dev, dtype=torch.int32)
    got = enc.grid_encode_diff_levels(pts, tbl, spec, ids, 2, occ_sat=sat)
    want = enc._encode_plain(pts, tbl, spec.resolutions, spec.offsets, min_level_ids=ids,
                             n_levels_calc=2, occ_sat=sat)
    assert torch.equal(got, want)
    if d == 2:
        plane = torch.randn(34 * 34, 4, generator=g, device=dev)
        got = enc.grid_encode_given_table(pts, plane, 34, occ_sat=sat)
        want = enc._encode_plain(pts, plane, (34,), (0, 34 * 34), occ_sat=sat)
        assert torch.equal(got, want)
    mask = torch.rand(66 ** d, generator=g, device=dev) < 0.5
    n_v = kernels.launches["grid_encode_v"]
    n_s = kernels.launches["grid_encode_s"]
    got = enc.grid_encode(pts, tbl, spec, occ_sat=sat, occ_mask=mask, mask_offsets=[0] * 4,
                          occ_bits=enc.pack_mask_bits(mask))
    want = enc._encode_plain(pts, tbl, spec.resolutions, spec.offsets, occ_mask=mask,
                             mask_offsets=(0,) * 4)
    assert torch.equal(got, want)
    assert kernels.launches["grid_encode_v"] == n_v + 1
    assert kernels.launches["grid_encode_s"] == n_s


def test_sat_masked_encode_refusals(dev):
    pts = torch.rand(64, 3, device=dev)
    table = torch.zeros(1024, 4, device=dev)
    good = torch.zeros(17, 17, 17, dtype=torch.int32, device=dev)
    for bad in (good.long(), good[:, :, :16].contiguous(), torch.zeros(17, 17, dtype=torch.int32,
                                                                       device=dev),
                torch.zeros(1, 1, 1, dtype=torch.int32, device=dev), good.cpu()):
        with pytest.raises(ValueError):
            enc._encode_cuda(pts, table, (10,), (0, 1024), occ_sat=bad)
    mask = torch.ones(1000, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="one mask form"):
        enc._encode_cuda(pts, table, (10,), (0, 1024), occ_mask=mask, mask_offsets=(0,),
                         occ_bits=enc.pack_mask_bits(mask), occ_sat=good)


# K1s/K2s read sources that one launch makes from the table: the coarse
# levels' corner bits (R - 2 <= Rb) and the occupancy rows the fine levels'
# windows read (csrc/grid_encode.cu); tests/test_torch_sat_sources.py holds
# the same arithmetic to cnc_tpu on the CPU.
SAT_SPLIT_GRIDS = ["random", "empty", "full", "single"]


def _split_grid(dev, d, rb, kind, g):
    if kind == "random":
        return torch.rand((rb,) * d, generator=g, device=dev) < 0.03
    if kind == "single":
        occ = torch.zeros((rb,) * d, dtype=torch.bool, device=dev)
        occ[tuple(int(i) for i in torch.randint(0, rb, (d,), generator=g, device=dev))] = True
        return occ
    return torch.full((rb,) * d, kind == "full", dtype=torch.bool, device=dev)


def _split_spec(d):
    """The default grids' levels (grid_3d: 7 coarse, 5 fine at Rb = 128;
    grid_2d: 1 coarse, 3 fine) with the split's two sides (R - 2 = Rb and
    Rb + 1), F set by the caller."""
    res = ((18, 24, 33, 44, 59, 80, 108, 130, 131, 148, 201, 275, 376, 514) if d == 3
           else (18, 130, 131, 258, 514, 1026))
    return res


@pytest.mark.parametrize("kind", SAT_SPLIT_GRIDS + ["edges"])
@pytest.mark.parametrize("rb", [128, 40])
@pytest.mark.parametrize("d", [2, 3])
def test_sat_mask_sources_kernel(dev, d, rb, kind):
    """The sources kernel equal to its twin (the coarse words and the
    occupancy rows) in one launch, at Rb = 128 and at a ragged Rb = 40."""
    g = torch.Generator(device=dev).manual_seed(d * 1000 + rb + len(kind))
    occ = (_sat_inputs(dev, d, 2, "edges_only", rb)[4] if kind == "edges"
           else _split_grid(dev, d, rb, kind, g))
    sat = sat_ops.build_sat(occ)
    res = _split_spec(d)
    _, _, words, _ = enc._sat_layout(d, res, rb)
    before = kernels.launches["sat_mask_sources"]
    got = enc.sat_mask_sources(sat, res)
    assert kernels.launches["sat_mask_sources"] == before + 1
    want = enc._sat_sources_plain(sat, res)
    torch.cuda.synchronize()
    assert torch.equal(got.bits[:words], want.bits[:words])
    assert torch.equal(got.rows, want.rows)
    # a description with no fine level makes no rows
    assert enc.sat_mask_sources(sat, (10, 18)).rows is None


@pytest.mark.parametrize("kind", SAT_SPLIT_GRIDS)
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("d", [2, 3])
def test_sat_masked_encode_both_sides_of_the_split(dev, d, f, kind):
    """At Rb = 128 over levels on both sides of the coarse/fine split, with
    points on the cube's faces and corners and outside it: K1s bit-equal to
    its twin, K2s within 1e-4 of the largest entry of the twin's autograd,
    on sources made once; the mixed-level encode likewise."""
    rb = 128
    g = torch.Generator(device=dev).manual_seed(d * 100 + f * 10 + SAT_SPLIT_GRIDS.index(kind))
    res = _split_spec(d)
    spec = GridSpec(num_dim=d, n_features=f, resolutions=res, log2_hashmap_size=14)
    pts = torch.rand(6000, d, generator=g, device=dev)
    pts[:60] = torch.round(pts[:60])                       # the cube's corners
    pts[60:120, 0] = torch.round(pts[60:120, 0])           # its faces
    pts[120:180] = pts[120:180] * 1.6 - 0.3                # outside [0, 1]
    table = torch.randn(spec.total_entries, f, generator=g, device=dev)
    occ = _split_grid(dev, d, rb, kind, g)
    sat = sat_ops.build_sat(occ)
    src = enc.sat_mask_sources(sat, res)
    got = enc._encode_cuda(pts, table, res, spec.offsets, occ_sat=sat, sat_src=src)
    leaf = table.clone().requires_grad_()
    want = enc._encode_plain(pts, leaf, res, spec.offsets, occ_sat=sat)
    assert torch.equal(got, want.detach())
    unmasked = enc._encode_plain(pts, table, res, spec.offsets)
    if kind == "empty":
        assert not bool(got.any())
    elif kind == "full":
        assert torch.equal(got, unmasked)
    else:
        assert not torch.equal(got, unmasked) and bool(got.any())
    cot = torch.randn(got.shape, generator=g, device=dev)
    before = kernels.launches["sat_mask_sources"]
    d_table = enc._encode_backward_cuda(pts, cot, table.shape[0], res, spec.offsets,
                                        occ_sat=sat, sat_src=src)
    assert kernels.launches["sat_mask_sources"] == before      # the forward's sources
    (want_d,) = torch.autograd.grad(want, leaf, cot)
    torch.testing.assert_close(d_table, want_d, rtol=0,
                               atol=1e-4 * max(float(want_d.abs().max()), 1e-6))
    ids = torch.randint(-2, len(res), (pts.shape[0],), generator=g, device=dev,
                        dtype=torch.int32)
    got = enc._encode_cuda(pts, table, res, spec.offsets, min_level_ids=ids, n_levels_calc=3,
                           occ_sat=sat, sat_src=src)
    leaf = table.clone().requires_grad_()
    want = enc._encode_plain(pts, leaf, res, spec.offsets, min_level_ids=ids,
                             n_levels_calc=3, occ_sat=sat)
    assert torch.equal(got, want.detach())
    cot = torch.randn(got.shape, generator=g, device=dev)
    d_table = enc._encode_backward_cuda(pts, cot, table.shape[0], res, spec.offsets,
                                        min_level_ids=ids, n_levels_calc=3, occ_sat=sat,
                                        sat_src=src)
    (want_d,) = torch.autograd.grad(want, leaf, cot)
    torch.testing.assert_close(d_table, want_d, rtol=0,
                               atol=1e-4 * max(float(want_d.abs().max()), 1e-6))


@pytest.mark.parametrize("d", [2, 3])
def test_sat_masked_autograd_makes_sources_once(dev, d):
    """grid_encode(occ_binary=) forward and backward through autograd: one
    sources launch, one K1s, one K2s; the result equals the twin's."""
    rb = 128
    g = torch.Generator(device=dev).manual_seed(7 + d)
    spec = GridSpec(num_dim=d, n_features=4, resolutions=_split_spec(d), log2_hashmap_size=14)
    pts = torch.rand(4000, d, generator=g, device=dev)
    tbl = torch.randn(spec.total_entries, 4, generator=g, device=dev)
    occ = _split_grid(dev, d, rb, "random", g)
    before = dict(kernels.launches)
    leaf = tbl.clone().requires_grad_()
    out = enc.grid_encode(pts, leaf, spec, occ_binary=occ)
    cot = torch.randn(out.shape, generator=g, device=dev)
    out.backward(cot)
    made = {k: kernels.launches[k] - before[k] for k in
            ("sat_mask_sources", "grid_encode_s", "grid_encode_s_bwd")}
    assert made == {"sat_mask_sources": 1, "grid_encode_s": 1, "grid_encode_s_bwd": 1}
    sat = sat_ops.build_sat(occ)
    ref = tbl.clone().requires_grad_()
    want = enc._encode_plain(pts, ref, spec.resolutions, spec.offsets, occ_sat=sat)
    assert torch.equal(out.detach(), want.detach())
    want.backward(cot)
    torch.testing.assert_close(leaf.grad, ref.grad, rtol=0,
                               atol=1e-4 * float(ref.grad.abs().max()))


@pytest.mark.parametrize("d", [2, 3])
def test_sat_masked_unfit_level_goes_coarse(dev, d, monkeypatch):
    """A fine level (R - 2 > Rb) whose windows the layout declares unfit
    (`_windows_fit`) gets vertex bits from the sources kernel, equal to
    their twin, and no occupancy rows; K1s through the coarse path is
    bit-equal to the twin and K2s within 1e-4."""
    rb = 32
    g = torch.Generator(device=dev).manual_seed(40 + d)
    res = (12, 66)
    sizes = (12 ** d, 2048)
    offsets = tuple(int(x) for x in np.cumsum((0,) + sizes))
    fits = enc._windows_fit
    for cache in (enc._sat_layout, enc._sat_ctypes):
        monkeypatch.setattr(enc, cache.__name__, functools.lru_cache(cache.__wrapped__))
    monkeypatch.setattr(enc, "_windows_fit", lambda r, rb: r != 66 and fits(r, rb))
    assert enc._sat_layout(d, res, rb)[3] is False
    pts = torch.rand(3000, d, generator=g, device=dev)
    table = torch.randn(offsets[-1], 4, generator=g, device=dev)
    sat = sat_ops.build_sat(_split_grid(dev, d, rb, "random", g))
    src = enc.sat_mask_sources(sat, res)
    want_src = enc._sat_sources_plain(sat, res)
    assert src.rows is None and torch.equal(src.bits, want_src.bits)
    out = enc._encode_cuda(pts, table, res, offsets, occ_sat=sat, sat_src=src)
    want = enc._encode_plain(pts, table, res, offsets, occ_sat=sat)
    assert torch.equal(out, want)
    cot = torch.randn(out.shape, generator=g, device=dev)
    d_table = enc._encode_backward_cuda(pts, cot, table.shape[0], res, offsets, occ_sat=sat,
                                        sat_src=src)
    leaf = table.clone().requires_grad_()
    (want_d,) = torch.autograd.grad(enc._encode_plain(pts, leaf, res, offsets, occ_sat=sat),
                                    leaf, cot)
    torch.testing.assert_close(d_table, want_d, rtol=0,
                               atol=1e-4 * max(float(want_d.abs().max()), 1e-6))
