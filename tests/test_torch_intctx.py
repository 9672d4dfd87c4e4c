"""cnc_torch's integer codec context (codec/intctx.py) against cnc_tpu's.

Every function is integer arithmetic and must equal cnc_tpu's exactly: the
lattice interp with negative numerators, the encodes on an occupancy grid
and tables that differ along every axis, the fixed-point MLPs with weights at
+-W_MAX and inputs at +-H_CLIP (where the LeakyReLU's product wraps in int32),
the pooling, the overlap weights, the frac plane, and the coder
probabilities with saturated and zero rows.  The inputs come from numpy
seeds and go to both packages as the same arrays.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.codec import intctx as jint
from cnc_torch.codec import intctx as tint

from test_torch_context_tables import asymmetric_occupancy, make_pair, random_sign_tables


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores: many small
    integer ops spread over every core's thread only contend, so this
    module's ops run on one thread (restored after it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jctx, tctx = make_pair()
    b = asymmetric_occupancy()
    return dict(jctx=jctx, tctx=tctx, b=b, jc=jctx.refresh_cache_int(jnp.asarray(b)),
                tc=tctx.refresh_cache_int(torch.from_numpy(b)),
                tabs={k: v.astype(np.int32) for k, v in random_sign_tables(tctx).items()})


def test_constants_equal():
    for name in ("FORMAT_VERSION", "Q_AXIS", "Q_FEAT", "Q_W", "H_CLIP", "M_SHIFT", "M_SCALE",
                 "M_CLIP", "W_MAX", "OVL_BITS"):
        assert getattr(tint, name) == getattr(jint, name), name
    assert tint.FORMAT_VERSION == 3


def test_floor_division_matches_jax():
    """torch's `//` floors negative int32 numerators as JAX's does."""
    a = np.arange(-5000, 5000, 7, dtype=np.int32)
    for b in (1, 2, 7, 64, 512, 4096):
        np.testing.assert_array_equal((torch.from_numpy(a) // b).numpy(),
                                      np.asarray(jnp.asarray(a) // b))
        assert (torch.from_numpy(a) // b).dtype == torch.int32


@pytest.mark.parametrize("rf,rc", [(10, 18), (18, 10), (34, 66), (66, 34), (130, 514),
                                   (258, 514), (1026, 514), (514, 1026), (514, 34)])
def test_axis_interp_matches(rf, rc):
    """Every coord of the rf-lattice; coarse->fine targets give negative
    numerators at c = 0."""
    c = np.arange(rf, dtype=np.int32)
    jp, jq = jint._axis_interp(jnp.asarray(c), rf, rc)
    tp, tq = tint._axis_interp(torch.from_numpy(c), rf, rc)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    if rc > rf:
        assert tp[0] < 0      # the negative numerator floors below zero


def _coords(rng, n, d, rf):
    c = rng.integers(0, rf, (n, d)).astype(np.int32)
    c[: n // 8] = 0                                  # oob rows, negative numerators
    c[n // 8: n // 4, 0] = rf - 1
    return c


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_int_encode_levels_matches(pair, kind):
    jctx, tctx = pair["jctx"], pair["tctx"]
    rng = np.random.default_rng(11)
    if kind == "3d":
        spec, moffs, mask_j, mask_t = tctx.spec3, tctx.mask3d_offsets, pair["jc"]["mask3d"], \
            pair["tc"]["mask3d"]
        tbl, level, d = pair["tabs"]["xyz"], 3, 3
        levels = tctx._ctx_levels_meta(spec, moffs, 1, 3)
    else:
        spec, moffs, mask_j, mask_t = tctx.spec2, tctx.mask2d_offsets, pair["jc"]["mask2d"][1], \
            pair["tc"]["mask2d"][1]
        tbl, level, d = pair["tabs"]["xz"], 1, 2
        levels = tctx._ctx_levels_meta(spec, moffs, 0, 1)
    assert levels == jctx._ctx_levels_meta(jctx.spec3 if d == 3 else jctx.spec2, moffs,
                                           *((1, 3) if d == 3 else (0, 1)))
    rf = spec.resolutions[level]
    c = _coords(rng, 3000, d, rf)
    want = np.asarray(jint.int_encode_levels(jnp.asarray(c), rf, jnp.asarray(tbl), levels,
                                             mask_j))
    got = tint.int_encode_levels(torch.from_numpy(c), rf, torch.from_numpy(tbl), levels, mask_t)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any() and (want > 0).any()
    # the packed form the wrapper takes decodes to the same coords
    packed = ((c[:, 0] * rf + c[:, 1]) * rf + c[:, 2]) if d == 3 else (c[:, 0] << 16) | c[:, 1]
    np.testing.assert_array_equal(tint.unpack_coords(torch.from_numpy(packed.astype(np.int32)),
                                                     d, rf).numpy(), c)
    np.testing.assert_array_equal(
        tint.int_encode(torch.from_numpy(packed.astype(np.int32)), d, rf, torch.from_numpy(tbl),
                        levels, mask_t).numpy(), want)


def test_int_encode_plane_matches(pair):
    tctx = pair["tctx"]
    rng = np.random.default_rng(12)
    r = tctx.pn_res
    plane = rng.integers(0, 257, (r * r, 2)).astype(np.int32)
    plane[: r * r // 2] += np.arange(r * r // 2, dtype=np.int32)[:, None] % 7   # asymmetric
    rf = tctx.spec2.resolutions[1]
    c = _coords(rng, 3000, 2, rf)
    mj, mt = pair["jc"]["mask2d"][2], pair["tc"]["mask2d"][2]
    want = np.asarray(jint.int_encode_plane(jnp.asarray(c), rf, jnp.asarray(plane), r, mj,
                                            tctx.pn_mask_offset))
    got = tint.int_encode_plane(torch.from_numpy(c), rf, torch.from_numpy(plane), r, mt,
                                tctx.pn_mask_offset)
    np.testing.assert_array_equal(got.numpy(), want)
    transposed = plane.reshape(r, r, 2).transpose(1, 0, 2).reshape(-1, 2)
    assert not np.array_equal(tint.int_encode_plane(
        torch.from_numpy(c), rf, torch.from_numpy(np.ascontiguousarray(transposed)), r, mt,
        tctx.pn_mask_offset).numpy(), want)


# the largest float32 that quantize_ctx_params takes (float32(7.9) lies above 7.9)
W_TOP = float(np.nextafter(np.float32(jint.W_MAX), np.float32(0)))


def _quantized_params(rng, extreme, n2_in=5):
    """Float context params in cnc_tpu's layout; `extreme`: |w| at W_MAX."""
    def lin(i, o):
        if extreme:
            w = np.where(rng.random((i, o)) > 0.5, 1, -1) * W_TOP
            b = np.where(rng.random(o) > 0.5, 1, -1) * W_TOP
        else:
            w, b = rng.uniform(-1, 1, (i, o)), rng.uniform(-1, 1, o)
        return {"w": w.astype(np.float32), "b": b.astype(np.float32)}

    return {"ctx3d": {"l0": lin(5, 32), "l1": lin(32, 32), "l2": lin(32, 2)},
            "ctx2d": {"1": lin(n2_in, 2)}}


@pytest.mark.parametrize("extreme", [False, True], ids=["trained", "w_max"])
def test_int_mlps_match(extreme):
    """The fixed-point MLPs, at ordinary weights and at +-W_MAX with inputs
    at +-H_CLIP, where x*41 in the hidden LeakyReLU leaves int32."""
    rng = np.random.default_rng(13 + extreme)
    fp = _quantized_params(rng, extreme)
    qj, qt = jint.quantize_ctx_params(fp), tint.quantize_ctx_params(fp)
    jax.tree.map(np.testing.assert_array_equal, qj, qt)
    lim = jint.H_CLIP if extreme else jint.Q_FEAT
    x = rng.integers(-lim, lim + 1, (4000, 5)).astype(np.int32)
    x[:4] = [[lim] * 5, [-lim] * 5, [0] * 5, [lim, -lim, lim, -lim, lim]]
    ip_t = jax.tree.map(torch.from_numpy, qt)
    ip_j = jax.tree.map(jnp.asarray, qj)
    want3 = np.asarray(jint.int_apply_ctx3d(ip_j["ctx3d"], jnp.asarray(x)))
    got3 = tint.int_apply_ctx3d(ip_t["ctx3d"], torch.from_numpy(x))
    np.testing.assert_array_equal(got3.numpy(), want3)
    want2 = np.asarray(jint.int_apply_ctx2d(ip_j["ctx2d"], 1, jnp.asarray(x)))
    np.testing.assert_array_equal(tint.int_apply_ctx2d(ip_t["ctx2d"], 1, torch.from_numpy(x)
                                                       ).numpy(), want2)
    if extreme:
        h = tint._int_matmul(torch.from_numpy(x), ip_t["ctx3d"]["l0"]["w"]) + \
            ip_t["ctx3d"]["l0"]["b"]
        h = torch.clamp(tint._int_leaky(h) // jint.Q_W, -jint.H_CLIP, jint.H_CLIP)
        h1 = tint._int_matmul(h, ip_t["ctx3d"]["l1"]["w"]) + ip_t["ctx3d"]["l1"]["b"]
        assert int(h1.min()) < -(2 ** 31) // 41      # the wrap is exercised


def test_leaky_wraps_as_xla():
    x = np.array([-(2 ** 31) // 41 - 1, -(2 ** 30), -600_000_000, -1, 0, 5, -4096, -4097,
                  2 ** 30], np.int32)
    np.testing.assert_array_equal(tint._int_leaky(torch.from_numpy(x)).numpy(),
                                  np.asarray(jint._int_leaky(jnp.asarray(x))))


def test_quantize_ctx_params_raises_above_w_max():
    rng = np.random.default_rng(0)
    fp = _quantized_params(rng, False)
    fp["ctx3d"]["l1"]["w"][3, 4] = 7.95
    for mod in (tint, jint):
        with pytest.raises(ValueError, match="exceeds"):
            mod.quantize_ctx_params(fp)
    fp["ctx3d"]["l1"]["w"][3, 4] = -W_TOP           # the bound itself quantizes
    jax.tree.map(np.testing.assert_array_equal, tint.quantize_ctx_params(fp),
                 jint.quantize_ctx_params(fp))


def test_quantize_pg_and_sign_table():
    for pg in (0.0, 0.5, 1.0, 1 / 3, 0.12345678, 0.5 / 256, 1.5 / 256, 2.5 / 256):
        assert tint.quantize_pg(pg) == jint.quantize_pg(pg)
    t = np.array([[1.0, -1.0], [0.0, 2.5], [-0.0, 1e-30]], np.float32)
    np.testing.assert_array_equal(tint.sign_table(torch.from_numpy(t)).numpy(),
                                  np.asarray(jint.sign_table(jnp.asarray(t))))


@pytest.mark.parametrize("rank", [1, 2])
def test_segment_sum_int_matches(rank):
    rng = np.random.default_rng(rank)
    n, s = 5000, 301
    x = rng.integers(-(1 << 20), 1 << 20, (n, 4) if rank == 2 else n).astype(np.int32)
    seg = np.sort(rng.integers(0, s, n)).astype(np.int32)
    valid = rng.random(n) < 0.6
    want = np.asarray(jint.segment_sum_int(jnp.asarray(x), jnp.asarray(seg), jnp.asarray(valid),
                                           s))
    got = tint.segment_sum_int(torch.from_numpy(x), torch.from_numpy(seg),
                               torch.from_numpy(valid), s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m_scale", [1, 37, 2048])
def test_device_pq_matches_host_and_cnc_tpu(m_scale):
    """The twin (cnc_tpu's long division) and the int64 yardstick equal
    host_pq and cnc_tpu's device_pq over the full operand range, with zero
    and negative sums, zero weights, exact saturation and the row below it."""
    rng = np.random.default_rng(7)
    n = 1 << 14
    wmax = (1 << 27) // m_scale
    msum = rng.integers(-(1 << 30), 1 << 30, (n, 2), dtype=np.int32)
    wsum = rng.integers(0, wmax, (n,), dtype=np.int32)
    msum[0] = 0
    msum[1] = -1
    wsum[2] = 0
    msum[3] = int(wsum[3]) * m_scale
    msum[4] = int(wsum[4]) * m_scale - 1
    want = jint.host_pq(msum, wsum, m_scale)
    np.testing.assert_array_equal(tint.host_pq(msum, wsum, m_scale), want)
    np.testing.assert_array_equal(
        np.asarray(jint.device_pq(jnp.asarray(msum), jnp.asarray(wsum), m_scale)), want)
    got = tint.device_pq(torch.from_numpy(msum), torch.from_numpy(wsum), m_scale)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tint.pq_int64(torch.from_numpy(msum), torch.from_numpy(wsum), m_scale).numpy(), want)
    assert want[3].tolist() == [65535, 65535] and want[0].tolist() == [1, 1]
    pq, cov, bits = tint.int_pq(torch.from_numpy(msum), torch.from_numpy(wsum), m_scale)
    np.testing.assert_array_equal(pq.numpy(), want)
    np.testing.assert_array_equal(cov.numpy(), wsum > 0)
    assert bits is None


def test_int_pq_sign_bits():
    rng = np.random.default_rng(8)
    sign = np.where(rng.random((300, 2)) > 0.5, 1, -1).astype(np.int32)
    evals = rng.integers(0, 200, 50).astype(np.int32)
    _, _, bits = tint.int_pq(torch.zeros(50, 2, dtype=torch.int32),
                             torch.zeros(50, dtype=torch.int32), 2048, torch.from_numpy(sign), 100,
                             torch.from_numpy(evals))
    np.testing.assert_array_equal(bits.numpy(), (sign[100 + evals] > 0).astype(np.uint8))


@pytest.mark.parametrize("r", [10, 18, 34, 66, 130])
def test_int_overlap_grid_matches(r):
    b = asymmetric_occupancy(seed=r)
    want = np.asarray(jint.int_overlap_grid(jnp.asarray(b), r, 16))
    got = tint.int_overlap_grid(torch.from_numpy(b), r, 16)
    assert got.dtype == torch.int32 and got.shape == (r ** 3,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() < 2 ** jint.OVL_BITS
    # the weights are shifted to OVL_BITS by a conservative bound: a +-1-cell
    # footprint under half a cell wide rounds to 0 (finer levels, K9b then
    # weighs every masked row 1)
    assert (want.max() > 0) == (r <= 34)


def test_int_frac_plane_matches(pair):
    tctx = pair["tctx"]
    sign3 = pair["tabs"]["xyz"]
    for ax in ("xy", "xz", "yz"):
        want = np.asarray(jint.int_frac_plane(jnp.asarray(sign3), pair["jc"]["pn"][ax],
                                              tctx.fine_offset, tctx.pn_res, 2))
        got = tint.frac_plane(torch.from_numpy(sign3), pair["tc"]["pn"][ax], tctx.fine_offset,
                              tctx.pn_res, 2)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.max() > 0


def test_int_frac_plane_cut_by_the_listed_count(pair):
    """Rows past the listed count n are not valid, and a count past the cap
    takes every row."""
    tctx = pair["tctx"]
    sign3 = pair["tabs"]["xyz"]
    for n in (0, 17, 1 << 30):
        pn_t = dict(pair["tc"]["pn"]["xy"], n=torch.tensor(n, dtype=torch.int32))
        pn_j = dict(pair["jc"]["pn"]["xy"], n=jnp.int32(n))
        np.testing.assert_array_equal(
            tint.int_frac_plane(torch.from_numpy(sign3), pn_t, tctx.fine_offset, tctx.pn_res,
                                2).numpy(),
            np.asarray(jint.int_frac_plane(jnp.asarray(sign3), pn_j, tctx.fine_offset,
                                           tctx.pn_res, 2)))
