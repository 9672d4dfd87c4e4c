"""The walk that csrc/pn_hist.cu's three frac-plane kernels share (K7, K7i,
K7b), on the CPU, at the edges of tests/pn_frac_cases.py.

  * `run_walk` mirrors the kernels' tiles, runs, lanes and bin stepping in
    numpy: in the sampled and the unsampled mode it visits each valid row
    once, in the bin that `_pn_rows` and searchsorted give.
  * K7i's twin (`intctx.int_frac_plane`, which `intctx.frac_plane` takes on
    the CPU) equals cnc_tpu's `int_frac_plane` exactly, and so does the
    integer plane counted over the walk's visits with the raw bin lengths.
  * K7b's plain function in its kernel's own arguments
    (`context_ops.pn_hist_backward_plain`) equals the gradient built from
    the walk's visits and `bin_scale`, the autograd twin run in float64, and
    jax.grad of cnc_tpu's `pn_frac_plane` within 1e-5 of its largest entry
    (for a cotangent that is 0 at the empty bins, where cnc_tpu's float32
    sums cancel 1e6-scaled terms).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.codec import intctx as jint
from cnc_tpu.models import context_models as jcm
from cnc_torch.codec import intctx as tint
from cnc_torch.ops import context_ops as cops
from pn_frac_cases import CASES, bin_scale, pn_case, run_walk, walk_map

SAMPLED = [k for k, (_, cap, _, sample_cap, _) in CASES.items()
           if sample_cap is not None and sample_cap < cap]
MODES = [(name, "unsampled") for name in CASES] + [(name, "sampled") for name in SAMPLED]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops in several worker processes on a few cores: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_ax(case):
    return {"entry_idx": torch.from_numpy(case["entry_idx"]),
            "bounds": torch.from_numpy(case["bounds"]),
            "n": torch.tensor(case["n"], dtype=torch.int32)}


def _jax_ax(case):
    return {"entry_idx": jnp.asarray(case["entry_idx"]), "bounds": jnp.asarray(case["bounds"]),
            "n": jnp.asarray(case["n"], dtype=jnp.int32)}


@pytest.mark.parametrize("name,mode", MODES)
def test_walk_visits_each_valid_row_once(name, mode):
    case = pn_case(name, 2)
    sample_cap = case["sample_cap"] if mode == "sampled" else None
    cap = case["entry_idx"].shape[0]
    ax = _torch_ax(case)
    sel, row_valid, bnd = cops._pn_rows(ax["entry_idx"], ax["bounds"], ax["n"], sample_cap)
    bins = bnd.shape[0] - 1
    j = torch.arange(sel.shape[0], dtype=torch.int32)
    bin_of = (torch.searchsorted(bnd, j, right=True).long() - 1).numpy()
    want = row_valid.numpy() & (bin_of >= 0) & (bin_of < bins)
    bmap, _ = walk_map(case["bounds"], case["n"], cap, sample_cap)
    np.testing.assert_array_equal(bmap, bnd.numpy())
    rows, row_bins = run_walk(case["bounds"], case["n"], cap, sample_cap, case["pn_res"])
    assert np.unique(rows).size == rows.size, "a row visited twice"
    order = np.argsort(rows)
    np.testing.assert_array_equal(rows[order], np.flatnonzero(want))
    np.testing.assert_array_equal(row_bins[order], bin_of[want])


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_int_frac_plane_matches_cnc_tpu(name, f):
    """K7i's twin (full coverage: sample_cap is not read) against cnc_tpu's,
    exactly, through the dispatching `frac_plane` too."""
    case = pn_case(name, f)
    sign = tint.sign_table(torch.from_numpy(case["table"]))
    want = np.asarray(jint.int_frac_plane(jint.sign_table(jnp.asarray(case["table"])),
                                          _jax_ax(case), case["fine_offset"], case["pn_res"], f))
    got = tint.int_frac_plane(sign, _torch_ax(case), case["fine_offset"], case["pn_res"], f)
    assert got.dtype == torch.int32 and got.shape == want.shape == (case["pn_res"] ** 2, f)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tint.frac_plane(sign, _torch_ax(case), case["fine_offset"],
                                       case["pn_res"], f), got)


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_walk_int_plane_equals_twin(name, f):
    """The integer plane K7i makes from the walk: each visited row's
    positive signs counted in its bin, pos * 256 // max(raw length, 1), the
    zero border, x fastest; equal to the twin."""
    case = pn_case(name, f)
    pn_res, scale = case["pn_res"], case["pn_res"] - 2
    cap = case["entry_idx"].shape[0]
    sign = tint.sign_table(torch.from_numpy(case["table"]))
    rows, bins = run_walk(case["bounds"], case["n"], cap, None, pn_res)
    pos = np.zeros((scale * scale, f), np.int64)
    entry = case["fine_offset"] + case["entry_idx"][rows].astype(np.int64)
    np.add.at(pos, bins, (sign.numpy()[np.clip(entry, 0, sign.shape[0] - 1)] > 0))
    raw = case["bounds"].astype(np.int64)
    frac = pos * 256 // np.maximum(raw[1:] - raw[:-1], 1)[:, None]
    plane = np.zeros((pn_res, pn_res, f), np.int64)
    b = np.arange(scale * scale)
    plane[b % scale + 1, b // scale + 1] = frac          # [y, x]: x fastest when flattened
    want = tint.int_frac_plane(sign, _torch_ax(case), case["fine_offset"], pn_res, f)
    np.testing.assert_array_equal(plane.reshape(-1, f), want.numpy())


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_backward_plain_matches_walk_and_jax_grad(name, f):
    """K7b's plain function: against the gradient the walk's visits give
    with `bin_scale` (each visited row whose value is > 0.9 adds its bin's
    scale; summed in float64, so within 1e-6 of the largest entry); against
    the autograd twin run in float64 within 1e-5 of its largest entry; and
    against jax.grad of cnc_tpu's plane within 1e-5 of its largest entry,
    as tests/test_torch_pn_frac.py holds the autograd twin, for the
    cotangent with the empty bins' rows set to 0.  (cnc_tpu's gradient
    differences reverse cumulative sums over all rows in float32, where an
    empty bin's gradient, divided by its 0 + 1e-6 rows, is 1e6 times the
    plane's and cancels: with the full cotangent that leaves errors up to
    the size of the result, which the autograd twin shares in float32 and
    not in float64.)"""
    case = pn_case(name, f)
    pn_res, sample_cap = case["pn_res"], case["sample_cap"]
    cap, table = case["entry_idx"].shape[0], case["table"]
    cot = np.random.default_rng([f, 7]).standard_normal((pn_res * pn_res, f)).astype(np.float32)
    ax = _torch_ax(case)
    got = cops.pn_hist_backward_plain(torch.from_numpy(table), case["fine_offset"],
                                      ax["entry_idx"], ax["bounds"], ax["n"], pn_res,
                                      sample_cap, torch.from_numpy(cot))
    assert got.dtype == torch.float32 and got.shape == table.shape
    got = got.numpy()

    bmap, _ = walk_map(case["bounds"], case["n"], cap, sample_cap)
    rows, bins = run_walk(case["bounds"], case["n"], cap, sample_cap, pn_res)
    if sample_cap is not None and sample_cap < cap:
        m = min(case["n"], cap)
        stride = np.float32(m) / np.float32(max(min(m, sample_cap), 1))
        src = np.minimum(np.floor(rows.astype(np.float32) * stride).astype(np.int64),
                         max(m - 1, 0))
        entries = case["entry_idx"][np.minimum(src, cap - 1)]
    else:
        entries = case["entry_idx"][rows]
    entry_rows = case["fine_offset"] + entries.astype(np.int64)
    add = np.where(table[entry_rows] > 0.9, bin_scale(cot, bmap, pn_res)[bins], 0.0)
    mirror = np.zeros(table.shape, np.float64)
    np.add.at(mirror, entry_rows, add)
    np.testing.assert_allclose(got, mirror, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(mirror).max())))

    leaf64 = torch.from_numpy(table).double().requires_grad_()
    cops._pn_frac_plane_plain(leaf64, case["fine_offset"], ax["entry_idx"], ax["bounds"],
                              ax["n"], pn_res, sample_cap).backward(torch.from_numpy(cot).double())
    want64 = leaf64.grad.numpy()
    np.testing.assert_allclose(got, want64, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want64).max())))

    scale = pn_res - 2
    b = np.arange(scale * scale)
    filled = (b % scale + 1) * pn_res + b // scale + 1
    cot_filled = np.zeros_like(cot)
    keep = filled[bmap[1:] > bmap[:-1]]
    cot_filled[keep] = cot[keep]
    got = cops.pn_hist_backward_plain(torch.from_numpy(table), case["fine_offset"],
                                      ax["entry_idx"], ax["bounds"], ax["n"], pn_res,
                                      sample_cap, torch.from_numpy(cot_filled)).numpy()
    model = types.SimpleNamespace(pn_res=pn_res, fine_offset=case["fine_offset"],
                                  cfg=types.SimpleNamespace(n_features=f))
    jg = np.asarray(jax.grad(lambda t: jnp.sum(jcm.ContextModels.pn_frac_plane(
        model, t, _jax_ax(case), sample_cap=sample_cap) * cot_filled))(jnp.asarray(table)))
    np.testing.assert_allclose(got, jg, rtol=0, atol=1e-5 * max(1.0, float(np.abs(jg).max())))
