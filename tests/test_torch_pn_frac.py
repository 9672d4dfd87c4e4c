"""The frac plane (K7) of cnc_torch at the edges of its index math.

The kernel (csrc/pn_hist.cu) never materialises the stride-sampled rows: it
finds each bin boundary's sampled position from the estimate
boundary / stride, stepped while src(j) = floor(j * stride) of a neighbour
decides.  `sampled_map` (tests/pn_frac_cases.py) follows that step for step
in float32; here it must equal torch.searchsorted
over the materialised src, as the twin forms it, at the edges of the
sampling (nothing listed, one row, fewer rows than the sample, a full and an
overflowed list, a sample that does not divide the list) and at the flagship's
sizes.  At the same edges the port's plain plane must equal cnc_tpu's
pn_frac_plane, and its gradient jax.grad's.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnc_tpu.models import context_models as jcm
from cnc_torch.models import context_models as tcm
from cnc_torch.ops import context_ops as cops
from pn_frac_cases import CASES, pn_case, sampled_map


def _model(case, f):
    """What pn_frac_plane reads of its model, for both packages."""
    return types.SimpleNamespace(pn_res=case["pn_res"], fine_offset=case["fine_offset"],
                                 cfg=types.SimpleNamespace(n_features=f))


def _torch_ax(case):
    return {"entry_idx": torch.from_numpy(case["entry_idx"]),
            "bounds": torch.from_numpy(case["bounds"]),
            "n": torch.tensor(case["n"], dtype=torch.int32)}


SAMPLED = [k for k, (_, cap, _, sample_cap, _) in CASES.items()
           if sample_cap is not None and sample_cap < cap]


@pytest.mark.parametrize("name", SAMPLED)
def test_sampled_map_equals_searchsorted(name):
    case = pn_case(name, 2)
    cap, sample_cap = case["entry_idx"].shape[0], case["sample_cap"]
    ax = _torch_ax(case)
    _, _, bmap = cops._pn_rows(ax["entry_idx"], ax["bounds"], ax["n"], sample_cap)
    got = sampled_map(case["bounds"], case["n"], cap, sample_cap)
    np.testing.assert_array_equal(got, bmap.numpy())


@pytest.mark.parametrize("n", [0, 1, (1 << 21) - 1, 1 << 21, (1 << 21) + 1, 5_000_011,
                               11_352_091, 1 << 24, (1 << 24) + 5])
def test_sampled_map_at_the_flagship_sizes(n):
    """pn_coords_cap 2^24, pn_frac_sample_cap 2^21 (the rate step's), with
    boundaries at random, at the list's ends and at the sample's steps."""
    cap, sample_cap = 1 << 24, 1 << 21
    m = min(n, cap)
    rng = np.random.default_rng(n % 1000)
    v = np.concatenate([rng.integers(0, m + 1, size=20_000), [0, 1, m, max(m - 1, 0), cap]])
    take = min(m, sample_cap)
    stride = np.float32(m) / np.float32(max(take, 1))
    j = rng.integers(0, max(take, 1), size=2000)
    steps = np.floor(j.astype(np.float32) * stride).astype(np.int64)
    bounds = np.sort(np.clip(np.concatenate([v, steps, steps + 1]), 0, cap)).astype(np.int32)
    _, _, bmap = cops._pn_rows(torch.zeros(cap, dtype=torch.int32), torch.from_numpy(bounds),
                               torch.tensor(n, dtype=torch.int32), sample_cap)
    np.testing.assert_array_equal(sampled_map(bounds, n, cap, sample_cap), bmap.numpy())


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_frac_plane_matches_cnc_tpu(name, f):
    """The port's plain plane (and the model method that dispatches to it)
    against cnc_tpu's at atol 1e-6; the table's gradient against jax.grad
    within 1e-5 of its largest entry (both difference reverse cumulative sums
    over every row in float32, each in its own order), as
    tests/test_torch_context_rate.py holds it."""
    case = pn_case(name, f)
    model, sample_cap = _model(case, f), case["sample_cap"]
    jax_ax = {"entry_idx": jnp.asarray(case["entry_idx"]), "bounds": jnp.asarray(case["bounds"]),
              "n": jnp.asarray(case["n"], dtype=jnp.int32)}
    want = np.asarray(jcm.ContextModels.pn_frac_plane(model, jnp.asarray(case["table"]), jax_ax,
                                                      sample_cap=sample_cap))
    ax = _torch_ax(case)
    leaf = torch.from_numpy(case["table"]).requires_grad_()
    got = cops._pn_frac_plane_plain(leaf, case["fine_offset"], ax["entry_idx"], ax["bounds"],
                                    ax["n"], case["pn_res"], sample_cap)
    assert got.shape == want.shape == (case["pn_res"] ** 2, f)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    by_model = tcm.ContextModels.pn_frac_plane(model, leaf.detach(), ax, sample_cap=sample_cap)
    assert torch.equal(by_model, got.detach())
    cot = np.random.default_rng(f).standard_normal(want.shape).astype(np.float32)
    jg = np.asarray(jax.grad(lambda t: jnp.sum(jcm.ContextModels.pn_frac_plane(
        model, t, jax_ax, sample_cap=sample_cap) * cot))(jnp.asarray(case["table"])))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), jg, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(jg).max())))
