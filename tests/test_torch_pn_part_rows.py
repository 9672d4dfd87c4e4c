"""K7p and K7pb (csrc/pn_hist.cu), a data-parallel rank's share of a frac
plane, on the CPU: their walk, mirrored by `pn_frac_cases.run_walk` with
the map clamped to the rank's rows, held to the plain twins at the edges of
tests/pn_part_cases.py, on one bin that holds more rows than a warp's group
and on a plane whose rows leave most runs empty.

  * The row-to-bin rule: the kernels' map (the sampled map from bounds in
    the sampled mode) equals `context_ops._pn_rows`' boundaries, and a row
    of the range [lo, hi) lies in bin b of the map clamped to the range
    exactly when it does in the map, which is what lets a warp walk a run's
    clamped map.
  * The walk over row ranges on a bin's edge and inside one bin, of size 0,
    past the row space and split unevenly over W = 3: each row of the range
    visited once, in its bin; the counts of the visits and the divisors
    equal to `_pn_part_plain`'s; K7pb's adds over the same visits equal to
    autograd through the twin in float64.
"""

import numpy as np
import pytest
import torch

from cnc_torch.ops import context_ops as cops
from pn_frac_cases import run_walk, walk_map
from pn_part_cases import PART_MODES, part_case, part_ranges


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops in several worker processes on a few cores: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name, mode, f):
    case = part_case(name, f)
    sample_cap = case["sample_cap"] if mode == "sampled" else None
    t = dict(table=torch.from_numpy(case["table"]), entry_idx=torch.from_numpy(case["entry_idx"]),
             bounds=torch.from_numpy(case["bounds"]),
             n=torch.tensor(case["n"], dtype=torch.int32))
    return case, sample_cap, t


@pytest.mark.parametrize("name,mode", PART_MODES)
def test_row_bin_rule_matches_the_map(name, mode):
    case, sample_cap, t = _inputs(name, mode, 2)
    cap = case["entry_idx"].shape[0]
    _, _, bnd = cops._pn_rows(t["entry_idx"], t["bounds"], t["n"], sample_cap)
    bmap = bnd.numpy().astype(np.int64)
    kmap, take = walk_map(case["bounds"], case["n"], cap, sample_cap)
    np.testing.assert_array_equal(kmap, bmap)
    for rname, (lo, size) in part_ranges(case["bounds"], case["n"], cap, sample_cap).items():
        j = np.arange(lo, max(min(lo + size, take), lo))
        cut = np.minimum(np.maximum(bmap, lo), lo + size)
        np.testing.assert_array_equal(np.searchsorted(cut, j, side="right"),
                                      np.searchsorted(bmap, j, side="right"), err_msg=rname)


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("name,mode", PART_MODES)
def test_part_walk_matches_the_twin(name, mode, f):
    case, sample_cap, t = _inputs(name, mode, f)
    cap = case["entry_idx"].shape[0]
    sel, _, _ = cops._pn_rows(t["entry_idx"], t["bounds"], t["n"], sample_cap)
    sel = sel.numpy().astype(np.int64)
    bmap, take = walk_map(case["bounds"], case["n"], cap, sample_cap)
    bins = len(bmap) - 1
    j = np.arange(len(sel))
    whole_bin = np.searchsorted(bmap, j, side="right") - 1
    positive = case["table"] > 0.9
    targs = (t["table"], case["fine_offset"], t["entry_idx"], t["bounds"], t["n"], sample_cap)
    gen = np.random.default_rng([f, len(name)])
    for rname, (lo, size) in part_ranges(case["bounds"], case["n"], cap, sample_cap).items():
        where = f"{rname} (lo {lo}, size {size})"
        part, den = cops._pn_part_plain(*targs, lo, size)
        rows, row_bins = run_walk(case["bounds"], case["n"], cap, sample_cap, case["pn_res"],
                                  lo, lo + size)
        want = (j >= lo) & (j < lo + size) & (j < take) & (whole_bin >= 0) & (whole_bin < bins)
        assert np.unique(rows).size == rows.size, f"{where}: a row visited twice"
        np.testing.assert_array_equal(np.sort(rows), np.flatnonzero(want), err_msg=where)
        np.testing.assert_array_equal(row_bins, whole_bin[rows], err_msg=where)
        # K7p: each visited row's positive features counted in its bin
        tab = np.clip(case["fine_offset"] + sel[rows], 0, case["table"].shape[0] - 1)
        counts = np.zeros((bins, f), np.int64)
        np.add.at(counts, row_bins, positive[tab].astype(np.int64))
        np.testing.assert_array_equal(counts.astype(np.float32), part.numpy(), err_msg=where)
        np.testing.assert_array_equal((bmap[1:] - bmap[:-1]).astype(np.float32)
                                      + np.float32(1e-6), den.numpy(), err_msg=where)
        # K7pb: each visited row's bin row of g where its entry's value is > 0.9
        g = gen.standard_normal((bins, f))
        leaf = t["table"].double().requires_grad_()
        cops._pn_part_plain(leaf, *targs[1:], lo, size)[0].backward(torch.from_numpy(g))
        d_table = np.zeros(case["table"].shape)
        np.add.at(d_table, tab, np.where(positive[tab], g[row_bins], 0.0))
        np.testing.assert_allclose(d_table, leaf.grad.numpy(), rtol=0, atol=1e-12,
                                   err_msg=where)


@pytest.mark.parametrize("mode", ["unsampled", "sampled"])
def test_big_bin_outgrows_a_group(mode):
    """The big-bin case holds one bin of more rows than a warp's group of
    32 x 4 rows, which the walk then takes in several groups."""
    case = part_case("big_bin", 4)
    sample_cap = case["sample_cap"] if mode == "sampled" else None
    bmap, _ = walk_map(case["bounds"], case["n"], case["entry_idx"].shape[0], sample_cap)
    assert np.diff(bmap).max() > 4 * 32


@pytest.mark.parametrize("mode", ["unsampled", "sampled"])
def test_gap_leaves_most_runs_empty(mode):
    """In the gap case most runs hold no row, so most warps find their
    run's clamped map empty and walk nothing."""
    case = part_case("gap", 4)
    sample_cap = case["sample_cap"] if mode == "sampled" else None
    m, _ = walk_map(case["bounds"], case["n"], case["entry_idx"].shape[0], sample_cap)
    scale = case["pn_res"] - 2
    per_run = [m[min(b + 8, scale * scale)] - m[b]
               for x in range(scale) for b in range(x * scale, (x + 1) * scale, 8)]
    assert np.mean(np.asarray(per_run) == 0) > 0.9


def test_mirror_constants_match_the_kernel_source():
    """The mirror's tile and group shapes are the ones csrc/pn_hist.cu
    compiles."""
    import re
    from pathlib import Path

    import pn_frac_cases as fc
    src = (Path(__file__).resolve().parent.parent / "cnc_torch" / "csrc"
           / "pn_hist.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int [^;]*\b{name} = (\d+)[,;]", src)
        assert m, name
        return int(m.group(1))

    assert (const("kTileX"), const("kTileY"), const("kRowsAhead")) == (
        fc.TILE_X, fc.TILE_Y, fc.ROWS_AHEAD)
