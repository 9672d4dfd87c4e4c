"""Row ranges at the edges of K7p's and K7pb's walk (csrc/pn_hist.cu
`pn_hist_part`, `pn_hist_part_bwd`: K7's and K7b's walk with each run's
boundaries clamped to a data-parallel rank's rows, which
`pn_frac_cases.run_walk(..., lo, hi)` mirrors), and cases of their own:
shared by the CPU tests (tests/test_torch_pn_part_rows.py) and the GPU
tests.
"""

import numpy as np

from pn_frac_cases import CASES, pn_case, walk_map

# cases of their own, in both modes: "big_bin", one bin holding far more
# rows than a warp's group of 32 x ROWS_AHEAD: (pn_res, cap, n, sample_cap,
# the big bin, its rows); "gap", rows in the first and the last 100 of
# 4,096 bins only, so that most runs hold no row at all
BIG_BIN = (18, 8192, 7000, 4000, 37, 3000)
GAP = (66, 8192, 6000, 2000, 100)


def part_case(name: str, f: int, seed: int = 0) -> dict:
    """pn_frac_cases.pn_case's inputs, or "big_bin"'s or "gap"'s: as pn_case,
    with BIG_BIN's one bin holding its rows and the rest spread over the
    bins, or GAP's rows spread over the two ends' bins."""
    if name not in ("big_bin", "gap"):
        return pn_case(name, f, seed)
    rng = np.random.default_rng([seed, f, 977 if name == "big_bin" else 978])
    if name == "big_bin":
        pn_res, cap, n, sample_cap, big, big_rows = BIG_BIN
        n_bins = (pn_res - 2) ** 2
        listed = min(n, cap)
        bins = np.sort(np.concatenate([np.full(big_rows, big),
                                       rng.integers(0, n_bins, size=listed - big_rows)]))
    else:
        pn_res, cap, n, sample_cap, end = GAP
        n_bins = (pn_res - 2) ** 2
        listed = min(n, cap)
        ends = np.concatenate([np.arange(end), np.arange(n_bins - end, n_bins)])
        bins = np.sort(rng.choice(ends, size=listed))
    bins = np.concatenate([bins, np.full(cap - listed, n_bins)])
    case = pn_case("n_at_cap", f, seed)      # its table and fine offset
    fine_size = case["table"].shape[0] - case["fine_offset"]
    entry_idx = np.zeros(cap, np.int32)
    entry_idx[:listed] = rng.integers(0, fine_size, size=listed)
    return dict(case, entry_idx=entry_idx, n=n, pn_res=pn_res, sample_cap=sample_cap,
                bounds=np.searchsorted(bins, np.arange(n_bins + 1), side="left").astype(np.int32))


# (case, mode): every case of pn_frac_cases unsampled, the sampled ones also
# sampled, and the big bin and the gap in both
PART_MODES = ([(name, "unsampled") for name in CASES]
              + [(name, "sampled") for name, (_, cap, _, sample_cap, _) in CASES.items()
                 if sample_cap is not None and sample_cap < cap]
              + [(name, mode) for name in ("big_bin", "gap") for mode in ("unsampled", "sampled")])


def part_ranges(bounds, n, cap, sample_cap) -> dict:
    """Row ranges (lo, size) at the walk's edges for one case: the whole
    space, a bin's edge and its inside (the first bin with three rows or
    more), size 0, a range past the space, and the three chunks of an
    uneven split at W = 3."""
    sampled = sample_cap is not None and sample_cap < cap
    space = sample_cap if sampled else cap
    bmap = np.asarray(walk_map(bounds, n, cap, sample_cap)[0], np.int64)
    lens = bmap[1:] - bmap[:-1]
    fat = np.flatnonzero(lens >= 3)
    b = int(fat[0]) if len(fat) else 0
    edge, end = int(bmap[b]), int(bmap[b + 1])
    chunk = -(-space // 3)
    out = {"whole": (0, space),
           "on_a_bin_edge": (edge, int(bmap[min(b + 2, len(bmap) - 1)]) - edge),
           "inside_one_bin": (edge + 1, max(end - edge - 2, 1)),
           "ends_inside_a_bin": (0, edge + 1),
           "size_0": (edge, 0),
           "size_0_past_space": (space, 0),
           "past_the_space": (max(space - 7, 0), 100),
           "starts_past_the_space": (space + 5, 10)}
    out.update({f"w3_rank{r}": (r * chunk, chunk) for r in range(3)})
    return out
