"""Frac-plane inputs at the edges of the kernel's index math, shared by the CPU
tests (tests/test_torch_pn_frac.py, against cnc_tpu) and the GPU tests
(tests/test_torch_kernels_gpu.py, the kernel against its twin).

Each case is one axis's pn coord list as the cache refresh leaves it: `cap`
rows sorted by bin, the first min(n, cap) listed (their bins ascending, each
row's finest-level entry), the rest parked past the last bin with entry 0;
`bounds` the bins' row boundaries (searchsorted of the sorted bins), a sign
table whose finest level holds +-1 and values at the 0.9 threshold, and the
stride-sampling cap.  numpy only, seeded.

`run_walk` mirrors the walk csrc/pn_hist.cu's kernels share (K7, K7i,
K7b, and K7p/K7pb over a range of rows): tiles, a warp's run of bins, lanes
on consecutive rows and each lane's bin by stepping; `bin_scale` is K7b's
per-bin scale.
"""

import numpy as np

# name: (pn_res, cap, n, sample_cap, bins occupied: "all" or "middle")
CASES = {
    "n0": (18, 4096, 0, 1024, "all"),
    "n1": (18, 4096, 1, 1024, "all"),
    "n_below_sample_cap": (23, 4096, 300, 1024, "all"),
    "n_at_cap": (23, 4096, 4096, 1024, "all"),
    "overflowed": (18, 4096, 4096 + 777, 1024, "all"),
    "sample_cap_at_cap": (18, 4096, 3000, 4096, "all"),
    "sample_cap_above_cap": (18, 4096, 3000, 8192, "all"),
    "take_not_dividing": (23, 4096, 1000, 300, "all"),
    "empty_end_bins": (66, 8192, 6000, 2000, "middle"),
    "unsampled": (66, 8192, 6000, None, "all"),
    # the earlier histogram test's cases: many rows a bin, most bins empty,
    # and a listed count below the list's capacity
    "dense": (66, 50_000, 50_000, None, "all"),
    "empty_bins": (66, 50_000, 50_000, None, "few"),
    "masked_tail": (66, 50_000, 25_000, 20_000, "all"),
}


def pn_case(name: str, f: int, seed: int = 0) -> dict:
    """One case's inputs as numpy arrays (int32 lists, float32 table) and
    ints: table, fine_offset, entry_idx, bounds, n, pn_res, sample_cap."""
    pn_res, cap, n, sample_cap, occupied = CASES[name]
    rng = np.random.default_rng([seed, f, sum(map(ord, name))])
    scale = pn_res - 2
    n_bins = scale * scale
    listed = min(n, cap)
    if occupied == "middle":         # the first and last 10% of the bins stay empty
        lo, hi = n_bins // 10, n_bins - n_bins // 10
    else:
        lo, hi = 0, n_bins
    if occupied == "few":            # 200 distinct bins: most hold no row
        choice = np.sort(rng.choice(np.arange(lo, hi), size=200, replace=False))
        bins = np.sort(rng.choice(choice, size=listed))
    else:
        bins = np.sort(rng.integers(lo, hi, size=listed))
    bins = np.concatenate([bins, np.full(cap - listed, n_bins)])
    bounds = np.searchsorted(bins, np.arange(n_bins + 1), side="left").astype(np.int32)
    fine_offset, fine_size = 37, 1 << 12
    entry_idx = np.zeros(cap, np.int32)
    entry_idx[:listed] = rng.integers(0, fine_size, size=listed)
    table = np.where(rng.random((fine_offset + fine_size, f)) > 0.4, 1.0, -1.0).astype(np.float32)
    edge = rng.random(table.shape) < 0.05          # at and just above the threshold
    table[edge] = np.where(rng.random(int(edge.sum())) < 0.5, np.float32(0.9),
                           np.nextafter(np.float32(0.9), np.float32(1.0)))
    return dict(table=table, fine_offset=fine_offset, entry_idx=entry_idx, bounds=bounds, n=n,
                pn_res=pn_res, sample_cap=sample_cap)


def sampled_map(bounds: np.ndarray, n: int, cap: int, sample_cap: int) -> np.ndarray:
    """The kernel's boundary map in the sampled mode (csrc/pn_hist.cu
    `sample_map`), step for step in float32: m = min(n, cap), take =
    min(m, sample_cap), stride = f32(m) / f32(max(take, 1)), src(j) =
    min(floor(f32(j) * stride), max(m - 1, 0)); for each boundary v, the
    first j in [0, take] with j == take or src(j) >= v: 0 for v <= 0, take
    for v past the last src, else ceil(f32(v) * f32(1 / stride)) clamped to [0, take]
    and moved down while src(j - 1) >= v, then up while src(j) < v.  src is
    never materialised."""
    m = min(n, cap)
    take = min(m, sample_cap)
    stride = np.float32(m) / np.float32(max(take, 1))
    src_max = max(m - 1, 0)

    def src(j):
        return np.minimum(np.floor(j.astype(np.float32) * stride).astype(np.int64), src_max)

    v = np.asarray(bounds, np.int64)
    inner = (v > 0) & (v <= src_max)          # the kernel estimates only these
    with np.errstate(divide="ignore", invalid="ignore"):   # stride is 0 when m is
        est = np.ceil(v.astype(np.float32) * (np.float32(1.0) / stride))
    j = np.clip(np.where(inner, est, 0).astype(np.int64), 0, take)
    while True:
        down = inner & (j > 0) & (src(np.maximum(j - 1, 0)) >= v)
        if not down.any():
            break
        j = np.where(down, j - 1, j)
    while True:
        up = inner & (j < take) & (src(j) < v)
        if not up.any():
            break
        j = np.where(up, j + 1, j)
    return np.where(v <= 0, 0, np.where(v > src_max, take, j))


TILE_X, TILE_Y, ROWS_AHEAD = 8, 8, 4     # csrc/pn_hist.cu kTileX, kTileY, kRowsAhead


def walk_map(bounds: np.ndarray, n: int, cap: int, sample_cap) -> tuple:
    """(map, take) of the kernels: the sampled boundary map and its take
    when 0 < sample_cap < cap (the wrappers' sampled mode), else the bounds
    clamped to [0, cap] and take = min(n, cap)."""
    m = min(n, cap)
    if sample_cap is not None and sample_cap < cap:
        return sampled_map(bounds, n, cap, sample_cap), min(m, sample_cap)
    return np.clip(np.asarray(bounds, np.int64), 0, cap), m


def run_walk(bounds: np.ndarray, n: int, cap: int, sample_cap, pn_res: int, lo: int = 0,
             hi=None) -> tuple:
    """The rows the kernels' walk visits and the bin each lane gives its
    row: (rows, bins), int64 arrays in visiting order.  A block a tile of
    TILE_X x-columns by TILE_Y y, a warp a column's run of bins; the warp
    steps over the run's rows [map[0], map[ny]) ROWS_AHEAD * 32 at a time,
    lane l of group u on row jb + 32 u + l; a lane's bin is stepped up from
    the bin of the previous group's lane 31 while the next boundary is at or
    below its row; lanes past the run or at or past take visit nothing.
    With `hi`, the map is clamped to the rows [lo, hi) first, as K7p and
    K7pb clamp each run's boundaries (`clamp_map`)."""
    scale = pn_res - 2
    bmap, take = walk_map(bounds, n, cap, sample_cap)
    if hi is not None:
        bmap = np.clip(bmap, lo, hi)
    lanes = np.arange(32)
    rows, bins = [], []
    for x0 in range(0, scale, TILE_X):
        for y0 in range(0, scale, TILE_Y):
            nx, ny = min(TILE_X, scale - x0), min(TILE_Y, scale - y0)
            for w in range(nx):
                base = (x0 + w) * scale + y0
                run = bmap[base:base + ny + 1]
                j1, b_first = int(run[ny]), 0
                for jb in range(int(run[0]), j1, 32 * ROWS_AHEAD):
                    for u in range(ROWS_AHEAD):
                        j = jb + 32 * u + lanes
                        b = np.full(32, b_first)
                        while True:
                            step = (b + 1 < ny) & (run[np.minimum(b + 1, ny)] <= j)
                            if not step.any():
                                break
                            b = b + step
                        ok = (j < j1) & (j < take)
                        rows.append(j[ok])
                        bins.append(base + b[ok])
                        b_first = int(b[31])
    cat = lambda xs: np.concatenate(xs).astype(np.int64) if xs else np.zeros(0, np.int64)
    return cat(rows), cat(bins)


def bin_scale(g: np.ndarray, bmap: np.ndarray, pn_res: int) -> np.ndarray:
    """K7b's scale of each bin b = x * (pn_res - 2) + y: the plane's
    gradient at row (y + 1) * pn_res + x + 1 over (f32(map[b+1] - map[b]) +
    1e-6), rounded in float32 as the kernel rounds it: [bins, F]."""
    scale = pn_res - 2
    b = np.arange(scale * scale)
    cnt = (bmap[1:] - bmap[:-1]).astype(np.float32) + np.float32(1e-6)
    return (g[(b % scale + 1) * pn_res + b // scale + 1].astype(np.float32)
            / cnt[:, None]).astype(np.float32)
