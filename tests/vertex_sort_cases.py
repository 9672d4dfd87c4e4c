"""A numpy mirror of the table build's counting sort by entry
(cnc_torch/csrc/vertex_tables.cu, K10): the keys by the kernel's index
arithmetic (its multiply-and-shift divisions, the XOR-prime hash in uint32),
count, the tiled scan of (count, count > 0) with its status words, place in a
given claim order (as the atomics would take the vertices), and per segment
the order pass's sort (odd-even transposition rounds, then a bitonic sort),
or, above the cap, the tile sorts and merge passes of the long-segment path.
tests/test_torch_vertex_count_sort.py holds it to the plain twin
(`_level_tables_plain`: keys, a stable torch.sort, the fill) and to cnc_tpu's
tables; the GPU tests take their cases from here.
"""

import numpy as np

from cnc_torch.utils import threefry

THREADS = 256                        # kThreads
PER_BLOCK = 4 * THREADS              # kPerThread * kThreads: ids a count or place block takes
ITEMS = 16                           # kItems
SCAN_TILE = THREADS * ITEMS          # kScanTile
CAP = 1024                           # kCap
ROUNDS = 32                          # kRounds
INT_MAX = (1 << 31) - 1


def make_fastdiv(d):
    """(m, shift) of common.cuh's make_fastdiv."""
    s = 0
    while (1 << s) < d:
        s += 1
    return ((1 << 32) * ((1 << s) - d)) // d + 1, s


def fastdiv(n, fd):
    """common.cuh's fastdiv for 0 <= n < 2^31: (umulhi(n, m) + n) >> shift."""
    m, s = fd
    n = np.asarray(n, np.uint64)
    return ((((n * np.uint64(m)) >> np.uint64(32)) + n) >> np.uint64(s)).astype(np.int64)


def coords_2d(ids, tile, rb):
    """The kernel's coords_2d: (x, y, block) of block-lattice points."""
    side = tile + 2
    b = fastdiv(ids, make_fastdiv(side * side))
    off = ids - b * side * side
    oi, bi = fastdiv(off, make_fastdiv(side)), fastdiv(b, make_fastdiv(rb))
    return bi * tile + oi, (b - bi * rb) * tile + off - oi * side, b


def vertex_keys(v, d, r, size, tile=0, rb=0, perm=None, ids=None):
    """The kernel's vertex_key for every id in [0, v) (or of `ids`)."""
    ids = np.arange(v, dtype=np.int64) if ids is None else np.asarray(ids, np.int64)
    u32 = lambda a: np.asarray(a, np.uint64) & np.uint64(0xFFFFFFFF)
    if d == 3:
        x = fastdiv(ids, make_fastdiv(r * r))
        rem = ids - x * r * r
        y = fastdiv(rem, make_fastdiv(r))
        z = rem - y * r
        dense = r ** 3 <= size
        h = (x + y * r + z * r * r) if dense else u32(
            u32(x) ^ u32(u32(y) * np.uint64(2654435761)) ^ u32(u32(z) * np.uint64(805459861)))
    else:
        x, y, _ = coords_2d(ids, tile, rb)
        dense = r * r <= size
        h = (x + y * r) if dense else u32(u32(x) ^ u32(u32(y) * np.uint64(2654435761)))
    h = np.asarray(h, np.uint64)
    if not dense:
        h = h & np.uint64(size - 1) if size & (size - 1) == 0 else h % np.uint64(size)
    idx = h.astype(np.int64)
    return np.asarray(perm, np.int64)[idx] if perm is not None else idx


def pack_status(flag, total, ords):
    """scan_kernel's status word: flag bits 62-63, entries 32-61, vertices 0-31."""
    return (int(flag) << 62) | (int(ords) << 32) | int(total)


def unpack_status(w):
    return w >> 62, w & 0xFFFFFFFF, (w >> 32) & 0x3FFFFFFF


def scan(counts, inv=None):
    """scan_kernel over counts [size]: tiles of SCAN_TILE keys, threads of
    ITEMS keys, warp and block scans, each tile's prefix from the status
    words of the tiles before it.  Returns (cursor [size], cum, values,
    n_entries, longest): cum and values [n_entries] at the entry ordinals."""
    counts = np.asarray(counts, np.int64)
    size = counts.size
    tiles = -(-size // SCAN_TILE)
    cursor = np.zeros(size, np.int64)
    cum, values = {}, {}
    status = []
    for tile in range(tiles):
        k0 = tile * SCAN_TILE + np.arange(THREADS) * ITEMS
        c = np.stack([np.where(k0 + j < size, counts[np.minimum(k0 + j, size - 1)], 0)
                      for j in range(ITEMS)], 1)
        s, o = c.sum(1), (c > 0).sum(1)
        ws, wo = s.reshape(-1, 32).cumsum(1), o.reshape(-1, 32).cumsum(1)   # inclusive
        bs = np.concatenate([[0], np.cumsum(ws[:, -1])[:-1]])
        bo = np.concatenate([[0], np.cumsum(wo[:, -1])[:-1]])
        agg_s, agg_o = int(ws[:, -1].sum()), int(wo[:, -1].sum())
        es = eo = 0                                  # the look-back
        for w in reversed(status):
            flag, ts, to = unpack_status(w)
            es, eo = es + ts, eo + to
            if flag == 2:
                break
        status.append(pack_status(2, es + agg_s, eo + agg_o))
        slot = es + np.repeat(bs, 32) + ws.reshape(-1) - s
        ords = eo + np.repeat(bo, 32) + wo.reshape(-1) - o
        for t in range(THREADS):
            sl, od = int(slot[t]), int(ords[t])
            for j in range(ITEMS):
                k = int(k0[t]) + j
                if k >= size:
                    break
                cursor[k] = sl
                if c[t, j] > 0:
                    cum[od], values[od] = sl, (int(inv[k]) if inv is not None else k)
                    od += 1
                sl += int(c[t, j])
    n_entries = unpack_status(status[-1])[2] if status else 0
    return (cursor, np.array([cum[e] for e in range(n_entries)], np.int64),
            np.array([values[e] for e in range(n_entries)], np.int64), n_entries,
            int(counts.max()) if size else 0)


def claim_order(v, how, rng):
    """The order in which the place pass's atomics take the vertices:
    'ascending'; 'racing blocks' (blocks of PER_BLOCK ids start in order,
    the vertices of 64 blocks in flight at once claim in any order);
    'shuffled' (any order at all)."""
    if how == "ascending":
        return np.arange(v)
    if how == "racing blocks":
        when = np.arange(v) // PER_BLOCK + rng.integers(0, 64, v)
        return np.lexsort((rng.random(v), when))
    if how == "shuffled":
        return rng.permutation(v)
    raise ValueError(how)


def place(keys, cursor, order):
    """ids [v]: each vertex at its key's cursor plus its rank among its
    key's vertices in the claim order."""
    rank = np.empty(keys.size, np.int64)
    rank[order] = np.arange(keys.size)
    ids = np.lexsort((rank, keys))               # by key, then by claim
    first = np.asarray(cursor)[keys[ids]]        # each slot's segment starts at its key's cursor
    assert (first <= np.arange(keys.size)).all()
    return ids


def warp_sort(a, bitonic=True):
    """warp_sort: odd-even transposition rounds until two in a row swap
    nothing (at most ROUNDS), then, if unsorted, the bitonic network over
    the next power of two padded with INT_MAX.  Each round's and stage's
    pairs are disjoint, so a vectorized step is the warp's."""
    a = np.array(a, np.int64)
    n, quiet, rnd = a.size, 0, 0
    while rnd < ROUNDS and quiet < 2:
        i = np.arange(rnd & 1, n - 1, 2)
        swap = a[i] > a[i + 1]
        a[i[swap]], a[i[swap] + 1] = a[i[swap] + 1], a[i[swap]]
        quiet = 0 if swap.any() else quiet + 1
        rnd += 1
    if quiet >= 2 or not bitonic:
        return a
    p = 1
    while p < n:
        p <<= 1
    b = np.concatenate([a, np.full(p - n, INT_MAX, np.int64)])
    k = 2
    while k <= p:
        j = k >> 1
        while j > 0:
            i = np.arange(p)
            l = i ^ j
            i, l = i[l > i], l[l > i]
            up = (i & k) == 0
            swap = (b[i] > b[l]) == up
            b[i[swap]], b[l[swap]] = b[l[swap]], b[i[swap]]
            j >>= 1
        k <<= 1
    return b[:n]


def long_segments(ids, cum, n_entries, v, longest, scratch):
    """The long-segment path over ids in place: tiles of CAP ids sorted by
    warp_sort, then merge passes of doubling width between ids and scratch
    (vert_entry), each element placed at its run's merged start plus its
    place in its run plus its lower bound in the partner run.  Returns the
    buffer the sorted ids end in."""
    starts = np.asarray(cum[:n_entries], np.int64)
    lens = np.append(starts[1:], v) - starts
    big = np.nonzero(lens > CAP)[0]
    for s, n in zip(starts[big], lens[big]):
        for o in range(0, n, CAP):
            ids[s + o:s + min(o + CAP, n)] = warp_sort(ids[s + o:s + min(o + CAP, n)])
    passes = max(0, int(np.ceil(np.log2(longest / CAP)))) if big.size else 0
    a, b, width = ids, scratch, CAP
    for _ in range(passes):
        for s, n in zip(starts[big], lens[big]):
            for run0 in range(0, n, width):        # merge_pass_kernel, a run's elements at once
                p0 = ((run0 // width) ^ 1) * width
                x = a[s + run0:s + min(run0 + width, n)]
                below = (np.searchsorted(a[s + p0:s + min(p0 + width, n)], x, side="left")
                         if p0 < n else 0)
                b[s + min(run0, p0) + np.arange(x.size) + below] = x
        a, b, width = b, a, 2 * width
    return a


def level_tables(v, d, r, size, e_max, tile=0, rb=0, perm=None, inv=None,
                 claims="racing blocks", seed=0, bitonic=True):
    """The kernel's tables of one hashed level: count, scan, place in the
    `claims` order, order (and the long-segment path), the past-count fill.
    Returns the twin's dict (int64 numpy arrays), and which segments took
    which path."""
    rng = np.random.default_rng(seed)
    keys = vertex_keys(v, d, r, size, tile, rb, perm)
    counts = np.bincount(keys, minlength=size)
    cursor, cum_e, val_e, n_entries, longest = scan(counts, inv)
    ids = place(keys, cursor, claim_order(v, claims, rng))
    cum = np.full(e_max + 1, v, np.int64)
    cum[:n_entries] = cum_e
    values = np.full(e_max, int(inv[0]) if inv is not None else 0, np.int64)
    values[:n_entries] = val_e
    vert_entry = np.full(v, -1, np.int64)
    paths = {"short": 0, "long": 0}
    for e in range(n_entries):
        start, end = cum[e], (cum[e + 1] if e + 1 < n_entries else v)
        if end - start > CAP:
            paths["long"] += 1
            continue
        ids[start:end] = warp_sort(ids[start:end], bitonic)
        vert_entry[start:end] = e
        paths["short"] += 1
    if longest > CAP:                            # long_write_kernel: the id, then the slot
        src = long_segments(ids, cum, n_entries, v, longest, vert_entry)
        starts = cum[:n_entries]
        lens = np.append(starts[1:], v) - starts
        for e in np.nonzero(lens > CAP)[0]:
            sl = slice(starts[e], starts[e] + lens[e])
            ids[sl] = src[sl].copy()
            vert_entry[sl] = e
    out = {"cum": cum, "entry_values": values, "vert_entry": vert_entry, "n_entries": n_entries,
           "longest": longest}
    if d == 3:
        out["pos_flat"] = ids
    else:
        x, y, blk = coords_2d(ids, tile, rb)
        out["coords"], out["block_id"] = (x << 16) | y, blk
    return out, paths


def perm_inv(n, seed):
    """A threefry entry permutation of n and its inverse (int64)."""
    perm = threefry.permutation(seed, n).astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    return perm, inv


def table_case(name):
    """(v, d, r, size, e_max, tile, rb, perm, inv) of a named level."""
    if name == "small 3D hashed":
        return 34 ** 3, 3, 34, 1024, 1024, 0, 0, None, None
    if name == "3D with empty keys":              # v just above size: a third of the keys empty
        return 26 ** 3, 3, 26, 1 << 14, 1 << 14, 0, 0, None, None
    if name == "3D non-power-of-two size":
        return 30 ** 3, 3, 30, 3001, 3001, 0, 0, None, None
    if name == "segments across the cap":          # 1,458 vertices a key on average
        return 72 ** 3, 3, 72, 256, 256, 0, 0, None, None
    if name == "one key holds every vertex":       # size 1: one segment of 5,832
        return 18 ** 3, 3, 18, 1, 1, 0, 0, None, None
    if name == "2D with perm and inv":
        perm, inv = perm_inv(256, 4323)
        return 16 * 16 * 4 ** 2, 2, 34, 256, 256, 2, 16, perm, inv
    if name == "2D dense lattice":                 # r^2 <= size: revisited coords share keys
        perm, inv = perm_inv(1 << 12, 4322)
        return 16 * 16 * 3 ** 2, 2, 18, 1 << 12, 1 << 12, 1, 16, perm, inv
    raise ValueError(name)


TABLE_CASES = ("small 3D hashed", "3D with empty keys", "3D non-power-of-two size",
         "segments across the cap", "one key holds every vertex", "2D with perm and inv",
         "2D dense lattice")
