"""A numpy mirror of the codec pool kernel's row handling
(cnc_torch/csrc/int_context.cu, int_ctx_pool): how the launch splits the
rows into blocks, how a block compacts a tile's kept rows into its queue, how
the queue is cut into batches of one row a lane, the warps' segmented sums
over runs of equal entries with one add a run, and the order check within a
block and across blocks.  tests/test_torch_codec_pool.py holds the mirror to
`intctx.segment_sum_int` and to a direct check of the precondition; the
cases here are the tile, warp, batch and block edges.  The finish (K9c in the
pool's launch, `int_ctx_pool_pq`): which block finishes which entry
(`finish_partition`), the window check every row passes (`window_ok`) and the
per-entry arithmetic (`finish_entry`); tests/test_torch_pool_finish.py holds
them to the twins.
"""

import numpy as np

THREADS = 256                      # kThreads
WARPS = THREADS // 32
ROWS_PER_THREAD = 4                # kRowsPerThread
TILE = THREADS * ROWS_PER_THREAD   # kTile
MAX_BLOCKS = 4096                  # kMaxBlocks


def block_spans(n, resident):
    """launch_pool's grid: about two waves of `resident` blocks, each a run
    of whole tiles; returns [(r0, r1)] per block."""
    tiles = -(-n // TILE)
    blocks = min(2 * resident, MAX_BLOCKS, tiles)
    per_block = -(-tiles // blocks)
    span = per_block * TILE
    return [(b * span, min(n, (b + 1) * span)) for b in range(-(-tiles // per_block))]


def tile_order(keep, base, r1):
    """The queue order of one tile's kept rows: thread t's row j is base +
    j * THREADS + t; the 32 (j, warp) ballot counts are scanned in order and
    a row lands at its count's prefix plus the kept lanes below it."""
    counts, rows = np.zeros(ROWS_PER_THREAD * WARPS, np.int64), {}
    for j in range(ROWS_PER_THREAD):
        for w in range(WARPS):
            lanes = [base + j * THREADS + w * 32 + lane for lane in range(32)]
            bal = [i for i in lanes if i < r1 and keep[i]]
            counts[j * WARPS + w] = len(bal)
            rows[j * WARPS + w] = bal
    prefix = np.concatenate([[0], np.cumsum(counts)[:-1]])
    queue = np.full(int(counts.sum()), -1, np.int64)
    for k, bal in rows.items():
        for below, i in enumerate(bal):
            queue[prefix[k] + below] = i
    return queue


def block_batches(keep, r0, r1):
    """The batches a block runs, in order: whenever its queue holds THREADS
    rows, THREADS of them; the rest after its last tile."""
    out, queue = [], np.zeros(0, np.int64)
    for base in range(r0, r1, TILE):
        queue = np.concatenate([queue, tile_order(keep, base, r1)])
        while queue.size >= THREADS:
            out.append(queue[:THREADS])
            queue = queue[THREADS:]
    if queue.size:
        out.append(queue)
    return out


def warp_run_sums(keys, vals):
    """warp_run_sums: 32 lanes' keys (-1: no row) and [32, C] values; the
    inclusive scan by shuffles over each run of equal keys.  Returns the
    lanes that end a run and the scanned values."""
    keys = np.asarray(keys)
    v = np.array(vals, np.int64)
    heads = [lane == 0 or keys[lane - 1] != keys[lane] for lane in range(32)]
    start = [max(h for h in range(lane + 1) if heads[h]) for lane in range(32)]
    o = 1
    while o < 32:
        up = np.concatenate([v[:o], v[:-o]])      # __shfl_up_sync keeps lanes < o
        v = np.where(np.array([lane - o >= start[lane] for lane in range(32)])[:, None],
                     v + up, v)
        o *= 2
    tails = [lane == 31 or heads[lane + 1] for lane in range(32)]
    return tails, v


def pool_sums(keep, slots, vals, n_e, resident):
    """The kernel's sums: every block, batch and warp as the kernel takes
    them, one add into msum per run (vals [n, C] int64; slots already less
    start_e).  Returns (sums [n_e, C], adds made)."""
    n, c = vals.shape
    out = np.zeros((n_e, c), np.int64)
    adds = 0
    for r0, r1 in block_spans(n, resident):
        for batch in block_batches(keep, r0, r1):
            rows = np.full(THREADS, -1, np.int64)
            rows[:batch.size] = batch
            for w in range(WARPS):
                lanes = rows[w * 32:(w + 1) * 32]
                if lanes[0] < 0:
                    continue                      # a warp without a row
                has = lanes >= 0
                keys = np.where(has, slots[np.maximum(lanes, 0)], -1)
                ok = (keys >= 0) & (keys < n_e)
                keys = np.where(has & ok, keys, -1)
                v = np.where(has[:, None], vals[np.maximum(lanes, 0)], 0)
                tails, v = warp_run_sums(keys, v)
                for lane in range(32):
                    if tails[lane] and keys[lane] >= 0:
                        out[keys[lane]] += v[lane]
                        adds += 1
    return out, adds


def order_fault(keep, slots, n_e, resident):
    """The kernel's fault word: a kept row's entry out of [0, n_e) or below
    the kept row before it in its block (the carry across batches), or a
    block's first entry below the largest last entry of the blocks before it
    (the last block's scan of the (first, last) records)."""
    fault, records = False, []
    for r0, r1 in block_spans(len(keep), resident):
        carry, first = -1, -1
        for batch in block_batches(keep, r0, r1):
            s = slots[batch]
            prev = np.concatenate([[carry], s[:-1]])
            fault |= bool(((s < 0) | (s >= n_e) | (s < prev)).any())
            if first < 0:
                first = int(s[0])
            carry = int(s[-1])
        records.append((first, carry))
    best = -1
    for first, last in records:
        if first >= 0 and first < best:
            fault = True
        best = max(best, last)
    return fault


def case(name, rng):
    """(keep [n] bool, slots [n] int64 sorted, n_e) of one named case."""
    if name == "tile edges":                   # 1,023 + 1,025 rows, kept at the cuts
        n, n_e = 2 * TILE + 1, 40
        keep = rng.random(n) < 0.5
        keep[[0, TILE - 1, TILE, 2 * TILE - 1, 2 * TILE]] = True
    elif name == "warp edges":                 # exactly 32 kept rows a warp's worth
        n, n_e = TILE, 9
        keep = np.zeros(n, bool)
        keep[:THREADS] = True
        keep[THREADS + 31:THREADS + 33] = True
    elif name == "run over warps and blocks":  # one entry over every block
        n, n_e = 20 * TILE + 77, 3
        keep = rng.random(n) < 0.9
        slots = np.concatenate([[0] * 50, [1] * (n - 100), [2] * 50])
        return keep, slots, n_e
    elif name == "entry with no kept row":
        n, n_e = 3 * TILE, 60
        slots = np.sort(rng.integers(0, n_e, n))
        keep = rng.random(n) < 0.3
        keep[slots == 17] = False
        return keep, slots, n_e
    elif name == "one entry":
        n, n_e = 5 * TILE - 3, 1
        keep = rng.random(n) < 0.2
    elif name == "sparse":                     # a level-11 chunk's 7%
        n, n_e = 40 * TILE + 5, 300
        keep = rng.random(n) < 0.07
    else:
        raise ValueError(name)
    return keep, np.sort(rng.integers(0, n_e, n)), n_e


CASES = ("tile edges", "warp edges", "run over warps and blocks", "entry with no kept row",
         "one entry", "sparse")


def window_ok(slots, start_e, n_e):
    """The finish's check of every row: the first row's entry is start_e, the
    last's start_e + n_e - 1, each row's entry its predecessor's or the next
    (window_row_ok, the unsigned difference at most 1)."""
    s = np.asarray(slots, np.int64)
    if s.size == 0:
        return n_e == 0
    step = (s[1:] - s[:-1]) % (1 << 32)
    return bool(s[0] == start_e and s[-1] == start_e + n_e - 1 and (step <= 1).all())


def finish_partition(slots, start_e, n_e, spans, mutation=None):
    """Who finishes which entry: [(entry, block, phase)] with phase "inside"
    (block b, after its pooling: the entries after the entry of row r0 - 1
    and before the entry of row r1) or "last" (the last block to finish:
    the entry at a boundary r0 inside it that ends before that block's r1).
    `mutation` breaks the rule as a faulty kernel would: "r0 off by one"
    (the inside range starts at the entry of row r0 - 1), "no hand-over"
    (no straddling entry is finished), "hand-over at every boundary" (the
    last block also takes a straddling entry that ends in a later block)."""
    slots = np.asarray(slots, np.int64)
    n, out = slots.size, []
    for b, (r0, r1) in enumerate(spans):
        lo = 0 if r0 == 0 else int(slots[r0 - 1]) - start_e + 1
        if mutation == "r0 off by one" and r0 > 0:
            lo -= 1
        hi = n_e if r1 == n else int(slots[r1]) - start_e
        out += [(e, b, "inside") for e in range(max(lo, 0), min(hi, n_e))]
    if mutation == "no hand-over":
        return out
    for b in range(1, len(spans)):
        r0, r1 = spans[b]
        s = int(slots[r0])
        if slots[r0 - 1] != s:
            continue
        if r1 < n and slots[r1] == s and mutation != "hand-over at every boundary":
            continue
        if 0 <= s - start_e < n_e:
            out.append((s - start_e, len(spans) - 1, "last"))
    return out


def finish_quotient(m, den):
    """finish_entry's msum * 65536 // den for msum > 0: the quotient of the
    two as doubles (IEEE, correctly rounded), truncated, then moved by one
    where the remainder leaves [0, den)."""
    num = np.asarray(m, np.int64) * 65536
    den = np.asarray(den, np.int64)
    q = (num.astype(np.float64) / den.astype(np.float64)).astype(np.int64)
    r = num - q * den
    return q + (r >= den) - (r < 0)


def finish_entry(msum, wsum, m_scale, sign_rows=None):
    """One entry's finish as the kernel computes it (host_pq's formula, the
    quotient by `finish_quotient`): (pq [F] uint16, covered, bits [F] uint8
    or None)."""
    m = np.asarray(msum, np.int64)
    den = max(int(wsum), 1) * m_scale
    q = np.where(m <= 0, 1, finish_quotient(np.maximum(m, 1), den))
    pq = np.clip(q, 1, 65535).astype(np.uint16)
    bits = None if sign_rows is None else (np.asarray(sign_rows) > 0).astype(np.uint8)
    return pq, bool(wsum > 0), bits


def window_slots(counts, start_e=0):
    """[n] sorted slots of a window whose entry e holds counts[e] rows."""
    return np.repeat(np.arange(len(counts), dtype=np.int64) + start_e, counts)
