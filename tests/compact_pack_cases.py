"""The index and bit arithmetic of the stream compaction (K3, csrc/compact.cu)
and of the mask packing (csrc/grid_encode.cu `pack_mask_bits_kernel`), step
for step in numpy, with the masks at the edges of both kernels.  Shared by the
CPU tests (tests/test_torch_compact_pack.py, each step against numpy and the
twins against cnc_tpu) and the GPU tests (tests/test_torch_kernels_gpu.py,
the kernels against their twins).

The constants are the kernels': K3 gives each of 256 threads 64 bytes (two
32-bit masks) of a tile of 16,384; a tile's status word holds its count or
inclusive prefix in bits 0-31, a flag in 32-33 and the launch's tag in
34-63, and a tile's look-back reads 32 earlier tiles' words at a time, one
a lane.  Both kernels turn
bytes into bits four at a time: a byte compare leaves 0xff or 0 per byte, one
bit of each is kept and a multiply by BYTE_BITS_MUL gathers the four at bits
28-31.
"""

import numpy as np

K3_THREADS, K3_MASKS = 256, 2
K3_BYTES = 32 * K3_MASKS
K3_TILE = K3_THREADS * K3_BYTES
K3_WARPS = K3_THREADS // 32
AGGREGATE, PREFIX = 1, 2
TAG_MOD = (1 << 30) - 1
BYTE_BITS_MUL = 0x10204080
PACK_THREADS = 256

# K3's masks: name -> (n, cap, density or "all"/"none", byte offset of the view)
T = K3_TILE
COMPACT_CASES = {
    "n0": (0, 16, 0.5, 0),
    "n1": (1, 16, "all", 0),
    "tile_minus_1": (T - 1, 300, 0.2, 0),
    "tile": (T, 300, 0.2, 0),
    "tile_plus_1": (T + 1, 4096, 0.9, 0),
    "many_tiles": (40 * T + 77, 9000, 0.3, 0),
    "cap_below_count": (5 * T + 3, 1000, 0.5, 0),
    "cap_at_count": (5 * T + 3, None, 0.5, 0),       # cap = the count
    "cap_above_n": (3 * T + 5, 4 * T, 0.5, 0),
    "all_set": (3 * T + 5, 2 * T, "all", 0),
    "none_set": (3 * T + 5, 2 * T, "none", 0),
    "dense_runs": (6 * T + 99, 4 * T, "runs", 0),     # whole tiles set: the stage's pad
    **{f"offset_{k}": (2 * T + 11, 5000, 0.4, k) for k in range(1, 16)},
}

# the packing's masks: name -> (rows, cols, byte offset of the view)
PACK_CASES = {
    "cols_mod_0": (3, 64 * 32, 0),
    "cols_mod_1": (3, 64 * 32 + 1, 0),
    "cols_mod_16": (3, 64 * 32 + 16, 0),       # the planes' case: 1,400,336 % 32 = 16
    "cols_mod_31": (3, 64 * 32 + 31, 0),
    "unaligned_rows": (4, 1000, 0),            # 1000 % 16 = 8: every other row
    "offset_1": (2, 4096, 1),
    "offset_7": (1, 777, 7),
}


def compact_case(name: str, seed: int = 0):
    """(a uint8 buffer, the mask's offset in it, n, cap) of one case: the
    mask is buffer[offset:offset + n], its bytes 0 or 1."""
    n, cap, density, offset = COMPACT_CASES[name]
    rng = np.random.default_rng([seed, sum(map(ord, name))])
    if density == "all":
        mask = np.ones(n, bool)
    elif density == "none":
        mask = np.zeros(n, bool)
    elif density == "runs":      # runs of 4,096 bytes, 78% of them set
        mask = np.repeat(rng.random(-(-n // 4096)) < 0.78, 4096)[:n]
    else:
        mask = rng.random(n) < density
    if cap is None:
        cap = int(mask.sum())
    buf = np.zeros(offset + n + 16, np.uint8)
    buf[offset:offset + n] = mask
    return buf, offset, n, cap


def pack_case(name: str, seed: int = 0):
    """(a uint8 buffer, the mask's offset in it, rows, cols)."""
    rows, cols, offset = PACK_CASES[name]
    rng = np.random.default_rng([seed, sum(map(ord, name))])
    buf = np.zeros(offset + rows * cols + 16, np.uint8)
    buf[offset:offset + rows * cols] = rng.random(rows * cols) < 0.4
    return buf, offset, rows, cols


def vcmpne4(w: np.ndarray) -> np.ndarray:
    """__vcmpne4(w, 0): 0xff in each byte of the uint32 words that is not 0."""
    b = np.asarray(w, np.uint32)[..., None] >> (8 * np.arange(4, dtype=np.uint32)) & 0xFF
    return ((b != 0).astype(np.uint32) * 0xFF << (8 * np.arange(4, dtype=np.uint32))).sum(
        -1, dtype=np.uint32)


def byte_bits4(w: np.ndarray) -> np.ndarray:
    """cnc_byte_bits4: bit k set where byte k of the word is not 0, in 32-bit
    arithmetic as the card does it (the product wraps)."""
    m = (vcmpne4(w) & np.uint32(0x01010101)).astype(np.uint64)
    return ((m * BYTE_BITS_MUL) & 0xFFFFFFFF).astype(np.uint32) >> np.uint32(28)


def byte_bits32(groups: np.ndarray) -> np.ndarray:
    """The word a thread makes of its 32 bytes (groups [..., 32] uint8) on the
    vector path: two 16-byte loads of four little-endian words each,
    cnc_byte_bits16 of each, the second shifted by 16."""
    words = np.ascontiguousarray(groups, np.uint8).view("<u4")      # [..., 8]
    nib = byte_bits4(words)
    return (nib << (4 * np.arange(8, dtype=np.uint32))).sum(-1, dtype=np.uint32)


def scalar_bits(groups: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The scalar path: bit j where byte j is in range and not 0."""
    set_ = (groups != 0) & valid
    return (set_.astype(np.uint32) << np.arange(groups.shape[-1], dtype=np.uint32)).sum(
        -1, dtype=np.uint32)


def popcount(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint32)
    return np.unpackbits(x.view(np.uint8).reshape(*x.shape, 4), axis=-1).sum(-1)


def k3_split(n: int, a: int):
    """K3's tiles over a mask of n bytes whose base lies `a` bytes past a
    16-byte boundary: (tiles, v0 [groups], vector [groups]) for each thread's
    64-byte group (tile * 256 + thread), byte v being mask[v - a]."""
    nv = n + a
    tiles = -(-nv // K3_TILE) if n else 0
    v0 = np.arange(tiles * K3_THREADS, dtype=np.int64) * K3_BYTES
    vector = (v0 >= a) & (v0 + K3_BYTES <= nv)
    return tiles, v0, vector


def k3_tile_bits(mask: np.ndarray, a: int):
    """Each group's K3_MASKS 32-bit masks [groups, K3_MASKS], by the path
    the kernel takes for the group."""
    n = mask.size
    tiles, v0, vector = k3_split(n, a)
    virt = np.zeros(tiles * K3_TILE, np.uint8)
    virt[a:a + n] = mask
    groups = virt.reshape(-1, K3_MASKS, 32)
    idx = v0[:, None, None] + np.arange(K3_BYTES).reshape(K3_MASKS, 32)
    sc = scalar_bits(groups, (idx >= a) & (idx < n + a))
    return tiles, np.where(vector[:, None], byte_bits32(groups), sc)


def stage_slot(r):
    """The shared-memory slot of a tile's r-th staged position: a 4-byte pad
    (two 16-bit slots) after every 64 slots."""
    return r + ((r >> 6) << 1)


def status_word(tag: int, flag: int, value: int) -> int:
    return (tag << 34) | (flag << 32) | value


def status_fields(w: int):
    """(tag, flag, value) of a status word."""
    return w >> 34, (w >> 32) & 3, w & 0xFFFFFFFF


def launch_tag(epoch: int) -> int:
    """The tag a launch reads from the epoch word: never 0, the tag of a word
    that was never written."""
    return epoch % TAG_MOD + 1


def look_back(words, tile: int, tag: int) -> int:
    """K3's look_back for `tile` > 0 over the status words of the tiles
    before it (all carrying `tag`), 32 lanes a window, lane k on tile end - k."""
    excl = 0
    end = tile - 1
    while True:
        flags, values = [], []
        for lane in range(32):
            idx = end - lane
            if idx >= 0:
                t, f, v = status_fields(words[idx])
                assert t == tag, "the kernel waits for this word"
            else:
                f, v = PREFIX, 0
            flags.append(f)
            values.append(v)
        prefixes = [k for k in range(32) if flags[k] == PREFIX]
        if prefixes:
            return excl + sum(values[:prefixes[0] + 1])
        excl += sum(values)
        end -= 32


def fill_split(lo: int, cap: int):
    """The fill of [lo, cap): (head, body, tail): scalar slots [lo, head),
    int4 stores over [head, tail) from a 16-byte aligned src, scalar
    [tail, cap)."""
    head = min((lo + 3) & ~3, cap)
    body = (cap - head) >> 2
    return head, body, head + 4 * body


def k3_emulate(mask: np.ndarray, a: int, cap: int, published=None):
    """K3 step for step over a uint8 mask at misalignment a: (src [cap]
    int32, count).  `published(tile, aggregates, prefixes)` gives the status
    word state each tile's look-back meets (flag per earlier tile); by
    default every earlier tile has published its prefix."""
    n = mask.size
    tiles, bits = k3_tile_bits(mask, a)
    src = np.full(cap, -1, np.int64)                 # -1: not written
    if tiles == 0:
        count = 0
    else:
        bits = bits.reshape(tiles, K3_WARPS, 32, K3_MASKS)
        c = popcount(bits).sum(-1)
        incl = np.cumsum(c, axis=-1)                 # the warp's shuffle scan
        warp_total = incl[..., -1]
        before = np.cumsum(warp_total, axis=-1) - warp_total
        agg = warp_total.sum(-1)
        rank = before[..., None] + incl - c
        prefix = np.cumsum(agg)
        tag = launch_tag(7)
        for tile in range(tiles):
            if tile == 0:
                excl = 0
            else:
                flags = (published(tile, agg, prefix) if published is not None
                         else np.full(tile, PREFIX))
                flags[0] = PREFIX
                words = [status_word(tag, int(f), int(prefix[j] if f == PREFIX else agg[j]))
                         for j, f in enumerate(flags)]
                excl = look_back(words, tile, tag)
            stage = np.full(stage_slot(K3_TILE), -1, np.int64)
            for t in range(K3_THREADS):
                w, l = divmod(t, 32)
                r = int(rank[tile, w, l])
                for m in range(K3_MASKS):
                    b = int(bits[tile, w, l, m])
                    while b:
                        j = (b & -b).bit_length() - 1
                        stage[stage_slot(r)] = t * K3_BYTES + 32 * m + j
                        r += 1
                        b &= b - 1
            if excl < cap:
                m = min(int(agg[tile]), cap - excl)
                staged = stage[stage_slot(np.arange(m))]
                assert (staged >= 0).all(), "a staged slot was not written"
                src[excl:excl + m] = tile * K3_TILE - a + staged
        count = int(prefix[-1])
    head, body, tail = fill_split(min(count, cap), cap)
    src[min(count, cap):head] = 0
    src[head:tail] = 0
    src[tail:cap] = 0
    assert (src >= 0).all(), "a slot was left unwritten"
    return src.astype(np.int32), count


def pack_split(rows: int, cols: int, a: int):
    """The packing's paths: vector [rows, words], True where row r starts
    16-byte aligned (the mask's base `a` bytes past a boundary) and word w
    is whole."""
    words = -(-cols // 32)
    row_aligned = (a + np.arange(rows, dtype=np.int64) * cols) % 16 == 0
    whole = np.arange(words, dtype=np.int64) * 32 + 32 <= cols
    return row_aligned[:, None] & whole[None, :]


def pack_emulate(mask: np.ndarray, a: int) -> np.ndarray:
    """The packing kernel step for step over a [rows, cols] uint8 mask whose
    base lies a bytes past a 16-byte boundary: int32 [rows, words]."""
    rows, cols = mask.shape
    words = -(-cols // 32)
    padded = np.zeros((rows, words * 32), np.uint8)
    padded[:, :cols] = mask
    groups = padded.reshape(rows, words, 32)
    col = np.arange(words * 32).reshape(words, 32)
    out = np.where(pack_split(rows, cols, a), byte_bits32(groups),
                   scalar_bits(groups, col < cols))
    return out.view(np.int32)
