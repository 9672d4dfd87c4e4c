// K10: the vertex -> entry tables of one context level.
//
// Replaces: cnc_tpu/models/context_models.py _fused_build_impl (269-396):
// every lattice vertex of a level is hashed to its table entry, the vertices
// are sorted by entry (stably: within an entry in ascending vertex id), and
// per entry the first vertex (`cum`), the table index (`entry_values`) and per
// vertex the entry's ordinal (`vert_entry`) are filled in by XLA scatters over
// a cumulative sum of the run heads.
// Plain twins: cnc_torch/ops/context_ops.py `_level_tables_plain` (keys,
// a stable torch.sort, the fill) and `_dense_level_plain`.
//
// A hashed level (every 2D level, and a 3D level with r^3 above the table
// size) is a counting sort by entry, since its keys lie in [0, size), at
// most 2^19.  A key is computed on the fly wherever it is needed: vertex id
// -> lattice coords (3D raster, last axis fastest, or the 2D block lattice of
// _coords_2d, 258-267) -> grid_index (dense x-fastest or the XOR-prime hash)
// -> the optional entry permutation.  Four launches:
//   count  one atomic add a vertex into counts[size] (2 MiB at most: it
//          stays in L2);
//   scan   one pass over the pairs (count, count > 0) by decoupled look-back
//          over tiles of 4,096 keys (as K3 in csrc/compact.cu): each key's
//          first sorted slot and, for a key that holds vertices, its entry
//          ordinal, which give cum and entry_values directly (no sort, no
//          head flags, no compaction, no binary search); counts become the
//          keys' cursors; n_entries and the largest count go to two words
//          the wrapper reads;
//   place  one atomic add a vertex on its key's cursor claims a slot of the
//          key's segment, where the vertex id is written (into pos_flat in
//          3D, block_id in 2D: outputs, used as scratch until the order).
//          The stores scatter 4 bytes at a time over the whole level; the
//          launch takes the keys in kPlacePasses ranges in turn (its grid's
//          y, every vertex's key recomputed in each), so that the segments
//          being filled at once, a line of L2 each, fit in L2 and their
//          lines leave it whole: at 514^3 on the H100, 7.59 device ms in one
//          range, 4.25 in four, no better in eight (PERF.md);
//   order  a warp a segment of up to kCap ids: the ids into shared memory,
//          sorted by id, then per slot vert_entry (the segment's ordinal)
//          and pos_flat, or coords and block_id; the same launch parks cum at
//          v and entry_values at 0 (through inv) past n_entries.  The place
//          pass claims slots in nearly the order of the ids (a vertex races
//          only the few in flight beside it), so the sort is odd-even
//          transposition until two rounds in a row swap nothing, and a
//          bitonic sort after kRounds rounds.
// A segment above kCap (a lattice the XOR-prime hash spreads unevenly) still
// comes out right, more slowly: its tiles of kCap ids are sorted in shared
// memory, then merged in passes of doubling width, each element placed by a
// binary search in the run it merges with, between the two output buffers;
// the wrapper launches this only when the largest count exceeds kCap.
// A dense 3D level (R^3 <= table size) needs no sort: its grid_index is a
// bijection, so entry e of the shuffled order is vertex inv(perm[e]).
//
// Bound on the H100: bytes.  Any build must write pos_flat and vert_entry
// (8 bytes a vertex) and cum and entry_values (8 bytes an entry); this one
// also writes and reads each id once more between place and order, and its
// two atomics and one scattered store a vertex are L2 transactions of their
// own, which bound count and place instead (about 90 G a second measured).
// At 514^3, 135,796,744 vertices.

#include <algorithm>
#include <climits>
#include <utility>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kPerThread = 4;                 // vertices a thread counts and places
constexpr int kPlacePasses = 4;               // key ranges the place pass takes in turn
constexpr int kItems = 16;                    // keys a thread scans
constexpr int kScanTile = kThreads * kItems;  // 4,096 keys
constexpr int kCap = 1024;                    // ids a segment sorts in shared memory
constexpr int kRounds = 32;                   // odd-even rounds before the bitonic sort
constexpr unsigned kAggregate = 1, kPrefix = 2;

struct Level {
  int v, d, r, size, tile, rb;
  bool dense;
  FastDiv div_rr, div_r, div_block, div_side, div_rb;  // 3D: r^2, r; 2D: (tile+2)^2, tile+2, rb
  const int* perm;
};

__device__ __forceinline__ uint32_t grid_index3(uint32_t x, uint32_t y, uint32_t z, uint32_t r,
                                                uint32_t size, bool dense) {
  if (dense) return x + y * r + z * r * r;
  const uint32_t h = x ^ (y * 2654435761u) ^ (z * 805459861u);
  return (size & (size - 1)) == 0 ? (h & (size - 1)) : (h % size);
}

__device__ __forceinline__ uint32_t grid_index2(uint32_t x, uint32_t y, uint32_t r,
                                                uint32_t size, bool dense) {
  if (dense) return x + y * r;
  const uint32_t h = x ^ (y * 2654435761u);
  return (size & (size - 1)) == 0 ? (h & (size - 1)) : (h % size);
}

// Block-lattice coords of point `id` (context_models._coords_2d).
__device__ __forceinline__ void coords_2d(const Level& L, int id, int* x, int* y, int* blk) {
  const int per_block = (L.tile + 2) * (L.tile + 2);
  const int b = fastdiv(id, L.div_block), off = id - b * per_block;
  const int oi = fastdiv(off, L.div_side), bi = fastdiv(b, L.div_rb);
  *x = bi * L.tile + oi;
  *y = (b - bi * L.rb) * L.tile + off - oi * (L.tile + 2);
  *blk = b;
}

__device__ __forceinline__ int vertex_key(const Level& L, int id) {
  uint32_t idx;
  if (L.d == 3) {
    const int x = fastdiv(id, L.div_rr), rem = id - x * L.r * L.r;
    const int y = fastdiv(rem, L.div_r), z = rem - y * L.r;
    idx = grid_index3(x, y, z, L.r, L.size, L.dense);
  } else {
    int x, y, blk;
    coords_2d(L, id, &x, &y, &blk);
    idx = grid_index2(x, y, L.r, L.size, L.dense);
  }
  return L.perm ? __ldg(L.perm + idx) : static_cast<int>(idx);
}

// count and place: a block takes kPerThread * kThreads consecutive ids, and
// blocks start in the order of their ids, so the place pass claims each
// segment's slots in nearly the order of its ids
__global__ void __launch_bounds__(kThreads) count_kernel(const Level L, int* __restrict__ counts) {
  const long long base = static_cast<long long>(blockIdx.x) * kPerThread * kThreads;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long id = base + j * kThreads + threadIdx.x;
    if (id < L.v) atomicAdd(counts + vertex_key(L, static_cast<int>(id)), 1);
  }
}

// blockIdx.y: the pass, which places the keys of its share of [0, size)
__global__ void __launch_bounds__(kThreads) place_kernel(const Level L, int* __restrict__ cursor,
                                                         int* __restrict__ ids) {
  const long long base = static_cast<long long>(blockIdx.x) * kPerThread * kThreads;
  const int lo = static_cast<int>(static_cast<long long>(L.size) * blockIdx.y / gridDim.y);
  const int hi = static_cast<int>(static_cast<long long>(L.size) * (blockIdx.y + 1) / gridDim.y);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long id = base + j * kThreads + threadIdx.x;
    if (id < L.v) {
      const int i = static_cast<int>(id);
      const int key = vertex_key(L, i);
      if (key >= lo && key < hi) ids[atomicAdd(cursor + key, 1)] = i;
    }
  }
}

// A scan status word: the tile's (vertex count, entry count) or their
// inclusive prefix, bits 0-31 and 32-61, and its flag, bits 62-63 (0: not
// published yet; the words are zeroed for every build).
__device__ __forceinline__ void publish(unsigned long long* status, int tile, unsigned flag,
                                        unsigned sum, unsigned ord) {
  const unsigned long long w = (static_cast<unsigned long long>(flag) << 62) |
                               (static_cast<unsigned long long>(ord) << 32) | sum;
  *reinterpret_cast<volatile unsigned long long*>(status + tile) = w;
}

// Warp 0 of the block that holds `tile` > 0: the (vertex, entry) counts of
// every tile before it.  Lane k reads tile end - k; a window with an
// inclusive prefix ends the walk at its nearest one.
__device__ void look_back(const unsigned long long* status, int tile, int lane, unsigned* sum,
                          unsigned* ord) {
  unsigned es = 0, eo = 0;
  for (int end = tile - 1;; end -= 32) {
    const int idx = end - lane;
    unsigned flag = kPrefix, s = 0, o = 0;  // before tile 0: a prefix of 0
    if (idx >= 0) {
      const volatile unsigned long long* p = status + idx;
      unsigned long long w;
      while ((w = *p) >> 62 == 0) __nanosleep(32);
      flag = static_cast<unsigned>(w >> 62);
      s = static_cast<unsigned>(w);
      o = static_cast<unsigned>(w >> 32) & 0x3fffffffu;
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, flag == kPrefix);
    if (prefixes) {
      const int nearest = __ffs(prefixes) - 1;
      *sum = es + __reduce_add_sync(0xffffffffu, lane <= nearest ? s : 0u);
      *ord = eo + __reduce_add_sync(0xffffffffu, lane <= nearest ? o : 0u);
      return;
    }
    es += __reduce_add_sync(0xffffffffu, s);
    eo += __reduce_add_sync(0xffffffffu, o);
  }
}

// counts[size] -> each key's first slot (in place: the place pass's
// cursors); per key with vertices, at its entry ordinal: cum (its first slot)
// and entry_values (the key, through inv).  work: [0] the tile claims, [1]
// n_entries, [2] the largest count.
__global__ void __launch_bounds__(kThreads)
scan_kernel(int* __restrict__ counts, int size, int tiles, const int* __restrict__ inv,
            int* __restrict__ cum, int* __restrict__ values, unsigned long long* status,
            int* work) {
  __shared__ unsigned warp_sum[kWarps], warp_ord[kWarps];
  __shared__ unsigned s_sum, s_ord;
  __shared__ int s_tile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(work, 1);   // tiles in claim order: the look-back cannot hang
  __syncthreads();
  const int tile = s_tile;
  const long long k0 = static_cast<long long>(tile) * kScanTile + t * kItems;
  int c[kItems];
  if (k0 + kItems <= size) {
    const int4* p = reinterpret_cast<const int4*>(counts + k0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 x = p[q];
      c[4 * q] = x.x; c[4 * q + 1] = x.y; c[4 * q + 2] = x.z; c[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) c[j] = k0 + j < size ? counts[k0 + j] : 0;
  }
  unsigned s = 0, o = 0;
  int most = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    s += c[j];
    o += c[j] > 0;
    most = max(most, c[j]);
  }
  unsigned is = s, io = o;   // inclusive warp scans
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned us = __shfl_up_sync(0xffffffffu, is, d), uo = __shfl_up_sync(0xffffffffu, io, d);
    if (lane >= d) {
      is += us;
      io += uo;
    }
  }
  most = __reduce_max_sync(0xffffffffu, most);
  if (lane == 31) {
    warp_sum[warp] = is;
    warp_ord[warp] = io;
  }
  if (lane == 0 && most > 0) atomicMax(work + 2, most);
  __syncthreads();
  unsigned bs = 0, bo = 0, as = 0, ao = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    bs += w < warp ? warp_sum[w] : 0u;
    bo += w < warp ? warp_ord[w] : 0u;
    as += warp_sum[w];
    ao += warp_ord[w];
  }
  if (t == 0) publish(status, tile, tile == 0 ? kPrefix : kAggregate, as, ao);
  if (warp == 0) {
    unsigned es = 0, eo = 0;
    if (tile > 0) look_back(status, tile, lane, &es, &eo);
    if (lane == 0) {
      if (tile > 0) publish(status, tile, kPrefix, es + as, eo + ao);
      if (tile == tiles - 1) work[1] = static_cast<int>(eo + ao);
      s_sum = es;
      s_ord = eo;
    }
  }
  __syncthreads();
  unsigned slot = s_sum + bs + is - s, ord = s_ord + bo + io - o;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (k0 + j >= size) break;
    counts[k0 + j] = static_cast<int>(slot);
    if (c[j] > 0) {
      const int key = static_cast<int>(k0 + j);
      cum[ord] = static_cast<int>(slot);
      values[ord] = inv ? __ldg(inv + key) : key;
      ++ord;
    }
    slot += c[j];
  }
}

// Sort buf[0, n) ascending, n <= kCap, by the 32 lanes of a warp.
__device__ void warp_sort(int* buf, int n, int lane) {
  int quiet = 0;
  for (int round = 0; round < kRounds && quiet < 2; ++round) {
    bool swapped = false;
    for (int i = 2 * lane + (round & 1); i + 1 < n; i += 64) {
      const int a = buf[i], b = buf[i + 1];
      if (a > b) {
        buf[i] = b;
        buf[i + 1] = a;
        swapped = true;
      }
    }
    quiet = __any_sync(0xffffffffu, swapped) ? 0 : quiet + 1;
    __syncwarp();
  }
  if (quiet >= 2) return;
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = n + lane; i < p; i += 32) buf[i] = INT_MAX;
  __syncwarp();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < p; i += 32) {
        const int l = i ^ j;
        if (l > i) {
          const int a = buf[i], b = buf[l];
          if ((a > b) == ((i & k) == 0)) {
            buf[i] = b;
            buf[l] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Slot i's outputs from its vertex id: vert_entry, and pos_flat (3D) or
// coords and block_id (2D).
__device__ __forceinline__ void write_slot(const Level& L, long long i, int id, int e,
                                           int* vert_entry, int* pos, int* block_id) {
  vert_entry[i] = e;
  if (L.d == 3) {
    pos[i] = id;
  } else {
    int x, y, blk;
    coords_2d(L, id, &x, &y, &blk);
    pos[i] = (x << 16) | y;
    block_id[i] = blk;
  }
}

// ids: the placed ids (pos in 3D, block_id in 2D).  A warp a segment of at
// most kCap ids; then the entries past n_entries parked.
__global__ void __launch_bounds__(kThreads)
order_kernel(const Level L, const int* work, int e_max, const int* __restrict__ inv, int* cum,
             int* values, const int* ids, int* vert_entry, int* pos, int* block_id) {
  __shared__ int sbuf[kWarps][kCap];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_entries = work[1];
  const int warps = gridDim.x * kWarps;
  int* buf = sbuf[warp];
  for (int e = blockIdx.x * kWarps + warp; e < n_entries; e += warps) {
    const int start = cum[e], end = e + 1 < n_entries ? cum[e + 1] : L.v;
    const int n = end - start;
    if (n > kCap) continue;   // the wrapper's long-segment path
    for (int i = lane; i < n; i += 32) buf[i] = ids[start + i];
    __syncwarp();
    warp_sort(buf, n, lane);
    for (int i = lane; i < n; i += 32)
      write_slot(L, static_cast<long long>(start) + i, buf[i], e, vert_entry, pos, block_id);
    __syncwarp();
  }
  const int fill = inv ? __ldg(inv) : 0;
  for (int e = n_entries + blockIdx.x * kThreads + threadIdx.x; e <= e_max;
       e += gridDim.x * kThreads) {
    cum[e] = L.v;
    if (e < e_max) values[e] = fill;
  }
}

// The long segments: tiles[t] = (first slot, ids) of a tile of at most kCap
// ids of one segment, a warp a tile.
__global__ void tile_sort_kernel(const int2* __restrict__ tiles, int* ids) {
  __shared__ int buf[kCap];
  const int lane = threadIdx.x;
  const int2 tl = tiles[blockIdx.x];
  for (int i = lane; i < tl.y; i += 32) buf[i] = ids[tl.x + i];
  __syncwarp();
  warp_sort(buf, tl.y, lane);
  for (int i = lane; i < tl.y; i += 32) ids[tl.x + i] = buf[i];
}

// One merge pass over the long segments, runs of `width` ids into runs of
// 2 width: segs[s] = (first slot, ids, entry), first[s] the segment's first
// element in [0, total), first[n_segs] = total.  Element p of a run moves to
// the merged run's start plus p's place in its run plus the count of the
// partner run's ids below it (the ids are distinct).
__global__ void merge_pass_kernel(const int* __restrict__ src, int* __restrict__ dst,
                                  const int3* __restrict__ segs, const int* __restrict__ first,
                                  int n_segs, int total, int width) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  int lo = 0, hi = n_segs;   // the last segment whose first element is <= g
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= g) lo = mid; else hi = mid;
  }
  const int3 sg = segs[lo];
  const int p = g - first[lo];
  const int run = p / width, run0 = run * width;
  const int p0 = (run ^ 1) * width, p1 = min(p0 + width, sg.y);
  const int x = src[sg.x + p];
  int below = 0;
  if (p0 < sg.y) {
    int a = p0, b = p1;   // lower bound of x in the partner run
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (src[sg.x + mid] < x) a = mid + 1; else b = mid;
    }
    below = a - p0;
  }
  dst[sg.x + min(run0, p0) + (p - run0) + below] = x;
}

__global__ void long_write_kernel(const Level L, const int* src, const int3* __restrict__ segs,
                                  const int* __restrict__ first, int n_segs, int total,
                                  int* vert_entry, int* pos, int* block_id) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  int lo = 0, hi = n_segs;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= g) lo = mid; else hi = mid;
  }
  const long long i = static_cast<long long>(segs[lo].x) + g - first[lo];
  write_slot(L, i, src[i], segs[lo].z, vert_entry, pos, block_id);
}

__global__ void dense_level_kernel(const int* __restrict__ perm, int v, int r,
                                   int* __restrict__ pos_flat, int* __restrict__ vert_entry,
                                   int* __restrict__ values, int* __restrict__ cum) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e > v) return;
  cum[e] = e;
  if (e == v) return;
  const int p = perm[e];            // dense table index x + y*r + z*r^2
  const int x = p % r, y = (p / r) % r, z = p / (r * r);
  pos_flat[e] = (x * r + y) * r + z;  // vertex id, last axis fastest
  vert_entry[e] = e;
  values[e] = p;
}

int scan_tiles(long long size) { return static_cast<int>((size + kScanTile - 1) / kScanTile); }

// The scratch of a build: work [4] (claims, n_entries, largest count, pad),
// the status words (an even count of int64), then counts [size] on a 16-byte
// boundary.
long long counts_offset(long long size) { return 4 + 4 * ((scan_tiles(size) + 1) / 2); }

Level make_level(long long v, int d, int r, int size, int tile, int rb, const int* perm) {
  Level L{};
  L.v = static_cast<int>(v);
  L.d = d;
  L.r = r;
  L.size = size;
  L.tile = tile;
  L.rb = rb;
  L.perm = perm;
  if (d == 3) {
    L.dense = static_cast<long long>(r) * r * r <= size;
    L.div_rr = make_fastdiv(static_cast<unsigned>(r) * r);
    L.div_r = make_fastdiv(static_cast<unsigned>(r));
  } else {
    L.dense = static_cast<long long>(r) * r <= size;
    L.div_block = make_fastdiv(static_cast<unsigned>((tile + 2) * (tile + 2)));
    L.div_side = make_fastdiv(static_cast<unsigned>(tile + 2));
    L.div_rb = make_fastdiv(static_cast<unsigned>(rb));
  }
  return L;
}

bool level_ok(long long v, int d, int r, int size, int tile, int rb) {
  return v >= 0 && v <= 0x7fffffffLL && size >= 1 && size < (1 << 30) && r >= 1 &&
         ((d == 3 && static_cast<long long>(r) * r * r == v) ||
          (d == 2 && tile >= 0 && rb >= 1 &&
           static_cast<long long>(rb) * rb * (tile + 2) * (tile + 2) == v));
}

int resident_blocks(const void* kernel) {
  int dev = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

}  // namespace

// The int32 words of a build's scratch for a table of `size` keys, to be
// zeroed before each build; words 1 and 2 then hold n_entries and the
// largest count (the longest segment).
CNC_EXPORT long long cnc_vertex_scratch_words(long long size) {
  return counts_offset(size) + size;
}

// The segment length above which cnc_vertex_long_segments must run.
CNC_EXPORT int cnc_vertex_segment_cap() { return kCap; }

// One hashed level, four launches: count, scan, place, order.  d = 3: the
// raster vertices of an r^3 lattice; d = 2: the block lattice (tile, rb).
// perm [size] int32 or null; inv [size] int32 or null (values through it).
// scratch [cnc_vertex_scratch_words(size)] zeroed.  Out: cum [e_max + 1],
// values [e_max], vert_entry [v], pos [v] (pos_flat in 3D, coords in 2D),
// block_id [v] (2D only, else null).  Segments above the cap are left to
// cnc_vertex_long_segments (pos in 3D, block_id in 2D then hold their ids
// in place order).
CNC_EXPORT int cnc_vertex_tables(long long v, int d, int r, int size, int tile, int rb,
                                 const int* perm, const int* inv, int e_max, int* scratch,
                                 int* cum, int* values, int* vert_entry, int* pos, int* block_id,
                                 void* stream) {
  if (!level_ok(v, d, r, size, tile, rb) || e_max < 0 || (d == 2) != (block_id != nullptr) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Level L = make_level(v, d, r, size, tile, rb, perm);
  int* work = scratch;
  auto* status = reinterpret_cast<unsigned long long*>(scratch + 4);
  int* counts = scratch + counts_offset(size);
  int* ids = d == 3 ? pos : block_id;
  const int resident = resident_blocks(reinterpret_cast<const void*>(order_kernel));
  if (resident <= 0) {
    const int rc = cnc_last_error();
    return rc ? rc : static_cast<int>(cudaErrorUnknown);
  }
  const unsigned grid = cnc_blocks(v, kPerThread * kThreads);
  if (v > 0) {
    count_kernel<<<grid, kThreads, 0, s>>>(L, counts);
    if (const int rc = cnc_last_error()) return rc;
  }
  const int tiles = scan_tiles(size);
  scan_kernel<<<tiles, kThreads, 0, s>>>(counts, size, tiles, inv, cum, values, status, work);
  if (const int rc = cnc_last_error()) return rc;
  if (v > 0) {
    place_kernel<<<dim3(grid, kPlacePasses), kThreads, 0, s>>>(L, counts, ids);
    if (const int rc = cnc_last_error()) return rc;
  }
  const unsigned order_grid = static_cast<unsigned>(
      std::min<long long>(cnc_blocks(static_cast<long long>(e_max) + 1, kWarps), 4LL * resident));
  order_kernel<<<order_grid, kThreads, 0, s>>>(L, work, e_max, inv, cum, values, ids, vert_entry,
                                               pos, block_id);
  return cnc_last_error();
}

// The segments above the cap of one level after cnc_vertex_tables: segs
// [n_segs] int3 (first slot, ids, entry ordinal), first [n_segs + 1] their
// elements' prefix (first[n_segs] = total), tiles [n_tiles] int2 (first
// slot, ids <= the cap) covering them; passes the merge passes (the
// longest segment <= cap * 2^passes).  The ids sit in pos (3D) or block_id
// (2D); vert_entry is the other buffer of the merges.
CNC_EXPORT int cnc_vertex_long_segments(long long v, int d, int r, int size, int tile, int rb,
                                        const int* segs, const int* first, int n_segs, int total,
                                        const int* tiles, int n_tiles, int passes,
                                        int* vert_entry, int* pos, int* block_id, void* stream) {
  if (!level_ok(v, d, r, size, tile, rb) || n_segs < 0 || total < 0 || n_tiles < 0 ||
      passes < 0 || (d == 2) != (block_id != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_segs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Level L = make_level(v, d, r, size, tile, rb, nullptr);
  int* a = d == 3 ? pos : block_id;
  int* b = vert_entry;
  tile_sort_kernel<<<n_tiles, 32, 0, s>>>(reinterpret_cast<const int2*>(tiles), a);
  if (const int rc = cnc_last_error()) return rc;
  const unsigned blocks = cnc_blocks(total, kThreads);
  const auto* sg = reinterpret_cast<const int3*>(segs);
  for (int k = 0, width = kCap; k < passes; ++k, width *= 2) {
    merge_pass_kernel<<<blocks, kThreads, 0, s>>>(a, b, sg, first, n_segs, total, width);
    if (const int rc = cnc_last_error()) return rc;
    std::swap(a, b);
  }
  long_write_kernel<<<blocks, kThreads, 0, s>>>(L, a, sg, first, n_segs, total, vert_entry, pos,
                                                block_id);
  return cnc_last_error();
}

// A dense 3D level: perm [v] int32 (v = r^3); out pos_flat, vert_entry,
// values [v] and cum [v + 1].
CNC_EXPORT int cnc_dense_level(const int* perm, int v, int r, int* pos_flat, int* vert_entry,
                               int* values, int* cum, void* stream) {
  dense_level_kernel<<<cnc_blocks(v + 1, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      perm, v, r, pos_flat, vert_entry, values, cum);
  return cnc_last_error();
}
