// K3: stream compaction of a boolean mask, one launch, single pass.
//
// Replaces: cnc_tpu/ops/scatter_ops.py compact_mask_indices (146-161), a
// cumsum plus a unique-index scatter in XLA.
// Plain twin: cnc_torch/ops/scatter_ops.py `_compact_plain`.
//
// Computes the positions of the first `cap` set bytes of mask[n] in ascending
// order into src[cap] (zero past the count) and the total count (NOT clamped
// to cap) into count[0], all on the device: no host sync.
//
// Bound on the H100: bytes.  The mask is read once (n bytes) and src written
// once (cap * 4 bytes): at the 3D rate context (n 11,352,091, cap 2^21)
// about 19.7 MB, 5.9 us at 3.35 TB/s; at the pn coord lists (n 512^3, cap
// 2^24) 201 MB, 60 us.
//
// Design: decoupled look-back.  Tiles of kTile bytes are claimed in order
// from a device counter by a grid of at most as many blocks as the card holds
// at once; each block loops over tiles.  A thread turns its 64 bytes (four
// 16-byte loads, all in flight before the first use; byte by byte where an
// unaligned base or the end of the mask cuts them) into two 32-bit masks in
// registers (cnc_byte_bits16); its rank comes from a warp shuffle scan of the
// threads' popcounts and the block's warp totals, and its positions go to
// shared memory as 16-bit offsets in the tile.  Thread 0 publishes the
// tile's count (for tile 0, its prefix) in one 64-bit status word; warp 0
// then walks back over its predecessors' words 32 at a time until it meets
// an inclusive prefix, and publishes its own.  The block stores its staged
// positions as one contiguous run, and nothing once the tile's exclusive
// prefix reaches cap.
//
// In design rounds on the H100 (PERF.md), 64 bytes a thread beat 32 and 128;
// claiming the next tile before this one's look-back, a look-back window of
// 256 tiles (8 words a lane) and a backed-off wait were each slower or no
// faster.
//
// The zero fill of [min(count, cap), cap) needs the total.  Once the tiles
// run out, every block waits for the last tile's prefix and clears its share
// of that range with 16-byte stores.  Waiting cannot hang: when a block finds
// no tile left, every tile has been claimed by a running block, and each
// tile waits only on tiles claimed before it.  A cudaMemsetAsync of src first
// would write the cap words twice and add a device operation; the last tile
// filling the range alone would leave one block to clear up to 64 MiB at the
// pn site.  So a compaction is one device operation.
//
// The status words carry the launch's tag (the epoch word, plus one), so no
// launch needs them cleared; the launch's last claim of the counter resets it
// and advances the epoch.  Words, counter and epoch are scratch the wrapper
// keeps per device and stream: launches on one stream run one at a time.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMasks = 2;                    // 32-bit masks per thread and tile
constexpr int kBytes = 32 * kMasks;          // four 16-byte loads a thread
constexpr int kTile = kThreads * kBytes;     // 16,384 bytes
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAggregate = 1, kPrefix = 2;
constexpr unsigned kTagMod = (1u << 30) - 1;  // tags 1 .. 2^30 - 1
constexpr long long kMaxN = 0x7fffffffLL;    // positions are int32

// A status word: the tile's count or inclusive prefix (bits 0-31), its flag
// (32-33) and the launch's tag (34-63).  A word with another tag is not ready.
__device__ __forceinline__ void publish(unsigned long long* status, int tile, unsigned tag,
                                        unsigned flag, unsigned value) {
  const unsigned long long w = (static_cast<unsigned long long>(tag) << 34) |
                               (static_cast<unsigned long long>(flag) << 32) | value;
  *reinterpret_cast<volatile unsigned long long*>(status + tile) = w;
}

// Spin until tile's word carries `tag` (and, with want_prefix, the prefix flag).
__device__ __forceinline__ unsigned long long wait_word(const unsigned long long* status,
                                                        int tile, unsigned tag,
                                                        bool want_prefix) {
  const volatile unsigned long long* p = status + tile;
  for (;;) {
    const unsigned long long w = *p;
    if (static_cast<unsigned>(w >> 34) == tag &&
        (!want_prefix || static_cast<unsigned>(w >> 32 & 3) == kPrefix))
      return w;
    __nanosleep(32);
  }
}

// Warp 0 of the block that holds `tile` > 0: the count of every tile before
// it.  Lane k reads tile end - k; a window with an inclusive prefix ends the
// walk at its nearest one.
__device__ unsigned look_back(const unsigned long long* status, int tile, unsigned tag,
                              int lane) {
  unsigned excl = 0;
  for (int end = tile - 1;; end -= 32) {
    const int idx = end - lane;
    unsigned flag = kPrefix, value = 0;  // before tile 0: a prefix of 0
    if (idx >= 0) {
      const unsigned long long w = wait_word(status, idx, tag, false);
      flag = static_cast<unsigned>(w >> 32 & 3);
      value = static_cast<unsigned>(w);
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, flag == kPrefix);
    if (prefixes) {
      const int nearest = __ffs(prefixes) - 1;
      return excl + __reduce_add_sync(0xffffffffu, lane <= nearest ? value : 0u);
    }
    excl += __reduce_add_sync(0xffffffffu, value);
  }
}

// One claim of the tile counter.  Each block makes exactly one claim that
// finds no tile left, so the claim numbered `last` is the launch's last: it
// resets the counter and advances the epoch.
__device__ __forceinline__ int claim(unsigned* work, unsigned last) {
  const unsigned t = atomicAdd(work, 1u);
  if (t == last) {
    __threadfence();
    atomicExch(work, 0u);
    atomicAdd(work + 1, 1u);
  }
  return static_cast<int>(t);
}

// The stage's slot of a tile's r-th position: a 4-byte pad after every 64
// slots (32 words).  Where a run of the mask is all set, thread t's ranks
// start at 64 t and every lane of a warp would write the same bank; the pad
// gives each lane its own.  Without it chip_smoke.py read the 3D context at
// step 16 (78% of the mask set, in long runs) at 0.0390 device ms on the H100
// (PERF.md).
__device__ __forceinline__ int stage_slot(int r) { return r + ((r >> 6) << 1); }

__global__ void __launch_bounds__(kThreads)
compact_kernel(const unsigned char* __restrict__ mask, long long n, int cap, int tiles,
               int* __restrict__ src, int* __restrict__ count,
               unsigned long long* __restrict__ status, unsigned* __restrict__ work) {
  __shared__ unsigned short stage[kTile + kTile / 32];  // the tile's positions, as offsets in it
  __shared__ int warp_total[kWarps];
  __shared__ int s_tile, s_excl, s_total;
  __shared__ unsigned s_tag;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned last_claim = static_cast<unsigned>(tiles) + gridDim.x - 1;
  if (tid == 0) {
    s_tag = *reinterpret_cast<volatile unsigned*>(work + 1) % kTagMod + 1;
    __threadfence();  // the epoch is read before this block's first claim
    s_tile = claim(work, last_claim);
    s_total = -1;
  }
  __syncthreads();
  const unsigned tag = s_tag;
  // tiles cover [0, n + a) from the 16-byte aligned `am`: byte v is mask[v - a]
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(mask) & 15);
  const unsigned char* am = mask - a;
  const long long nv = n + a;

  for (;;) {
    const int tile = s_tile;
    if (tile >= tiles) break;
    const long long tile_v = static_cast<long long>(tile) * kTile;
    const long long v0 = tile_v + tid * kBytes;
    unsigned bits[kMasks];
    if (v0 >= a && v0 + kBytes <= nv) {  // every load in flight before the first use
      const uint4* p = reinterpret_cast<const uint4*>(am + v0);
      uint4 raw[2 * kMasks];
#pragma unroll
      for (int k = 0; k < 2 * kMasks; ++k) raw[k] = __ldg(p + k);
#pragma unroll
      for (int m = 0; m < kMasks; ++m)
        bits[m] = cnc_byte_bits16(raw[2 * m]) | cnc_byte_bits16(raw[2 * m + 1]) << 16;
    } else {  // the bytes an unaligned base or the end of the mask cuts
#pragma unroll
      for (int m = 0; m < kMasks; ++m) {
        bits[m] = 0;
        for (int j = 0; j < 32; ++j) {
          const long long v = v0 + 32 * m + j;
          if (v >= a && v < nv && am[v] != 0) bits[m] |= 1u << j;
        }
      }
    }
    int c = 0;
#pragma unroll
    for (int m = 0; m < kMasks; ++m) c += __popc(bits[m]);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int before = 0, agg = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = warp_total[w];
      before += w < warp ? x : 0;
      agg += x;
    }
    if (tid == 0) publish(status, tile, tag, tile == 0 ? kPrefix : kAggregate, agg);
    int r = before + incl - c;
#pragma unroll
    for (int m = 0; m < kMasks; ++m)
      for (unsigned b = bits[m]; b; b &= b - 1)
        stage[stage_slot(r++)] = static_cast<unsigned short>(tid * kBytes + 32 * m + __ffs(b) - 1);
    if (warp == 0) {
      const unsigned excl = tile == 0 ? 0u : look_back(status, tile, tag, lane);
      if (lane == 0) {
        if (tile > 0) publish(status, tile, tag, kPrefix, excl + agg);
        s_excl = static_cast<int>(excl);
        if (tile == tiles - 1) {
          *count = static_cast<int>(excl + agg);
          s_total = static_cast<int>(excl + agg);
        }
      }
    }
    __syncthreads();
    const int excl = s_excl;
    if (excl < cap) {
      const long long pos0 = tile_v - a;
      const int m = min(agg, cap - excl);
      for (int i = tid; i < m; i += kThreads)
        src[excl + i] = static_cast<int>(pos0 + stage[stage_slot(i)]);
    }
    // the next tile; the stage, s_excl and s_tile are next written after the
    // next tile's first barrier, which every thread reaches after these reads
    if (tid == 0) s_tile = claim(work, last_claim);
    __syncthreads();
  }

  // every block: wait for the total, then clear its share of [min(total, cap), cap)
  if (tid == 0 && s_total < 0) {
    if (tiles == 0) {
      s_total = 0;
      if (blockIdx.x == 0) *count = 0;
    } else {
      s_total = static_cast<int>(wait_word(status, tiles - 1, tag, true));
    }
  }
  __syncthreads();
  const long long lo = min(s_total, cap);
  const long long head = min((lo + 3) & ~3LL, static_cast<long long>(cap));
  const long long body = (cap - head) >> 2;  // int4 stores from head (src is 16-byte aligned)
  const long long tail = head + body * 4;
  const long long gt = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const long long gs = static_cast<long long>(gridDim.x) * kThreads;
  if (gt < head - lo) src[lo + gt] = 0;
  int4* zeros = reinterpret_cast<int4*>(src + head);
  for (long long j = gt; j < body; j += gs) zeros[j] = make_int4(0, 0, 0, 0);
  if (gt < cap - tail) src[tail + gt] = 0;
}

// Blocks resident at once on the current device (the grid's most).
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_kernel, kThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

}  // namespace

// The int64 status words a stream's scratch needs: one per tile of the
// largest mask the kernel takes (2^31 - 1 bytes).
CNC_EXPORT long long cnc_compact_scratch() { return (kMaxN + kTile) / kTile; }

// mask [n] uint8 (bool; any byte alignment), src [cap] int32 (16-byte
// aligned), count [1] int32, status [cnc_compact_scratch()] int64 and work
// [2] int32 (the claim counter and the epoch), both zeroed once when the
// scratch is made; all on the device.  n < 2^31, cap >= 0.
CNC_EXPORT int cnc_compact_mask(const unsigned char* mask, long long n, int cap, int* src,
                                int* count, unsigned long long* status, unsigned* work,
                                void* stream) {
  if (n < 0 || n > kMaxN || cap < 0 || (reinterpret_cast<uintptr_t>(src) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long a = static_cast<long long>(reinterpret_cast<uintptr_t>(mask) & 15);
  const long long tiles = n ? (n + a + kTile - 1) / kTile : 0;
  const int resident = resident_blocks();
  if (resident <= 0) {
    const int rc = cnc_last_error();
    return rc ? rc : static_cast<int>(cudaErrorUnknown);
  }
  const long long blocks = tiles < 1 ? 1 : (tiles < resident ? tiles : resident);
  compact_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(mask, n, cap, static_cast<int>(tiles),
                                                        src, count, status, work);
  return cnc_last_error();
}
