// K6: masked per-segment sums of single floats, the backward of
// segment_gather (each 3D context row's level probability, 2^21 rows into a
// dozen level segments), and the gather itself.
//
// Replaces: cnc_tpu/models/context_models.py _segment_tail_values (123-140),
// one XLA scatter-add of the masked rows into [num_segments] zeros with
// invalid rows routed out of range and dropped.  Plain twin:
// cnc_torch/ops/context_ops.py `_segment_pool_plain`.
//
// out[seg[i]] += x[i] for every row with valid[i] and seg[i] in
// [0, num_segments); the wrapper zeroes out.  The rows come in long runs of
// equal ids, in any order.
//
// Bound on the H100: bytes (x, seg and valid read once, out written once; at
// 2^21 rows about 19 MB, 6 us).  What costs in practice is the adds that
// meet on one word, and each such add rounds at the size of the whole sum:
// a segment of 10^6 rows summed in 3 x 10^4 adds of warp sums can land
// 1e-5 of the sum away from the exact one.  So each block reduces its tile of
// SP_THREADS x SP_ROWS rows first: every thread sums its SP_ROWS rows,
// adding out a run that ends inside them; a segmented scan by warp shuffles
// joins the lanes' last runs, and one over the warps' last runs in shared
// memory joins those; a run's last lane adds its sum, so a run inside one
// tile costs one atomicAdd.  Runs that cross a tile meet in the atomics, so
// the order of the f32 adds, and the last bits, vary from run to run.
//
// The gather: d_x[i] = valid[i] ? g[seg[i]] : 0, segment_gather's forward.
//
// K6m, segment_mean: the pooling of one call site in one pass,
//   pooled[s, :] = sum_i w_i x[i, :] / max(sum_i den[i], min_den),
//   covered[s]   = sum_i den[i] > 0,
// over the live rows i of segment s (valid, id in range), with w_i = den[i]
// for the overlap-weighted sites and 1 for the count sites.  It replaces the
// two or three K6 launches, the memsets and the clamp / divide / compare of
// each site (cnc_tpu's _segment_tail_values pairs at context_models.py
// 1025-1043 and 1346-1357).  Plain twin: context_ops `_segment_mean_plain`.
//
// The ids of the live rows must not decrease (each site's rows are sorted by
// entry; padding and invalid rows may carry any id).  Under that order the
// pooling is a reduce-by-key with the monoid
//   (k1, s1) + (k2, s2) = k2 > k1 ? (k2, s2) : k2 == k1 ? (k1, s1 + s2) : (k1, s1)
// on (the last live id so far, the sum of that id's rows), dead rows being
// (-1, 0).  At most 256 blocks each take a run of consecutive tiles of 2048
// rows (256 threads x 8 rows, read as float4 where aligned) and scan them in
// order, carrying the sum from tile to tile; a live row whose id differs
// from the scan's id before it heads a run and closes the run before it,
// whose sum the exclusive scan holds, and writes the empty segments between
// the two.  Runs that may touch the block's edges (its first run, and its
// last) go to a per-block record; the last block to finish (a device
// counter, reset by that block) scans the records in order and writes those
// segments and the empty ones between blocks; the empty ones after the last
// live id are written by every block at the start when the last row is live
// (a compacted buffer cut at its budget), else by the last block.  So every
// output element is written exactly once, with no atomics on the data and
// no memset, and the sums' order is fixed: two runs give the same bits.  A
// live id below the id before it sets *fault (a device word the caller
// reads when it likes; no host sync here).
//
// Bound on the H100: bytes.  At the 3D site (2^21 rows of F=4 into about
// 2e5 entries) x, den, seg and valid are read once (25 B a row) and 25 B per
// segment written: about 54 MB, 16 us.  One tile per block (1,024 blocks in
// one wave, two resident per SM) spent most of its time in each block's
// chain of load, scan and walk latencies and in a four-round combine; runs
// of tiles per block overlap those chains and leave one round.
//
// Its backward is one gather: d_x[i, :] = live_i w_i g[seg_i, :] / max(D_s, min_den)
// with the per-segment den sums D kept from the forward.

#include "common.cuh"

namespace {

constexpr int SP_THREADS = 256;
constexpr int SP_ROWS = 8;

// A segmented inclusive scan of v over the warp's runs of equal keys (a lane
// heads a run when its key differs from the lane before it).  Returns
// whether this lane ends its run; its v is then the run's sum.
__device__ __forceinline__ bool warp_run_sum(int key, float& v, int lane) {
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != key);
  const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane - o >= start) v += u;
  }
  return lane == 31 || ((heads >> (lane + 1)) & 1u);
}

__global__ void __launch_bounds__(SP_THREADS)
segment_pool_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                    const unsigned char* __restrict__ valid, float* __restrict__ out,
                    long long n, int num_segments) {
  __shared__ int warp_key[SP_THREADS / 32];
  __shared__ float warp_sum[SP_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first =
      (static_cast<long long>(blockIdx.x) * SP_THREADS + threadIdx.x) * SP_ROWS;
  // this thread's rows: the runs that end inside them are added out, the
  // last one is carried (key -1: no live row)
  int key = -1;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < SP_ROWS; ++k) {
    const long long i = first + k;
    if (i >= n || !valid[i]) continue;
    const int s = seg[i];
    if (s < 0 || s >= num_segments) continue;
    if (s != key) {
      if (key >= 0) atomicAdd(out + key, v);
      key = s;
      v = 0.f;
    }
    v += x[i];
  }
  const bool tail = warp_run_sum(key, v, lane);
  if (lane == 31) {
    warp_key[warp] = key;
    warp_sum[warp] = v;
  } else if (tail && key >= 0) {
    atomicAdd(out + key, v);
  }
  __syncthreads();
  if (warp == 0) {
    key = lane < SP_THREADS / 32 ? warp_key[lane] : -1;
    v = lane < SP_THREADS / 32 ? warp_sum[lane] : 0.f;
    if (warp_run_sum(key, v, lane) && key >= 0) atomicAdd(out + key, v);
  }
}

__global__ void segment_pool_backward_kernel(const float* __restrict__ g,
                                             const int* __restrict__ seg,
                                             const unsigned char* __restrict__ valid,
                                             float* __restrict__ d_x, long long n,
                                             int num_segments) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = seg[i];
  const bool live = valid[i] && s >= 0 && s < num_segments;
  d_x[i] = live ? g[s] : 0.f;
}


// ------------------------------------------------------------- segment_mean
constexpr int SM_THREADS = 256;
constexpr int SM_ROWS = 8;
constexpr int SM_TILE = SM_THREADS * SM_ROWS;
constexpr int SM_WARPS = SM_THREADS / 32;
// at most this many blocks, each over a run of consecutive tiles, so the
// last block combines one record per thread (two blocks fit an SM)
constexpr int SM_MAX_BLOCKS = SM_THREADS;
// a run of empty segments longer than this inside a tile is written by the
// whole block (up to SM_BIG_GAPS of them per tile), a shorter one by the
// thread that finds it
constexpr int SM_SMALL_GAP = 16;
constexpr int SM_BIG_GAPS = 64;

template <int F>
struct Agg {
  int key;        // the last live id so far, -1 before the first
  float s[F];     // the sum of that id's (weighted) rows
  float d;        // the sum of their den
};

template <int F>
__device__ __forceinline__ Agg<F> agg_identity() {
  Agg<F> a;
  a.key = -1;
#pragma unroll
  for (int f = 0; f < F; ++f) a.s[f] = 0.f;
  a.d = 0.f;
  return a;
}

// a = a + b, a before b
template <int F>
__device__ __forceinline__ void agg_add(Agg<F>& a, const Agg<F>& b) {
  if (b.key > a.key) {
    a = b;
  } else if (b.key == a.key) {
#pragma unroll
    for (int f = 0; f < F; ++f) a.s[f] += b.s[f];
    a.d += b.d;
  }
}

template <int F>
__device__ __forceinline__ Agg<F> agg_shfl_up(const Agg<F>& a, int o) {
  Agg<F> r;
  r.key = __shfl_up_sync(0xffffffffu, a.key, o);
#pragma unroll
  for (int f = 0; f < F; ++f) r.s[f] = __shfl_up_sync(0xffffffffu, a.s[f], o);
  r.d = __shfl_up_sync(0xffffffffu, a.d, o);
  return r;
}

// Exclusive scan of one Agg per thread over the block (SM_THREADS threads);
// *total (shared) gets the block's sum.  `warp_sums` holds SM_WARPS entries;
// two calls in a row take two different buffers (no barrier at the end).
template <int F>
__device__ Agg<F> block_exclusive_scan(const Agg<F>& v, Agg<F>* warp_sums, Agg<F>* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Agg<F> inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Agg<F> t = agg_shfl_up(inc, o);
    if (lane >= o) {
      agg_add(t, inc);
      inc = t;
    }
  }
  Agg<F> exc = agg_shfl_up(inc, 1);
  if (lane == 0) exc = agg_identity<F>();
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Agg<F> w = lane < SM_WARPS ? warp_sums[lane] : agg_identity<F>();
    Agg<F> wi = w;
#pragma unroll
    for (int o = 1; o < SM_WARPS; o <<= 1) {
      Agg<F> t = agg_shfl_up(wi, o);
      if (lane >= o) {
        agg_add(t, wi);
        wi = t;
      }
    }
    Agg<F> we = agg_shfl_up(wi, 1);
    if (lane == 0) we = agg_identity<F>();
    __syncwarp();
    if (lane < SM_WARPS) warp_sums[lane] = we;
    if (lane == SM_WARPS - 1) *total = wi;
  }
  __syncthreads();
  Agg<F> out = warp_sums[warp];
  agg_add(out, exc);
  return out;
}

// The same for ints under +; *total is shared too.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < SM_WARPS ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < SM_WARPS; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    __syncwarp();
    if (lane < SM_WARPS) warp_sums[lane] = wi - w;
    if (lane == SM_WARPS - 1) *total = wi;
  }
  __syncthreads();
  const int out = warp_sums[warp] + inc - v;
  __syncthreads();
  return out;
}

template <int F>
struct MeanOut {
  float* pooled;
  unsigned char* covered;
  float* den_sum;
  float min_den;
};

template <int F>
__device__ __forceinline__ void write_segment(const MeanOut<F>& o, int k, const float* s, float d) {
  const float c = fmaxf(d, o.min_den);
  if constexpr (F == 4) {
    *reinterpret_cast<float4*>(o.pooled + static_cast<long long>(k) * 4) =
        make_float4(s[0] / c, s[1] / c, s[2] / c, s[3] / c);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) o.pooled[static_cast<long long>(k) * F + f] = s[f] / c;
  }
  o.covered[k] = d > 0.f ? 1 : 0;
  o.den_sum[k] = d;
}

template <int F>
__device__ __forceinline__ void write_empty(const MeanOut<F>& o, int k) {
  if constexpr (F == 4) {
    *reinterpret_cast<float4*>(o.pooled + static_cast<long long>(k) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) o.pooled[static_cast<long long>(k) * F + f] = 0.f;
  }
  o.covered[k] = 0;
  o.den_sum[k] = 0.f;
}

// per-tile record: keys [2] (first live id, last live id) as ints, then the
// first run's sums (F + 1) and the tile's total (F + 1) as floats
template <int F>
struct TileRec {
  static constexpr int WORDS = 2 + 2 * (F + 1);
};

template <int F, bool WEIGHTED>
__global__ void __launch_bounds__(SM_THREADS, 2)
segment_mean_kernel(const float* __restrict__ x, const float* __restrict__ den,
                    const int* __restrict__ seg, const unsigned char* __restrict__ valid,
                    long long n, int num_segments, MeanOut<F> out, int* __restrict__ recs,
                    unsigned* __restrict__ counter, int* __restrict__ fault, bool vec,
                    long long tiles, long long tiles_per_block) {
  __shared__ Agg<F> warp_sums[2][SM_WARPS];
  __shared__ Agg<F> s_total;
  __shared__ int s_first_key;
  __shared__ float s_first_sum[F + 1];
  __shared__ int s_first_set;
  __shared__ bool s_last;
  __shared__ int s_gap_lo[SM_THREADS];
  __shared__ int s_gap_off[SM_THREADS + 1];
  __shared__ int s_isum[SM_WARPS];
  __shared__ int s_n_gap;
  __shared__ int s_n_big[2];
  __shared__ int s_big[2][SM_BIG_GAPS][2];
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_first_key = -1;
    s_first_set = 0;
    s_n_big[0] = s_n_big[1] = 0;
  }
  // when the last row is live, the empty segments after its id are known
  // now: every block writes its share of them
  const int tail_key = n > 0 ? seg[n - 1] : -1;
  const bool tail_live = n > 0 && valid[n - 1] && tail_key >= 0 && tail_key < num_segments;
  if (tail_live) {
    for (long long e = tail_key + 1 + static_cast<long long>(blockIdx.x) * SM_THREADS + tid;
         e < num_segments; e += static_cast<long long>(gridDim.x) * SM_THREADS)
      write_empty(out, static_cast<int>(e));
  }
  // this block's tiles, in order, with the sum so far carried between them
  Agg<F> carry = agg_identity<F>();
  int buf = 0;
  const long long t_end = min(tiles, (blockIdx.x + 1) * tiles_per_block);
  for (long long tile = blockIdx.x * tiles_per_block; tile < t_end; ++tile, buf ^= 1) {
    const long long row0 = tile * SM_TILE + static_cast<long long>(tid) * SM_ROWS;
    // ---- load this thread's 8 rows: id (-1 where dead), weighted values, den
    int key[SM_ROWS];
    float val[SM_ROWS][F];
    float dv[SM_ROWS];
    if (vec && row0 + SM_ROWS <= n) {
      const int4 s0 = *reinterpret_cast<const int4*>(seg + row0);
      const int4 s1 = *reinterpret_cast<const int4*>(seg + row0 + 4);
      const uint2 v8 = *reinterpret_cast<const uint2*>(valid + row0);
      const float4 d0 = *reinterpret_cast<const float4*>(den + row0);
      const float4 d1 = *reinterpret_cast<const float4*>(den + row0 + 4);
      const int ks[SM_ROWS] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float ds[SM_ROWS] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int r = 0; r < SM_ROWS; ++r) {
        const unsigned byte = ((r < 4 ? v8.x : v8.y) >> (8 * (r & 3))) & 0xffu;
        const bool live = byte != 0 && ks[r] >= 0 && ks[r] < num_segments;
        key[r] = live ? ks[r] : -1;
        dv[r] = live ? ds[r] : 0.f;
      }
      if constexpr (F == 4) {
#pragma unroll
        for (int r = 0; r < SM_ROWS; ++r) {
          const float4 q = *reinterpret_cast<const float4*>(x + (row0 + r) * 4);
          val[r][0] = q.x;
          val[r][1] = q.y;
          val[r][2] = q.z;
          val[r][3] = q.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < SM_ROWS; ++r)
#pragma unroll
          for (int f = 0; f < F; ++f) val[r][f] = x[(row0 + r) * F + f];
      }
    } else {
#pragma unroll
      for (int r = 0; r < SM_ROWS; ++r) {
        const long long i = row0 + r;
        bool live = false;
        int k = -1;
        if (i < n) {
          k = seg[i];
          live = valid[i] != 0 && k >= 0 && k < num_segments;
        }
        key[r] = live ? k : -1;
        dv[r] = live ? den[i] : 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) val[r][f] = live ? x[i * F + f] : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < SM_ROWS; ++r) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float v = key[r] >= 0 ? val[r][f] : 0.f;
        if (WEIGHTED) v = v * dv[r];
        val[r][f] = v;
      }
    }

    // ---- the thread's own sum, then the block's exclusive scan
    Agg<F> mine = agg_identity<F>();
    int my_first = -1;
#pragma unroll
    for (int r = 0; r < SM_ROWS; ++r) {
      if (key[r] < 0) continue;
      if (my_first < 0) my_first = key[r];
      Agg<F> a;
      a.key = key[r];
#pragma unroll
      for (int f = 0; f < F; ++f) a.s[f] = val[r][f];
      a.d = dv[r];
      agg_add(mine, a);
    }
    Agg<F> run = carry;
    agg_add(run, block_exclusive_scan(mine, warp_sums[buf], &s_total));
    if (carry.key < 0) {
      // the thread holding the block's first live row names its first id
      if (run.key < 0 && my_first >= 0) s_first_key = my_first;
      __syncthreads();
    }
    const int first_key = s_first_key;

    // ---- walk the rows: each head closes the run before it
#pragma unroll
    for (int r = 0; r < SM_ROWS; ++r) {
      const int k = key[r];
      if (k < 0) continue;
      if (k != run.key) {
        if (k < run.key) *fault = 1;
        if (run.key >= 0) {
          if (run.key == first_key) {
            // the block's first run may have begun in an earlier block
#pragma unroll
            for (int f = 0; f < F; ++f) s_first_sum[f] = run.s[f];
            s_first_sum[F] = run.d;
            s_first_set = 1;
          } else {
            write_segment(out, run.key, run.s, run.d);
          }
          int slot = SM_BIG_GAPS;
          if (k - run.key - 1 > SM_SMALL_GAP) slot = atomicAdd(&s_n_big[buf], 1);
          if (slot < SM_BIG_GAPS) {
            s_big[buf][slot][0] = run.key + 1;
            s_big[buf][slot][1] = k;
          } else {
            for (int e = run.key + 1; e < k; ++e) write_empty(out, e);
          }
        }
        run.key = k;
#pragma unroll
        for (int f = 0; f < F; ++f) run.s[f] = val[r][f];
        run.d = dv[r];
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) run.s[f] += val[r][f];
        run.d += dv[r];
      }
    }
    agg_add(carry, s_total);
    // the tile's long runs of empty segments, by the whole block
    __syncthreads();
    const int n_big = min(s_n_big[buf], SM_BIG_GAPS);
    for (int g = 0; g < n_big; ++g)
      for (int e = s_big[buf][g][0] + tid; e < s_big[buf][g][1]; e += SM_THREADS)
        write_empty(out, e);
    if (tid == 0) s_n_big[buf ^ 1] = 0;
  }
  __syncthreads();

  // ---- the block's record, then the last block finishes the edges
  constexpr int W = TileRec<F>::WORDS;
  if (tid == 0) {
    int* rec = recs + static_cast<long long>(blockIdx.x) * W;
    float* fr = reinterpret_cast<float*>(rec);
    rec[0] = s_first_key;
    rec[1] = carry.key;
    const bool single = !s_first_set;   // one id in the block's rows (or none)
#pragma unroll
    for (int f = 0; f < F; ++f) {
      fr[2 + f] = single ? carry.s[f] : s_first_sum[f];
      fr[3 + F + f] = carry.s[f];
    }
    fr[2 + F] = single ? carry.d : s_first_sum[F];
    fr[3 + 2 * F] = carry.d;
    __threadfence();
    s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  const int n_tiles = gridDim.x;    // one record per block
  carry = agg_identity<F>();
  for (int base = 0; base < n_tiles; base += SM_THREADS) {
    const int t = base + tid;
    int fk = -1;
    Agg<F> tot = agg_identity<F>();
    float fs[F + 1];
#pragma unroll
    for (int f = 0; f <= F; ++f) fs[f] = 0.f;
    if (t < n_tiles) {
      const int* rec = recs + static_cast<long long>(t) * W;
      const float* fr = reinterpret_cast<const float*>(rec);
      fk = __ldcg(rec);
      tot.key = __ldcg(rec + 1);
#pragma unroll
      for (int f = 0; f <= F; ++f) fs[f] = __ldcg(fr + 2 + f);
#pragma unroll
      for (int f = 0; f < F; ++f) tot.s[f] = __ldcg(fr + 3 + F + f);
      tot.d = __ldcg(fr + 3 + 2 * F);
    }
    Agg<F> pre_in = block_exclusive_scan(tot, warp_sums[buf ^= 1], &s_total);
    const Agg<F> chunk_total = s_total;
    Agg<F> pre = carry;
    agg_add(pre, pre_in);
    int gap_lo = 0, gap_len = 0;
    if (fk >= 0) {
      if (fk < pre.key) {
        *fault = 1;
      } else if (fk == pre.key) {
        if (fk != tot.key) {
          float s[F];
#pragma unroll
          for (int f = 0; f < F; ++f) s[f] = pre.s[f] + fs[f];
          write_segment(out, fk, s, pre.d + fs[F]);
        }
      } else {
        if (pre.key >= 0) write_segment(out, pre.key, pre.s, pre.d);
        gap_lo = pre.key + 1;
        gap_len = fk - gap_lo;
        if (fk != tot.key) write_segment(out, fk, fs, fs[F]);
      }
    }
    // the empty segments between tiles, by the whole block
    const int off = block_exclusive_sum(gap_len, s_isum, &s_n_gap);
    const int n_gap = s_n_gap;
    s_gap_lo[tid] = gap_lo;
    s_gap_off[tid] = off;
    if (tid == 0) s_gap_off[SM_THREADS] = n_gap;
    __syncthreads();
    for (int q = tid; q < n_gap; q += SM_THREADS) {
      int lo = 0, hi = SM_THREADS;      // the last j with s_gap_off[j] <= q
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_gap_off[mid] <= q) lo = mid; else hi = mid;
      }
      write_empty(out, s_gap_lo[lo] + (q - s_gap_off[lo]));
    }
    __syncthreads();
    agg_add(carry, chunk_total);
  }
  // the last run, and the empty segments after it (written by every block
  // above when the last row is live)
  if (tid == 0 && carry.key >= 0) write_segment(out, carry.key, carry.s, carry.d);
  if (!tail_live)
    for (int e = carry.key + 1 + tid; e < num_segments; e += SM_THREADS) write_empty(out, e);
  if (tid == 0) *counter = 0u;
}

template <int F>
__global__ void segment_mean_backward_kernel(const float* __restrict__ g,
                                             const float* __restrict__ den,
                                             const int* __restrict__ seg,
                                             const unsigned char* __restrict__ valid,
                                             const float* __restrict__ den_sum, long long n,
                                             int num_segments, float min_den, bool weighted,
                                             float* __restrict__ d_x) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = seg[i];
  const bool live = valid[i] && s >= 0 && s < num_segments;
  float c = 1.f, w = 1.f;
  if (live) {
    c = fmaxf(den_sum[s], min_den);
    if (weighted) w = den[i];
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float v = 0.f;
    if (live) {
      v = g[static_cast<long long>(s) * F + f] / c;
      if (weighted) v = v * w;
    }
    d_x[i * F + f] = v;
  }
}

}  // namespace

// x [n] f32, seg [n] int32, valid [n] bool bytes, out [num_segments] f32
// zeroed by the caller.
CNC_EXPORT int cnc_segment_pool(const float* x, const int* seg, const unsigned char* valid,
                                float* out, long long n, int num_segments, void* stream) {
  if (n == 0) return 0;
  segment_pool_kernel<<<cnc_blocks((n + SP_ROWS - 1) / SP_ROWS, SP_THREADS), SP_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, seg, valid, out, n,
                                                             num_segments);
  return cnc_last_error();
}

// g [num_segments] f32, d_x [n] f32 (every element written).
CNC_EXPORT int cnc_segment_pool_backward(const float* g, const int* seg,
                                         const unsigned char* valid, float* d_x, long long n,
                                         int num_segments, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  segment_pool_backward_kernel<<<cnc_blocks(n, threads), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(g, seg, valid, d_x, n,
                                                                      num_segments);
  return cnc_last_error();
}

// The grid of segment_mean over n rows: (blocks, tiles per block).
static void segment_mean_grid(long long n, long long* blocks, long long* per_block) {
  const long long tiles = n > 0 ? (n + SM_TILE - 1) / SM_TILE : 1;
  *per_block = (tiles + SM_MAX_BLOCKS - 1) / SM_MAX_BLOCKS;
  *blocks = (tiles + *per_block - 1) / *per_block;
}

// The words of scratch segment_mean needs for n rows of f floats: one record
// per block.
CNC_EXPORT long long cnc_segment_mean_scratch(long long n, int f) {
  long long blocks, per_block;
  segment_mean_grid(n, &blocks, &per_block);
  return blocks * (2 + 2 * (f + 1));
}

// x [n, f] f32, den [n] f32, seg [n] int32, valid [n] bool bytes; writes
// pooled [num_segments, f] f32, covered [num_segments] bool bytes and den_sum
// [num_segments] f32, every element once.  weighted: the rows enter as
// x * den.  scratch: cnc_segment_mean_scratch words; counter: one word, 0
// before the launch (the kernel leaves it 0); fault: one word, set to 1 when
// a live id falls below the one before it.  f in (1, 2, 4).
CNC_EXPORT int cnc_segment_mean(const float* x, const float* den, const int* seg,
                                const unsigned char* valid, long long n, int f,
                                int num_segments, float min_den, int weighted, float* pooled,
                                unsigned char* covered, float* den_sum, int* scratch,
                                unsigned* counter, int* fault, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks, per_block;
  segment_mean_grid(n, &blocks, &per_block);
  const long long tiles = n > 0 ? (n + SM_TILE - 1) / SM_TILE : 1;
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(den) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(seg) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(valid) % 8 == 0);
  const unsigned grid = static_cast<unsigned>(blocks);
#define CNC_SM_LAUNCH(FF)                                                                      \
  {                                                                                            \
    MeanOut<FF> o{pooled, covered, den_sum, min_den};                                          \
    if (weighted)                                                                              \
      segment_mean_kernel<FF, true><<<grid, SM_THREADS, 0, s>>>(                               \
          x, den, seg, valid, n, num_segments, o, scratch, counter, fault, vec, tiles,         \
          per_block);                                                                          \
    else                                                                                       \
      segment_mean_kernel<FF, false><<<grid, SM_THREADS, 0, s>>>(                              \
          x, den, seg, valid, n, num_segments, o, scratch, counter, fault, vec, tiles,         \
          per_block);                                                                          \
  }
  switch (f) {
    case 1: CNC_SM_LAUNCH(1) break;
    case 2: CNC_SM_LAUNCH(2) break;
    case 4: CNC_SM_LAUNCH(4) break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CNC_SM_LAUNCH
  return cnc_last_error();
}

// g [num_segments, f] f32 (the gradient of pooled), den_sum from the
// forward; d_x [n, f] f32, every element written.
CNC_EXPORT int cnc_segment_mean_backward(const float* g, const float* den, const int* seg,
                                         const unsigned char* valid, const float* den_sum,
                                         long long n, int f, int num_segments, float min_den,
                                         int weighted, float* d_x, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const unsigned blocks = cnc_blocks(n, threads);
  const bool w = weighted != 0;
  switch (f) {
    case 1: segment_mean_backward_kernel<1><<<blocks, threads, 0, s>>>(g, den, seg, valid, den_sum, n, num_segments, min_den, w, d_x); break;
    case 2: segment_mean_backward_kernel<2><<<blocks, threads, 0, s>>>(g, den, seg, valid, den_sum, n, num_segments, min_den, w, d_x); break;
    case 4: segment_mean_backward_kernel<4><<<blocks, threads, 0, s>>>(g, den, seg, valid, den_sum, n, num_segments, min_den, w, d_x); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}
