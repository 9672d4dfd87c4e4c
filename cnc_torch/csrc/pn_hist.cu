// K7: the dimension-wise prior's frac plane, in one launch per plane.
//
// Replaces: cnc_tpu/models/context_models.py pn_frac_plane (756-836): the
// stride sampling of the cached coord list (808-820), a gather of the finest
// level's rows at the bin-sorted entry indices, the straight-through
// indicator _pos_indicator (53-66, entry > 0.9), the row mask, _csum_diffs
// (1371-1381, per-feature cumulative sums differenced at the bin
// boundaries), frac = pos / (cnt + 1e-6), the zero border ring and the
// x-fastest [pn_res^2, F] layout.
// Plain twin: cnc_torch/ops/context_ops.py `_pn_frac_plane_plain`.
//
// With bins b = x * scale + y (scale = pn_res - 2) and the cache's ascending
// row boundaries bounds[b] (0 <= bounds <= cap), its entry list entry_idx
// [cap] and its count n (read on the card), m = min(n, cap):
//   unsampled: rows j in [map[b], map[b+1]) with map = bounds, valid when
//              j < m, entry entry_idx[j];
//   sampled:   take = min(m, sample_cap), stride = f32(m) / f32(max(take, 1))
//              and src(j) = min(floor(f32(j) * stride), max(m - 1, 0)), each
//              rounded to nearest in float32 as torch rounds them; row j < take
//              reads entry entry_idx[min(src(j), cap - 1)], and
//              map[b] = #{j < take : src(j) < bounds[b]}, which is
//              min(searchsorted_left(src, bounds[b]), take) because src is
//              monotone in j: found from its estimate bounds[b] * (1 / stride)
//              by stepping while a neighbour decides, src never materialised.
//   pos[b, f] = #{valid rows of bin b with table[fine_offset + entry, f] > 0.9}
//   plane[(y + 1) * pn_res + (x + 1), f] = pos / (f32(map[b+1] - map[b]) + 1e-6f)
// and every border row of the plane is zero.  The counts are integers, the
// divide and the add rounded to nearest as torch does: the plane equals the
// twin's bit for bit.
//
// One block a tile of 8 x-columns by 8 y, one warp a column's run of 8 bins,
// whose rows are contiguous (the refresh sorts the coord list by bin).  The
// warp finds the run's boundaries (the sampled map from its estimate), then
// walks the run's rows with consecutive lanes on consecutive rows, four rows
// a lane in flight: the entry_idx loads first (coalesced), then each lane's
// bin by stepping from the bin of its 32 rows' first, then the table rows,
// then the counts: the lanes of one bin are grouped (__match_any_sync) and
// the group's leader adds its ballots' counts to the bin's shared counters.
// Integers, so exact in any order.  The block then writes its tile with
// consecutive threads on consecutive x, which are consecutive plane rows.
// (A warp a run of 64 bins with one row a lane in flight, and a tile of
// 8 x 16 bins whose rows the whole block walks, measured 3.3-3.6x and 1.4-1.7x
// slower on the step's planes; see PERF.md.)
//
// Bound on the H100: bytes; one entry_idx word a sampled row (2^21 rows a
// plane), one random 16-byte table row a distinct entry out of the 8 MB
// finest level, which the L2 holds, the boundaries and the 4 MB plane.
//
// The backward (reached only with pn_frac_grad) is the indicator's
// straight-through rule: d_table[fine_offset + sel[r], f] += g[bin(r), f]
// where the entry is > 0.9 and the row valid, as atomics into a zeroed table;
// the wrapper passes g = d_plane / (cnt + 1e-6) at each bin and the rows and
// boundaries the plain index math gives.
//
// K7i, the integer mode, replaces the codec's plane: cnc_tpu/codec/intctx.py
// int_frac_plane (298-321), a gather of the int32 sign table's finest level at
// every listed entry (full coverage: no stride sampling), the sign counts per
// bin by per-feature int32 cumulative sums differenced at the boundaries,
// frac_q = pos * Q_FEAT // max(cnt, 1), the zero border and the x-fastest
// [pn_res^2, F] layout.  Plain twin: cnc_torch/codec/intctx.py
// `int_frac_plane`.  One thread per plane row: border rows write zeros; an
// inner row (x, y) walks bin (x - 1) * (pn_res - 2) + (y - 1), counting its
// valid rows (row < min(n, rows)) whose sign is positive; cnt is the bin's
// length, as the twin takes it.  Integers, so it equals the twin exactly.
// Bound: bytes, one 16-byte sign row per listed row (2^24 rows at full width,
// about 300 MB with sel) plus the 4 MB plane.

#include "common.cuh"

namespace {

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ table, long long row,
                                         float* v) {
  if constexpr (F == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(table) + row);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = __ldg(reinterpret_cast<const float2*>(table) + row);
    v[0] = q.x; v[1] = q.y;
  }
}

// A block's bins: 8 x-columns by 8 y, a warp a column's run of 8 bins; each
// lane takes kRowsAhead rows at a time.
constexpr int kTileX = 8, kTileY = 8, kRowsAhead = 4;
constexpr int kPlaneThreads = kTileX * 32;

// src(j) of the sampled mode, rounded as torch rounds it.
__device__ __forceinline__ int sample_src(int j, float stride, int src_max) {
  return min(static_cast<int>(floorf(__fmul_rn(static_cast<float>(j), stride))), src_max);
}

// The first j in [0, take] with j == take or src(j) >= v.  src is monotone
// in j, so the estimate v / stride (by the reciprocal inv_stride) moved while
// a neighbour decides is exact; it moves a step or two at most.
__device__ __forceinline__ int sample_map(int v, int take, float stride, float inv_stride,
                                          int src_max) {
  if (v <= 0) return 0;
  if (v > src_max) return take;
  int j = min(max(static_cast<int>(ceilf(static_cast<float>(v) * inv_stride)), 0), take);
  while (j > 0 && sample_src(j - 1, stride, src_max) >= v) --j;
  while (j < take && sample_src(j, stride, src_max) < v) ++j;
  return j;
}

template <int F>
__global__ void __launch_bounds__(kPlaneThreads)
pn_frac_plane_kernel(const float* __restrict__ table, long long fine_offset, long long table_rows,
                     const int* __restrict__ entry_idx, const int* __restrict__ bounds,
                     const int* __restrict__ n_listed, int cap, int sample_cap, int pn_res,
                     float* __restrict__ plane) {
  __shared__ int s_map[kTileX][kTileY + 1];   // each run's row boundaries
  __shared__ int s_pos[kTileX][kTileY * F];
  const int scale = pn_res - 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the border ring: rows y = 0 and y = pn_res - 1, columns x = 0 and x = pn_res - 1
  const int gid = blockIdx.x * kPlaneThreads + threadIdx.x;
  if (gid < 2 * pn_res) {
    const long long a = gid < pn_res ? gid : static_cast<long long>(gid - pn_res) * pn_res;
    const long long b = gid < pn_res ? static_cast<long long>(pn_res - 1) * pn_res + gid
                                     : a + pn_res - 1;
#pragma unroll
    for (int f = 0; f < F; ++f) plane[a * F + f] = plane[b * F + f] = 0.f;
  }
  const int tiles_y = (scale + kTileY - 1) / kTileY;
  if (static_cast<int>(blockIdx.x) >= ((scale + kTileX - 1) / kTileX) * tiles_y) return;
  const int tx0 = (blockIdx.x / tiles_y) * kTileX, ty0 = (blockIdx.x % tiles_y) * kTileY;
  const int nx = min(kTileX, scale - tx0), ny = min(kTileY, scale - ty0);

  const int m = min(*n_listed, cap);
  const bool sampled = sample_cap > 0;
  const int take = sampled ? min(m, sample_cap) : m;   // rows below it are valid
  const float stride = __fdiv_rn(static_cast<float>(m), static_cast<float>(max(take, 1)));
  const float inv_stride = __frcp_rn(stride);
  const int src_max = max(m - 1, 0);

  if (warp < nx) {
    // the run's boundaries
    for (int t = lane; t <= ny; t += 32) {
      const int v = bounds[static_cast<long long>(tx0 + warp) * scale + ty0 + t];
      s_map[warp][t] = sampled ? sample_map(v, take, stride, inv_stride, src_max)
                               : min(max(v, 0), cap);
    }
    for (int i = lane; i < kTileY * F; i += 32) s_pos[warp][i] = 0;
    __syncwarp();

    // the run's rows, consecutive lanes on consecutive rows; a lane's bin is
    // found by stepping from the bin of its 32 rows' first
    const int* map = s_map[warp];
    const int j1 = map[ny];
    int b_first = 0;
    for (int jb = map[0]; jb < j1; jb += 32 * kRowsAhead) {
      int e[kRowsAhead], bin[kRowsAhead];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {      // the entries' loads first
        const int j = jb + 32 * u + lane;
        e[u] = 0;
        if (j < j1 && j < take)
          e[u] = sampled ? entry_idx[min(sample_src(j, stride, src_max), cap - 1)]
                         : entry_idx[j];
      }
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        const int j = jb + 32 * u + lane;
        int b = b_first;
        while (b + 1 < ny && map[b + 1] <= j) ++b;
        bin[u] = j < j1 && j < take ? b : -1;
        b_first = __shfl_sync(~0u, b, 31);
      }
      float v[kRowsAhead][F];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u)        // then the table rows'
        load_row<F>(table, min(max(fine_offset + e[u], 0LL), table_rows - 1), v[u]);
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        // the lanes of one bin add their counts once, by their lowest lane
        const unsigned grp = __match_any_sync(~0u, bin[u]);
        const bool leader = bin[u] >= 0 && __ffs(grp) - 1 == lane;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const int c = __popc(__ballot_sync(~0u, bin[u] >= 0 && v[u][f] > 0.9f) & grp);
          if (leader && c) s_pos[warp][bin[u] * F + f] += c;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // the tile: consecutive threads on consecutive x, i.e. consecutive plane rows
  for (int i = threadIdx.x; i < kTileX * ny; i += kPlaneThreads) {
    const int xi = i % kTileX, yi = i / kTileX;
    if (xi >= nx) continue;
    const float den = __fadd_rn(static_cast<float>(s_map[xi][yi + 1] - s_map[xi][yi]), 1e-6f);
    float o[F];
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = __fdiv_rn(static_cast<float>(s_pos[xi][yi * F + f]), den);
    float* out = plane + (static_cast<long long>(ty0 + yi + 1) * pn_res + tx0 + xi + 1) * F;
    if constexpr (F == 4) *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
    else *reinterpret_cast<float2*>(out) = make_float2(o[0], o[1]);
  }
}

template <int F>
__global__ void pn_hist_backward_kernel(const float* __restrict__ table, long long fine_offset,
                                        long long table_rows, const int* __restrict__ sel,
                                        const unsigned char* __restrict__ row_valid,
                                        const int* __restrict__ bnd,
                                        const float* __restrict__ g,
                                        float* __restrict__ d_table, int n_bins, int n_rows) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_bins) return;
  const int lo = min(max(bnd[b], 0), n_rows), hi = min(max(bnd[b + 1], 0), n_rows);
  float gb[F];
#pragma unroll
  for (int f = 0; f < F; ++f) gb[f] = g[static_cast<long long>(b) * F + f];
  for (int r = lo; r < hi; ++r) {
    if (!row_valid[r]) continue;
    const long long row = min(max(fine_offset + sel[r], 0LL), table_rows - 1);
    float v[F];
    load_row<F>(table, row, v);
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (v[f] > 0.9f) atomicAdd(d_table + row * F + f, gb[f]);
  }
}

constexpr int kQFeat = 256;   // codec/intctx.py Q_FEAT

template <int F>
__global__ void pn_hist_int_kernel(const int* __restrict__ sign, long long fine_offset,
                                   long long tbl_rows, const int* __restrict__ sel,
                                   long long n_rows, const int* __restrict__ n_listed,
                                   const int* __restrict__ bnd, int pn_res,
                                   int* __restrict__ plane) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= static_cast<long long>(pn_res) * pn_res) return;
  const int xo = static_cast<int>(o % pn_res), yo = static_cast<int>(o / pn_res);
  int* out = plane + o * F;
  if (xo == 0 || yo == 0 || xo == pn_res - 1 || yo == pn_res - 1) {
#pragma unroll
    for (int f = 0; f < F; ++f) out[f] = 0;
    return;
  }
  const long long b = static_cast<long long>(xo - 1) * (pn_res - 2) + (yo - 1);
  const long long n_valid = min(static_cast<long long>(*n_listed), n_rows);
  const int b0 = bnd[b], b1 = bnd[b + 1];
  const long long lo = min(max(static_cast<long long>(b0), 0LL), n_rows);
  const long long hi = min(max(static_cast<long long>(b1), 0LL), n_rows);
  int cnt[F];
#pragma unroll
  for (int f = 0; f < F; ++f) cnt[f] = 0;
  for (long long r = lo; r < hi && r < n_valid; ++r) {
    const long long row = min(max(fine_offset + sel[r], 0LL), tbl_rows - 1);
    int v[F];
    if constexpr (F == 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(sign) + row);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      const int2 q = __ldg(reinterpret_cast<const int2*>(sign) + row);
      v[0] = q.x; v[1] = q.y;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) cnt[f] += v[f] > 0 ? 1 : 0;
  }
  // pos >= 0 and the bin length >= 1 after the clamp: truncation floors
  const int len = max(b1 - b0, 1);
#pragma unroll
  for (int f = 0; f < F; ++f) out[f] = cnt[f] * kQFeat / len;
}

}  // namespace

// sign [tbl_rows, f] int32 (rows 4f-byte aligned), sel [n_rows] int32 finest-
// level entries sorted by bin, n_listed a device int32 (rows at or past it are
// not valid), bnd [(pn_res-2)^2 + 1] int32; plane [pn_res^2, f] int32, every
// element written; f in (2, 4).
CNC_EXPORT int cnc_pn_hist_int(const int* sign, long long fine_offset, long long tbl_rows,
                               const int* sel, long long n_rows, const int* n_listed,
                               const int* bnd, int pn_res, int f, int* plane, void* stream) {
  const long long n_out = static_cast<long long>(pn_res) * pn_res;
  if (n_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned blocks = cnc_blocks(n_out, threads);
  switch (f) {
    case 2: pn_hist_int_kernel<2><<<blocks, threads, 0, s>>>(sign, fine_offset, tbl_rows, sel, n_rows, n_listed, bnd, pn_res, plane); break;
    case 4: pn_hist_int_kernel<4><<<blocks, threads, 0, s>>>(sign, fine_offset, tbl_rows, sel, n_rows, n_listed, bnd, pn_res, plane); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}

// table [table_rows, f] f32 (rows 4*f-byte aligned), entry_idx [cap] int32,
// bounds [(pn_res-2)^2 + 1] int32 ascending in [0, cap], n_listed a device
// int32, sample_cap 0 for the unsampled mode (else 0 < sample_cap < cap);
// plane [pn_res^2, f] f32, every element written; f in (2, 4), pn_res >= 3.
CNC_EXPORT int cnc_pn_frac_plane(const float* table, long long fine_offset, long long table_rows,
                                 const int* entry_idx, const int* bounds, const int* n_listed,
                                 int cap, int sample_cap, int pn_res, int f, float* plane,
                                 void* stream) {
  if (pn_res < 3 || cap <= 0 || sample_cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int scale = pn_res - 2;
  const long long tiles = static_cast<long long>((scale + kTileX - 1) / kTileX) *
                          ((scale + kTileY - 1) / kTileY);
  const long long border = cnc_blocks(2LL * pn_res, kPlaneThreads);   // blocks that zero the ring
  const unsigned blocks = static_cast<unsigned>(tiles > border ? tiles : border);
  switch (f) {
    case 2: pn_frac_plane_kernel<2><<<blocks, kPlaneThreads, 0, s>>>(table, fine_offset, table_rows, entry_idx, bounds, n_listed, cap, sample_cap, pn_res, plane); break;
    case 4: pn_frac_plane_kernel<4><<<blocks, kPlaneThreads, 0, s>>>(table, fine_offset, table_rows, entry_idx, bounds, n_listed, cap, sample_cap, pn_res, plane); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}

// g [n_bins, f] f32, d_table [table_rows, f] f32 zeroed by the caller.
CNC_EXPORT int cnc_pn_hist_backward(const float* table, long long fine_offset,
                                    long long table_rows, const int* sel,
                                    const unsigned char* row_valid, const int* bnd,
                                    const float* g, float* d_table, int n_bins, int n_rows, int f,
                                    void* stream) {
  if (n_bins == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned blocks = cnc_blocks(n_bins, threads);
  switch (f) {
    case 2: pn_hist_backward_kernel<2><<<blocks, threads, 0, s>>>(table, fine_offset, table_rows, sel, row_valid, bnd, g, d_table, n_bins, n_rows); break;
    case 4: pn_hist_backward_kernel<4><<<blocks, threads, 0, s>>>(table, fine_offset, table_rows, sel, row_valid, bnd, g, d_table, n_bins, n_rows); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}
