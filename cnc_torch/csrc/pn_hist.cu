// The dimension-wise prior's frac planes: K7 (the rate's float plane), K7i
// (the codec's integer plane) and K7b (K7's backward), one launch each, all
// three on one walk over runs of bins; and K7p / K7pb, K7 and K7b over a
// range of rows (the data-parallel step's share of a plane).
//
// K7 replaces: cnc_tpu/models/context_models.py pn_frac_plane (756-836): the
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
// K7i replaces the codec's plane: cnc_tpu/codec/intctx.py int_frac_plane
// (298-321): the unsampled rows of an int32 sign table (full coverage),
// pos[b, f] = #{valid rows of bin b with sign > 0}, frac_q = pos * Q_FEAT //
// max(bounds[b+1] - bounds[b], 1), where the bin's length is the raw one
// (rows at or past m count in it and never in pos), the zero border and
// the same layout.  Plain twin: cnc_torch/codec/intctx.py `int_frac_plane`.
// Integers only, so it equals the twin bit for bit.
//
// K7b replaces the gradient of pn_frac_plane: the indicator's
// straight-through rule through _csum_diffs, d_table[fine_offset + e, f] +=
// g[(y + 1) * pn_res + (x + 1), f] / (f32(map[b+1] - map[b]) + 1e-6f) for
// every valid row of bin b whose entry e has table value > 0.9, into a
// table the wrapper zeroes (autograd adds it into the 3D table's gradient).
// It takes the forward's own inputs and the plane-layout gradient g.  Plain
// twins: autograd through `_pn_frac_plane_plain`, and `pn_hist_backward_plain`
// in this kernel's arguments.  Float atomics: the sums' order varies.
//
// K7p replaces the row-sharded histogram of pn_frac_plane under axis_name
// (cnc_tpu/models/context_models.py 783-802): one rank's partial per-bin
// counts over the rows [lo, lo + size) of the same row space (j indexes the
// sampled rows in the sampled mode), partial[b, f] = #{valid rows j of bin b
// with lo <= j < lo + size and table value > 0.9}, as float32 in bin order
// [bins, F] (no divide, no border, no transpose), and den[b] =
// f32(map[b+1] - map[b]) + 1e-6f over the whole row space, the divisor the
// plane takes once the ranks' partials are summed.  The walk clamps each
// run's boundaries to the range: a row of the range lies in bin b of the
// clamped map exactly when it does in the map.  The counts are integers
// (exact in float32 below 2^24 rows), so the partials of any split sum to
// K7's counts exactly.  Plain twin: cnc_torch/ops/context_ops.py
// `_pn_part_plain`.  K7pb is K7b over the same range with the partial's
// gradient g_part [bins, F] in bin order as each bin's scale (the divide is
// the finish's, outside the kernel).
//
// The walk.  One block a tile of 8 x-columns by 8 y, one warp a column's run
// of 8 bins, whose rows are contiguous (the refresh sorts the coord list by
// bin).  The warp finds the run's boundaries (the sampled map from its
// estimate), then walks the run's rows with consecutive lanes on
// consecutive rows, four rows a lane in flight: the entry_idx loads first
// (coalesced), then each lane's bin by stepping from the bin of its 32
// rows' first, then the table rows, then the row's work.  K7 and K7i count:
// the lanes of one bin are grouped (__match_any_sync) and the group's
// leader adds its ballots' counts to the bin's shared counters, and the
// block writes its tile with consecutive threads on consecutive x, which
// are consecutive plane rows.  K7b first reads the tile's gradient rows the
// same way into per-bin scales in shared memory, then each row with a bit
// set adds its bin's scales, masked by the indicator, in one vector atomic.
// (A warp a run of 64 bins with one row a lane in flight, and a tile of
// 8 x 16 bins whose rows the whole block walks, measured 3.3-3.6x and 1.4-1.7x
// slower on the rate step's planes; counting by group heads from a shuffle
// and a ballot instead of __match_any_sync, and eight rows a lane in flight
// in K7i's longer runs, no faster; see PERF.md.)
//
// Bounds on the H100, all bytes.  K7: one entry_idx word a counted row
// (2^21 sampled rows a plane), one random 16-byte table row a distinct
// entry out of the 8 MB finest level, which the L2 holds, the boundaries
// and the 4 MB plane.  K7i: the same with every listed row (about 10.2M of
// a 2^24 list at full width): an entry_idx word a listed row, a 16-byte
// sign row a distinct entry, the boundaries and the 4 MB plane (about 55 MB,
// as chip_smoke.py counts it).  K7b: the forward's reads, the gradient plane,
// and a 16-byte d_table row written a distinct entry set; with the zero
// fill of the whole 3D table (about 64 MB at full width) for the backward
// as autograd runs it.  K7p: an entry_idx word a counted row of the range, a
// table row a distinct entry among them, the boundaries, the partial and
// den written once (den 1 MB, the partial 4 MB at full width and F = 4).
// K7pb: K7p's reads, the partial's gradient and a d_table row a distinct
// entry with a bit set.

#include <type_traits>

#include "common.cuh"

namespace {

template <typename T, int F>
__device__ __forceinline__ void load_row(const T* __restrict__ table, long long row, T* v) {
  using V4 = typename std::conditional<std::is_same<T, int>::value, int4, float4>::type;
  using V2 = typename std::conditional<std::is_same<T, int>::value, int2, float2>::type;
  if constexpr (F == 4) {
    const V4 q = __ldg(reinterpret_cast<const V4*>(table) + row);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const V2 q = __ldg(reinterpret_cast<const V2*>(table) + row);
    v[0] = q.x; v[1] = q.y;
  }
}

template <typename T, int F>
__device__ __forceinline__ void store_row(T* __restrict__ out, long long row, const T* v) {
  using V4 = typename std::conditional<std::is_same<T, int>::value, int4, float4>::type;
  using V2 = typename std::conditional<std::is_same<T, int>::value, int2, float2>::type;
  if constexpr (F == 4) reinterpret_cast<V4*>(out)[row] = V4{v[0], v[1], v[2], v[3]};
  else reinterpret_cast<V2*>(out)[row] = V2{v[0], v[1]};
}

__device__ __forceinline__ bool positive(float v) { return v > 0.9f; }   // _pos_indicator
__device__ __forceinline__ bool positive(int v) { return v > 0; }        // a sign

// A block's bins: 8 x-columns by 8 y, a warp a column's run of 8 bins; each
// lane takes kRowsAhead rows at a time.
constexpr int kTileX = 8, kTileY = 8, kRowsAhead = 4;
constexpr int kPlaneThreads = kTileX * 32;
constexpr int kQFeat = 256;   // codec/intctx.py Q_FEAT

// The rows a plane counts: rows below take are valid; the rest of the
// sampled mode's arithmetic.
struct Rows {
  int cap, take, src_max;
  float stride, inv_stride;
};

__device__ __forceinline__ Rows plane_rows(const int* n_listed, int cap, int sample_cap,
                                           bool sampled) {
  Rows r;
  const int m = min(*n_listed, cap);
  r.cap = cap;
  r.take = sampled ? min(m, sample_cap) : m;
  r.stride = __fdiv_rn(static_cast<float>(m), static_cast<float>(max(r.take, 1)));
  r.inv_stride = __frcp_rn(r.stride);
  r.src_max = max(m - 1, 0);
  return r;
}

// src(j) of the sampled mode, rounded as torch rounds it.
__device__ __forceinline__ int sample_src(int j, const Rows& r) {
  return min(static_cast<int>(floorf(__fmul_rn(static_cast<float>(j), r.stride))), r.src_max);
}

// The first j in [0, take] with j == take or src(j) >= v.  src is monotone
// in j, so the estimate v / stride (by the reciprocal inv_stride) moved while
// a neighbour decides is exact; it moves a step or two at most.
__device__ __forceinline__ int sample_map(int v, const Rows& r) {
  if (v <= 0) return 0;
  if (v > r.src_max) return r.take;
  int j = min(max(static_cast<int>(ceilf(static_cast<float>(v) * r.inv_stride)), 0), r.take);
  while (j > 0 && sample_src(j - 1, r) >= v) --j;
  while (j < r.take && sample_src(j, r) < v) ++j;
  return j;
}

// The block's tile of bins; false for a block past the last tile.
struct Tile {
  int x0, y0, nx, ny;
};

__device__ __forceinline__ bool plane_tile(int scale, Tile& t) {
  const int tiles_y = (scale + kTileY - 1) / kTileY;
  if (static_cast<int>(blockIdx.x) >= ((scale + kTileX - 1) / kTileX) * tiles_y) return false;
  t.x0 = (blockIdx.x / tiles_y) * kTileX;
  t.y0 = (blockIdx.x % tiles_y) * kTileY;
  t.nx = min(kTileX, scale - t.x0);
  t.ny = min(kTileY, scale - t.y0);
  return true;
}

// The border ring: rows y = 0 and y = pn_res - 1, columns x = 0 and
// x = pn_res - 1, by the first blocks' threads.
template <typename T, int F>
__device__ __forceinline__ void zero_border(T* __restrict__ plane, int pn_res) {
  const int gid = blockIdx.x * kPlaneThreads + threadIdx.x;
  if (gid >= 2 * pn_res) return;
  const long long a = gid < pn_res ? gid : static_cast<long long>(gid - pn_res) * pn_res;
  const long long b = gid < pn_res ? static_cast<long long>(pn_res - 1) * pn_res + gid
                                   : a + pn_res - 1;
  const T zero[F] = {};
  store_row<T, F>(plane, a, zero);
  store_row<T, F>(plane, b, zero);
}

// A warp's run (column x0 + warp, bins y0 .. y0 + ny - 1): its ny + 1 row
// boundaries into map, and (where raw is given) the boundaries as they are.
template <bool kSampled>
__device__ __forceinline__ void load_map(const int* __restrict__ bounds, int scale, const Tile& t,
                                         int warp, const Rows& r, int* map, int* raw) {
  for (int i = threadIdx.x & 31; i <= t.ny; i += 32) {
    const int v = bounds[static_cast<long long>(t.x0 + warp) * scale + t.y0 + i];
    map[i] = kSampled ? sample_map(v, r) : min(max(v, 0), r.cap);
    if (raw) raw[i] = v;
  }
}

// The run's rows [map[0], map[ny]), consecutive lanes on consecutive rows,
// kRowsAhead rows a lane in flight.  visit(bin, row, v) runs on every lane
// of the warp in step, once for each of its kRowsAhead rows: bin in
// [0, ny) for a valid row, else -1; row the clamped table row of its entry;
// v its F values.
template <typename T, int F, bool kSampled, typename Visit>
__device__ __forceinline__ void walk_run(const T* __restrict__ table, long long fine_offset,
                                         long long table_rows, const int* __restrict__ entry_idx,
                                         const int* map, int ny, const Rows& r, Visit&& visit) {
  const int lane = threadIdx.x & 31;
  const int j1 = map[ny];
  int b_first = 0;
  for (int jb = map[0]; jb < j1; jb += 32 * kRowsAhead) {
    int e[kRowsAhead], bin[kRowsAhead];
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {      // the entries' loads first
      const int j = jb + 32 * u + lane;
      e[u] = 0;
      if (j < j1 && j < r.take)
        e[u] = kSampled ? entry_idx[min(sample_src(j, r), r.cap - 1)] : entry_idx[j];
    }
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {      // each lane's bin, stepped from its rows' first
      const int j = jb + 32 * u + lane;
      int b = b_first;
      while (b + 1 < ny && map[b + 1] <= j) ++b;
      bin[u] = j < j1 && j < r.take ? b : -1;
      b_first = __shfl_sync(~0u, b, 31);
    }
    long long row[kRowsAhead];
    T v[kRowsAhead][F];
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {      // then the table rows'
      row[u] = min(max(fine_offset + e[u], 0LL), table_rows - 1);
      load_row<T, F>(table, row[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) visit(bin[u], row[u], v[u]);
  }
}

// A run's boundaries clamped to the rows [lo, hi): K7p's and K7pb's walk.
__device__ __forceinline__ void clamp_map(const int* map, int ny, int lo, int hi, int* cut) {
  for (int i = threadIdx.x & 31; i <= ny; i += 32) cut[i] = min(max(map[i], lo), hi);
}

// K7 (T = float) and K7i (T = int, unsampled): the whole plane; K7p (T =
// float, kRange): the rows [lo, hi)'s partial counts and the bins' divisors.
template <typename T, int F, bool kSampled, bool kRange = false>
__global__ void __launch_bounds__(kPlaneThreads)
pn_plane_kernel(const T* __restrict__ table, long long fine_offset, long long table_rows,
                const int* __restrict__ entry_idx, const int* __restrict__ bounds,
                const int* __restrict__ n_listed, int cap, int sample_cap, int pn_res,
                T* __restrict__ plane, int lo = 0, int hi = 0, float* __restrict__ den = nullptr) {
  constexpr bool kInt = std::is_same<T, int>::value;
  static_assert(!(kInt && kRange), "K7p counts the float table");
  __shared__ int s_map[kTileX][kTileY + 1];            // each run's row boundaries
  __shared__ int s_raw[kInt ? kTileX : 1][kTileY + 1];  // K7i: the bounds as given
  __shared__ int s_cut[kRange ? kTileX : 1][kTileY + 1];  // K7p: clamped to [lo, hi)
  __shared__ int s_pos[kTileX][kTileY * F];
  if constexpr (!kRange) zero_border<T, F>(plane, pn_res);
  const int scale = pn_res - 2;
  Tile t;
  if (!plane_tile(scale, t)) return;
  const Rows r = plane_rows(n_listed, cap, sample_cap, kSampled);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp < t.nx) {
    int* pos = s_pos[warp];
    load_map<kSampled>(bounds, scale, t, warp, r, s_map[warp], kInt ? s_raw[warp] : nullptr);
    const int* walk_map = s_map[warp];
    if constexpr (kRange) {
      __syncwarp();
      clamp_map(s_map[warp], t.ny, lo, hi, s_cut[warp]);
      walk_map = s_cut[warp];
    }
    for (int i = lane; i < kTileY * F; i += 32) pos[i] = 0;
    __syncwarp();
    walk_run<T, F, kSampled>(table, fine_offset, table_rows, entry_idx, walk_map, t.ny, r,
                             [&](int bin, long long, const T* v) {
      // the lanes of one bin add their counts once, by their lowest lane
      const unsigned grp = __match_any_sync(~0u, bin);
      const bool leader = bin >= 0 && __ffs(grp) - 1 == lane;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int c = __popc(__ballot_sync(~0u, bin >= 0 && positive(v[f])) & grp);
        if (leader && c) pos[bin * F + f] += c;
      }
      __syncwarp();
    });
  }
  __syncthreads();

  if constexpr (kRange) {
    // the partial in bin order: consecutive threads on consecutive y, i.e.
    // consecutive bins
    for (int i = threadIdx.x; i < kTileY * t.nx; i += kPlaneThreads) {
      const int yi = i % kTileY, xi = i / kTileY;
      if (yi >= t.ny) continue;
      const long long b = static_cast<long long>(t.x0 + xi) * scale + t.y0 + yi;
      float o[F];
#pragma unroll
      for (int f = 0; f < F; ++f) o[f] = static_cast<float>(s_pos[xi][yi * F + f]);
      store_row<float, F>(plane, b, o);
      den[b] = __fadd_rn(static_cast<float>(s_map[xi][yi + 1] - s_map[xi][yi]), 1e-6f);
    }
    return;
  }
  // the tile: consecutive threads on consecutive x, i.e. consecutive plane rows
  for (int i = threadIdx.x; i < kTileX * t.ny; i += kPlaneThreads) {
    const int xi = i % kTileX, yi = i / kTileX;
    if (xi >= t.nx) continue;
    T o[F];
    if constexpr (kInt) {
      // pos >= 0 and the bin length >= 1 after the clamp: truncation floors
      const int len = max(s_raw[xi][yi + 1] - s_raw[xi][yi], 1);
#pragma unroll
      for (int f = 0; f < F; ++f) o[f] = s_pos[xi][yi * F + f] * kQFeat / len;
    } else {
      const float den = __fadd_rn(static_cast<float>(s_map[xi][yi + 1] - s_map[xi][yi]), 1e-6f);
#pragma unroll
      for (int f = 0; f < F; ++f) o[f] = __fdiv_rn(static_cast<float>(s_pos[xi][yi * F + f]), den);
    }
    store_row<T, F>(plane, static_cast<long long>(t.y0 + yi + 1) * pn_res + t.x0 + xi + 1, o);
  }
}

// K7b: the gradient g [pn_res^2, F] of K7's plane into d_table; K7pb
// (kRange): the gradient g [bins, F] of K7p's partial, over the rows [lo, hi).
template <int F, bool kSampled, bool kRange = false>
__global__ void __launch_bounds__(kPlaneThreads)
pn_plane_backward_kernel(const float* __restrict__ table, long long fine_offset,
                         long long table_rows, const int* __restrict__ entry_idx,
                         const int* __restrict__ bounds, const int* __restrict__ n_listed,
                         int cap, int sample_cap, int pn_res, const float* __restrict__ g,
                         float* __restrict__ d_table, int lo = 0, int hi = 0) {
  __shared__ int s_map[kTileX][kTileY + 1];
  __shared__ int s_cut[kRange ? kTileX : 1][kTileY + 1];
  __shared__ float s_scale[kTileX][kTileY * F];     // g / (cnt + 1e-6) a bin; K7pb: g
  const int scale = pn_res - 2;
  Tile t;
  if (!plane_tile(scale, t)) return;
  const Rows r = plane_rows(n_listed, cap, sample_cap, kSampled);
  const int warp = threadIdx.x >> 5;
  if (warp < t.nx) {
    load_map<kSampled>(bounds, scale, t, warp, r, s_map[warp], nullptr);
    if constexpr (kRange) {
      __syncwarp();
      clamp_map(s_map[warp], t.ny, lo, hi, s_cut[warp]);
    }
  }
  __syncthreads();
  if constexpr (kRange) {
    // the tile's rows of g in bin order: consecutive threads on consecutive bins
    for (int i = threadIdx.x; i < kTileY * t.nx; i += kPlaneThreads) {
      const int yi = i % kTileY, xi = i / kTileY;
      if (yi >= t.ny) continue;
      load_row<float, F>(g, static_cast<long long>(t.x0 + xi) * scale + t.y0 + yi,
                         &s_scale[xi][yi * F]);
    }
  } else {
    // the tile's gradient rows: consecutive threads on consecutive plane rows
    for (int i = threadIdx.x; i < kTileX * t.ny; i += kPlaneThreads) {
      const int xi = i % kTileX, yi = i / kTileX;
      if (xi >= t.nx) continue;
      const float den = __fadd_rn(static_cast<float>(s_map[xi][yi + 1] - s_map[xi][yi]), 1e-6f);
      float gv[F];
      load_row<float, F>(g, static_cast<long long>(t.y0 + yi + 1) * pn_res + t.x0 + xi + 1, gv);
#pragma unroll
      for (int f = 0; f < F; ++f) s_scale[xi][yi * F + f] = __fdiv_rn(gv[f], den);
    }
  }
  __syncthreads();
  if (warp >= t.nx) return;
  const float* sc = s_scale[warp];
  const int* walk_map = s_map[warp];
  if constexpr (kRange) walk_map = s_cut[warp];
  walk_run<float, F, kSampled>(table, fine_offset, table_rows, entry_idx, walk_map, t.ny, r,
                               [&](int bin, long long row, const float* v) {
    if (bin < 0) return;
    float a[F];
    bool any = false;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const bool on = positive(v[f]);
      a[f] = on ? sc[bin * F + f] : 0.f;
      any |= on;
    }
    if (!any) return;
    if constexpr (F == 4)
      atomicAdd(reinterpret_cast<float4*>(d_table) + row, make_float4(a[0], a[1], a[2], a[3]));
    else
      atomicAdd(reinterpret_cast<float2*>(d_table) + row, make_float2(a[0], a[1]));
  });
}

long long plane_tiles(int pn_res) {
  const int scale = pn_res - 2;
  return static_cast<long long>((scale + kTileX - 1) / kTileX) * ((scale + kTileY - 1) / kTileY);
}

// Enough blocks for the tiles and for the border ring's 2 * pn_res threads.
unsigned plane_blocks(int pn_res) {
  const long long tiles = plane_tiles(pn_res);
  const long long border = cnc_blocks(2LL * pn_res, kPlaneThreads);
  return static_cast<unsigned>(tiles > border ? tiles : border);
}

// K7p's launches take the tiles alone (no border); lo/hi/den only with kRange.
template <typename T, bool kSampled, bool kRange = false>
int launch_plane(const T* table, long long fine_offset, long long table_rows,
                 const int* entry_idx, const int* bounds, const int* n_listed, int cap,
                 int sample_cap, int pn_res, int f, T* plane, cudaStream_t s, int lo = 0,
                 int hi = 0, float* den = nullptr) {
  const unsigned blocks = kRange ? static_cast<unsigned>(plane_tiles(pn_res))
                                 : plane_blocks(pn_res);
  switch (f) {
    case 2: pn_plane_kernel<T, 2, kSampled, kRange><<<blocks, kPlaneThreads, 0, s>>>(table, fine_offset, table_rows, entry_idx, bounds, n_listed, cap, sample_cap, pn_res, plane, lo, hi, den); break;
    case 4: pn_plane_kernel<T, 4, kSampled, kRange><<<blocks, kPlaneThreads, 0, s>>>(table, fine_offset, table_rows, entry_idx, bounds, n_listed, cap, sample_cap, pn_res, plane, lo, hi, den); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}

template <bool kSampled, bool kRange = false>
int launch_backward(const float* table, long long fine_offset, long long table_rows,
                    const int* entry_idx, const int* bounds, const int* n_listed, int cap,
                    int sample_cap, int pn_res, int f, const float* g, float* d_table,
                    cudaStream_t s, int lo = 0, int hi = 0) {
  const unsigned blocks = static_cast<unsigned>(plane_tiles(pn_res));
  switch (f) {
    case 2: pn_plane_backward_kernel<2, kSampled, kRange><<<blocks, kPlaneThreads, 0, s>>>(table, fine_offset, table_rows, entry_idx, bounds, n_listed, cap, sample_cap, pn_res, g, d_table, lo, hi); break;
    case 4: pn_plane_backward_kernel<4, kSampled, kRange><<<blocks, kPlaneThreads, 0, s>>>(table, fine_offset, table_rows, entry_idx, bounds, n_listed, cap, sample_cap, pn_res, g, d_table, lo, hi); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}

}  // namespace

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
  return sample_cap > 0
             ? launch_plane<float, true>(table, fine_offset, table_rows, entry_idx, bounds,
                                         n_listed, cap, sample_cap, pn_res, f, plane, s)
             : launch_plane<float, false>(table, fine_offset, table_rows, entry_idx, bounds,
                                          n_listed, cap, 0, pn_res, f, plane, s);
}

// K7i: sign [tbl_rows, f] int32 (rows 4*f-byte aligned), the rest as
// cnc_pn_frac_plane's unsampled mode; plane [pn_res^2, f] int32.
CNC_EXPORT int cnc_pn_hist_int(const int* sign, long long fine_offset, long long tbl_rows,
                               const int* entry_idx, const int* bounds, const int* n_listed,
                               int cap, int pn_res, int f, int* plane, void* stream) {
  if (pn_res < 3 || cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_plane<int, false>(sign, fine_offset, tbl_rows, entry_idx, bounds, n_listed, cap,
                                  0, pn_res, f, plane, static_cast<cudaStream_t>(stream));
}

// K7b: the forward's arguments, g [pn_res^2, f] f32 (rows 4*f-byte aligned)
// and d_table [table_rows, f] f32 (rows 4*f-byte aligned), zeroed by the
// caller; adds into d_table.
CNC_EXPORT int cnc_pn_hist_backward(const float* table, long long fine_offset,
                                    long long table_rows, const int* entry_idx, const int* bounds,
                                    const int* n_listed, int cap, int sample_cap, int pn_res,
                                    int f, const float* g, float* d_table, void* stream) {
  if (pn_res < 3 || cap <= 0 || sample_cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sample_cap > 0
             ? launch_backward<true>(table, fine_offset, table_rows, entry_idx, bounds, n_listed,
                                     cap, sample_cap, pn_res, f, g, d_table, s)
             : launch_backward<false>(table, fine_offset, table_rows, entry_idx, bounds,
                                      n_listed, cap, 0, pn_res, f, g, d_table, s);
}

// K7p: the rows [lo, lo + size) of cnc_pn_frac_plane's row space (0 <= lo,
// 0 <= size; rows past the space count nothing), the rest of the arguments
// as there; partial [(pn_res-2)^2, f] f32 (rows 4*f-byte aligned) and den
// [(pn_res-2)^2] f32, every element written.
CNC_EXPORT int cnc_pn_hist_part(const float* table, long long fine_offset, long long table_rows,
                                const int* entry_idx, const int* bounds, const int* n_listed,
                                int cap, int sample_cap, int pn_res, int f, int lo, int size,
                                float* partial, float* den, void* stream) {
  if (pn_res < 3 || cap <= 0 || sample_cap < 0 || lo < 0 || size < 0 ||
      static_cast<long long>(lo) + size > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sample_cap > 0
             ? launch_plane<float, true, true>(table, fine_offset, table_rows, entry_idx, bounds,
                                               n_listed, cap, sample_cap, pn_res, f, partial, s,
                                               lo, lo + size, den)
             : launch_plane<float, false, true>(table, fine_offset, table_rows, entry_idx,
                                                bounds, n_listed, cap, 0, pn_res, f, partial, s,
                                                lo, lo + size, den);
}

// K7pb: K7p's arguments, g_part [(pn_res-2)^2, f] f32 (rows 4*f-byte aligned)
// and d_table as cnc_pn_hist_backward's, zeroed by the caller; adds into it.
CNC_EXPORT int cnc_pn_hist_part_backward(const float* table, long long fine_offset,
                                         long long table_rows, const int* entry_idx,
                                         const int* bounds, const int* n_listed, int cap,
                                         int sample_cap, int pn_res, int f, int lo, int size,
                                         const float* g_part, float* d_table, void* stream) {
  if (pn_res < 3 || cap <= 0 || sample_cap < 0 || lo < 0 || size < 0 ||
      static_cast<long long>(lo) + size > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sample_cap > 0
             ? launch_backward<true, true>(table, fine_offset, table_rows, entry_idx, bounds,
                                           n_listed, cap, sample_cap, pn_res, f, g_part, d_table,
                                           s, lo, lo + size)
             : launch_backward<false, true>(table, fine_offset, table_rows, entry_idx, bounds,
                                            n_listed, cap, 0, pn_res, f, g_part, d_table, s, lo,
                                            lo + size);
}
