// K7: the dimension-wise prior's sign histogram.
//
// Replaces: cnc_tpu/models/context_models.py pn_frac_plane's inner sum
// (783-792): a gather of the finest level's rows at the bin-sorted entry
// indices, the straight-through indicator _pos_indicator (53-66, entry > 0.9),
// the row mask, and _csum_diffs (1371-1381), per-feature cumulative sums
// differenced at the bin boundaries.
// Plain twin: cnc_torch/ops/context_ops.py `_pn_hist_plain`.
//
// pos[b, f] = #{ r in [bnd[b], bnd[b+1]) : row_valid[r] and
//                table[fine_offset + sel[r], f] > 0.9 }.
// The rows of a bin are contiguous (the refresh sorts the coord list by bin),
// so a histogram needs neither a sort nor atomics: one thread per bin walks
// its rows and counts.  The counts are small integers held in f32, so the
// kernel equals its twin exactly whatever the order.
//
// Bound on the H100: bytes; one random 16-byte table row per valid row (2^21
// rows a plane when sampled, 2^24 when not) out of the 8 MB finest level,
// which the L2 holds, plus sel, row_valid, bnd and the 4 MB output.  Bins
// differ in length, so warps diverge; the simple form stays.
//
// The backward (reached only with pn_frac_grad) is the indicator's
// straight-through rule: d_table[fine_offset + sel[r], f] += g[bin(r), f]
// where the entry is > 0.9 and the row valid, as atomics into a zeroed table.
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

template <int F>
__global__ void pn_hist_kernel(const float* __restrict__ table, long long fine_offset,
                               long long table_rows, const int* __restrict__ sel,
                               const unsigned char* __restrict__ row_valid,
                               const int* __restrict__ bnd, float* __restrict__ pos,
                               int n_bins, int n_rows) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_bins) return;
  const int lo = min(max(bnd[b], 0), n_rows), hi = min(max(bnd[b + 1], 0), n_rows);
  int cnt[F];
#pragma unroll
  for (int f = 0; f < F; ++f) cnt[f] = 0;
  for (int r = lo; r < hi; ++r) {
    if (!row_valid[r]) continue;
    const long long row = min(max(fine_offset + sel[r], 0LL), table_rows - 1);
    float v[F];
    load_row<F>(table, row, v);
#pragma unroll
    for (int f = 0; f < F; ++f) cnt[f] += v[f] > 0.9f ? 1 : 0;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) pos[static_cast<long long>(b) * F + f] = static_cast<float>(cnt[f]);
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

// table [table_rows, f] f32 (rows 4*f-byte aligned), sel [n_rows] int32,
// row_valid [n_rows] bool bytes, bnd [n_bins + 1] int32 ascending, pos
// [n_bins, f] f32 (every element written); f in (2, 4).
CNC_EXPORT int cnc_pn_hist(const float* table, long long fine_offset, long long table_rows,
                           const int* sel, const unsigned char* row_valid, const int* bnd,
                           float* pos, int n_bins, int n_rows, int f, void* stream) {
  if (n_bins == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned blocks = cnc_blocks(n_bins, threads);
  switch (f) {
    case 2: pn_hist_kernel<2><<<blocks, threads, 0, s>>>(table, fine_offset, table_rows, sel, row_valid, bnd, pos, n_bins, n_rows); break;
    case 4: pn_hist_kernel<4><<<blocks, threads, 0, s>>>(table, fine_offset, table_rows, sel, row_valid, bnd, pos, n_bins, n_rows); break;
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
