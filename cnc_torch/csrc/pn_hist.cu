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

}  // namespace

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
