// K6: context pooling, masked per-segment sums over sorted segment ids.
//
// Replaces: cnc_tpu/models/context_models.py _segment_tail_values (123-140),
// one XLA scatter-add of the masked rows into [num_segments(, F)] zeros with
// invalid rows routed out of range and dropped; its users are the 3D
// overlap-weighted pooling (1346-1357) and the 2D count pooling (1025-1043).
// Plain twin: cnc_torch/ops/context_ops.py `_segment_pool_plain`.
//
// out[seg[i], :] += x[i, :] for every row with valid[i] and seg[i] in
// [0, num_segments); the wrapper zeroes out.  The ids of one entry's rows are
// contiguous (the vertex tables are sorted by entry), broken only by invalid
// rows, so most of a warp's 32 rows fall into a handful of runs.
//
// Bound on the H100: bytes (x, seg and valid read once, out written once; at
// 2^21 rows of F=4 about 44 MB, 13 us).  What costs in practice is the atomic
// rate, so the design cuts the atomics: one thread per row, a segmented
// inclusive scan by warp shuffles over each run of equal ids inside the warp
// (five steps), and one atomicAdd per run and feature from the run's last
// lane.  Runs that cross a warp meet in the atomics, so the order of the
// f32 adds, and the last bits, vary from run to run.
//
// The backward is a gather: d_x[i, :] = valid[i] ? g[seg[i], :] : 0.

#include "common.cuh"

namespace {

template <int F>
__global__ void segment_pool_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                                    const unsigned char* __restrict__ valid,
                                    float* __restrict__ out, long long n, int num_segments) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int key = -1;
  float v[F];
#pragma unroll
  for (int f = 0; f < F; ++f) v[f] = 0.f;
  if (i < n && valid[i]) {
    const int s = seg[i];
    if (s >= 0 && s < num_segments) {
      key = s;
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = x[i * F + f];
    }
  }
  // runs of equal keys: a lane heads a run when its key differs from the
  // lane before it
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const bool head = lane == 0 || prev != key;
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float u = __shfl_up_sync(0xffffffffu, v[f], o);
      if (lane - o >= start) v[f] += u;
    }
  }
  const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (tail && key >= 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(out + static_cast<long long>(key) * F + f, v[f]);
  }
}

template <int F>
__global__ void segment_pool_backward_kernel(const float* __restrict__ g,
                                             const int* __restrict__ seg,
                                             const unsigned char* __restrict__ valid,
                                             float* __restrict__ d_x, long long n,
                                             int num_segments) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = seg[i];
  const bool live = valid[i] && s >= 0 && s < num_segments;
#pragma unroll
  for (int f = 0; f < F; ++f)
    d_x[i * F + f] = live ? g[static_cast<long long>(s) * F + f] : 0.f;
}

}  // namespace

// x [n, f] f32, seg [n] int32, valid [n] bool bytes, out [num_segments, f] f32
// zeroed by the caller; f in (1, 2, 4).
CNC_EXPORT int cnc_segment_pool(const float* x, const int* seg, const unsigned char* valid,
                                float* out, long long n, int f, int num_segments,
                                void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const unsigned blocks = cnc_blocks(n, threads);
  switch (f) {
    case 1: segment_pool_kernel<1><<<blocks, threads, 0, s>>>(x, seg, valid, out, n, num_segments); break;
    case 2: segment_pool_kernel<2><<<blocks, threads, 0, s>>>(x, seg, valid, out, n, num_segments); break;
    case 4: segment_pool_kernel<4><<<blocks, threads, 0, s>>>(x, seg, valid, out, n, num_segments); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}

// g [num_segments, f] f32, d_x [n, f] f32 (every element written).
CNC_EXPORT int cnc_segment_pool_backward(const float* g, const int* seg,
                                         const unsigned char* valid, float* d_x, long long n,
                                         int f, int num_segments, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const unsigned blocks = cnc_blocks(n, threads);
  switch (f) {
    case 1: segment_pool_backward_kernel<1><<<blocks, threads, 0, s>>>(g, seg, valid, d_x, n, num_segments); break;
    case 2: segment_pool_backward_kernel<2><<<blocks, threads, 0, s>>>(g, seg, valid, d_x, n, num_segments); break;
    case 4: segment_pool_backward_kernel<4><<<blocks, threads, 0, s>>>(g, seg, valid, d_x, n, num_segments); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}
