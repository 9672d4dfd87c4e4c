// Table scatter-add: out = zeros([size, F]).index_add(idx, vals), rows whose
// index falls outside [0, size) dropped.
//
// Replaces: cnc_tpu/ops/scatter_ops.py scatter_add / scatter_add_cols (31-53,
// per-column XLA scatter-adds with mode="drop"), and is the Hopper counterpart
// of the serial scatter-add probe tools/pallas_probe.py pallas_scatter (113,
// kernel 96-108: out[:, idx[i]] += val[:, i], one index after the other in a
// VMEM-resident transposed table).
// Plain twin: cnc_torch/ops/scatter_ops.py `_scatter_add_plain`.
//
// On the TPU the updates had to run serially inside one core.  Here a thread
// takes a row: it reads idx[i] once and the row's F values as V-wide vectors
// (float4, float2 or single floats; V chosen at launch from F and the
// alignment of vals and out), and adds each vector to out[idx[i]] with one
// vector atomic (sm_90's atomicAdd on float4 / float2: each element is added
// atomically, the vector as a whole need not be).  At the probe's shapes (F
// = 8, 2^23 rows into 2^18) that is 16.8M atomics where a thread a float
// made 67M, and each row's index is read once, not F times.  idx and vals
// are read once and streamed (__ldcs), so the table, 8 MB there, keeps the
// L2 where its atomics resolve.  No warp aggregation: uniform rows share a
// table row within a warp about 0.2% of the time at those shapes.  Bound on
// the H100: bytes (idx 4 B and vals 4*F B per row read once, the table
// written once); the sum order varies from run to run.

#include "common.cuh"

namespace {

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<1> {
  using T = float;
};

// vals [n, f], out [size, f]; f a multiple of V, both V * 4-byte aligned
template <int V>
__global__ void scatter_add_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                                   float* __restrict__ out, long long n, int f, int size) {
  using T = typename Vec<V>::T;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = __ldcs(idx + i);
  if (row < 0 || row >= size) return;
  const int nv = f / V;
  const T* src = reinterpret_cast<const T*>(vals) + i * nv;
  T* dst = reinterpret_cast<T*>(out) + static_cast<long long>(row) * nv;
  for (int q = 0; q < nv; ++q) atomicAdd(dst + q, __ldcs(src + q));
}

// 4 where f % 4 == 0 and both pointers are 16-byte aligned, else 2 where f is
// even and both are 8-byte aligned, else 1
int vector_width(const float* vals, const float* out, int f) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(out);
  return f % 4 == 0 && a % 16 == 0 ? 4 : f % 2 == 0 && a % 8 == 0 ? 2 : 1;
}

}  // namespace

// vals [n, f] f32, idx [n] int32, out [size, f] f32 zeroed by the caller.
CNC_EXPORT int cnc_scatter_add(const float* vals, const int* idx, float* out, long long n, int f,
                               int size, void* stream) {
  if (n == 0 || f == 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = cnc_blocks(n, threads);
  switch (vector_width(vals, out, f)) {
    case 4:
      scatter_add_kernel<4><<<blocks, threads, 0, s>>>(vals, idx, out, n, f, size);
      break;
    case 2:
      scatter_add_kernel<2><<<blocks, threads, 0, s>>>(vals, idx, out, n, f, size);
      break;
    default:
      scatter_add_kernel<1><<<blocks, threads, 0, s>>>(vals, idx, out, n, f, size);
  }
  return cnc_last_error();
}

// The vector width cnc_scatter_add takes for these pointers and f.
CNC_EXPORT int cnc_scatter_add_width(const float* vals, const float* out, int f) {
  return vector_width(vals, out, f);
}
