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
// On the TPU the updates had to run serially inside one core.  Here every
// update is its own thread: thread t = i*F + f adds vals[i, f] to
// out[idx[i], f] with one float atomicAdd, so a warp reads vals coalesced and
// the F threads of a row hit neighbouring addresses.  Bound on the H100:
// bytes (idx 4 B and vals 4*F B per row read once, the table written once);
// in practice the L2's atomic rate, and the sum order varies from run to run.

#include "common.cuh"

namespace {

__global__ void scatter_add_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                                   float* __restrict__ out, long long n, int f, int size) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * f) return;
  const long long i = t / f;
  const int row = idx[i];
  if (row < 0 || row >= size) return;
  atomicAdd(out + static_cast<long long>(row) * f + (t - i * f), vals[t]);
}

}  // namespace

// vals [n, f] f32, idx [n] int32, out [size, f] f32 zeroed by the caller.
CNC_EXPORT int cnc_scatter_add(const float* vals, const int* idx, float* out, long long n, int f,
                               int size, void* stream) {
  if (n == 0 || f == 0) return 0;
  const int threads = 256;
  scatter_add_kernel<<<cnc_blocks(n * f, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(vals, idx, out, n, f, size);
  return cnc_last_error();
}
