// Lane gather on a transposed table: out[r, j] = tbl[r, idx[j]].
//
// Replaces: tools/pallas_probe.py pallas_gather (79, kernel 70-73), the probe
// that asked whether a VMEM-resident [8, T] transposed table could serve row
// gathers as lane shuffles (take_along_axis along the lane axis, the one
// index broadcast over the 8 sublanes).  The row gather itself is what K1
// does on the row-major [T, F] table (grid_encode.cu); this kernel keeps the
// probe's own function and layout.  No module of the port's paths calls it.
// Plain twin: cnc_torch/ops/scatter_ops.py `_lane_gather_plain`.
//
// One thread per index j reads idx[j] once and copies the `rows` values of
// column idx[j]; for each r a warp writes 32 neighbouring floats of out.  An
// index outside [0, T) is clamped into the table.  Bound on the H100: bytes
// (idx and out once, each distinct table column once); the reads are random
// 4-byte accesses, a 32-byte sector each.

#include "common.cuh"

namespace {

__global__ void lane_gather_kernel(const float* __restrict__ tbl, const int* __restrict__ idx,
                                   float* __restrict__ out, int rows, int t_cols, long long n) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int c = min(max(idx[j], 0), t_cols - 1);
  for (int r = 0; r < rows; ++r)
    out[static_cast<long long>(r) * n + j] = __ldg(tbl + static_cast<long long>(r) * t_cols + c);
}

}  // namespace

// tbl [rows, t_cols] f32, idx [n] int32, out [rows, n] f32.
CNC_EXPORT int cnc_lane_gather(const float* tbl, const int* idx, float* out, int rows,
                               int t_cols, long long n, void* stream) {
  if (n == 0 || rows == 0) return 0;
  const int threads = 256;
  lane_gather_kernel<<<cnc_blocks(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      tbl, idx, out, rows, t_cols, n);
  return cnc_last_error();
}
