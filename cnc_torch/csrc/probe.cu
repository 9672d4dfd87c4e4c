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
// Bound on the H100: bytes (idx and out once, each distinct table column
// once).  What holds a direct gather back is the layout: one column's `rows`
// values lie T floats apart, so an index costs `rows` 32-byte L2 sectors for
// `rows` * 4 useful bytes (at the probe's [8, 2^18] table and 2^23 indices,
// 67M sectors, 2.1 GB of L2 traffic, for a table of 8 MB).  So the call runs
// two kernels:
//   1. transpose: the table into a [groups, T, W] scratch (the wrapper's), W
//      = 4 for rows <= 4 and 8 above, groups = ceil(rows / W), rows past the
//      last zero.  A thread a (column, group): W coalesced row reads, W / 4
//      float4 stores.  8 MB at the probe's shapes, written once a call, and
//      it stays in the 50 MB L2.
//   2. gather: a thread an index reads idx[j] once (streaming, __ldcs),
//      then per group one 16- or 32-byte column (one sector) as float4s, and
//      writes its values down the output rows: for each row a warp stores 32
//      neighbouring floats.  The stores are evict-first (__stcs), so the
//      output (268 MB at the probe's shapes) does not push the scratch out of
//      L2.
// An index outside [0, T) is clamped into the table.  The result is a copy,
// equal to the twin's bit for bit.

#include "common.cuh"

namespace {

template <int W>
__global__ void lane_transpose_kernel(const float* __restrict__ tbl, float* __restrict__ scratch,
                                      int rows, int t_cols, int groups) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(t_cols) * groups) return;
  const int g = static_cast<int>(t / t_cols);
  const int c = static_cast<int>(t - static_cast<long long>(g) * t_cols);
  float v[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int r = g * W + k;
    v[k] = r < rows ? __ldg(tbl + static_cast<long long>(r) * t_cols + c) : 0.0f;
  }
  float4* dst = reinterpret_cast<float4*>(scratch) + t * (W / 4);
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int W>
__global__ void lane_gather_kernel(const float* __restrict__ scratch, const int* __restrict__ idx,
                                   float* __restrict__ out, int rows, int t_cols, int groups,
                                   long long n) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int c = min(max(__ldcs(idx + j), 0), t_cols - 1);
  for (int g = 0; g < groups; ++g) {
    const float4* src =
        reinterpret_cast<const float4*>(scratch) + (static_cast<long long>(g) * t_cols + c) * (W / 4);
    float v[W];
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 x = __ldg(src + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int r = g * W + k;
      if (r < rows) __stcs(out + static_cast<long long>(r) * n + j, v[k]);
    }
  }
}

int group_width(int rows) { return rows <= 4 ? 4 : 8; }

}  // namespace

// Floats of the transposed scratch a call on a [rows, t_cols] table takes.
CNC_EXPORT long long cnc_lane_gather_scratch(int rows, int t_cols) {
  const int w = group_width(rows);
  return static_cast<long long>((rows + w - 1) / w) * t_cols * w;
}

// tbl [rows, t_cols] f32, idx [n] int32, out [rows, n] f32, scratch of
// cnc_lane_gather_scratch(rows, t_cols) floats, 16-byte aligned; t_cols >= 1.
CNC_EXPORT int cnc_lane_gather(const float* tbl, const int* idx, float* out, float* scratch,
                               int rows, int t_cols, long long n, void* stream) {
  if (n == 0 || rows == 0) return 0;
  const int threads = 256;
  const int w = group_width(rows);
  const int groups = (rows + w - 1) / w;
  const long long cols = static_cast<long long>(t_cols) * groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 4) {
    lane_transpose_kernel<4><<<cnc_blocks(cols, threads), threads, 0, s>>>(tbl, scratch, rows,
                                                                          t_cols, groups);
    lane_gather_kernel<4><<<cnc_blocks(n, threads), threads, 0, s>>>(scratch, idx, out, rows,
                                                                      t_cols, groups, n);
  } else {
    lane_transpose_kernel<8><<<cnc_blocks(cols, threads), threads, 0, s>>>(tbl, scratch, rows,
                                                                          t_cols, groups);
    lane_gather_kernel<8><<<cnc_blocks(n, threads), threads, 0, s>>>(scratch, idx, out, rows,
                                                                      t_cols, groups, n);
  }
  return cnc_last_error();
}
