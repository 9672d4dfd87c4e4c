// K1: multiresolution hash-grid encode, forward.
//
// Replaces (cnc_tpu, the XLA composition of one encode call):
//   ops/encoding.py  _level_setup (145-152), _corner_setup (52-101, without
//                    the occupancy masks), _gather_levels (104-142)
//   ops/scatter_ops.py grouped_gather_interp forward (56-96)
//   ops/hash_ops.py  grid_index (67-102)
// Plain twin: cnc_torch/ops/encoding.py `_encode_plain`.
//
// For each (point, level): pos = x*(R-2)+0.5, floor/frac, the 2^D corners
// with min(pg+1, R-1), border corners (coordinate 0 or R-1) dropped, dense
// row-major index (x fastest) when R^D <= level size, else the XOR-prime hash
// masked to the level size; the weighted row sum over surviving corners is
// divided by the surviving weight (1e-9 when none survive); points outside
// [0,1] give zeros.  Output [N, L*F] f32, level-major.
//
// Bound on the H100: random reads of one table row per corner (16 B at F=4),
// 2^D rows per (point, level).  The three 2D planes (5.5 MB each) stay in the
// 50 MB L2; the 64 MB 3D table does not, so its hashed levels go to HBM at
// sector granularity.  Arithmetic is a few dozen flops per corner.
//
// Simple design: one thread per (point, level), consecutive threads on the
// levels of one point (so the output row is written contiguously), corners in
// a loop, one 16-byte __ldg per corner row at F=4 (8 bytes at F=2; no other
// F is built).  The position is rounded with __fmul_rn/__fadd_rn so the
// lattice cell matches the twin exactly; the weights may contract to FMA (the
// interpolation is continuous across cells, so the tolerance covers it).

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;

struct Levels {
  int res[kMaxLevels];
  int offset[kMaxLevels];
  int size[kMaxLevels];
};

template <int D>
__device__ __forceinline__ uint32_t grid_index(const uint32_t* cc, uint32_t res, uint32_t size,
                                               bool dense) {
  // hash_ops.grid_index: uint32 products wrap mod 2^32 (gridencoder.cu:45-87)
  uint32_t idx = 0;
  if (dense) {
    uint32_t stride = 1;
#pragma unroll
    for (int ax = 0; ax < D; ++ax) {
      idx += cc[ax] * stride;
      stride *= res;
    }
    return idx;
  }
#pragma unroll
  for (int ax = 0; ax < D; ++ax)
    idx ^= cc[ax] * (ax == 0 ? 1u : ax == 1 ? 2654435761u : 805459861u);
  return (size & (size - 1)) == 0 ? (idx & (size - 1)) : (idx % size);
}

// One table row as one 8- or 16-byte load (F = 2 or 4, the widths every
// config of the repo uses; the wrapper rejects any other F).
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ table, long long row,
                                         float* v) {
  static_assert(F == 2 || F == 4, "K1 takes F = 2 or 4");
  if constexpr (F == 4) {
    float4 q = __ldg(reinterpret_cast<const float4*>(table) + row);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    float2 q = __ldg(reinterpret_cast<const float2*>(table) + row);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int D, int F>
__global__ void grid_encode_forward_kernel(const float* __restrict__ points,
                                           const float* __restrict__ table,
                                           float* __restrict__ out, int n, int n_levels,
                                           Levels lv) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n) * n_levels) return;
  const int p = static_cast<int>(t / n_levels);
  const int l = static_cast<int>(t % n_levels);
  float* o = out + (static_cast<long long>(p) * n_levels + l) * F;

  float x[D];
  bool oob = false;
  for (int ax = 0; ax < D; ++ax) {
    x[ax] = points[static_cast<long long>(p) * D + ax];
    oob |= !(x[ax] >= 0.f && x[ax] <= 1.f);  // NaN counts as outside
  }
  if (oob) {
    for (int f = 0; f < F; ++f) o[f] = 0.f;
    return;
  }

  const int res = lv.res[l];
  const uint32_t size = static_cast<uint32_t>(lv.size[l]);
  const long long offset = lv.offset[l];
  bool dense = true;  // R^D <= size, in 64 bits (1026^2, 514^3 fit)
  {
    long long rd = 1;
    for (int ax = 0; ax < D; ++ax) rd *= res;
    dense = rd <= static_cast<long long>(size);
  }
  const float scale = static_cast<float>(res - 2);
  int pg[D];
  float frac[D];
  for (int ax = 0; ax < D; ++ax) {
    const float pos = __fadd_rn(__fmul_rn(x[ax], scale), 0.5f);
    const float fl = floorf(pos);
    pg[ax] = static_cast<int>(fl);
    frac[ax] = __fsub_rn(pos, fl);
  }

  float acc[F];
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  float wsum = 0.f;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    uint32_t cc[D];
    float w = 1.f;
    bool valid = true;
#pragma unroll
    for (int ax = 0; ax < D; ++ax) {
      const bool up = (c >> ax) & 1;
      const int v = up ? min(pg[ax] + 1, res - 1) : pg[ax];
      w = __fmul_rn(w, up ? frac[ax] : __fsub_rn(1.f, frac[ax]));
      valid &= (v != 0) && (v != res - 1);
      cc[ax] = static_cast<uint32_t>(v);
    }
    if (!valid) continue;
    const uint32_t idx = grid_index<D>(cc, static_cast<uint32_t>(res), size, dense);
    float row[F];
    load_row<F>(table, offset + idx, row);
    for (int f = 0; f < F; ++f) acc[f] += w * row[f];
    wsum += w;
  }
  const float wn = wsum == 0.f ? 1e-9f : wsum;
  for (int f = 0; f < F; ++f) o[f] = acc[f] / wn;
}

template <int D>
int launch_f(const float* points, const float* table, float* out, int n, int f,
             int n_levels, const Levels& lv, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = cnc_blocks(static_cast<long long>(n) * n_levels, threads);
  switch (f) {
    case 2: grid_encode_forward_kernel<D, 2><<<blocks, threads, 0, stream>>>(points, table, out, n, n_levels, lv); break;
    case 4: grid_encode_forward_kernel<D, 4><<<blocks, threads, 0, stream>>>(points, table, out, n, n_levels, lv); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}

}  // namespace

// points [n, d] f32, table [rows, f] f32, out [n, n_levels*f] f32, all
// contiguous on the device.  res/offsets/sizes are host arrays of n_levels
// ints; the wrapper has checked offsets[l] + sizes[l] <= rows.
CNC_EXPORT int cnc_grid_encode_forward(const float* points, const float* table, float* out,
                                       int n, int d, int f, int n_levels, const int* res,
                                       const int* offsets, const int* sizes, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Levels lv;
  for (int l = 0; l < n_levels; ++l) {
    lv.res[l] = res[l];
    lv.offset[l] = offsets[l];
    lv.size[l] = sizes[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 2) return launch_f<2>(points, table, out, n, f, n_levels, lv, s);
  if (d == 3) return launch_f<3>(points, table, out, n, f, n_levels, lv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
