// K1 and K2: multiresolution hash-grid encode, forward and backward.
//
// Replaces (cnc_tpu, the XLA composition of one encode call):
//   ops/encoding.py  _level_setup (145-152), _corner_setup (52-101, with the
//                    flat occ_mask of 90-94, without the summed-area one),
//                    _gather_levels (104-142), grid_encode_diff_levels
//                    (211-247), grid_encode_given_table (250-270)
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
// Variants for the rate estimate (K1v, and K2v in the backward), all in the
// same kernels: with `mask`, a corner is also dropped when the bool at
// mask_off[level] + flat(corner) is false, flat = (cc0*R + cc1)*R + cc2 with
// the LAST axis fastest (the mask grids' order, not the table's); with
// `min_ids`, thread (point, j) takes level clamp(min_ids[point] + j, 0, L-1)
// of the L levels described, for j < n_out; a caller's dense plane is one
// static level whose size is its row count.
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
//
// K2, the backward (d_table only), replaces cnc_tpu's
//   ops/scatter_ops.py _ggi_bwd (104-122): per-feature column scatter-adds of
//                    g*w into the table, composed with the autodiff of
//   ops/encoding.py  _gather_levels' renormalisation and out-of-range zeroing
// and is the function of the serial scatter-add probe
// tools/pallas_probe.py pallas_scatter (113, kernel 96-108).
// Plain twin: autograd of cnc_torch/ops/encoding.py `_encode_plain`.
//
// Same thread mapping as K1.  Each (point, level) recomputes its corners with
// the same device functions K1 uses (so the cells, borders and hashes agree),
// sums the surviving weight in a first pass over the corners, and in a second
// adds (g / wn) * w_c to row gidx_c of d_table with one vector atomicAdd per
// row (float4 at F=4, float2 at F=2: sm_90 adds each element atomically).
// Points outside [0,1] add nothing.  The wrapper zeroes d_table.
//
// Bound on the H100: bytes, and in practice atomics.  It reads the points and
// the gradient once and read-modify-writes each distinct row touched; the
// 2^D * L row updates per point (96 at D=3, L=12) land at random rows, and on
// the coarse dense levels hundreds of thousands of updates fall into a few
// thousand rows, which the L2 serialises.  The sum order varies from run to
// run, so the kernel is compared with its twin by a tolerance.

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;

struct Levels {
  int res[kMaxLevels];
  int offset[kMaxLevels];
  int size[kMaxLevels];
  long long mask_off[kMaxLevels];
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

// One (point, level): the lattice cell, its fractional position and the
// level's table block.
template <int D>
struct LevelCell {
  int pg[D];
  float frac[D];
  int res;
  uint32_t size;
  long long offset;
  bool dense;
  const unsigned char* mask;  // this level's corner mask grid, or null
};

// Loads point p; false when it lies outside [0,1]^D (NaN counts as outside).
template <int D>
__device__ __forceinline__ bool load_point(const float* __restrict__ points, int p, float* x) {
  bool inside = true;
  for (int ax = 0; ax < D; ++ax) {
    x[ax] = points[static_cast<long long>(p) * D + ax];
    inside &= x[ax] >= 0.f && x[ax] <= 1.f;
  }
  return inside;
}

template <int D>
__device__ __forceinline__ LevelCell<D> level_cell(const float* x, const Levels& lv, int l,
                                                   const unsigned char* mask) {
  LevelCell<D> c;
  c.mask = mask ? mask + lv.mask_off[l] : nullptr;
  c.res = lv.res[l];
  c.size = static_cast<uint32_t>(lv.size[l]);
  c.offset = lv.offset[l];
  long long rd = 1;  // R^D <= size, in 64 bits (1026^2, 514^3 fit)
  for (int ax = 0; ax < D; ++ax) rd *= c.res;
  c.dense = rd <= static_cast<long long>(c.size);
  const float scale = static_cast<float>(c.res - 2);
  for (int ax = 0; ax < D; ++ax) {
    const float pos = __fadd_rn(__fmul_rn(x[ax], scale), 0.5f);
    const float fl = floorf(pos);
    c.pg[ax] = static_cast<int>(fl);
    c.frac[ax] = __fsub_rn(pos, fl);
  }
  return c;
}

// Corner k of the cell: its D-linear weight and global table row; false when
// the corner lies on the border (coordinate 0 or R-1), or its mask bit is
// unset, and is dropped.
template <int D>
__device__ __forceinline__ bool cell_corner(const LevelCell<D>& c, int k, float* w,
                                            long long* row) {
  uint32_t cc[D];
  float wk = 1.f;
  bool valid = true;
#pragma unroll
  for (int ax = 0; ax < D; ++ax) {
    const bool up = (k >> ax) & 1;
    const int v = up ? min(c.pg[ax] + 1, c.res - 1) : c.pg[ax];
    wk = __fmul_rn(wk, up ? c.frac[ax] : __fsub_rn(1.f, c.frac[ax]));
    valid &= (v != 0) && (v != c.res - 1);
    cc[ax] = static_cast<uint32_t>(v);
  }
  *w = wk;
  if (valid && c.mask) {
    long long flat = cc[0];
#pragma unroll
    for (int ax = 1; ax < D; ++ax) flat = flat * c.res + cc[ax];
    valid = c.mask[flat] != 0;
  }
  if (valid) *row = c.offset + grid_index<D>(cc, static_cast<uint32_t>(c.res), c.size, c.dense);
  return valid;
}

// The level thread (p, j) works on: j itself, or with per-point first levels
// clamp(min_ids[p] + j, 0, n_levels - 1).
__device__ __forceinline__ int level_of(const int* __restrict__ min_ids, int p, int j,
                                        int n_levels) {
  return min_ids ? min(max(min_ids[p] + j, 0), n_levels - 1) : j;
}

template <int D, int F>
__global__ void grid_encode_forward_kernel(const float* __restrict__ points,
                                           const float* __restrict__ table,
                                           float* __restrict__ out, int n, int n_out,
                                           int n_levels, Levels lv,
                                           const unsigned char* __restrict__ mask,
                                           const int* __restrict__ min_ids) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n) * n_out) return;
  const int p = static_cast<int>(t / n_out);
  const int j = static_cast<int>(t % n_out);
  float* o = out + t * F;

  float x[D];
  if (!load_point<D>(points, p, x)) {
    for (int f = 0; f < F; ++f) o[f] = 0.f;
    return;
  }
  const LevelCell<D> cell = level_cell<D>(x, lv, level_of(min_ids, p, j, n_levels), mask);

  float acc[F];
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  float wsum = 0.f;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    float w;
    long long idx;
    if (!cell_corner<D>(cell, c, &w, &idx)) continue;
    float row[F];
    load_row<F>(table, idx, row);
    for (int f = 0; f < F; ++f) acc[f] += w * row[f];
    wsum += w;
  }
  const float wn = wsum == 0.f ? 1e-9f : wsum;
  for (int f = 0; f < F; ++f) o[f] = acc[f] / wn;
}

// One table row of d_table += v, as one vector atomic (each element is added
// atomically; the row as a whole need not be).
template <int F>
__device__ __forceinline__ void atomic_add_row(float* __restrict__ table, long long row,
                                               const float* v) {
  static_assert(F == 2 || F == 4, "K2 takes F = 2 or 4");
  if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(table) + row, make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(table) + row, make_float2(v[0], v[1]));
  }
}

template <int D, int F>
__global__ void grid_encode_backward_kernel(const float* __restrict__ points,
                                            const float* __restrict__ grad,
                                            float* __restrict__ d_table, int n, int n_out,
                                            int n_levels, Levels lv,
                                            const unsigned char* __restrict__ mask,
                                            const int* __restrict__ min_ids) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n) * n_out) return;
  const int p = static_cast<int>(t / n_out);
  const int j = static_cast<int>(t % n_out);

  float x[D];
  if (!load_point<D>(points, p, x)) return;
  const LevelCell<D> cell = level_cell<D>(x, lv, level_of(min_ids, p, j, n_levels), mask);

  float wsum = 0.f;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    float w;
    long long idx;
    if (cell_corner<D>(cell, c, &w, &idx)) wsum += w;
  }
  if (wsum == 0.f) return;  // no corner survived, or all weights are zero

  // a zero gradient adds nothing: skip its atomics (the padding rows of a
  // compacted batch all sit on one vertex and would queue on its rows)
  const float* g = grad + t * F;
  float gs[F];
  bool any = false;
  for (int f = 0; f < F; ++f) {
    any |= g[f] != 0.f;
    gs[f] = g[f] / wsum;
  }
  if (!any) return;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    float w;
    long long idx;
    if (!cell_corner<D>(cell, c, &w, &idx)) continue;
    float v[F];
    for (int f = 0; f < F; ++f) v[f] = gs[f] * w;
    atomic_add_row<F>(d_table, idx, v);
  }
}

template <int D>
int launch_b(const float* points, const float* grad, float* d_table, int n, int f, int n_out,
             int n_levels, const Levels& lv, const unsigned char* mask, const int* min_ids,
             cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = cnc_blocks(static_cast<long long>(n) * n_out, threads);
  switch (f) {
    case 2: grid_encode_backward_kernel<D, 2><<<blocks, threads, 0, stream>>>(points, grad, d_table, n, n_out, n_levels, lv, mask, min_ids); break;
    case 4: grid_encode_backward_kernel<D, 4><<<blocks, threads, 0, stream>>>(points, grad, d_table, n, n_out, n_levels, lv, mask, min_ids); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}

bool fill_levels(Levels* lv, int n_out, int n_levels, const int* res, const int* offsets,
                 const int* sizes, const long long* mask_offs) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_out < 1 || n_out > n_levels) return false;
  for (int l = 0; l < n_levels; ++l) {
    lv->res[l] = res[l];
    lv->offset[l] = offsets[l];
    lv->size[l] = sizes[l];
    lv->mask_off[l] = mask_offs[l];
  }
  return true;
}

template <int D>
int launch_f(const float* points, const float* table, float* out, int n, int f, int n_out,
             int n_levels, const Levels& lv, const unsigned char* mask, const int* min_ids,
             cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = cnc_blocks(static_cast<long long>(n) * n_out, threads);
  switch (f) {
    case 2: grid_encode_forward_kernel<D, 2><<<blocks, threads, 0, stream>>>(points, table, out, n, n_out, n_levels, lv, mask, min_ids); break;
    case 4: grid_encode_forward_kernel<D, 4><<<blocks, threads, 0, stream>>>(points, table, out, n, n_out, n_levels, lv, mask, min_ids); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}

}  // namespace

// points [n, d] f32, table [rows, f] f32, out [n, n_out*f] f32, all
// contiguous on the device.  res/offsets/sizes/mask_offs are host arrays of
// n_levels entries; the wrapper has checked offsets[l] + sizes[l] <= rows and
// that each level's mask grid lies inside `mask`.  mask (bool bytes) and
// min_ids (int32 [n]) are device pointers or null; without min_ids,
// n_out == n_levels.
CNC_EXPORT int cnc_grid_encode_forward(const float* points, const float* table, float* out,
                                       int n, int d, int f, int n_out, int n_levels,
                                       const int* res, const int* offsets, const int* sizes,
                                       const unsigned char* mask, const long long* mask_offs,
                                       const int* min_ids, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, n_out, n_levels, res, offsets, sizes, mask_offs) ||
      (!min_ids && n_out != n_levels))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 2) return launch_f<2>(points, table, out, n, f, n_out, n_levels, lv, mask, min_ids, s);
  if (d == 3) return launch_f<3>(points, table, out, n, f, n_out, n_levels, lv, mask, min_ids, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2.  points [n, d] f32, grad [n, n_out*f] f32, d_table [rows, f] f32
// zeroed by the caller and 4*f-byte aligned; levels, mask and min_ids as in
// the forward.  Adds every point's share of grad into d_table.
CNC_EXPORT int cnc_grid_encode_backward(const float* points, const float* grad, float* d_table,
                                        int n, int d, int f, int n_out, int n_levels,
                                        const int* res, const int* offsets, const int* sizes,
                                        const unsigned char* mask, const long long* mask_offs,
                                        const int* min_ids, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, n_out, n_levels, res, offsets, sizes, mask_offs) ||
      (!min_ids && n_out != n_levels))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 2) return launch_b<2>(points, grad, d_table, n, f, n_out, n_levels, lv, mask, min_ids, s);
  if (d == 3) return launch_b<3>(points, grad, d_table, n, f, n_out, n_levels, lv, mask, min_ids, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
