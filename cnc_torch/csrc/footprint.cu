// K8: per-corner occupancy footprint grids of one level lattice.
//
// Replaces: cnc_tpu/models/context_models.py _dense_mask_grid (1384-1412) and
// _dense_mask_overlap_grids (1415-1459): D separable box pools over the
// occupancy grid, each a cumulative sum along one axis read at per-corner
// bounds (and, for the overlap, interpolated at the continuous bounds).
// Plain twin: cnc_torch/ops/context_ops.py `_footprint_plain`, which keeps
// cnc_tpu's separable order.
//
// For corner c = (c_0, .., c_{D-1}) of an R^D lattice over an Rb^D occupancy
// grid, with the per-axis bounds the wrapper computes in float64 as cnc_tpu
// does (lo/hi: the cells the +-1-cell footprint box touches; a/b: the box's
// continuous ends in cell units, each split into its cell a_i = floor(a) and
// the f32 fraction a - a_i):
//   mask[c] = any occupied cell in prod_ax [lo[c_ax], hi[c_ax]]
//   ovl[c]  = sum over those cells of occ * prod_ax len_ax(cell), where
//             len(cell) = clamp(b - cell, 0, 1) - clamp(a - cell, 0, 1)
//             is the length of [a, b] inside the cell (D = 3 only).
// This is the direct form of the separable pools: the sums are linear in the
// occupancy, so summing cell by cell gives the same integral.  It adds only
// non-negative terms (no differences of large cumulative sums), so it is
// closer to the exact value than the twin; the two are held together by a
// tolerance on ovl and exactly on mask.
//
// Bound on the H100: bytes written, one bool per corner plus one f32 with the
// overlap (223M corners over the twelve 3D levels, 680 MB for the finest
// alone); the 2 MB occupancy grid stays in cache.  The work per corner is the
// box's cell count: up to 8^3 on the coarsest context level, 2^3 on the
// finest, where nearly all corners are.  One thread per corner, last axis
// fastest, so a warp writes 32 neighbouring outputs and reads neighbouring
// cells.

#include "common.cuh"

namespace {

struct Axis {
  const int* lo;
  const int* hi;
  const int* a_i;
  const int* b_i;
  const float* a_fr;
  const float* b_fr;
};

// Length of [a, b] inside cell `cell`, from the split bounds.
__device__ __forceinline__ float cell_len(int cell, int a_i, float a_fr, int b_i, float b_fr) {
  const float upper = cell < b_i ? 1.f : (cell == b_i ? b_fr : 0.f);
  const float lower = cell < a_i ? 1.f : (cell == a_i ? a_fr : 0.f);
  return upper - lower;
}

template <bool OVL>
__global__ void footprint3_kernel(const unsigned char* __restrict__ occ, int rb, int r, Axis ax,
                                  unsigned char* __restrict__ mask, float* __restrict__ ovl) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(r) * r * r;
  if (t >= total) return;
  const int cz = static_cast<int>(t % r);
  const int cy = static_cast<int>((t / r) % r);
  const int cx = static_cast<int>(t / (static_cast<long long>(r) * r));
  const int x0 = ax.lo[cx], x1 = ax.hi[cx];
  const int y0 = ax.lo[cy], y1 = ax.hi[cy];
  const int z0 = ax.lo[cz], z1 = ax.hi[cz];
  // the continuous bounds of the three axes, read once (unused without OVL)
  int ai[3] = {0, 0, 0}, bi[3] = {0, 0, 0};
  float af[3] = {0.f, 0.f, 0.f}, bf[3] = {0.f, 0.f, 0.f};
  if (OVL) {
    const int c[3] = {cx, cy, cz};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ai[k] = ax.a_i[c[k]]; af[k] = ax.a_fr[c[k]];
      bi[k] = ax.b_i[c[k]]; bf[k] = ax.b_fr[c[k]];
    }
  }
  bool any = false;
  float sum = 0.f;
  for (int x = x0; x <= x1; ++x) {
    float sx = 0.f;
    for (int y = y0; y <= y1; ++y) {
      const unsigned char* line = occ + (static_cast<long long>(x) * rb + y) * rb;
      float sy = 0.f;
      for (int z = z0; z <= z1; ++z) {
        if (!line[z]) continue;
        any = true;
        if (OVL) sy += cell_len(z, ai[2], af[2], bi[2], bf[2]);
      }
      if (OVL) sx += sy * cell_len(y, ai[1], af[1], bi[1], bf[1]);
    }
    if (OVL) sum += sx * cell_len(x, ai[0], af[0], bi[0], bf[0]);
  }
  mask[t] = any ? 1 : 0;
  if (OVL) ovl[t] = sum;
}

__global__ void footprint2_kernel(const unsigned char* __restrict__ occ, int rb, int r, Axis ax,
                                  unsigned char* __restrict__ mask) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(r) * r) return;
  const int cy = static_cast<int>(t % r);
  const int cx = static_cast<int>(t / r);
  const int y0 = ax.lo[cy], y1 = ax.hi[cy];
  bool any = false;
  for (int x = ax.lo[cx]; x <= ax.hi[cx] && !any; ++x)
    for (int y = y0; y <= y1; ++y)
      if (occ[static_cast<long long>(x) * rb + y]) { any = true; break; }
  mask[t] = any ? 1 : 0;
}

}  // namespace

// occ [rb^d] bool bytes (row-major, last axis fastest); bounds_i [4, r] int32
// rows lo, hi, a_i, b_i; bounds_f [2, r] f32 rows a_fr, b_fr; mask [r^d] bool
// bytes; ovl [r^3] f32 or null (d = 3 only).  The wrapper has checked
// 0 <= lo <= hi < rb.
CNC_EXPORT int cnc_footprint(const unsigned char* occ, int rb, int d, int r, const int* bounds_i,
                             const float* bounds_f, unsigned char* mask, float* ovl,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Axis ax{bounds_i, bounds_i + r, bounds_i + 2 * r, bounds_i + 3 * r, bounds_f,
                bounds_f + r};
  const int threads = 256;
  if (d == 3) {
    const unsigned blocks = cnc_blocks(static_cast<long long>(r) * r * r, threads);
    if (ovl) footprint3_kernel<true><<<blocks, threads, 0, s>>>(occ, rb, r, ax, mask, ovl);
    else footprint3_kernel<false><<<blocks, threads, 0, s>>>(occ, rb, r, ax, mask, ovl);
  } else if (d == 2) {
    if (ovl) return static_cast<int>(cudaErrorInvalidValue);
    footprint2_kernel<<<cnc_blocks(static_cast<long long>(r) * r, threads), threads, 0, s>>>(
        occ, rb, r, ax, mask);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}
