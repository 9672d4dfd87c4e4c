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
// does (lo/hi: the cells the +-1-cell footprint box touches; a_fr/b_fr: the
// fractions of the box's continuous ends inside cells lo and hi, where those
// ends fall):
//   mask[c] = any occupied cell in prod_ax [lo[c_ax], hi[c_ax]]
//   ovl[c]  = sum over those cells of occ * prod_ax len_ax(cell), where
//             len(cell) = upper - lower, upper = 1 below hi and b_fr at hi,
//             lower = a_fr at lo and 0 above it: the length of the box's
//             continuous extent inside the cell (D = 3 only).
// The sums are linear in the occupancy, so summing cell by cell gives the
// separable pools' integral; only non-negative terms are added (no
// differences of large cumulative sums), so the result is closer to the exact
// value than the twin's.  The mask is held to the twin exactly, the overlap
// by a tolerance.
//
// The lattice is walked by rows: a row is the corners that share every
// coordinate but the last (c_0, c_1) in 3D, c_0 in 2D.  A row's box along the
// other axes is the same for all its corners, so a block collapses it once:
// for each cell z of the last axis,
//   bits[z] = any occupied cell of the row's box at z,
//   w[z]    = sum over the box's lines (x, y) of len_x len_y occ[x, y, z],
// Rb entries in shared memory, read from the box's lines of the occupancy
// (Rb bytes each; the 2 MB grid stays in the L2).  A thread collapses 16
// cells of the row: one 16-byte load a line, the lines' loads independent of
// each other.  When a row's box holds many lines (the coarse levels), G
// threads share each 16 cells, each summing every G-th line, and their
// partial sums are added in order, so two runs are bit-equal.  A corner then
// reads only its own [lo, hi] span of those entries: 1 to 2 at the finest
// level, at most 17 at the coarsest.  No corner walks a box, no index is
// decoded by a 64-bit division: rows come from the block index, corners from
// each thread's positions along the last axis.
//
// A block owns K consecutive rows, one contiguous span of the flat outputs.
// What a corner needs along the last axis is the same for every row, and the
// wrapper tabulates it per coordinate: lo, hi and the weights of cells lo
// and hi (in between they are 1).  A thread loads that for its positions
// along the last axis once and walks the block's rows with it: per corner
// then two shared words for the mask and the row's entries lo..hi for the
// overlap.  The results are staged in shared memory and the block writes its
// span out with consecutive threads on consecutive groups of four corners:
// one 4-byte store of the mask and one 16-byte store of the overlap a group,
// aligned to the outputs (mask_out at any byte offset: scalar heads and
// tails).  (Two earlier forms, a warp a row loading each corner's bounds and
// four corners a thread computed and stored straight to global memory,
// measured 2.5x and 3.8x slower at the finest level; see PERF.md.)

// Bound on the H100: bytes written, one bool per corner plus one f32 with the
// overlap (223M corners over the twelve 3D levels, 680 MB for the finest
// alone); the 2 MB occupancy grid is read once and stays in cache.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 264;   // two a streaming multiprocessor on the H100
constexpr int kStageBytes = 24 << 10;   // a block's staged outputs

// One coordinate's row of the wrapper's table: lo, hi, a_fr, b_fr (f32 bits;
// the box along an axis of the row), then lo, hi, w_lo, w_hi (f32 bits; the
// weights of cells lo and hi when the coordinate is a corner's last one).
struct Bound {
  int lo, hi;
  float a_fr, b_fr;
};

__device__ __forceinline__ Bound load_bound(const int4* __restrict__ table, int c) {
  const int4 q = __ldg(table + 2 * c);
  return Bound{q.x, q.y, __int_as_float(q.z), __int_as_float(q.w)};
}

// Length of the box's continuous extent inside `cell`, for lo <= cell <= hi.
__device__ __forceinline__ float cell_len(int cell, const Bound& b) {
  const float upper = cell < b.hi ? 1.f : b.b_fr;
  const float lower = cell == b.lo ? b.a_fr : 0.f;
  return upper - lower;
}

// Whether any of bits [lo, hi] is set in a row's words, word by word (boxes
// over 32 cells).
__device__ __forceinline__ bool any_in(const unsigned* __restrict__ words, int lo, int hi) {
  unsigned hit = 0u;
  for (int v = lo >> 5; v <= (hi >> 5); ++v) {
    unsigned span = v == (lo >> 5) ? ~0u << (lo & 31) : ~0u;
    if (v == (hi >> 5) && (hi & 31) != 31) span &= (2u << (hi & 31)) - 1u;
    hit |= words[v] & span;
  }
  return hit != 0u;
}

// The low bits of four bool bytes as four bits.
__device__ __forceinline__ unsigned nibble(unsigned word) {
  return (((word & 0x01010101u) * 0x01020408u) >> 24) & 0xFu;
}

// WIDE: boxes of more than two cells along the last axis (the coarser
// levels); without it the corner walk has no loop over the box's interior,
// which measured 1.4x faster at the finest level (see PERF.md)
template <int D, bool OVL, bool WIDE>
__global__ void __launch_bounds__(kThreads)
footprint_rows_kernel(const unsigned char* __restrict__ occ, int rb, int r,
                      const int4* __restrict__ table, int g_threads, int k_rows,
                      unsigned char* __restrict__ mask, float* __restrict__ ovl) {
  extern __shared__ unsigned smem[];
  const int chunks = rb >> 4, nwords = (rb + 31) >> 5;
  // per thread: 16 partial sums and 16 bits; per row of the block: the
  // totals (the partials themselves when one thread takes each 16 cells)
  float* part = reinterpret_cast<float*>(smem);                           // [K][G][rb] (OVL)
  float* w = g_threads == 1 ? part : part + (OVL ? k_rows * g_threads * rb : 0);   // [K][rb]
  unsigned* pbits = reinterpret_cast<unsigned*>(
      part + (OVL ? k_rows * g_threads * rb + (g_threads == 1 ? 0 : k_rows * rb) : 0));
  unsigned* bits = pbits + k_rows * g_threads * chunks;                  // [K][nwords]
  // the block's outputs, staged: [K * r + 3] floats (OVL) at a 16-byte
  // boundary, then [K * r + 3] bytes
  float* stage_ovl = reinterpret_cast<float*>(
      reinterpret_cast<uintptr_t>(bits + k_rows * nwords + 3) & ~static_cast<uintptr_t>(15));
  unsigned char* stage_mask =
      reinterpret_cast<unsigned char*>(stage_ovl + (OVL ? k_rows * r + 3 : 0));

  const long long rows = D == 3 ? static_cast<long long>(r) * r : r;
  const long long row0 = static_cast<long long>(blockIdx.x) * k_rows;
  const int n_rows = static_cast<int>(min(static_cast<long long>(k_rows), rows - row0));

  // ---- collapse: thread (k, g, c) sums lines g, g + G, ... of row k's box
  // over cells 16c .. 16c + 15
  {
    const int c = threadIdx.x % chunks, rest = threadIdx.x / chunks;
    const int g = rest % g_threads, k = rest / g_threads;
    if (k < n_rows) {
      const int row = static_cast<int>(row0 + k);
      const int cx = D == 3 ? row / r : row;
      const Bound bx = load_bound(table, cx);
      const Bound by = D == 3 ? load_bound(table, row - cx * r) : Bound{0, 0, 0.f, 1.f};
      const int ny = by.hi - by.lo + 1;
      const int n_lines = (bx.hi - bx.lo + 1) * ny;
      float acc[16];
#pragma unroll
      for (int b = 0; b < 16; ++b) acc[b] = 0.f;
      uint4 any = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
      for (int li = g; li < n_lines; li += g_threads) {
        const int x = bx.lo + li / ny, y = by.lo + li % ny;
        const long long line = D == 3 ? static_cast<long long>(x) * rb + y : x;
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(occ + line * rb) + c);
        any.x |= q.x; any.y |= q.y; any.z |= q.z; any.w |= q.w;
        if (OVL && (q.x | q.y | q.z | q.w)) {
          const float wl = cell_len(x, bx) * cell_len(y, by);
          const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if ((words[b >> 2] >> ((b & 3) << 3)) & 1u) acc[b] += wl;
        }
      }
      const int slot = (k * g_threads + g) * chunks + c;
      pbits[slot] = nibble(any.x) | nibble(any.y) << 4 | nibble(any.z) << 8 | nibble(any.w) << 12;
      if (OVL) {
        float4* dst = reinterpret_cast<float4*>(part + (k * g_threads + g) * rb + (c << 4));
#pragma unroll
        for (int b = 0; b < 4; ++b)
          dst[b] = make_float4(acc[4 * b], acc[4 * b + 1], acc[4 * b + 2], acc[4 * b + 3]);
      }
    }
  }
  __syncthreads();
  // the row totals: partials added in order
  for (int i = threadIdx.x; i < n_rows * nwords; i += kThreads) {
    const int kk = i / nwords, wd = i - kk * nwords;
    unsigned b = 0u;
    for (int gg = 0; gg < g_threads; ++gg) {
      const unsigned* pb = pbits + (kk * g_threads + gg) * chunks;
      b |= pb[2 * wd] | (2 * wd + 1 < chunks ? pb[2 * wd + 1] << 16 : 0u);
    }
    bits[i] = b;
  }
  if (OVL && g_threads > 1) {
    for (int i = threadIdx.x; i < n_rows * rb; i += kThreads) {
      const int kk = i / rb, z = i - kk * rb;
      float s = 0.f;
      for (int gg = 0; gg < g_threads; ++gg) s += part[(kk * g_threads + gg) * rb + z];
      w[i] = s;
    }
  }
  __syncthreads();

  // ---- corners: a thread takes positions cz = t, t + 256, .. along the last
  // axis and holds their tabulated bounds and weights while it walks the
  // block's rows, into the block's staged span in shared memory; placed at
  // the outputs' alignment phase, so the span is written out four aligned
  // corners a store
  const long long span0 = row0 * r;
  const int span = n_rows * r;
  const int mask_phase = static_cast<int>(reinterpret_cast<uintptr_t>(mask + span0) & 3);
  const int ovl_phase =
      OVL ? static_cast<int>((reinterpret_cast<uintptr_t>(ovl + span0) >> 2) & 3) : 0;
  unsigned char* st_mask = stage_mask + mask_phase;
  float* st_ovl = stage_ovl + ovl_phase;
  for (int cz = threadIdx.x; cz < r; cz += kThreads) {
    const int4 t = __ldg(table + 2 * cz + 1);
    const int lo = t.x, hi = t.y, n = hi - lo + 1;
    const float w_lo = __int_as_float(t.z), w_hi = __int_as_float(t.w);
    // bits [lo, hi] of a box of at most 32 cells: in the pair of words from
    // lo's on (at the row's last word the second is that word again, which
    // the span does not reach)
    const int wd = lo >> 5, wd2 = min(wd + 1, nwords - 1), sh = lo & 31;
    const unsigned long long span_bits = (1ull << min(n, 32)) - 1ull;
    for (int kk = 0; kk < n_rows; ++kk) {
      const unsigned* rbits = bits + kk * nwords;
      const int at = kk * r + cz;
      if (!WIDE || n <= 32) {
        const unsigned long long pair =
            rbits[wd] | static_cast<unsigned long long>(rbits[wd2]) << 32;
        st_mask[at] = ((pair >> sh) & span_bits) != 0ull;
      } else {
        st_mask[at] = any_in(rbits, lo, hi);
      }
      if (OVL) {
        // cell hi weighs 0 when it is cell lo
        const float* wr = w + kk * rb;
        float s = w_lo * wr[lo];
        if (WIDE)
          for (int z = lo + 1; z < hi; ++z) s += wr[z];
        st_ovl[at] = s + w_hi * wr[hi];
      }
    }
  }
  __syncthreads();
  // ---- the span out: scalar heads and tails, aligned groups of four between
  {
    unsigned char* dst = mask + span0;
    const int head = min((4 - mask_phase) & 3, span), body = (span - head) >> 2;
    for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = st_mask[i];
    for (int g = threadIdx.x; g < body; g += kThreads)
      *reinterpret_cast<uchar4*>(dst + head + 4 * g) =
          *reinterpret_cast<const uchar4*>(st_mask + head + 4 * g);
    for (int i = head + 4 * body + threadIdx.x; i < span; i += kThreads) dst[i] = st_mask[i];
  }
  if (OVL) {
    float* dst = ovl + span0;
    const int head = min((4 - ovl_phase) & 3, span), body = (span - head) >> 2;
    for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = st_ovl[i];
    for (int g = threadIdx.x; g < body; g += kThreads)
      *reinterpret_cast<float4*>(dst + head + 4 * g) =
          *reinterpret_cast<const float4*>(st_ovl + head + 4 * g);
    for (int i = head + 4 * body + threadIdx.x; i < span; i += kThreads) dst[i] = st_ovl[i];
  }
}

template <int D, bool OVL>
int launch(const unsigned char* occ, int rb, int r, const int4* table, int max_span,
           unsigned char* mask, float* ovl, cudaStream_t s) {
  // threads per 16 cells of a row: enough that each sums at most about 8 of
  // the box's lines; the rest of the block's threads take further rows
  const int chunks = rb >> 4, lines = D == 3 ? max_span * max_span : max_span;
  int g_threads = 1;
  while (g_threads * 2 * chunks <= kThreads && g_threads * 8 < lines) g_threads <<= 1;
  // rows per block: as many as the threads collapse at once, but few enough
  // that the grid fills the card (a plane level has only r rows) and that
  // the staged outputs fit kStageBytes
  const long long rows = D == 3 ? static_cast<long long>(r) * r : r;
  const int per_corner = OVL ? 5 : 1;
  const int k_rows = static_cast<int>(std::min<long long>(
      {kThreads / (g_threads * chunks),
       std::max<long long>(1, (rows + kMinBlocks - 1) / kMinBlocks),
       std::max(1, kStageBytes / (r * per_corner))}));
  const int nwords = (rb + 31) >> 5;
  const size_t part = OVL ? static_cast<size_t>(k_rows) * g_threads * rb : 0;
  const size_t totals = OVL && g_threads > 1 ? static_cast<size_t>(k_rows) * rb : 0;
  const size_t smem = (part + totals) * sizeof(float) +
                      (static_cast<size_t>(k_rows) * g_threads * chunks +
                       static_cast<size_t>(k_rows) * nwords) * sizeof(unsigned) +
                      16 + (static_cast<size_t>(k_rows) * r + 3) * per_corner;
  if (max_span > 2)
    footprint_rows_kernel<D, OVL, true><<<cnc_blocks(rows, k_rows), kThreads, smem, s>>>(
        occ, rb, r, table, g_threads, k_rows, mask, ovl);
  else
    footprint_rows_kernel<D, OVL, false><<<cnc_blocks(rows, k_rows), kThreads, smem, s>>>(
        occ, rb, r, table, g_threads, k_rows, mask, ovl);
  return cnc_last_error();
}

}  // namespace

// occ [rb^d] bool bytes (row-major, last axis fastest, 16-byte aligned);
// table [r, 8] int32, the rows of the struct Bound comment, with
// 0 <= lo <= hi < rb (the wrapper checks them, and that the continuous ends
// fall in cells lo and hi); max_span the largest hi - lo + 1;
// mask [r^d] bool bytes at any offset; ovl [r^3] f32 or null (d = 3 only).
// 16 <= rb <= 512, a multiple of 16.
CNC_EXPORT int cnc_footprint(const unsigned char* occ, int rb, int d, int r, const int* table,
                             int max_span, unsigned char* mask, float* ovl, void* stream) {
  if (r <= 0) return 0;
  if (rb < 16 || rb > 512 || rb % 16 || max_span <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(occ) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* t = reinterpret_cast<const int4*>(table);
  if (d == 3) {
    return ovl ? launch<3, true>(occ, rb, r, t, max_span, mask, ovl, s)
               : launch<3, false>(occ, rb, r, t, max_span, mask, ovl, s);
  }
  if (d == 2 && !ovl) return launch<2, false>(occ, rb, r, t, max_span, mask, ovl, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
