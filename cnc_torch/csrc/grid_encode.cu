// K1 and K2: multiresolution hash-grid encode, forward and backward.
//
// Replaces (cnc_tpu, the XLA composition of one encode call):
//   ops/encoding.py  _level_setup (145-152), _corner_setup (52-101, with the
//                    flat occ_mask of 90-94 and the summed-area one of 95-97),
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
// same kernels: with a mask, a corner is also dropped when bit
// mask_off[level] + flat(corner) of the packed mask is unset, flat =
// (cc0*R + cc1)*R + cc2 with the LAST axis fastest (the mask grids' order,
// not the table's); bit i lives in word i / 32 at bit i % 32 (the bool grid
// packed little-endian by `cnc_pack_mask_bits` below, once per cache
// refresh); with `min_ids`, point p takes level clamp(min_ids[p] + j, 0, L-1)
// of the L levels described, for j < n_out; a caller's dense plane is one
// static level whose size is its row count.
//
// Bound on the H100: random reads of one table row per corner (16 B at F=4),
// 2^D rows per (point, level).  The three 2D planes (5.5 MB each) stay in the
// 50 MB L2; the 64 MB 3D table does not, so its hashed levels go to HBM at
// sector granularity.  Arithmetic is a few dozen flops per corner.
//
// Design.  A block of 8 warps takes a tile of points and every one of their
// n_out levels.  Lanes map to points and each warp walks its levels one pass
// at a time, so a warp's level (resolution, offset, dense or hashed) is
// uniform: always for K1, and for K1v's compacted rows, which come grouped by
// level, everywhere but at a window's edge.  `wpt` warps share 32 points and
// split their levels (wpt divides n_out where it can); the points (and level
// ids) are staged in shared memory with coalesced loads, and the output tile
// is staged there and written back as contiguous float4 (float2) rows.  Per
// (point, level), all 2^D corners' rows, weights and mask words are computed
// first, then every surviving corner's row load is issued at once
// (predicated, no branch between them), then the corners are summed in order
// 0..2^D-1.  The packed masks are an eighth of the bool grids (all 3D levels
// 26.6 MB against 0.208 GiB), so they stay in L2 beside the table.  The file
// is built with -fmad=false and sums the corners in the twin's order, so the
// forward equals its twin bit for bit: the rate estimate feeds it to a
// LeakyReLU MLP, whose gradient jumps where an input crosses a kink, and a
// last-bit difference would move the kernel's gradient to one side and the
// twin's to the other.
//
// K2, the backward (d_table only), replaces cnc_tpu's
//   ops/scatter_ops.py _ggi_bwd (104-122): per-feature column scatter-adds of
//                    g*w into the table, composed with the autodiff of
//   ops/encoding.py  _gather_levels' renormalisation and out-of-range zeroing
// and is the function of the serial scatter-add probe
// tools/pallas_probe.py pallas_scatter (113, kernel 96-108).
// Plain twin: autograd of cnc_torch/ops/encoding.py `_encode_plain`.
//
// Same tiling and corners as K1 (the output gradient's tile is staged in
// shared memory as the forward's output is), each corner computed once and
// kept in registers through the surviving weight's sum and the adds of
// (g / wn) * w_c.  The adds are aggregated in the warp: for each corner slot
// the lanes that add into one row find each other (__match_any_sync), sum
// their values by shuffles, and the group's lowest lane issues one vector
// atomicAdd (float4 at F=4, float2 at F=2; sm_90 adds each element
// atomically).  A march emits samples in (ray, t) order, so neighbouring
// lanes often share the coarse levels' rows: at a training march's 30.5M
// updates of the xyz table this issues 12.0M atomics.  Summing across the
// slots as well would leave 7.9M, but a per-warp table of pending adds in
// shared memory (256 slots, linear probing) cost 4x the time (PERF.md).  The
// rate's 3D context encode shares few rows between lanes (48.0M updates,
// 45.2M atomics).  Points outside [0,1], corners without weight and zero
// gradients (the padding rows of a compacted batch, which all sit on one
// vertex) add nothing.  The wrapper zeroes d_table.
//
// Bound on the H100: bytes, and in practice atomics.  It reads the points and
// the gradient once and read-modify-writes each distinct row touched; the
// 2^D * L row updates per point (96 at D=3, L=12) land at random rows, and on
// the coarse dense levels hundreds of thousands of updates fall into a few
// thousand rows, which the L2 serialises.  The sum order varies from run to
// run, so the kernel is compared with its twin by a tolerance.
//
// K1s and K2s: the same two kernels masked by a summed-area table, through
// sources made from it (template parameter Sat), the counterpart of cnc_tpu's
// `occupancy_mask(occ_sat, cc, R, rb)` inside _corner_setup (ops/encoding.py
// 95-97, ops/sat.py 68-98; the TPU form of the reference's corner walk,
// gridencoder.cu:222-276): a corner is kept when its footprint box on the
// Rb grid, formed as sat.footprint_box forms it (float32 without FMA:
// scale = 1/(R-2) rounded once, pn = (c - 0.5)*scale, lo/hi =
// trunc(clamp((pn -/+ scale)*Rb, 0, Rb-1))), holds an occupied cell.  The
// table is int32 [Rb+1]^D with the last axis fastest (8.6 MB at Rb = 128).
// Plain twin: ops/encoding.py `_encode_plain(occ_sat=)`, over ops/sat.py.
//
// Bound on the H100: the table rows as for K1, plus the sources' words and
// windows that the corners read (the sources launch reads the SAT once).
// The first form gathered the 2^D table entries of every live corner's box:
// (2^D)^2 scattered int32 gathers a (point, level), each a 32-byte L2
// sector, about 8 GB of L2 traffic at grid_3d over 327,680 points, and 45x
// the bound.  The mask is boolean, so any exact way to decide "an occupied
// cell in the box" gives the same bits; this form cuts the gathers by
// splitting the levels at the wrapper (`_sat_layout`, from R and Rb):
//   * coarse levels (R - 2 <= Rb: the box is a cell or wider, R^D <=
//     (Rb+2)^D vertices; grid_3d's levels 0-6, 2.1M vertices): one launch a
//     call (`cnc_sat_mask_sources`, a warp a word in lattice order, so the
//     table reads coalesce) writes every vertex's bit, packed as the rate's
//     masks are, and the encode reads one bit a corner as K1v does;
//   * fine levels (R - 2 > Rb: the box is under two cells wide, and the 2^D
//     corners' boxes overlap): the same launch packs the occupancy itself,
//     one bit a cell recovered from the table, in rows along the last axis
//     (256 KB of bits at Rb = 128 in 3D, held as 64-bit windows, 512 KB, so
//     that any 4 cells of a row are one load).  A (point, level) forms each
//     axis's two boxes (corner coordinate pg and pg+1), loads the window of
//     at most 4 (2D) or 4x4 (3D) rows over the union of its corners' boxes,
//     4 bits a row, and decides every corner from registers by ORs and
//     masks.  The wrapper
//     makes a level fine only when every such window, formed in the same
//     float32 steps, spans at most 4 cells an axis (at R - 2 > Rb the two
//     boxes of an axis cover less than 3 cells' length; only rounding at a
//     large Rb could widen them, and such a level goes coarse), so the
//     encodes never read the table.
// K2s takes the forward's sources (the autograd context keeps them), so the
// backward evaluates no table.  Exact either way, so the forward stays
// bit-equal to its twin.

// K1f, the radiance field's input row (`cnc_field_input`), replaces
// (cnc_tpu, what XLA fuses into the base MLP's first product)
//   models/radiance_field.py encode_position (105-118): the 3D encode, the
//                    three plane encodes on x01[:, dims] and their concatenation
//   ops/sh.py        sine_embed (58-71): x, sin and cos of x * 2^i, concatenated
// Plain twin: the composition itself, cnc_torch/models/radiance_field.py
// `encode_position` on a CPU tensor (four K1 calls, sine_embed, torch.cat on
// the card, where the training render's gradient needs it).
//
// For each point of x01 [N, 3] it writes one row: the n3 3D levels, then the
// n2 levels of the xy, xz and yz planes (each plane's two coordinates read
// from the point itself, inside or outside [0,1] by those two alone), then
// the 3 + 6*n_freqs sine columns in sine_embed's order; 159 columns at the
// published widths.  The grid columns come from K1's own per-level code
// (`encode_level`), so they equal the four K1 calls bit for bit; the sine
// columns are sinf/cosf of the exact power-of-two product (float32 as
// torch.sin takes it), within a last bit of torch.sin and torch.cos.
//
// Bound on the H100: bytes.  Per point, 12 bytes of position and a 636-byte
// row, plus the distinct table rows: about 340 MB at a view round's 524,288
// points, 0.10 ms at 3.35 TB/s.  The composition it replaces wrote the four
// encodes, read them back into the concatenation, and made 21 [N, 3] pieces
// and a [N, 63] copy for the sine columns, and each plane's index copied
// from the host waited for the stream.
//
// Design.  One launch, no host sync.  K1's tiling: 8 warps a block, `wpt`
// warps share 32 points and split the 24 levels (3 a warp at the published
// widths, so 8 warps gather a point's levels at once, and a warp's level,
// plane and table are uniform across its lanes).  The row is
// staged in shared memory at an odd stride of 159 floats (a lane a point:
// no bank conflicts), the sine columns are filled by every thread of the
// block once the levels are done, and the tile's span of 32 rows (20,352
// bytes, 16-byte aligned) is stored 16 bytes a thread with the streaming
// hint (the row is read once, by the product that follows).

// The mask packing (`cnc_pack_mask_bits`) replaces no XLA composition:
// cnc_tpu's encode reads the bool masks (ops/encoding.py 90-94) and the port
// packs them once per cache refresh so that the encodes read a bit a corner.
// Plain twin: ops/encoding.py `_pack_bits_plain`.  Bound and design at the
// kernel, below.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoRow = 0xffffffffu;  // a lane with nothing to add

struct Levels {
  int res[kMaxLevels];
  int offset[kMaxLevels];
  int size[kMaxLevels];
  long long mask_off[kMaxLevels];
  bool dense[kMaxLevels];                 // R^D <= size
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

// The 2^D corners of one (point, level): global table row, D-linear weight,
// and whether the corner survives (not on the border, its mask bit set).
template <int D>
struct Corners {
  uint32_t row[1 << D];
  float w[1 << D];
  bool live[1 << D];
};

// The footprint box's ends on one axis for lattice coordinate c (the float32
// steps of sat.footprint_box, no FMA: the file is built with -fmad=false).
__device__ __forceinline__ void footprint_ends(int c, float scale, float frb, float top, int& lo,
                                               int& hi) {
  const float pn = __fmul_rn(__fsub_rn(static_cast<float>(c), 0.5f), scale);
  lo = static_cast<int>(fminf(fmaxf(__fmul_rn(__fsub_rn(pn, scale), frb), 0.f), top));
  hi = static_cast<int>(fminf(fmaxf(__fmul_rn(__fadd_rn(pn, scale), frb), 0.f), top));
}

// The occupied cells in the inclusive box [lo, hi] of the summed-area table
// `sat` ([rb+1]^D int32, last axis fastest): 2^D entries, all loaded before
// they are summed.
template <int D>
__device__ __forceinline__ int box_count(const int* __restrict__ sat, int rb, const int* lo,
                                         const int* hi) {
  int v[1 << D];
#pragma unroll
  for (int s = 0; s < (1 << D); ++s) {
    long long idx = 0;
#pragma unroll
    for (int ax = 0; ax < D; ++ax) idx = idx * (rb + 1) + ((s >> ax) & 1 ? lo[ax] : hi[ax] + 1);
    v[s] = __ldg(sat + idx);
  }
  int count = 0;
#pragma unroll
  for (int s = 0; s < (1 << D); ++s) count += (__popc(s) & 1) ? -v[s] : v[s];
  return count;
}

// Whether the footprint of corner cc of a resolution-res level on the Rb
// grid holds an occupied cell.
template <int D>
__device__ __forceinline__ bool footprint_any(const int* cc, int res, const int* __restrict__ sat,
                                              int rb) {
  const float scale = __frcp_rn(static_cast<float>(res - 2));
  int lo[D], hi[D];
#pragma unroll
  for (int ax = 0; ax < D; ++ax)
    footprint_ends(cc[ax], scale, static_cast<float>(rb), static_cast<float>(rb - 1), lo[ax],
                   hi[ax]);
  return box_count<D>(sat, rb, lo, hi) > 0;
}

// The fine levels' source, the occupancy rows (`cnc_sat_mask_sources`):
// row r = (i0*rb + i1) in 3D, i0 in 2D, of nw = ceil(rb/32) 64-bit windows,
// window k = word k | word k+1 << 32, bit i of word k the cell at last-axis
// coordinate 32k + i.  The coarse levels' bits come as the packed mask
// (`bits`, at mask_off[l]); a fine level has mask_off -1.
struct SatSrc {
  const unsigned long long* rows;
  int rb, nw;
};

// A fine level's 2^D corners of one point (lattice cell pg): `live[k]` is
// cleared where corner k's box holds no occupied cell.  Each axis has two
// boxes (corner coordinate pg and min(pg+1, res-1)); the window is the 4
// cells from the lower box's start on every axis, which holds both boxes
// (the wrapper's layout makes a level fine only where they span at most 4
// cells together).  Its rows' 4-bit slices are read
// once (win[a], 3D: row (a, b) at bits 4b..4b+3), OR-ed over each axis-0
// box, then masked by the corner's axis-1 (3D) and last-axis box.
template <int D>
__device__ __forceinline__ void fine_mask(const int* pg, int res, const SatSrc& m, bool* live) {
  const float scale = __frcp_rn(static_cast<float>(res - 2));
  const float frb = static_cast<float>(m.rb), top = static_cast<float>(m.rb - 1);
  int lo[D][2], hi[D][2], base[D], span[D];
#pragma unroll
  for (int ax = 0; ax < D; ++ax) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      footprint_ends(u ? min(pg[ax] + 1, res - 1) : pg[ax], scale, frb, top, lo[ax][u],
                     hi[ax][u]);
    base[ax] = min(lo[ax][0], lo[ax][1]);
    span[ax] = max(hi[ax][0], hi[ax][1]) - base[ax];   // cells in the window - 1, < 4
  }
  constexpr int last = D - 1;
  const int word = base[last] >> 5, shift = base[last] & 31;
  uint32_t win[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    win[a] = 0u;
    if constexpr (D == 3) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (a <= span[0] && b <= span[1]) {
          const long long row = static_cast<long long>(base[0] + a) * m.rb + base[1] + b;
          win[a] |= static_cast<uint32_t>((__ldg(m.rows + row * m.nw + word) >> shift) & 0xfu)
                    << (4 * b);
        }
    } else {
      if (a <= span[0])
        win[a] = static_cast<uint32_t>(
            (__ldg(m.rows + static_cast<long long>(base[0] + a) * m.nw + word) >> shift) & 0xfu);
    }
  }
  uint32_t r[2] = {0u, 0u};   // the window's rows OR-ed over each axis-0 box
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (a >= lo[0][u] - base[0] && a <= hi[0][u] - base[0]) r[u] |= win[a];
  const auto cells = [](int l, int h, int width) {   // bits [l, h] of `width`-bit fields
    return ((1u << (width * (h - l + 1))) - 1u) << (width * l);
  };
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    const int u0 = k & 1, ul = (k >> last) & 1;
    uint32_t sel = cells(lo[last][ul] - base[last], hi[last][ul] - base[last], 1);
    if constexpr (D == 3) {
      const int u1 = (k >> 1) & 1;
      sel = (sel * 0x1111u) & cells(lo[1][u1] - base[1], hi[1][u1] - base[1], 4);
    }
    live[k] = live[k] && (r[u0] & sel) != 0u;
  }
}

// Sat adds the fine levels' source: a level with mask_off -1 reads the
// occupancy rows; every other level reads the packed bits (none when bits
// is null).
template <int D, bool Sat>
__device__ __forceinline__ void level_corners(const float* x, const Levels& lv, int l,
                                              const uint32_t* __restrict__ bits,
                                              const SatSrc& src, Corners<D>& c) {
  const int res = lv.res[l];
  const uint32_t size = static_cast<uint32_t>(lv.size[l]);
  const uint32_t offset = static_cast<uint32_t>(lv.offset[l]);
  const bool dense = lv.dense[l];
  const float scale = static_cast<float>(res - 2);
  int pg[D];
  float frac[D];
#pragma unroll
  for (int ax = 0; ax < D; ++ax) {
    const float pos = __fadd_rn(__fmul_rn(x[ax], scale), 0.5f);
    const float fl = floorf(pos);
    pg[ax] = static_cast<int>(fl);
    frac[ax] = __fsub_rn(pos, fl);
  }
  uint32_t word[1 << D];
  long long bit[1 << D];
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    uint32_t cc[D];
    float wk = 1.f;
    bool valid = true;
#pragma unroll
    for (int ax = 0; ax < D; ++ax) {
      const bool up = (k >> ax) & 1;
      const int v = up ? min(pg[ax] + 1, res - 1) : pg[ax];
      wk = __fmul_rn(wk, up ? frac[ax] : __fsub_rn(1.f, frac[ax]));
      valid &= (v != 0) && (v != res - 1);
      cc[ax] = static_cast<uint32_t>(v);
    }
    c.w[k] = wk;
    c.live[k] = valid;
    c.row[k] = offset + grid_index<D>(cc, static_cast<uint32_t>(res), size, dense);
    long long flat = cc[0];
#pragma unroll
    for (int ax = 1; ax < D; ++ax) flat = flat * res + cc[ax];
    bit[k] = lv.mask_off[l] + flat;
  }
  if constexpr (Sat) {
    if (lv.mask_off[l] < 0) {
      fine_mask<D>(pg, res, src, c.live);
      return;
    }
  }
  if (bits) {
    // every corner's mask word in flight at once, then the bits
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) word[k] = c.live[k] ? __ldg(bits + (bit[k] >> 5)) : 0u;
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) c.live[k] = c.live[k] && ((word[k] >> (bit[k] & 31)) & 1u);
  }
}

// One table row as one 8- or 16-byte load (F = 2 or 4, the widths every
// config of the repo uses; the wrapper rejects any other F).
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ table, uint32_t row,
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

// The tile: `wpt` warps share 32 points and split their levels; a block
// holds kWarps / wpt such groups.  wpt is the largest of 8, 4, 2, 1 that
// divides n_out with at most 4 levels per warp, else the largest power of
// two up to 8 not above n_out, so the staged output tile stays within
// kThreads * 4 levels (16 KB at F = 4).
int warps_per_point(int n_out) {
  for (int p = kWarps; p > 1; p /= 2)
    if (n_out % p == 0 && n_out / p <= 4) return p;
  if (n_out <= 4) return 1;
  int p = 1;
  while (p * 2 <= n_out && p * 2 <= kWarps) p *= 2;
  return p;
}

template <int D, int F>
size_t smem_bytes(int tile, int n_out) {
  return static_cast<size_t>(tile) * (n_out * F + D + 1) * sizeof(float);
}

// Shared memory of one block: the [tile, n_out*F] output (or gradient)
// tile, then the tile's points and level ids.
struct Staged {
  float* rows;
  float* pts;
  int* ids;
};

template <int D, int F>
__device__ __forceinline__ Staged stage_tile(float* smem, const float* __restrict__ points,
                                             const int* __restrict__ min_ids, long long p0,
                                             int n_pts, int tile, int n_out) {
  Staged s;
  s.rows = smem;
  s.pts = smem + static_cast<size_t>(tile) * n_out * F;
  s.ids = reinterpret_cast<int*>(s.pts + tile * D);
  for (int i = threadIdx.x; i < n_pts * D; i += kThreads) s.pts[i] = points[p0 * D + i];
  if (min_ids)
    for (int i = threadIdx.x; i < n_pts; i += kThreads) s.ids[i] = min_ids[p0 + i];
  return s;
}

// Copies n floats between global and shared memory as float4 (F = 4) or
// float2 (F = 2) rows; both ends are 4F-byte aligned (the tile starts at a
// multiple of n_out*F floats of a freshly allocated tensor).
template <int F>
__device__ __forceinline__ void copy_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int n) {
  using V = typename std::conditional<F == 4, float4, float2>::type;
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  for (int i = threadIdx.x; i < n / F; i += kThreads) d[i] = s[i];
}

__device__ __forceinline__ bool inside_unit(const float* x, int d) {
  bool inside = true;  // NaN counts as outside
  for (int ax = 0; ax < d; ++ax) inside &= x[ax] >= 0.f && x[ax] <= 1.f;
  return inside;
}

// One (point, level) of the forward: every surviving corner's row loaded at
// once, the rows summed by weight in corner order 0..2^D-1, over the
// surviving weight (1e-9 when none survive); zeros outside [0,1].  K1 and
// K1f share it, so their columns are equal bit for bit.
template <int D, int F, bool Sat>
__device__ __forceinline__ void encode_level(const float* x, bool inside,
                                             const float* __restrict__ table, const Levels& lv,
                                             int l, const uint32_t* __restrict__ bits,
                                             const SatSrc& src, float* acc) {
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  if (!inside) return;
  Corners<D> c;
  level_corners<D, Sat>(x, lv, l, bits, src, c);
  float v[1 << D][F];
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    if (c.live[k]) {
      load_row<F>(table, c.row[k], v[k]);
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) v[k][f] = 0.f;
    }
  }
  float wsum = 0.f;
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    if (!c.live[k]) continue;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += c.w[k] * v[k][f];
    wsum += c.w[k];
  }
  const float wn = wsum == 0.f ? 1e-9f : wsum;
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = acc[f] / wn;
}

template <int D, int F, bool Sat>
__global__ void __launch_bounds__(kThreads)
grid_encode_forward_kernel(const float* __restrict__ points, const float* __restrict__ table,
                           float* __restrict__ out, int n, int n_out, int n_levels, Levels lv,
                           const uint32_t* __restrict__ bits, const int* __restrict__ min_ids,
                           SatSrc src, int wpt) {
  extern __shared__ float4 smem4[];
  const int tile = kThreads / wpt;
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;
  const int n_pts = static_cast<int>(min(static_cast<long long>(tile), n - p0));
  const Staged s = stage_tile<D, F>(reinterpret_cast<float*>(smem4), points, min_ids, p0, n_pts,
                                    tile, n_out);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lp = (warp / wpt) * 32 + (threadIdx.x & 31);  // the lane's point in the tile
  if (lp < n_pts) {
    float x[D];
#pragma unroll
    for (int ax = 0; ax < D; ++ax) x[ax] = s.pts[lp * D + ax];
    const bool inside = inside_unit(x, D);
    for (int j = warp % wpt; j < n_out; j += wpt) {
      float* o = s.rows + (lp * n_out + j) * F;
      const int l = min_ids ? min(max(s.ids[lp] + j, 0), n_levels - 1) : j;
      float acc[F];
      encode_level<D, F, Sat>(x, inside, table, lv, l, bits, src, acc);
#pragma unroll
      for (int f = 0; f < F; ++f) o[f] = acc[f];
    }
  }
  __syncthreads();
  copy_rows<F>(out + p0 * n_out * F, s.rows, n_pts * n_out * F);
}

// K1f: the radiance field's whole input row (see the header).  Tasks are the
// n3 3D levels, then the n2 levels of the xy, xz and yz planes; `wpt` warps
// share 32 points and split the tasks as K1's warps split levels, each
// warp's task uniform across its lanes.  The row is staged in shared memory
// (`width` floats a point), the sine columns are written by every thread of
// the block after the tasks, and the tile's span goes out as float4s.
template <int F>
__global__ void __launch_bounds__(kThreads)
grid_encode_forward_kernel_field(const float* __restrict__ x01, const float* __restrict__ t3,
                                 const float* __restrict__ t_xy, const float* __restrict__ t_xz,
                                 const float* __restrict__ t_yz, float* __restrict__ out, int n,
                                 Levels l3, int n3, Levels l2, int n2, int n_freqs, int width,
                                 int wpt) {
  extern __shared__ float4 smem4[];
  const int tile = kThreads / wpt;
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;
  const int n_pts = static_cast<int>(min(static_cast<long long>(tile), n - p0));
  float* rows = reinterpret_cast<float*>(smem4);
  float* pts = rows + tile * width;
  for (int i = threadIdx.x; i < n_pts * 3; i += kThreads) pts[i] = x01[p0 * 3 + i];
  __syncthreads();

  const SatSrc none{nullptr, 0, 0};
  const int warp = threadIdx.x >> 5;
  const int lp = (warp / wpt) * 32 + (threadIdx.x & 31);
  if (lp < n_pts) {
    const float x[3] = {pts[lp * 3], pts[lp * 3 + 1], pts[lp * 3 + 2]};
    const bool inside = inside_unit(x, 3);
    float* row = rows + lp * width;
    for (int j = warp % wpt; j < n3 + 3 * n2; j += wpt) {
      float acc[F];
      if (j < n3) {
        encode_level<3, F, false>(x, inside, t3, l3, j, nullptr, none, acc);
      } else {
        // the plane's two coordinates, as x01[:, dims] gives them: the
        // point is inside or outside [0,1] by those two alone
        const int p = (j - n3) / n2;
        const float xp[2] = {x[p == 2 ? 1 : 0], x[p == 0 ? 1 : 2]};
        encode_level<2, F, false>(xp, inside_unit(xp, 2), p == 0 ? t_xy : p == 1 ? t_xz : t_yz,
                                  l2, (j - n3) % n2, nullptr, none, acc);
      }
#pragma unroll
      for (int f = 0; f < F; ++f) row[j * F + f] = acc[f];
    }
  }
  // the sine embedding: x, then sin(x * 2^i) and cos(x * 2^i) for i < n_freqs
  const int n_sine = 3 + 6 * n_freqs, col0 = (n3 + 3 * n2) * F;
  for (int i = threadIdx.x; i < n_pts * n_sine; i += kThreads) {
    const int p = i / n_sine, c = i % n_sine;
    float v;
    if (c < 3) {
      v = pts[p * 3 + c];
    } else {
      const int k = c - 3, r = k % 6;
      const float a = __fmul_rn(pts[p * 3 + r % 3], static_cast<float>(1u << (k / 6)));
      v = r < 3 ? sinf(a) : cosf(a);
    }
    rows[p * width + col0 + c] = v;
  }
  __syncthreads();
  // the tile's rows are one contiguous span of the output, 16-byte aligned
  // (p0 * width floats, p0 a multiple of 32)
  const int total = n_pts * width;
  float4* dst = reinterpret_cast<float4*>(out + p0 * width);
  for (int i = threadIdx.x; i < total / 4; i += kThreads) __stcs(dst + i, smem4[i]);
  for (int i = total / 4 * 4 + threadIdx.x; i < total; i += kThreads)
    out[p0 * width + i] = rows[i];
}

// One table row of d_table += v, as one vector atomic (each element is added
// atomically; the row as a whole need not be).
template <int F>
__device__ __forceinline__ void atomic_add_row(float* __restrict__ table, uint32_t row,
                                               const float* v) {
  static_assert(F == 2 || F == 4, "K2 takes F = 2 or 4");
  if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(table) + row, make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(table) + row, make_float2(v[0], v[1]));
  }
}

// Sums v over the lanes of `peers` (the lanes holding this lane's key) into
// the group's lowest lane.  Every lane of the warp calls it; groups of one
// lane leave at once.  (The segmented tree of NVIDIA's "warp-aggregated
// atomics with __match_any_sync": each step folds the next-higher peer's
// partial sum into every lane whose rank in its group is even.)
template <int F>
__device__ __forceinline__ void reduce_peers(unsigned peers, float* v) {
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (lane == 31 ? 0u : (kFull << (lane + 1)));
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above) - 1;  // -1 when none is left
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float t = __shfl_sync(kFull, v[f], next < 0 ? lane : next);
      if (next >= 0) v[f] += t;
    }
    // lanes of odd rank have been folded into their lower neighbour: drop them
    above &= __ballot_sync(kFull, (rank & 1u) == 0u);
    rank >>= 1;
  }
}

template <int D, int F, bool Sat>
__global__ void __launch_bounds__(kThreads)
grid_encode_backward_kernel(const float* __restrict__ points, const float* __restrict__ grad,
                            float* __restrict__ d_table, int n, int n_out, int n_levels,
                            Levels lv, const uint32_t* __restrict__ bits,
                            const int* __restrict__ min_ids, SatSrc src, int wpt) {
  extern __shared__ float4 smem4[];
  const int tile = kThreads / wpt;
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;
  const int n_pts = static_cast<int>(min(static_cast<long long>(tile), n - p0));
  const Staged s = stage_tile<D, F>(reinterpret_cast<float*>(smem4), points, min_ids, p0, n_pts,
                                    tile, n_out);
  copy_rows<F>(s.rows, grad + p0 * n_out * F, n_pts * n_out * F);
  __syncthreads();

  // every lane stays to the end: the aggregation is warp-synchronous
  const int warp = threadIdx.x >> 5;
  const int lp = (warp / wpt) * 32 + (threadIdx.x & 31);
  float x[D];
#pragma unroll
  for (int ax = 0; ax < D; ++ax) x[ax] = lp < n_pts ? s.pts[lp * D + ax] : -1.f;
  const bool inside = lp < n_pts && inside_unit(x, D);
  for (int j = warp % wpt; j < n_out; j += wpt) {
    Corners<D> c;
    float gs[F];
    bool adds = false;
    if (inside) {
      const int l = min_ids ? min(max(s.ids[lp] + j, 0), n_levels - 1) : j;
      level_corners<D, Sat>(x, lv, l, bits, src, c);
      float wsum = 0.f;
#pragma unroll
      for (int k = 0; k < (1 << D); ++k) wsum += c.live[k] ? c.w[k] : 0.f;
      const float* g = s.rows + (lp * n_out + j) * F;
      bool any = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        any |= g[f] != 0.f;
        gs[f] = wsum == 0.f ? 0.f : g[f] / wsum;
      }
      // no surviving weight, or a zero gradient: nothing to add
      adds = wsum != 0.f && any;
    }
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) {
      const bool live = adds && c.live[k];
      const uint32_t key = live ? c.row[k] : kNoRow;
      float v[F];
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = live ? gs[f] * c.w[k] : 0.f;
      const unsigned peers = __match_any_sync(kFull, key);
      reduce_peers<F>(peers, v);
      if (live && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) atomic_add_row<F>(d_table, key, v);
    }
  }
}

bool fill_levels(Levels* lv, int d, int n_out, int n_levels, const int* res, const int* offsets,
                 const int* sizes, const long long* mask_offs) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_out < 1 || n_out > n_levels) return false;
  for (int l = 0; l < n_levels; ++l) {
    lv->res[l] = res[l];
    lv->offset[l] = offsets[l];
    lv->size[l] = sizes[l];
    lv->mask_off[l] = mask_offs[l];
    long long rd = 1;  // R^D <= size, in 64 bits (1026^2, 514^3 fit)
    for (int ax = 0; ax < d; ++ax) rd *= res[l];
    lv->dense[l] = rd <= static_cast<long long>(sizes[l]);
  }
  return true;
}

// One launch of either kernel over all points: tiles of kThreads / wpt.
template <int D, int F, bool Backward, bool Sat>
int launch(const float* points, const float* in, float* out, int n, int n_out, int n_levels,
           const Levels& lv, const uint32_t* bits, const int* min_ids, const SatSrc& src,
           cudaStream_t stream) {
  const int wpt = warps_per_point(n_out);
  const int tile = kThreads / wpt;
  const unsigned blocks = cnc_blocks(n, tile);
  const size_t smem = smem_bytes<D, F>(tile, n_out);
  if constexpr (Backward) {
    grid_encode_backward_kernel<D, F, Sat><<<blocks, kThreads, smem, stream>>>(
        points, in, out, n, n_out, n_levels, lv, bits, min_ids, src, wpt);
  } else {
    grid_encode_forward_kernel<D, F, Sat><<<blocks, kThreads, smem, stream>>>(
        points, in, out, n, n_out, n_levels, lv, bits, min_ids, src, wpt);
  }
  return cnc_last_error();
}

template <int D, int F, bool Backward>
int launch_with(const float* points, const float* in, float* out, int n, int n_out,
                int n_levels, const Levels& lv, const uint32_t* bits, const int* min_ids,
                const SatSrc& src, cudaStream_t stream) {
  if (src.rows)
    return launch<D, F, Backward, true>(points, in, out, n, n_out, n_levels, lv, bits, min_ids,
                                        src, stream);
  return launch<D, F, Backward, false>(points, in, out, n, n_out, n_levels, lv, bits, min_ids,
                                       src, stream);
}

template <bool Backward>
int encode(const float* points, const float* in, float* out, int n, int d, int f, int n_out,
           int n_levels, const int* res, const int* offsets, const int* sizes,
           const uint32_t* bits, const long long* mask_offs, const int* min_ids, int rb,
           const unsigned long long* rows, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, d, n_out, n_levels, res, offsets, sizes, mask_offs) ||
      (!min_ids && n_out != n_levels) || (rows && rb < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // with the rows, a coarse level reads the packed bits; a fine one needs them
  for (int l = 0; l < n_levels; ++l)
    if (mask_offs[l] < 0 ? !rows : rows && !bits) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SatSrc src{rows, rb, (rb + 31) / 32};
  const auto go = [&](auto kernel) {
    return kernel(points, in, out, n, n_out, n_levels, lv, bits, min_ids, src, s);
  };
  if (d == 2 && f == 2) return go(launch_with<2, 2, Backward>);
  if (d == 2 && f == 4) return go(launch_with<2, 4, Backward>);
  if (d == 3 && f == 2) return go(launch_with<3, 2, Backward>);
  if (d == 3 && f == 4) return go(launch_with<3, 4, Backward>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K1s/K2s's mask sources (see the header).  The jobs are the coarse levels,
// whose R^D vertices (last axis fastest) become bits of `bits` from word
// word_off, then, when `rows` is given, the occupancy rows; their words are
// numbered one after the other (job j's end in job_end[j]) and a warp makes
// one word: its lanes take 32 consecutive vertices (cells), so the table
// reads of a warp fall on neighbouring entries, and the ballot is the word.
// The grid covers the words and nothing else.  Bound on the H100:
// operations, 2^D table reads and a footprint box (6 a axis) a vertex;
// bytes, the table read once and the words written once.
struct CoarseLevels {
  int n, n_jobs;
  int res[kMaxLevels];
  long long word_off[kMaxLevels];
  long long job_end[kMaxLevels + 1];
};

template <int D>
__global__ void __launch_bounds__(kThreads)
sat_mask_sources_kernel(const int* __restrict__ sat, int rb, CoarseLevels cl,
                        uint32_t* __restrict__ bits, uint32_t* __restrict__ rows32) {
  const int lane = threadIdx.x & 31;
  long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= cl.job_end[cl.n_jobs - 1]) return;   // the warp leaves together
  int job = 0;
  while (w >= cl.job_end[job]) ++job;
  if (job > 0) w -= cl.job_end[job - 1];
  bool bit = false;
  if (job < cl.n) {
    const int res = cl.res[job];
    long long n_vert = 1;
    for (int ax = 0; ax < D; ++ax) n_vert *= res;
    long long flat = w * 32 + lane;
    if (flat < n_vert) {
      int cc[D];
#pragma unroll
      for (int ax = D - 1; ax >= 0; --ax) {
        cc[ax] = static_cast<int>(flat % res);
        flat /= res;
      }
      bit = footprint_any<D>(cc, res, sat, rb);
    }
    const unsigned word = __ballot_sync(kFull, bit);
    if (lane == 0) bits[cl.word_off[job] + w] = word;
    return;
  }
  const int nw = (rb + 31) / 32;
  const long long row = w / nw;
  const int k = static_cast<int>(w % nw);
  const int i_last = k * 32 + lane;
  if (i_last < rb) {
    int cell[D];
    long long r = row;
#pragma unroll
    for (int ax = D - 2; ax >= 0; --ax) {
      cell[ax] = static_cast<int>(r % rb);
      r /= rb;
    }
    cell[D - 1] = i_last;
    bit = box_count<D>(sat, rb, cell, cell) > 0;
  }
  const unsigned word = __ballot_sync(kFull, bit);
  if (lane == 0) {
    // word k is the low half of window k and the high half of window k-1;
    // the last window's high half is 0
    const long long at = 2 * (row * nw + k);
    rows32[at] = word;
    if (k > 0) rows32[at - 1] = word;
    if (k == nw - 1) rows32[at + 1] = 0u;
  }
}

// The mask packing: one thread a word, the warp's 32 words stored as one
// 128-byte run.  Bound on the H100: bytes (each bool read once, each word
// written once; the 3D mask's 223,231,256 bools and 26.6 MiB of words,
// 0.075 ms at 3.35 TB/s).  Where the row starts 16-byte aligned and the word
// is whole, the thread reads its 32 bytes as two 16-byte loads and makes the
// word in registers (cnc_byte_bits16); a row that starts unaligned, and a
// row's ragged last word, are read byte by byte.  blockIdx.y walks the rows.
__global__ void pack_mask_bits_kernel(const unsigned char* __restrict__ mask, long long rows,
                                      long long cols, long long words, uint32_t* __restrict__ out) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= words) return;
  const long long c0 = w * 32;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const unsigned char* row = mask + r * cols;
    unsigned bits = 0;
    if ((reinterpret_cast<uintptr_t>(row) & 15) == 0 && c0 + 32 <= cols) {
      const uint4* p = reinterpret_cast<const uint4*>(row + c0);
      bits = cnc_byte_bits16(__ldg(p)) | cnc_byte_bits16(__ldg(p + 1)) << 16;
    } else {
      const int m = static_cast<int>(cols - c0 < 32 ? cols - c0 : 32);
      for (int j = 0; j < m; ++j) bits |= (row[c0 + j] != 0 ? 1u : 0u) << j;
    }
    out[r * words + w] = bits;
  }
}

}  // namespace

// K1.  points [n, d] f32, table [rows, f] f32, out [n, n_out*f] f32, all
// contiguous on the device, table and out 4*f-byte aligned.
// res/offsets/sizes/mask_offs are host arrays of n_levels entries; the
// wrapper has checked offsets[l] + sizes[l] <= rows < 2^31 and that each
// level's mask grid lies inside `bits`.  bits (the packed mask, int32 words)
// and min_ids (int32 [n]) are device pointers or null; without min_ids,
// n_out == n_levels.  K1s: `bits` and `rows` are the sources
// `cnc_sat_mask_sources` made from a summed-area table of side rb + 1, and
// mask_offs[l] is -1 at a fine level, which reads `rows` (null when no
// level is fine).
CNC_EXPORT int cnc_grid_encode_forward(const float* points, const float* table, float* out,
                                       int n, int d, int f, int n_out, int n_levels,
                                       const int* res, const int* offsets, const int* sizes,
                                       const uint32_t* bits, const long long* mask_offs,
                                       const int* min_ids, int rb,
                                       const unsigned long long* rows, void* stream) {
  return encode<false>(points, table, out, n, d, f, n_out, n_levels, res, offsets, sizes, bits,
                       mask_offs, min_ids, rb, rows, stream);
}

// K2.  points [n, d] f32, grad [n, n_out*f] f32 (4*f-byte aligned), d_table
// [rows, f] f32 zeroed by the caller and 4*f-byte aligned; levels, bits,
// min_ids, rb and rows as in the forward (K2s: the forward's sources).
// Adds every point's share of grad into d_table.
CNC_EXPORT int cnc_grid_encode_backward(const float* points, const float* grad, float* d_table,
                                        int n, int d, int f, int n_out, int n_levels,
                                        const int* res, const int* offsets, const int* sizes,
                                        const uint32_t* bits, const long long* mask_offs,
                                        const int* min_ids, int rb,
                                        const unsigned long long* rows, void* stream) {
  return encode<true>(points, grad, d_table, n, d, f, n_out, n_levels, res, offsets, sizes, bits,
                      mask_offs, min_ids, rb, rows, stream);
}

// K1f.  x01 [n, 3] f32; t3 (the 3D table) and t_xy, t_xz, t_yz (the planes')
// [rows, f] f32, 4*f-byte aligned; out [n, (n3 + 3*n2)*f + 3 + 6*n_freqs]
// f32, 16-byte aligned; all contiguous on the device.  res/off/size are host
// arrays of each grid's levels; the wrapper has checked that they lie inside
// the tables.  One launch.
CNC_EXPORT int cnc_field_input(const float* x01, const float* t3, const float* t_xy,
                               const float* t_xz, const float* t_yz, float* out, int n, int f,
                               int n3, const int* res3, const int* off3, const int* size3, int n2,
                               const int* res2, const int* off2, const int* size2, int n_freqs,
                               void* stream) {
  static const long long no_mask[kMaxLevels] = {};
  Levels l3, l2;
  if (!fill_levels(&l3, 3, n3, n3, res3, off3, size3, no_mask) ||
      !fill_levels(&l2, 2, n2, n2, res2, off2, size2, no_mask) || (f != 2 && f != 4) ||
      n_freqs < 0 || n_freqs > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int width = (n3 + 3 * n2) * f + 3 + 6 * n_freqs;
  const int wpt = warps_per_point(n3 + 3 * n2);
  const int tile = kThreads / wpt;
  const size_t smem = static_cast<size_t>(tile) * (width + 3) * sizeof(float);
  const auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<cnc_blocks(n, tile), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        x01, t3, t_xy, t_xz, t_yz, out, n, l3, n3, l2, n2, n_freqs, width, wpt);
    return cnc_last_error();
  };
  return f == 4 ? go(grid_encode_forward_kernel_field<4>)
                : go(grid_encode_forward_kernel_field<2>);
}

// K1s/K2s's mask sources of the table sat (int32 [rb+1]^d on the device):
// for each of the n_coarse levels (host arrays res and word_offs) the
// vertices' bits into `bits` (int32 words) from word word_offs[j]; with
// `rows` (int64 [rb^(d-1), ceil(rb/32)]), the occupancy rows.  One launch.
CNC_EXPORT int cnc_sat_mask_sources(const int* sat, int d, int rb, int n_coarse, const int* res,
                                    const long long* word_offs, uint32_t* bits, void* rows,
                                    void* stream) {
  if ((d != 2 && d != 3) || rb < 1 || n_coarse < 0 || n_coarse > kMaxLevels ||
      (n_coarse > 0 && !bits))
    return static_cast<int>(cudaErrorInvalidValue);
  CoarseLevels cl;
  cl.n = n_coarse;
  cl.n_jobs = n_coarse + (rows ? 1 : 0);
  long long words = 0;
  for (int j = 0; j < n_coarse; ++j) {
    if (res[j] < 3) return static_cast<int>(cudaErrorInvalidValue);
    cl.res[j] = res[j];
    cl.word_off[j] = word_offs[j];
    long long n_vert = 1;
    for (int ax = 0; ax < d; ++ax) n_vert *= res[j];
    cl.job_end[j] = words += (n_vert + 31) / 32;
  }
  if (rows) {
    long long n_rows = 1;
    for (int ax = 1; ax < d; ++ax) n_rows *= rb;
    cl.job_end[n_coarse] = words += n_rows * ((rb + 31) / 32);
  }
  if (words == 0) return 0;
  const unsigned grid = static_cast<unsigned>((words + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* rows32 = static_cast<uint32_t*>(rows);
  if (d == 2)
    sat_mask_sources_kernel<2><<<grid, kThreads, 0, s>>>(sat, rb, cl, bits, rows32);
  else
    sat_mask_sources_kernel<3><<<grid, kThreads, 0, s>>>(sat, rb, cl, bits, rows32);
  return cnc_last_error();
}

// The packed copy of a bool mask [rows, cols] (contiguous on the device):
// out [rows, words] int32 words, words = ceil(cols / 32), bit c % 32 of word
// c / 32 set when mask[r, c] is; the bits past cols are 0.
CNC_EXPORT int cnc_pack_mask_bits(const unsigned char* mask, long long rows, long long cols,
                                  unsigned* out, void* stream) {
  const long long words = (cols + 31) / 32;
  if (rows * words == 0) return 0;
  const dim3 grid(cnc_blocks(words, 256), static_cast<unsigned>(rows < 65535 ? rows : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pack_mask_bits_kernel<<<grid, 256, 0, s>>>(mask, rows, cols, words, out);
  return cnc_last_error();
}
