// K9: the integer codec context.  int_ctx_pool (one launch a pool), which
// also finishes the coder's probabilities (K9c) in the same launch.
//
// Replaces (cnc_tpu, the XLA compositions of the codec's pool programs):
//   int_ctx_pool: codec/intctx.py int_encode_levels (110-170) and
//       int_encode_plane (173-210), the exact lattice interpolation of the
//       coarser levels' signs (and of the dimension-wise prior plane) at each
//       coded vertex; _int_matmul/_int_leaky/int_apply_ctx3d/int_apply_ctx2d
//       (214-242); then, of models/context_models.py pool_3d_level_int
//       (1197-1206) and pool_2d_level_int (1254-1260), `mean // 2**m_shift`,
//       the overlap or count weight and the two segment_sum_int calls
//       (intctx.py 325-331);
//   K9c, its finish: codec/intctx.py device_pq (344-372) and the covered and
//       sign-bit outputs of codec/codec.py _pool3d_fn/_pool2d_fn (131-134,
//       150-153).
// Plain twins: cnc_torch/codec/intctx.py int_ctx_pool_plain (the kept rows
// through int_encode_levels, int_encode_plane, int_apply_ctx3d/2d and
// segment_sum_int), then _int_pq_plain (device_pq) for the finish.
//
// Every step is integer arithmetic, so the kernel equals its twins bit for
// bit, the pool's atomics included (integer sums do not depend on their
// order).  JAX's `//` floors, C++'s `/` truncates toward zero: every division
// whose numerator can be negative goes through `floordiv`, or, by a power of
// two, through an arithmetic right shift (which floors; the LeakyReLU's
// x*41 // 4096, h // Q_W, out // 2**M_SHIFT, mean // 2**m_shift).  The format
// keeps every sum and product under 2**30 except the LeakyReLU's x*41, which
// XLA computes with int32 wrap-around; `mul_wrap` makes that wrap explicit
// (signed overflow is undefined in C++), as the twin does in int64.
//
// int_ctx_pool.  One pool of the codec: the rows of one window (the vertices
// of a run of entries, sorted by entry), of which a row is kept where its
// occupancy mask byte is set (7% of a level-11 chunk's 2,044,350 rows, 41% of
// the 2D level 3's 1,638,400).  Per kept row: its context features against
// the k coarser levels (2^D corners each: clamp, border test, corner mask
// byte, dense or hashed entry in uint32, one 16- or 8-byte sign row), in 2D
// the prior plane's, the fixed-point MLP (3D kF+1 -> 32 -> 32 -> F, 2D one
// Linear), and its weighted mean added into its entry.
//
// Bound on the H100: at the level-11 chunk, operations (about 3,100 integer
// multiply-adds a kept row in the MLP against a few dozen bytes); at the 2D
// levels, bytes (every row's id and mask byte, each kept row's corner mask
// bytes and sign rows).  The design:
//   * Rows that are not kept cost their id and one mask byte: a block takes
//     a run of consecutive tiles of 1,024 rows (4 a thread, coalesced), the
//     warps ballot their rows' mask bytes and a scan of the 32 warp counts
//     writes the kept rows' indices, in order, into a queue in shared
//     memory.  Whenever the queue holds 256 rows, every lane takes one (a
//     warp with none skips), so lanes run on kept rows only, and no launch
//     or temporary of the window's size is needed.
//   * The features stay in registers: the per-axis interpolation (pgc, fq)
//     depends only on the coordinate and the level, so it is a table
//     (tab[level * rf + c] = pgc * 64 + fq; built once per model by the
//     twin's own _axis_interp, loaded into shared memory once per block): no
//     division is left in the corner loop, and the 3D row decode divides by
//     rf^2 and rf with precomputed multipliers.
//   * The MLP's shapes are fixed at compile time, one instance per (D, F,
//     context levels, plane), so its activations stay in registers; its
//     weights sit in shared memory, read as broadcast 16-byte loads.
//   * Pooling by runs: the kept rows come sorted by entry, so each warp sums
//     its runs of equal entries with shuffles and a run's last lane adds
//     them, F + 1 int32 atomics a run.  Tensor cores do not fit: features
//     reach 256, hidden activations 4,096, and exact int8 IMMA would need
//     limb splits.
//   * The precondition, kept rows' entries in [0, n_e) and non-decreasing, is
//     checked: within a block against the kept row before (across lanes,
//     warps and batches), across blocks by the last block to finish (a
//     device counter it resets), over the blocks' (first, last) records: a
//     block's first entry must not lie below the largest last entry of the
//     blocks before it.  A violation sets *fault, a device word the wrapper
//     reads.
//
// K9c, the finish (with pq set).  Per entry: pq = clip(msum * 65536 //
// (max(wsum, 1) * m_scale), 1, 65535) in int64 (msum <= 0 gives 1), which is
// host_pq's formula and equals cnc_tpu's uint32 long division; covered =
// wsum > 0; in encode the entry's sign bits from its table row.  Alone it
// was one thread an entry in a launch of its own, whose fixed cost (a
// launch, three allocations, three copies to the host) was nearly all of
// its time; here it is the pool's epilogue.  The window's rows are exactly
// the rows of entries [start_e, start_e + n_e), sorted, each entry with at
// least one (the codec's windows are; the twin raises where a window is
// not, and the kernel checks the kept rows only, as the pool always did).
// So each entry's last row lies in one block's span [r0, r1), and that
// block owns it.  A block finishes the entries it owns whose first row is in
// its span too, after its own pooling (their sign bits, which need no sum,
// before it): no other block adds to them.  An entry that starts before r0
// and ends in the span (at most one a block, found by the block before its
// pooling and left in its record) is finished by the last block to finish,
// after the order check.  Each block computes what it finishes before the
// pooling and keeps it in shared memory, and the finish has one call site,
// to keep the pooling's registers as they were; ptxas still spills a few
// bytes of the flagship 3D instance at its 128-register cap, outside the
// per-row work (PERF.md).  Bound: bytes (the sums read, the outputs
// written), far below the pool's own.

#include "common.cuh"

namespace {

constexpr int kQAxis = 32, kQFeat = 256, kHClip = 1 << 12, kMClip = 1 << 14;
constexpr int kQWShift = 9, kMShift = 6;   // Q_W = 2^9, M_SHIFT
constexpr int kMaxCtx = 4;                 // context levels of one pool
constexpr int kHidden = 32;                // the 3D MLP's hidden width
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;   // rows a block scans at once
constexpr int kQueue = kThreads + kTile;
constexpr int kMaxBlocks = 4096;
static_assert(kRowsPerThread * kWarps == 32, "one warp scans the tile's warp counts");

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int mul_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

struct CtxLevels {
  int res[kMaxCtx];
  long long offset[kMaxCtx];
  unsigned size[kMaxCtx];
  long long mask_off[kMaxCtx];
  bool dense[kMaxCtx];
};

struct PoolArgs {
  const int* ids;        // [n] packed vertex ids of the window
  const int* slots;      // [n] entry ids, start_e added
  long long n;
  long long span;        // rows per block, a multiple of kTile
  int start_e, n_e, rf;
  FastDiv div_rr, div_r;  // 3D row decode
  const unsigned char* mask;
  long long mask_len, mask_off;
  const int* sign;
  long long tbl_rows;
  CtxLevels lv;
  const int* plane;      // 2D with the prior plane
  int pn_res;
  long long plane_moff;
  const int* params;     // per layer w [in, out] row-major, then b [out]
  const int* interp;     // [tables * rf] pgc * 64 + fq
  int pg_q, m_shift;
  const int* ovl;        // 3D overlap weights by lattice index, or null
  long long ovl_len;
  int* msum;             // [n_e, F], zeroed
  int* wsum;             // [n_e], zeroed
  int4* records;         // [gridDim.x] (first, last) kept entry and straddling entry per block
  unsigned* counter;     // blocks finished; 0 between launches
  int* fault;
  // the finish (K9c), or pq null
  unsigned short* pq;    // [n_e, F]
  unsigned char* covered;  // [n_e]
  unsigned char* bits;   // [n_e, F] or null
  const int* evals;      // [n_e] the entries' sign rows, less tbl_offset
  long long tbl_offset;
  int m_scale;
};

template <int D, int F, int K, bool PLANE>
struct Shape {
  static constexpr int kIn = K * F + (PLANE ? F : 0) + 1;
  static constexpr int kParams = D == 3 ? kIn * kHidden + kHidden + kHidden * kHidden + kHidden +
                                              kHidden * F + F
                                        : kIn * F + F;
  static constexpr int kTables = K + (PLANE ? 1 : 0);
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// hash_ops.grid_index for a static level: dense x-fastest when R^D <= size,
// else the XOR-prime hash masked (or taken mod) to the size, in uint32
template <int D>
__device__ __forceinline__ uint32_t grid_index(const int* cc, uint32_t res, uint32_t size,
                                               bool dense) {
  uint32_t idx = 0;
  if (dense) {
    uint32_t stride = 1;
#pragma unroll
    for (int ax = 0; ax < D; ++ax) {
      idx += static_cast<uint32_t>(cc[ax]) * stride;
      stride *= res;
    }
    return idx;
  }
#pragma unroll
  for (int ax = 0; ax < D; ++ax)
    idx ^= static_cast<uint32_t>(cc[ax]) * (ax == 0 ? 1u : ax == 1 ? 2654435761u : 805459861u);
  return (size & (size - 1)) == 0 ? (idx & (size - 1)) : (idx % size);
}

template <int F>
__device__ __forceinline__ void load_irow(const int* __restrict__ t, long long row, int* v) {
  if constexpr (F == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(t) + row);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const int2 q = __ldg(reinterpret_cast<const int2*>(t) + row);
    v[0] = q.x; v[1] = q.y;
  }
}

__device__ __forceinline__ long long clamp_row(long long r, long long rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// A row's mask index: the flat lattice index (3D: the id itself, last axis
// fastest; 2D: x * rf + y of the id (x << 16) | y), plus the level's offset
template <int D>
__device__ __forceinline__ long long row_mask_index(int id, const PoolArgs& a) {
  if constexpr (D == 3) return a.mask_off + id;
  return a.mask_off + static_cast<long long>(static_cast<unsigned>(id) >> 16) * a.rf +
         (id & 0xFFFF);
}

// One context level's F features at Q_FEAT (int_encode_levels), from the
// level's (pgc, fq) per axis
template <int D, int F>
__device__ __forceinline__ void level_features(const int* pgc, const int* fq, int l,
                                               const PoolArgs& a, int* out) {
  const int rc = a.lv.res[l];
  unsigned char live[1 << D];
  long long row[1 << D];
  int w[1 << D];
  // the corners' mask bytes first, all loads in flight, then their sign rows
#pragma unroll
  for (int corner = 0; corner < (1 << D); ++corner) {
    int cc[D];
    int wt = 1;
    bool valid = true;
    long long flat = 0;
#pragma unroll
    for (int ax = 0; ax < D; ++ax) {
      int v;
      if ((corner >> ax) & 1) {
        v = min(pgc[ax] + 1, rc - 1);
        wt *= fq[ax];
      } else {
        v = pgc[ax];
        wt *= kQAxis - fq[ax];
      }
      v = min(max(v, 0), rc - 1);
      cc[ax] = v;
      valid = valid && v != 0 && v != rc - 1;
      flat = flat * rc + v;
    }
    const long long m = a.lv.mask_off[l] + flat;
    live[corner] = (valid && m >= 0 && m < a.mask_len) ? __ldg(a.mask + m) : 0;
    w[corner] = wt;
    row[corner] = clamp_row(
        a.lv.offset[l] + grid_index<D>(cc, static_cast<uint32_t>(rc), a.lv.size[l], a.lv.dense[l]),
        a.tbl_rows);
  }
  int acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0;
  int wsum = 0;
#pragma unroll
  for (int corner = 0; corner < (1 << D); ++corner) {
    if (!live[corner]) continue;
    int v[F];
    load_irow<F>(a.sign, row[corner], v);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += w[corner] * v[f];
    wsum += w[corner];
  }
#pragma unroll
  for (int f = 0; f < F; ++f) out[f] = wsum == 0 ? 0 : floordiv(acc[f] * kQFeat, wsum);
}

// The prior plane's F features (int_encode_plane): dense x-fastest, values
// already at Q_FEAT
template <int F>
__device__ __forceinline__ void plane_features(const int* pgc, const int* fq, const PoolArgs& a,
                                               int* out) {
  const int r = a.pn_res;
  unsigned char live[4];
  long long row[4];
  int w[4];
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    int cc[2];
    int wt = 1;
#pragma unroll
    for (int ax = 0; ax < 2; ++ax) {
      int v;
      if ((corner >> ax) & 1) {
        v = min(pgc[ax] + 1, r - 1);
        wt *= fq[ax];
      } else {
        v = pgc[ax];
        wt *= kQAxis - fq[ax];
      }
      cc[ax] = min(max(v, 0), r - 1);
    }
    const bool valid = cc[0] != 0 && cc[0] != r - 1 && cc[1] != 0 && cc[1] != r - 1;
    const long long m = a.plane_moff + static_cast<long long>(cc[0]) * r + cc[1];
    live[corner] = (valid && m >= 0 && m < a.mask_len) ? __ldg(a.mask + m) : 0;
    w[corner] = wt;
    row[corner] = cc[0] + static_cast<long long>(cc[1]) * r;
  }
  int acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0;
  int wsum = 0;
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    if (!live[corner]) continue;
    int v[F];
    load_irow<F>(a.plane, row[corner], v);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += w[corner] * v[f];
    wsum += w[corner];
  }
#pragma unroll
  for (int f = 0; f < F; ++f) out[f] = wsum == 0 ? 0 : floordiv(acc[f], wsum);
}

// y = x @ W + b with W [IN, OUT] row-major then b [OUT] in shared memory
// (16-byte aligned rows when OUT % 4 == 0, 8-byte when OUT == 2)
template <int IN, int OUT>
__device__ __forceinline__ void dense_layer(const int* sw, const int* x, int* y) {
#pragma unroll
  for (int j = 0; j < OUT; ++j) y[j] = sw[IN * OUT + j];
#pragma unroll
  for (int k = 0; k < IN; ++k) {
    const int xk = x[k];
    if constexpr (OUT % 4 == 0) {
#pragma unroll
      for (int j = 0; j < OUT; j += 4) {
        const int4 q = *reinterpret_cast<const int4*>(sw + k * OUT + j);
        y[j] += xk * q.x;
        y[j + 1] += xk * q.y;
        y[j + 2] += xk * q.z;
        y[j + 3] += xk * q.w;
      }
    } else {
      static_assert(OUT == 2, "layer widths are multiples of 4, or 2");
      const int2 q = *reinterpret_cast<const int2*>(sw + k * OUT);
      y[0] += xk * q.x;
      y[1] += xk * q.y;
    }
  }
}

// the hidden activation: LeakyReLU (x * 41 // 4096 below 0, wrapped), // Q_W,
// clip to +-H_CLIP
__device__ __forceinline__ int hidden_act(int v) {
  if (v < 0) v = mul_wrap(v, 41) >> 12;
  return min(max(v >> kQWShift, -kHClip), kHClip);
}

// The row's MLP output at M_SCALE, clipped (int_apply_ctx3d / int_apply_ctx2d)
template <int D, int F, int IN>
__device__ __forceinline__ void mlp(const int* sw, const int* x, int* out) {
  if constexpr (D == 3) {
    int h[kHidden], g[kHidden];
    dense_layer<IN, kHidden>(sw, x, h);
#pragma unroll
    for (int j = 0; j < kHidden; ++j) h[j] = hidden_act(h[j]);
    const int* s1 = sw + IN * kHidden + kHidden;
    dense_layer<kHidden, kHidden>(s1, h, g);
#pragma unroll
    for (int j = 0; j < kHidden; ++j) g[j] = hidden_act(g[j]);
    dense_layer<kHidden, F>(s1 + kHidden * kHidden + kHidden, g, out);
  } else {
    dense_layer<IN, F>(sw, x, out);
  }
#pragma unroll
  for (int f = 0; f < F; ++f) out[f] = min(max(out[f] >> kMShift, -kMClip), kMClip);
}

// A warp's segmented inclusive sums of v over its runs of equal keys (a lane
// heads a run when its key differs from the lane before it).  Returns whether
// this lane ends its run; its v then holds the run's sums.
template <int N>
__device__ __forceinline__ bool warp_run_sums(int key, int* v, int lane) {
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != key);
  const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int u = __shfl_up_sync(0xffffffffu, v[j], o);
      if (lane - o >= start) v[j] += u;
    }
  }
  return lane == 31 || ((heads >> (lane + 1)) & 1u);
}

// K9c's sign bits of entry e (they need no sum)
template <int F>
__device__ __forceinline__ void write_bits(const PoolArgs& a, int e) {
  int v[F];
  load_irow<F>(a.sign, clamp_row(a.tbl_offset + __ldg(a.evals + e), a.tbl_rows), v);
  unsigned b = 0;
#pragma unroll
  for (int f = 0; f < F; ++f) b |= static_cast<unsigned>(v[f] > 0) << (8 * f);
  if constexpr (F == 4) {
    reinterpret_cast<unsigned*>(a.bits)[e] = b;
  } else {
    reinterpret_cast<unsigned short*>(a.bits)[e] = static_cast<unsigned short>(b);
  }
}

// K9c's probabilities and coverage of entry e, whose sums are complete:
// read through L2, where the atomics landed
template <int F>
__device__ __forceinline__ void finish_entry(const PoolArgs& a, int e) {
  int m[F];
  if constexpr (F == 4) {
    const int4 q = __ldcg(reinterpret_cast<const int4*>(a.msum) + e);
    m[0] = q.x; m[1] = q.y; m[2] = q.z; m[3] = q.w;
  } else {
    const int2 q = __ldcg(reinterpret_cast<const int2*>(a.msum) + e);
    m[0] = q.x; m[1] = q.y;
  }
  const int ws = __ldcg(a.wsum + e);
  a.covered[e] = ws > 0;
  const long long den = static_cast<long long>(max(ws, 1)) * a.m_scale;
  unsigned p[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    // msum * 65536 // den: below 2^47 over below 2^42, so the rounded double
    // quotient is within 1/64 of the exact one and one correction step makes
    // it the floor (cheaper than a 64-bit integer division)
    long long q = 1;
    if (m[f] > 0) {
      const long long num = static_cast<long long>(m[f]) * 65536;
      q = static_cast<long long>(__ddiv_rn(static_cast<double>(num), static_cast<double>(den)));
      const long long r = num - q * den;
      q += (r >= den) - (r < 0);
    }
    p[f] = static_cast<unsigned>(q < 1 ? 1 : (q > 65535 ? 65535 : q));
  }
  if constexpr (F == 4) {
    reinterpret_cast<uint2*>(a.pq)[e] = make_uint2(p[0] | p[1] << 16, p[2] | p[3] << 16);
  } else {
    reinterpret_cast<unsigned*>(a.pq)[e] = p[0] | p[1] << 16;
  }
}

// One batch of nb <= kThreads kept rows (queue order = row order): lane t of
// the block takes q[t].
template <int D, int F, int K, bool PLANE>
__device__ __forceinline__ void pool_batch(const PoolArgs& a, const int* q, int nb, const int* sw,
                                           const int* tab, int* sslot, int& s_carry,
                                           int& s_first, int& s_fault) {
  using S = Shape<D, F, K, PLANE>;
  const int t = threadIdx.x, lane = t & 31;
  const bool has = t < nb;
  const int i = has ? q[t] : 0;
  const int slot = has ? __ldg(a.slots + i) - a.start_e : -1;
  sslot[t] = slot;
  __syncthreads();
  bool ok = true;
  if (has) {
    const int prev = t > 0 ? sslot[t - 1] : s_carry;
    ok = slot >= 0 && slot < a.n_e;
    if (!ok || slot < prev) s_fault = 1;
  }
  if ((t & ~31) < nb) {   // a warp with at least one row
    int v[F + 1];
#pragma unroll
    for (int j = 0; j <= F; ++j) v[j] = 0;
    if (has) {
      const int p = __ldg(a.ids + i);
      int c[D];
      if constexpr (D == 3) {
        c[0] = fastdiv(p, a.div_rr);
        const int rem = p - c[0] * a.rf * a.rf;
        c[1] = fastdiv(rem, a.div_r);
        c[2] = rem - c[1] * a.rf;
      } else {
        c[0] = static_cast<int>(static_cast<unsigned>(p) >> 16);
        c[1] = p & 0xFFFF;
      }
      bool oob = false;
#pragma unroll
      for (int ax = 0; ax < D; ++ax) oob |= c[ax] == 0 || c[ax] >= a.rf - 1;
      int x[S::kIn];
#pragma unroll
      for (int j = 0; j < S::kIn - 1; ++j) x[j] = 0;
      if (!oob) {
#pragma unroll
        for (int l = 0; l < S::kTables; ++l) {
          int pgc[D], fq[D];
#pragma unroll
          for (int ax = 0; ax < D; ++ax) {
            const int e = tab[l * a.rf + c[ax]];
            pgc[ax] = e >> 6;
            fq[ax] = e & 63;
          }
          if (l < K) {
            level_features<D, F>(pgc, fq, l, a, x + l * F);
          } else if constexpr (D == 2 && PLANE) {
            plane_features<F>(pgc, fq, a, x + K * F);
          }
        }
      }
      x[S::kIn - 1] = a.pg_q;
      int out[F];
      mlp<D, F, S::kIn>(sw, x, out);
      int wgt = 1;
      if (a.ovl != nullptr) wgt = (p >= 0 && p < a.ovl_len) ? max(__ldg(a.ovl + p), 1) : 1;
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = (out[f] >> a.m_shift) * wgt;
      v[F] = wgt;
    }
    const int key = (has && ok) ? slot : -1;
    if (warp_run_sums<F + 1>(key, v, lane) && key >= 0) {
#pragma unroll
      for (int f = 0; f < F; ++f) atomicAdd(a.msum + static_cast<long long>(key) * F + f, v[f]);
      atomicAdd(a.wsum + key, v[F]);
    }
  }
  __syncthreads();
  if (t == 0) {
    if (s_first < 0) s_first = sslot[0];
    s_carry = sslot[nb - 1];
  }
  __syncthreads();
}

// The last block's check of the blocks' (first, last) records: a block's
// first kept entry must not lie below the largest last entry before it.
__device__ __forceinline__ void check_block_order(const PoolArgs& a, int* wcount) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int carry = -1;   // the largest last entry of the blocks before this chunk
  for (unsigned b0 = 0; b0 < gridDim.x; b0 += kThreads) {
    const unsigned b = b0 + t;
    const int4 r = b < gridDim.x ? __ldcg(a.records + b) : make_int4(-1, -1, -1, -1);
    int incl = r.y;   // inclusive max-scan of the lasts over the block
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = max(incl, u);
    }
    if (lane == 31) wcount[warp] = incl;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before = max(before, wcount[w]);
    const int up = __shfl_up_sync(0xffffffffu, incl, 1);
    const int excl = max(before, lane > 0 ? up : -1);
    if (r.x >= 0 && r.x < excl) *a.fault = 1;
    for (int w = 0; w < kWarps; ++w) carry = max(carry, wcount[w]);
    __syncthreads();
  }
}

// The entry that starts before the span [r0, r1) and ends in it (rows r0 - 1
// and r0 share it, and its rows end before r1), or -1: the last block to
// finish finishes it.
__device__ __forceinline__ int straddling_entry(const PoolArgs& a, long long r0, long long r1) {
  if (r0 == 0) return -1;
  const int s = __ldg(a.slots + r0);
  if (__ldg(a.slots + r0 - 1) != s || (r1 < a.n && __ldg(a.slots + r1) == s)) return -1;
  const int e = s - a.start_e;
  return e >= 0 && e < a.n_e ? e : -1;
}

template <int D, int F, int K, bool PLANE>
__global__ void __launch_bounds__(kThreads, 2) int_ctx_pool_kernel(const PoolArgs a) {
  using S = Shape<D, F, K, PLANE>;
  extern __shared__ int4 smem4[];
  int* sw = reinterpret_cast<int*>(smem4);
  int* tab = sw + round4(S::kParams);
  int* queue = tab + round4(S::kTables * a.rf);
  int* sslot = queue + kQueue;
  __shared__ int wcount[32];
  __shared__ int s_total, s_carry, s_first, s_fault;
  // the finish's work: the entries [s_lo, s_hi) this block finishes, the
  // entry that straddles r0 (the last block finishes it), and whether the
  // launch finishes at all (held in shared memory, so that no register
  // carries them through the pooling)
  __shared__ int s_lo, s_hi, s_str;
  __shared__ bool s_last, s_fin;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int j = t; j < S::kParams; j += kThreads) sw[j] = __ldg(a.params + j);
  for (int j = t; j < S::kTables * a.rf; j += kThreads) tab[j] = __ldg(a.interp + j);
  const long long r0 = static_cast<long long>(blockIdx.x) * a.span;
  const long long r1 = min(a.n, r0 + a.span);
  if (t == 0) {
    s_carry = -1;
    s_first = -1;
    s_fault = 0;
    // the entries whose rows all lie in [r0, r1): after the entry of row
    // r0 - 1, before the entry of row r1
    s_fin = a.pq != nullptr;
    if (s_fin) {
      s_lo = max(r0 == 0 ? 0 : __ldg(a.slots + r0 - 1) - a.start_e + 1, 0);
      s_hi = min(r1 == a.n ? a.n_e : __ldg(a.slots + r1) - a.start_e, a.n_e);
      s_str = straddling_entry(a, r0, r1);
    }
  }
  __syncthreads();
  // the sign bits of the entries this block finishes, and of the entry that
  // straddles r0: they need no sum, so they are written before the pooling
  if (s_fin && a.bits != nullptr) {
    for (int e = s_lo + t; e < s_hi; e += kThreads) write_bits<F>(a, e);
    if (t == 0 && s_str >= 0) write_bits<F>(a, s_str);
  }

  int qlen = 0;
  for (long long base = r0; base < r1; base += kTile) {
    // the tile's kept rows, in row order, onto the queue
    int id[kRowsPerThread];
    bool keep[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const long long i = base + j * kThreads + t;
      keep[j] = i < r1;
      id[j] = keep[j] ? __ldg(a.ids + i) : 0;
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (keep[j]) {
        const long long m = row_mask_index<D>(id[j], a);
        keep[j] = m >= 0 && m < a.mask_len && __ldg(a.mask + m);
      }
    }
    unsigned bal[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      bal[j] = __ballot_sync(0xffffffffu, keep[j]);
      if (lane == 0) wcount[j * kWarps + warp] = __popc(bal[j]);
    }
    __syncthreads();
    if (warp == 0) {
      const int c = wcount[lane];
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      wcount[lane] = incl - c;
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      if (keep[j])
        queue[qlen + wcount[j * kWarps + warp] + __popc(bal[j] & below)] =
            static_cast<int>(base + j * kThreads + t);
    qlen += s_total;
    __syncthreads();
    int head = 0;
    for (; qlen - head >= kThreads; head += kThreads)
      pool_batch<D, F, K, PLANE>(a, queue + head, kThreads, sw, tab, sslot, s_carry, s_first,
                                 s_fault);
    if (head > 0) {   // the rest (< kThreads rows) to the front
      const int rest = qlen - head;
      const int v = t < rest ? queue[head + t] : 0;
      __syncthreads();
      if (t < rest) queue[t] = v;
      __syncthreads();
      qlen = rest;
    }
  }
  if (qlen > 0)
    pool_batch<D, F, K, PLANE>(a, queue, qlen, sw, tab, sslot, s_carry, s_first, s_fault);

  // the order across blocks: the last block to finish checks the records.
  // The block's adds come before thread 0's fence and count (the barrier at
  // the end of each batch), so the last block reads other blocks' sums whole
  if (t == 0) {
    a.records[blockIdx.x] = make_int4(s_first, s_carry, s_fin ? s_str : -1, 0);
    if (s_fault) *a.fault = 1;
    __threadfence();
    s_last = atomicAdd(a.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    check_block_order(a, wcount);
  }
  // the finish, one call site for both kinds of entry (so the pooling's
  // registers stay as they were): those whose rows all lie in [r0, r1), and,
  // in the last block, those that start before a block's span and end in it
  if (s_fin) {
    const int n_in = max(s_hi - s_lo, 0);
    const int n_all = n_in + (s_last ? static_cast<int>(gridDim.x) : 0);
    for (int j = t; j < n_all; j += kThreads) {
      const int e = j < n_in ? s_lo + j : __ldcg(&a.records[j - n_in].z);
      if (e >= 0) finish_entry<F>(a, e);
    }
  }
  if (s_last && t == 0) *a.counter = 0;
}

template <int D, int F, int K, bool PLANE>
int launch_pool(PoolArgs a, cudaStream_t s) {
  using S = Shape<D, F, K, PLANE>;
  auto kernel = int_ctx_pool_kernel<D, F, K, PLANE>;
  const size_t smem =
      static_cast<size_t>(round4(S::kParams) + round4(S::kTables * a.rf) + kQueue + kThreads) *
      sizeof(int);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return cnc_last_error();
  int dev = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return cnc_last_error();
  // about two waves of blocks, each a run of whole tiles
  const long long tiles = (a.n + kTile - 1) / kTile;
  long long blocks = 2LL * (per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks > tiles) blocks = tiles;
  const long long per_block = (tiles + blocks - 1) / blocks;
  a.span = per_block * kTile;
  blocks = (tiles + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  return cnc_last_error();
}

}  // namespace

// The int32 words of a stream's scratch: the block records (four words a
// block of the largest grid).  The finish counter is one more word, zeroed
// once by the caller (each launch leaves it 0).
CNC_EXPORT long long cnc_int_ctx_pool_scratch() { return 4LL * kMaxBlocks; }

// One codec pool.  ids [n] int32 packed vertex ids of an rf-lattice (D = 3:
// the flat index, last axis fastest; D = 2: (x << 16) | y), slots [n] int32
// their entries plus start_e, sorted; a row is kept where mask[mask_off +
// its flat index] (bool [mask_len]).  sign [tbl_rows, f] int32 +-1 (rows
// 4f-byte aligned); k context levels described by res, offset, size and
// mask_off (host arrays of k); plane [pn_res^2, f] int32 or null (D = 2
// only); interp [(k + plane) * rf] int32 the per-axis interpolation table;
// params [n_params] int32, per layer w [in, out] then b [out] (3D: in -> 32
// -> 32 -> f, 2D: in -> f, in = k f (+ f) + 1); ovl [ovl_len] int32 or null
// (3D: the row weight max(ovl[id], 1), else 1).  msum [n_e, f] and wsum
// [n_e] int32 zeroed by the caller; records [cnc_int_ctx_pool_scratch()]
// and counter [1] scratch of the stream; fault [1] set to 1 where the kept
// rows' entries leave [0, n_e) or decrease.  With pq [n_e, f] uint16 (4f-
// byte aligned) and covered [n_e] the launch also finishes every entry
// (K9c: pq with m_scale, covered; bits [n_e, f] uint8 (f-byte aligned), the
// sign bits of rows tbl_offset + evals [n_e] int32, or both null); it then
// needs slots to run from start_e to start_e + n_e - 1 by steps of 0 or 1,
// and sets fault where they do not.
CNC_EXPORT int cnc_int_ctx_pool(const int* ids, const int* slots, long long n, int start_e,
                                int n_e, int d, int rf, const unsigned char* mask,
                                long long mask_len, long long mask_off, const int* sign,
                                long long tbl_rows, int f, int k, const int* res,
                                const long long* offset, const long long* size,
                                const long long* lv_mask_off, const int* plane, int pn_res,
                                long long plane_moff, const int* interp, const int* params,
                                long long n_params, int pg_q, int m_shift, const int* ovl,
                                long long ovl_len, int* msum, int* wsum, int* records,
                                unsigned* counter, int* fault, unsigned short* pq,
                                unsigned char* covered, unsigned char* bits, const int* evals,
                                long long tbl_offset, int m_scale, void* stream) {
  const auto misaligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes != 0;
  };
  if (f != 2 && f != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (pq != nullptr && (covered == nullptr || (bits == nullptr) != (evals == nullptr) ||
                        m_scale < 1 || n < n_e || misaligned(pq, 2 * f) || misaligned(bits, f) ||
                        misaligned(msum, 4 * f)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || n_e == 0) return 0;
  if (k < 0 || k > kMaxCtx || rf < 3 || rf > 65535 || m_shift < 0 || m_shift > 30 ||
      (d == 3 && (plane != nullptr || static_cast<long long>(rf) * rf * rf > 0x7fffffffLL)))
    return static_cast<int>(cudaErrorInvalidValue);
  PoolArgs a{};
  a.ids = ids;
  a.slots = slots;
  a.n = n;
  a.start_e = start_e;
  a.n_e = n_e;
  a.rf = rf;
  a.div_rr = make_fastdiv(static_cast<unsigned>(rf) * rf);
  a.div_r = make_fastdiv(static_cast<unsigned>(rf));
  a.mask = mask;
  a.mask_len = mask_len;
  a.mask_off = mask_off;
  a.sign = sign;
  a.tbl_rows = tbl_rows;
  for (int l = 0; l < k; ++l) {
    a.lv.res[l] = res[l];
    a.lv.offset[l] = offset[l];
    a.lv.size[l] = static_cast<unsigned>(size[l]);
    a.lv.mask_off[l] = lv_mask_off[l];
    long long rd = 1;
    for (int ax = 0; ax < d; ++ax) rd *= res[l];
    a.lv.dense[l] = rd <= size[l];
  }
  a.plane = plane;
  a.pn_res = pn_res;
  a.plane_moff = plane_moff;
  a.params = params;
  a.interp = interp;
  a.pg_q = pg_q;
  a.m_shift = m_shift;
  a.ovl = ovl;
  a.ovl_len = ovl_len;
  a.msum = msum;
  a.wsum = wsum;
  a.records = reinterpret_cast<int4*>(records);
  a.counter = counter;
  a.fault = fault;
  a.pq = pq;
  a.covered = covered;
  a.bits = bits;
  a.evals = evals;
  a.tbl_offset = tbl_offset;
  a.m_scale = m_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pl = plane != nullptr;
  long long want = -1;
#define CNC_POOL(D, F, K, P)                                                                  \
  if (d == D && f == F && k == K && pl == P) {                                                \
    want = Shape<D, F, K, P>::kParams;                                                        \
    if (n_params != want) return static_cast<int>(cudaErrorInvalidValue);                     \
    return launch_pool<D, F, K, P>(a, s);                                                     \
  }
#define CNC_POOL_K(D, F, P) CNC_POOL(D, F, 1, P) CNC_POOL(D, F, 2, P) CNC_POOL(D, F, 3, P)     \
  CNC_POOL(D, F, 4, P)
  CNC_POOL_K(3, 4, false)
  CNC_POOL_K(3, 2, false)
  CNC_POOL_K(2, 4, false)
  CNC_POOL_K(2, 4, true)
  CNC_POOL_K(2, 2, false)
  CNC_POOL_K(2, 2, true)
  CNC_POOL(2, 4, 0, false)
  CNC_POOL(2, 4, 0, true)
  CNC_POOL(2, 2, 0, false)
  CNC_POOL(2, 2, 0, true)
#undef CNC_POOL_K
#undef CNC_POOL
  return static_cast<int>(cudaErrorInvalidValue);
}
