// K9: the integer codec context.  K9a int_encode, K9b int_mlp_pool, K9c int_pq.
//
// Replaces (cnc_tpu, the XLA compositions of the codec's pool programs):
//   K9a codec/intctx.py int_encode_levels (110-170) and int_encode_plane
//       (173-210): exact lattice interpolation of the coarser levels' signs
//       (and of the dimension-wise prior plane) at each coded vertex;
//   K9b codec/intctx.py _int_matmul/_int_leaky/int_apply_ctx3d/int_apply_ctx2d
//       (214-242), then, of models/context_models.py pool_3d_level_int
//       (1197-1206) and pool_2d_level_int (1254-1260), `mean // 2**m_shift`,
//       the overlap or count weight and the two segment_sum_int calls
//       (intctx.py 325-331);
//   K9c codec/intctx.py device_pq (344-372) and the covered and sign-bit
//       outputs of codec/codec.py _pool3d_fn/_pool2d_fn (131-134, 150-153).
// Plain twins: cnc_torch/codec/intctx.py int_encode_levels, int_encode_plane
// (K9a), int_apply_ctx3d/2d and segment_sum_int (K9b), device_pq (K9c).
//
// Every step is integer arithmetic, so each kernel equals its twin bit for
// bit, K9b's atomics included (integer sums do not depend on their order).
// JAX's `//` floors, C++'s `/` truncates toward zero: every division whose
// numerator can be negative (_axis_interp when the target grid is finer, the
// LeakyReLU's x*41 // 4096, h // Q_W, out // 2**M_SHIFT, mean // 2**m_shift,
// acc*Q_FEAT // wsum) goes through `floordiv`.  The format keeps every sum
// and product under 2**30 except the LeakyReLU's x*41, which XLA computes
// with int32 wrap-around; `mul_wrap` makes that wrap explicit (signed
// overflow is undefined in C++), as the twin does in int64.
//
// K9a.  One thread per vertex row: the row's coords from its packed id (the
// flat index with the last axis fastest in 3D, (x << 16) | y in 2D), then per
// context level the per-axis interp, and for each of the 2^D corners the
// clamp, the border test, the mask bit (mask grids are last-axis-fastest),
// the dense x-fastest or hashed entry (hash_ops.grid_index, uint32 wrap) and
// one 16-byte load of the +-1 sign row (8 bytes at F = 2).  Bound on the
// H100: bytes, the gathers; a 3D chunk of about 2M rows reads 24 corners'
// mask bytes and up to 24 sign rows per row.  The simple form stays: no
// shared-memory staging of the coarse levels (which the L2 holds anyway).
//
// K9b.  One thread per row, the int32 weights of the MLP (13 -> 32 -> 32 -> 4
// in 3D, one Linear in 2D) in shared memory, activations in local arrays.
// Rows whose mask bit is false weigh 0 and add nothing, so they skip the MLP.
// Each kept row adds mean * weight into msum[slot] and the weight into
// wsum[slot] with int32 atomics.  Bound on the H100: operations (about 3,100
// integer multiply-adds per kept 3D row against a few dozen bytes).  Rows
// come sorted by slot, so a warp-segmented sum as K6's would cut the atomics;
// not done in this first form.
//
// K9c.  One thread per entry: pq = clip(msum * 65536 // (max(wsum, 1) *
// m_scale), 1, 65535) in int64 (msum <= 0 gives 1), which is host_pq's
// formula and equals cnc_tpu's uint32 long division; covered = wsum > 0; the
// entry's sign bits from its table row.  Bound: bytes.

#include "common.cuh"

namespace {

constexpr int kQAxis = 32, kQFeat = 256, kQW = 512, kHClip = 1 << 12, kMShift = 6,
              kMClip = 1 << 14;
constexpr int kMaxCtx = 4;       // context levels of one encode
constexpr int kMaxWidth = 64;    // MLP layer width
constexpr int kMaxLayers = 3;

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int mul_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

struct CtxLevels {
  int n;
  int res[kMaxCtx];
  long long offset[kMaxCtx];
  unsigned size[kMaxCtx];
  long long mask_off[kMaxCtx];
  bool dense[kMaxCtx];
};

struct MlpDims {
  int d[kMaxLayers + 1];
};

// cnc_tpu/codec/intctx.py _axis_interp
__device__ __forceinline__ void axis_interp(int c, int rf, int rc, int& pgc, int& fq) {
  const int den = 2 * (rf - 2);
  const int num = (2 * c - 1) * (rc - 2) + (rf - 2);
  pgc = floordiv(num, den);
  const int rem = num - pgc * den;
  fq = floordiv(rem * kQAxis + den / 2, den);
}

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

template <int D, int F>
__global__ void int_encode_kernel(const int* __restrict__ packed, long long n, int rf,
                                  const int* __restrict__ sign, long long tbl_rows, CtxLevels lv,
                                  const unsigned char* __restrict__ mask, long long mask_len,
                                  const int* __restrict__ plane, int pn_res, long long plane_moff,
                                  int n_cols, int* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = packed[i];
  int c[D];
  if constexpr (D == 3) {
    c[0] = p / (rf * rf);
    c[1] = (p / rf) % rf;
    c[2] = p % rf;
  } else {
    c[0] = static_cast<int>(static_cast<unsigned>(p) >> 16);
    c[1] = p & 0xFFFF;
  }
  bool oob = false;
#pragma unroll
  for (int ax = 0; ax < D; ++ax) oob |= c[ax] == 0 || c[ax] >= rf - 1;
  int* o = out + i * n_cols;
  for (int l = 0; l < lv.n; ++l) {
    const int rc = lv.res[l];
    int pgc[D], fq[D];
#pragma unroll
    for (int ax = 0; ax < D; ++ax) axis_interp(c[ax], rf, rc, pgc[ax], fq[ax]);
    int acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0;
    int wsum = 0;
#pragma unroll
    for (int corner = 0; corner < (1 << D); ++corner) {
      int cc[D];
      int w = 1;
      bool valid = true;
      long long flat = 0;
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        int v;
        if ((corner >> ax) & 1) {
          v = min(pgc[ax] + 1, rc - 1);
          w *= fq[ax];
        } else {
          v = pgc[ax];
          w *= kQAxis - fq[ax];
        }
        v = min(max(v, 0), rc - 1);
        cc[ax] = v;
        valid = valid && v != 0 && v != rc - 1;
        flat = flat * rc + v;
      }
      if (!valid) continue;
      const long long m = lv.mask_off[l] + flat;
      if (m < 0 || m >= mask_len || !mask[m]) continue;
      const long long row = clamp_row(
          lv.offset[l] + grid_index<D>(cc, static_cast<uint32_t>(rc), lv.size[l], lv.dense[l]),
          tbl_rows);
      int v[F];
      load_irow<F>(sign, row, v);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += w * v[f];
      wsum += w;
    }
#pragma unroll
    for (int f = 0; f < F; ++f)
      o[l * F + f] = (oob || wsum == 0) ? 0 : floordiv(acc[f] * kQFeat, wsum);
  }
  if constexpr (D == 2) {
    if (plane == nullptr) return;
    int pgc[2], fq[2];
    axis_interp(c[0], rf, pn_res, pgc[0], fq[0]);
    axis_interp(c[1], rf, pn_res, pgc[1], fq[1]);
    int acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0;
    int wsum = 0;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      int cc[2];
      int w = 1;
#pragma unroll
      for (int ax = 0; ax < 2; ++ax) {
        int v;
        if ((corner >> ax) & 1) {
          v = min(pgc[ax] + 1, pn_res - 1);
          w *= fq[ax];
        } else {
          v = pgc[ax];
          w *= kQAxis - fq[ax];
        }
        cc[ax] = min(max(v, 0), pn_res - 1);
      }
      if (cc[0] == 0 || cc[0] == pn_res - 1 || cc[1] == 0 || cc[1] == pn_res - 1) continue;
      const long long m = plane_moff + static_cast<long long>(cc[0]) * pn_res + cc[1];
      if (m < 0 || m >= mask_len || !mask[m]) continue;
      int v[F];
      load_irow<F>(plane, cc[0] + static_cast<long long>(cc[1]) * pn_res, v);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += w * v[f];
      wsum += w;
    }
#pragma unroll
    for (int f = 0; f < F; ++f)
      o[lv.n * F + f] = (oob || wsum == 0) ? 0 : floordiv(acc[f], wsum);
  }
}

template <int F>
__global__ void int_mlp_pool_kernel(const int* __restrict__ feats, long long w, int n_feat,
                                    int pg_q, const int* __restrict__ params, int n_params,
                                    int n_layers, MlpDims dims, int m_shift,
                                    const unsigned char* __restrict__ mask,
                                    const int* __restrict__ slots, const int* __restrict__ ovl,
                                    const int* __restrict__ pos, int n_e,
                                    int* __restrict__ msum, int* __restrict__ wsum) {
  extern __shared__ int sp[];
  for (int j = threadIdx.x; j < n_params; j += blockDim.x) sp[j] = params[j];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= w || !mask[i]) return;
  const int slot = slots[i];
  if (slot < 0 || slot >= n_e) return;
  int x[kMaxWidth], y[kMaxWidth];
  for (int k = 0; k < n_feat; ++k) x[k] = feats[i * n_feat + k];
  x[n_feat] = pg_q;
  const int* p = sp;
  int din = dims.d[0];
  for (int l = 0; l < n_layers; ++l) {
    const int dout = dims.d[l + 1];
    const int* wt = p;
    const int* b = p + din * dout;
    for (int j = 0; j < dout; ++j) {
      int acc = 0;
      for (int k = 0; k < din; ++k) acc += x[k] * wt[k * dout + j];
      acc += b[j];
      if (l < n_layers - 1) {
        if (acc < 0) acc = floordiv(mul_wrap(acc, 41), 4096);
        acc = min(max(floordiv(acc, kQW), -kHClip), kHClip);
      } else {
        acc = min(max(floordiv(acc, 1 << kMShift), -kMClip), kMClip);
      }
      y[j] = acc;
    }
    for (int j = 0; j < dout; ++j) x[j] = y[j];
    p = b + dout;
    din = dout;
  }
  const int wgt = ovl != nullptr ? max(ovl[pos[i]], 1) : 1;
#pragma unroll
  for (int f = 0; f < F; ++f)
    atomicAdd(msum + static_cast<long long>(slot) * F + f, floordiv(x[f], 1 << m_shift) * wgt);
  atomicAdd(wsum + slot, wgt);
}

template <int F>
__global__ void int_pq_kernel(const int* __restrict__ msum, const int* __restrict__ wsum,
                              long long n_e, int m_scale, const int* __restrict__ sign,
                              long long offset, const int* __restrict__ evals, long long tbl_rows,
                              unsigned short* __restrict__ pq, unsigned char* __restrict__ covered,
                              unsigned char* __restrict__ bits) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_e) return;
  const int ws = wsum[e];
  covered[e] = ws > 0;
  const long long den = static_cast<long long>(max(ws, 1)) * m_scale;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int m = msum[e * F + f];
    long long q = m <= 0 ? 1 : static_cast<long long>(m) * 65536 / den;
    q = q < 1 ? 1 : (q > 65535 ? 65535 : q);
    pq[e * F + f] = static_cast<unsigned short>(q);
  }
  if (bits != nullptr) {
    int v[F];
    load_irow<F>(sign, clamp_row(offset + evals[e], tbl_rows), v);
#pragma unroll
    for (int f = 0; f < F; ++f) bits[e * F + f] = v[f] > 0;
  }
}

}  // namespace

// packed [n] int32 vertex ids of an rf-lattice (D = 3 or 2); sign [tbl_rows,
// f] int32 +-1 (rows 4f-byte aligned); k context levels described by res,
// offset, size and mask_off (host arrays of kMaxCtx); mask [mask_len] bool;
// plane [pn_res^2, f] int32 or null (D = 2 only); out [n, n_cols] int32,
// n_cols = k*f (+ f with the plane), every element written.
CNC_EXPORT int cnc_int_encode(const int* packed, long long n, int d, int rf, const int* sign,
                              long long tbl_rows, int f, int k, const int* res,
                              const long long* offset, const long long* size,
                              const long long* mask_off, const unsigned char* mask,
                              long long mask_len, const int* plane, int pn_res,
                              long long plane_moff, int n_cols, int* out, void* stream) {
  if (n == 0) return 0;
  if (k < 0 || k > kMaxCtx) return static_cast<int>(cudaErrorInvalidValue);
  CtxLevels lv{};
  lv.n = k;
  for (int l = 0; l < k; ++l) {
    lv.res[l] = res[l];
    lv.offset[l] = offset[l];
    lv.size[l] = static_cast<unsigned>(size[l]);
    lv.mask_off[l] = mask_off[l];
    long long rd = 1;
    for (int ax = 0; ax < d; ++ax) rd *= res[l];
    lv.dense[l] = rd <= size[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned blocks = cnc_blocks(n, threads);
#define CNC_INT_ENCODE(D, F)                                                                     \
  int_encode_kernel<D, F><<<blocks, threads, 0, s>>>(packed, n, rf, sign, tbl_rows, lv, mask,    \
                                                     mask_len, plane, pn_res, plane_moff, n_cols, \
                                                     out)
  if (d == 3 && f == 4) CNC_INT_ENCODE(3, 4);
  else if (d == 3 && f == 2) CNC_INT_ENCODE(3, 2);
  else if (d == 2 && f == 4) CNC_INT_ENCODE(2, 4);
  else if (d == 2 && f == 2) CNC_INT_ENCODE(2, 2);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef CNC_INT_ENCODE
  return cnc_last_error();
}

// feats [w, n_feat] int32 (the MLP's input less its last column, pg_q);
// params [n_params] int32, per layer w [in, out] row-major then b [out];
// dims [n_layers + 1] layer widths (host), dims[0] = n_feat + 1; mask [w]
// bool, slots [w] int32; ovl (the level's int overlap grid) and pos [w] int32,
// or both null; msum [n_e, f] and wsum [n_e] int32 zeroed by the caller.
CNC_EXPORT int cnc_int_mlp_pool(const int* feats, long long w, int n_feat, int pg_q,
                                const int* params, long long n_params, int n_layers,
                                const int* dims, int m_shift, const unsigned char* mask,
                                const int* slots, const int* ovl, const int* pos, int n_e,
                                int* msum, int* wsum, void* stream) {
  if (w == 0 || n_e == 0) return 0;
  if (n_layers < 1 || n_layers > kMaxLayers || dims[0] != n_feat + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpDims md{};
  long long need = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
    md.d[l] = dims[l];
    if (l > 0) need += static_cast<long long>(dims[l - 1]) * dims[l] + dims[l];
  }
  if (need != n_params) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned blocks = cnc_blocks(w, threads);
  const size_t smem = static_cast<size_t>(n_params) * sizeof(int);
  switch (dims[n_layers]) {
    case 4: int_mlp_pool_kernel<4><<<blocks, threads, smem, s>>>(feats, w, n_feat, pg_q, params, static_cast<int>(n_params), n_layers, md, m_shift, mask, slots, ovl, pos, n_e, msum, wsum); break;
    case 2: int_mlp_pool_kernel<2><<<blocks, threads, smem, s>>>(feats, w, n_feat, pg_q, params, static_cast<int>(n_params), n_layers, md, m_shift, mask, slots, ovl, pos, n_e, msum, wsum); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}

// msum [n_e, f] int32, wsum [n_e] int32; sign [tbl_rows, f] int32 with evals
// [n_e] int32 (the entries' table indices, offset added), or both null;
// pq [n_e, f] uint16, covered [n_e] bool, bits [n_e, f] uint8 (null when sign
// is), every element written.
CNC_EXPORT int cnc_int_pq(const int* msum, const int* wsum, long long n_e, int f, int m_scale,
                          const int* sign, long long offset, const int* evals,
                          long long tbl_rows, unsigned short* pq, unsigned char* covered,
                          unsigned char* bits, void* stream) {
  if (n_e == 0) return 0;
  if ((sign == nullptr) != (evals == nullptr) || (sign == nullptr) != (bits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const unsigned blocks = cnc_blocks(n_e, threads);
  switch (f) {
    case 4: int_pq_kernel<4><<<blocks, threads, 0, s>>>(msum, wsum, n_e, m_scale, sign, offset, evals, tbl_rows, pq, covered, bits); break;
    case 2: int_pq_kernel<2><<<blocks, threads, 0, s>>>(msum, wsum, n_e, m_scale, sign, offset, evals, tbl_rows, pq, covered, bits); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return cnc_last_error();
}
