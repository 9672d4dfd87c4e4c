// K10: the vertex -> entry tables of one context level.
//
// Replaces: cnc_tpu/models/context_models.py _fused_build_impl (269-396):
// every lattice vertex of a level is hashed to its table entry, the vertices
// are sorted by entry, and per entry the first vertex (`cum`), the table index
// (`entry_values`) and per vertex the entry's ordinal (`vert_entry`) are
// filled in by XLA scatters over a cumulative sum of the run heads.
// Plain twins: cnc_torch/ops/context_ops.py `_vertex_keys_plain`,
// `_entry_fill_plain`, `_dense_level_plain`.
//
// The stable sort between the two halves stays a library call, as it is one
// in cnc_tpu (jax.lax.sort); each level is sorted on its own, so the keys need
// no level tag.  The halves:
//   (i)  keys: vertex id -> lattice coords (3D raster, last axis fastest, or
//        the 2D block lattice of _coords_2d, 258-267) -> grid_index (dense
//        x-fastest or the XOR-prime hash) -> the optional entry permutation.
//   (ii) after the sort, over the sorted keys: run-head flags; the heads'
//        positions come out of the compaction kernel (csrc/compact.cu) in
//        ascending order, which IS cum[0..n_entries); then per entry
//        cum (parked at V past the exact count) and entry_values (0 past it,
//        mapped back through the inverse permutation when there is one); and
//        per vertex the ordinal of its entry, by a binary search of its
//        position in cum (and, in 2D, its packed coords and block id).
//   A dense 3D level (R^3 <= table size) needs no sort: its grid_index is a
//   bijection, so entry e of the shuffled order is vertex inv(perm[e]).
//
// Bound on the H100: bytes (4 to 12 bytes read and written per vertex and
// pass, 219M hashed 3D vertices in all); it runs once, when the model is
// built.

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t grid_index3(uint32_t x, uint32_t y, uint32_t z, uint32_t r,
                                                uint32_t size, bool dense) {
  if (dense) return x + y * r + z * r * r;
  const uint32_t h = x ^ (y * 2654435761u) ^ (z * 805459861u);
  return (size & (size - 1)) == 0 ? (h & (size - 1)) : (h % size);
}

__device__ __forceinline__ uint32_t grid_index2(uint32_t x, uint32_t y, uint32_t r,
                                                uint32_t size, bool dense) {
  if (dense) return x + y * r;
  const uint32_t h = x ^ (y * 2654435761u);
  return (size & (size - 1)) == 0 ? (h & (size - 1)) : (h % size);
}

// Block-lattice coords of point `id` (context_models._coords_2d).
__device__ __forceinline__ void coords_2d(long long id, int tile, int rb, int* x, int* y,
                                          int* blk) {
  const int per_block = (tile + 2) * (tile + 2);
  const int b = static_cast<int>(id / per_block), off = static_cast<int>(id % per_block);
  *x = (b / rb) * tile + off / (tile + 2);
  *y = (b % rb) * tile + off % (tile + 2);
  *blk = b;
}

__global__ void vertex_keys_kernel(int* __restrict__ keys, long long v, int d, int r, int size,
                                   int tile, int rb, const int* __restrict__ perm) {
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (id >= v) return;
  uint32_t idx;
  if (d == 3) {
    const long long rr = static_cast<long long>(r) * r;
    const bool dense = rr * r <= size;
    idx = grid_index3(static_cast<uint32_t>(id / rr), static_cast<uint32_t>((id / r) % r),
                      static_cast<uint32_t>(id % r), r, size, dense);
  } else {
    int x, y, blk;
    coords_2d(id, tile, rb, &x, &y, &blk);
    idx = grid_index2(x, y, r, size, static_cast<long long>(r) * r <= size);
  }
  keys[id] = perm ? perm[idx] : static_cast<int>(idx);
}

__global__ void head_flags_kernel(const int* __restrict__ skey, long long v,
                                  unsigned char* __restrict__ head) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= v) return;
  head[i] = (i == 0 || skey[i] != skey[i - 1]) ? 1 : 0;
}

__global__ void entry_fill_kernel(const int* __restrict__ skey, const int* __restrict__ heads,
                                  const int* __restrict__ n_entries, int v, int e_max,
                                  const int* __restrict__ inv, int* __restrict__ cum,
                                  int* __restrict__ values) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e > e_max) return;
  const bool live = e < *n_entries;
  cum[e] = live ? heads[e] : v;
  if (e < e_max) {
    const int val = live ? skey[heads[e]] : 0;
    values[e] = inv ? inv[val] : val;
  }
}

__global__ void vertex_fill_kernel(const long long* __restrict__ loc, const int* __restrict__ cum,
                                   const int* __restrict__ n_entries, long long v, int d,
                                   int tile, int rb, int* __restrict__ vert_entry,
                                   int* __restrict__ pos, int* __restrict__ block_id) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= v) return;
  // the last entry whose first vertex is at or before i
  int lo = 0, hi = *n_entries;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= i) lo = mid; else hi = mid;
  }
  vert_entry[i] = lo;
  if (d == 3) {
    pos[i] = static_cast<int>(loc[i]);
  } else {
    int x, y, blk;
    coords_2d(loc[i], tile, rb, &x, &y, &blk);
    pos[i] = (x << 16) | y;
    block_id[i] = blk;
  }
}

__global__ void dense_level_kernel(const int* __restrict__ perm, int v, int r,
                                   int* __restrict__ pos_flat, int* __restrict__ vert_entry,
                                   int* __restrict__ values, int* __restrict__ cum) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e > v) return;
  cum[e] = e;
  if (e == v) return;
  const int p = perm[e];            // dense table index x + y*r + z*r^2
  const int x = p % r, y = (p / r) % r, z = p / (r * r);
  pos_flat[e] = (x * r + y) * r + z;  // vertex id, last axis fastest
  vert_entry[e] = e;
  values[e] = p;
}

}  // namespace

// keys [v] int32 out.  d = 3: raster vertices of an r^3 lattice; d = 2: the
// block lattice (tile, rb).  perm [size] int32 or null.
CNC_EXPORT int cnc_vertex_keys(int* keys, long long v, int d, int r, int size, int tile, int rb,
                               const int* perm, void* stream) {
  if (v == 0) return 0;
  if (d != 2 && d != 3) return static_cast<int>(cudaErrorInvalidValue);
  vertex_keys_kernel<<<cnc_blocks(v, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, v, d, r, size, tile, rb, perm);
  return cnc_last_error();
}

// skey [v] int32 sorted; head [v] bool bytes out.
CNC_EXPORT int cnc_vertex_heads(const int* skey, long long v, unsigned char* head, void* stream) {
  if (v == 0) return 0;
  head_flags_kernel<<<cnc_blocks(v, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(skey, v,
                                                                                       head);
  return cnc_last_error();
}

// heads [>= e_max + 1] int32: the heads' positions ascending (first n_entries
// slots); n_entries [1] int32 on the device; loc [v] int64, the sort's
// indices.  Out: cum [e_max + 1], values [e_max], vert_entry [v], pos [v]
// (pos_flat in 3D, packed coords in 2D), block_id [v] (2D only, else null).
CNC_EXPORT int cnc_vertex_fill(const int* skey, const long long* loc, const int* heads,
                               const int* n_entries, long long v, int e_max, int d, int tile,
                               int rb, const int* inv, int* cum, int* values, int* vert_entry,
                               int* pos, int* block_id, void* stream) {
  if (v == 0) return 0;
  if ((d != 2 && d != 3) || v > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  entry_fill_kernel<<<cnc_blocks(e_max + 1, 256), 256, 0, s>>>(
      skey, heads, n_entries, static_cast<int>(v), e_max, inv, cum, values);
  int rc = cnc_last_error();
  if (rc) return rc;
  vertex_fill_kernel<<<cnc_blocks(v, 256), 256, 0, s>>>(loc, cum, n_entries, v, d, tile, rb,
                                                        vert_entry, pos, block_id);
  return cnc_last_error();
}

// A dense 3D level: perm [v] int32 (v = r^3); out pos_flat, vert_entry,
// values [v] and cum [v + 1].
CNC_EXPORT int cnc_dense_level(const int* perm, int v, int r, int* pos_flat, int* vert_entry,
                               int* values, int* cum, void* stream) {
  dense_level_kernel<<<cnc_blocks(v + 1, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      perm, v, r, pos_flat, vert_entry, values, cum);
  return cnc_last_error();
}
