// K3: stream compaction of a boolean mask.
//
// Replaces: cnc_tpu/ops/scatter_ops.py compact_mask_indices (146-161), a
// cumsum plus a unique-index scatter in XLA.
// Plain twin: cnc_torch/ops/scatter_ops.py `_compact_plain`.
//
// Computes the positions of the first `cap` set bytes of mask[n] in ascending
// order into src[cap] (zero past the count) and the total count (NOT clamped
// to cap) into count[0], all on the device: no host sync.
//
// Bound on the H100: bytes.  It reads the mask twice (n bytes each pass) and
// writes cap*4 bytes; at the main path's n = 1,048,576 that is about 2.3 MB,
// well under a microsecond of HBM time, so launch latency (three launches)
// dominates.
//
// Simple design, three launches: (1) each block counts its tile of kTile
// elements (a warp reduction per warp, then the block's warps); (2) one block
// scans the per-block counts into exclusive offsets and writes the total; (3)
// each block recounts its tile, scans it within the block (warp shuffles),
// writes each set element's position, and zero-fills src[total:cap].
// Each thread owns kItems consecutive elements so the output stays ordered.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int thread_count(const unsigned char* __restrict__ mask, long long n,
                                            long long base) {
  int c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    c += (i < n && mask[i]) ? 1 : 0;
  }
  return c;
}

__global__ void count_kernel(const unsigned char* __restrict__ mask, long long n,
                             int* __restrict__ block_sums) {
  __shared__ int warp_sums[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kTile +
                         static_cast<long long>(threadIdx.x) * kItems;
  int c = thread_count(mask, n, base);
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    block_sums[blockIdx.x] = s;
  }
}

// Inclusive scan of one value per thread across the block; returns the
// inclusive prefix, and the block total in *total (shared).
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int x = warp_sums[w];
      warp_sums[w] = s;  // exclusive warp offsets
      s += x;
    }
    *total = s;
  }
  __syncthreads();
  return v + warp_sums[warp];
}

__global__ void scan_kernel(int* __restrict__ block_sums, int n_blocks, int* __restrict__ count) {
  __shared__ int warp_sums[kWarps];
  __shared__ int total;
  int carry = 0;
  for (int start = 0; start < n_blocks; start += kThreads) {
    const int i = start + threadIdx.x;
    const int v = i < n_blocks ? block_sums[i] : 0;
    const int incl = block_inclusive_scan(v, warp_sums, &total);
    if (i < n_blocks) block_sums[i] = carry + incl - v;
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = carry;
}

__global__ void fill_kernel(const unsigned char* __restrict__ mask, long long n,
                            const int* __restrict__ block_offsets,
                            const int* __restrict__ count, int cap, int* __restrict__ src) {
  __shared__ int warp_sums[kWarps];
  __shared__ int total;
  const long long base = static_cast<long long>(blockIdx.x) * kTile +
                         static_cast<long long>(threadIdx.x) * kItems;
  const int c = thread_count(mask, n, base);
  const int incl = block_inclusive_scan(c, warp_sums, &total);
  int pos = block_offsets[blockIdx.x] + incl - c;
  for (int k = 0; k < kItems && pos < cap; ++k) {
    const long long i = base + k;
    if (i < n && mask[i]) src[pos++] = static_cast<int>(i);
  }
  // zero-fill the slots past the count (disjoint from the writes above)
  const int filled = min(*count, cap);
  for (long long j = filled + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       j < cap; j += static_cast<long long>(gridDim.x) * kThreads)
    src[j] = 0;
}

}  // namespace

// mask [n] uint8 (bool), src [cap] int32, count [1] int32, block_sums
// [cnc_compact_scratch(n)] int32 scratch; all on the device.
CNC_EXPORT int cnc_compact_scratch(long long n) { return static_cast<int>(cnc_blocks(n, kTile)); }

CNC_EXPORT int cnc_compact_mask(const unsigned char* mask, long long n, int cap, int* src,
                                int* count, int* block_sums, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = cnc_blocks(n, kTile);
  count_kernel<<<blocks, kThreads, 0, s>>>(mask, n, block_sums);
  int rc = cnc_last_error();
  if (rc) return rc;
  scan_kernel<<<1, kThreads, 0, s>>>(block_sums, static_cast<int>(blocks), count);
  rc = cnc_last_error();
  if (rc) return rc;
  fill_kernel<<<blocks, kThreads, 0, s>>>(mask, n, block_sums, count, cap, src);
  return cnc_last_error();
}
