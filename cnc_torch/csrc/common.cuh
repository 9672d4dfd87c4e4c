// Helpers shared by the port's kernels.  Every exported function has a plain
// C interface (pointers, ints, floats, the stream as void*) so the library is
// loaded with ctypes and never includes PyTorch's headers.  Each returns the
// cudaError_t of its launches as an int (0 = success); the Python wrapper
// raises on anything else.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define CNC_EXPORT extern "C" __attribute__((visibility("default")))

static inline int cnc_last_error() { return static_cast<int>(cudaGetLastError()); }

static inline unsigned cnc_blocks(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

// The bits of 16 mask bytes, bit j set where byte j is not 0 (K3 and the mask
// packing).  Per 32-bit word: __vcmpne4 leaves 0xff or 0 in each byte, one bit
// of each is kept, and the multiply by 0x10204080 moves byte k's bit to bit
// 28 + k with no carry into bits 28-31 (every other partial product lands on
// its own bit below 28 or above 31).  tests/compact_pack_cases.py holds this
// to numpy's packbits over every pattern.
static __device__ __forceinline__ unsigned cnc_byte_bits4(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

static __device__ __forceinline__ unsigned cnc_byte_bits16(uint4 v) {
  return cnc_byte_bits4(v.x) | cnc_byte_bits4(v.y) << 4 | cnc_byte_bits4(v.z) << 8 |
         cnc_byte_bits4(v.w) << 12;
}

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 by a multiply and a shift
// (PyTorch's IntDivider): shift = ceil(log2 d), m = 2^32 (2^shift - d) / d + 1
struct FastDiv {
  unsigned m;
  int shift;
};

static inline FastDiv make_fastdiv(unsigned d) {
  int s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {static_cast<unsigned>(m), s};
}

static __device__ __forceinline__ int fastdiv(int n, FastDiv f) {
  const unsigned u = static_cast<unsigned>(n);
  return static_cast<int>((__umulhi(u, f.m) + u) >> f.shift);
}
