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
