// Error text for the codes the other sources return.
#include "common.cuh"

CNC_EXPORT const char* cnc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
