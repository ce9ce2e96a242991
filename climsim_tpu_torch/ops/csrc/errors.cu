// Error text for the codes the kernel entries return.
#include "common.cuh"

extern "C" const char* cst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
