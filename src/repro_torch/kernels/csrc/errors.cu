// Error text for the status codes the launch functions return.

#include <cuda_runtime.h>

extern "C" const char* kernels_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
