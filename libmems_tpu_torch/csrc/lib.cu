// Error reporting for the C interface of the kernel library.
#include "common.cuh"

extern "C" const char* lm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
