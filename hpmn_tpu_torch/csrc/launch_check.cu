// Error text for the cudaError_t codes the launch functions return, so the
// Python wrappers can raise with CUDA's own message.

#include <cuda_runtime.h>

extern "C" const char* hpmn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
