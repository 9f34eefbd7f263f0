// Error text for the codes the port's C entry points return.
#include <cuda_runtime.h>

extern "C" const char* quan_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
