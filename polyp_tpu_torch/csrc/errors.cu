// Readable CUDA error names for the Python wrappers, which receive the
// cudaError_t that each kernel entry point returns.
#include <cuda_runtime.h>

extern "C" const char* polyp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
