// Readable CUDA error names for the Python wrappers, which receive the
// cudaError_t that each kernel entry point returns; and the device limit a
// wrapper checks a kernel's shared memory against.
#include <cuda_runtime.h>

extern "C" const char* polyp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most dynamic shared memory a block may take on `device` (the opt-in
// limit; 227 KB on the H100), or -1 if the runtime cannot say.
extern "C" long long polyp_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    return -1;
  }
  return bytes;
}
