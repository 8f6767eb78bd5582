// Helpers shared by the port's kernels. Every kernel here launches on the
// stream its caller passes and returns cudaGetLastError() from a C entry
// point, which the Python wrapper checks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace polyp {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// cp.async (sm_80+): a 16-byte global -> shared copy that bypasses the
// registers and completes asynchronously; with valid == false it writes 16
// zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue cp.async copies of a [rows x cols] bf16 tile from global to shared
// memory, 16 bytes a thread; it lands after cp_async_wait and a barrier.
// Element (r, c) of the tile is src[r * ld_src + c]; it reads as 0 where
// r >= row_limit or c >= col_limit, which masks ragged edges. `cols`,
// `ld_src`, `col_limit` and `ld_dst` are multiples of 8 and `src` is 16-byte
// aligned (the wrappers check this), so every 8-element vector lies wholly
// inside or wholly outside the valid region.
__device__ __forceinline__ void load_tile_async_vec8(bf16* dst, int ld_dst, const bf16* src,
                                                     long long ld_src, int rows, int cols,
                                                     int row_limit, int col_limit) {
  const int vecs_per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * vecs_per_row; i += blockDim.x) {
    const int r = i / vecs_per_row;
    const int c = (i % vecs_per_row) * 8;
    const bool valid = r < row_limit && c < col_limit;
    cp_async16(dst + r * ld_dst + c, valid ? src + r * ld_src + c : src, valid);
  }
}

}  // namespace polyp
