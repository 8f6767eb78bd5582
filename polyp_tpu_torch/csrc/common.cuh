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

// cp.async of 4 bytes (cp-size 4 takes .ca only); zeros where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

// The fp32 twin of load_tile_async_vec8: a [rows x cols] fp32 tile, element
// (r, c) = src[r * ld_src + c], 0 where r >= row_limit or c >= col_limit.
// With vec4, 16 bytes a copy: `cols`, `ld_src`, `col_limit` and `ld_dst` are
// multiples of 4 and `src` is 16-byte aligned; without, 4 bytes a copy and
// any strides.
__device__ __forceinline__ void load_tile_async_f32(float* dst, int ld_dst, const float* src,
                                                    long long ld_src, int rows, int cols,
                                                    int row_limit, int col_limit, bool vec4) {
  if (vec4) {
    const int vecs_per_row = cols / 4;
    for (int i = threadIdx.x; i < rows * vecs_per_row; i += blockDim.x) {
      const int r = i / vecs_per_row;
      const int c = (i % vecs_per_row) * 4;
      const bool valid = r < row_limit && c < col_limit;
      cp_async16(dst + r * ld_dst + c, valid ? src + r * ld_src + c : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols;
      const int c = i % cols;
      const bool valid = r < row_limit && c < col_limit;
      cp_async4(dst + r * ld_dst + c, valid ? src + r * ld_src + c : src, valid);
    }
  }
}

// a · b over four consecutive elements, summed in order
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 3xTF32: products to about fp32's accuracy on the tensor cores. x = big +
// small, both tf32 (10 mantissa bits): big = x rounded to nearest, ties
// away from zero (cvt.rna's rounding for every finite x, done here on the
// bits by an integer add and mask: the conversion unit cvt runs on issues
// at a quarter of the integer and fp32 pipes' rate, which bounds a kernel
// that splits every operand it reads), small = the rounded remainder;
// big·big' + big·small' + small·big' carries a product to about fp32's
// precision, where one tf32 product keeps about 5e-4 of it.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32_bits(float x, uint32_t& big, uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

// c += a · b on the tensor cores, one m16n8k8 tile, tf32 in, fp32
// accumulators. Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8",
// .tf32), g = lane / 4, t = lane % 4:
//   A: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B: b0 = B[t][g], b1 = B[t+4][g]
//   C: c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a · b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3_tf32(float (&c)[4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                          const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

}  // namespace polyp
