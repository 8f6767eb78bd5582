// W8A8 dense for Hopper (sm_90a):
//   out[m, n] = bf16(acc[m, n] * (sx * sw[n]) + bias[n]),
//   acc = Σ_k q(x[m, k]) * wq[n, k]  (s8×s8→s32),
// where q(v) = clip(rint(v / sx), -127, 127), wq [O, C] int8 is the weight
// quantized per output channel with scales sw [O] (torch Linear layout), and
// sx is the activation scale, read from device memory (a calibrated static
// scale gathered at the current timestep, or a dynamic one the wrapper
// computed on the device). x is bf16 and quantized here, or int8 already
// quantized by its producer with sx (the GroupNorm int8 epilogue).
//
// Replaces the TPU kernel polyp_tpu/ops/fused_dense.py::fused_w8a8_dense
// (body _dense_q_kernel). Like it, the activation is quantized on its way
// into the tile and never stored as int8 in device memory, and the
// dequantize and bias run in the epilogue.
//
// What bounds it on the H100: bytes and launch latency. At SD widths and
// 256px (C, O ≤ 1280; M ≤ 4096 tokens) a call does under 1 GOP against
// about 5 MB of bf16 in and out: under a microsecond of the card's 1,979
// TOP/s int8, one or two of its 3.35 TB/s. Design: one block per 64 rows × 128 columns, eight warps of
// 32 × 32 outputs each on the integer tensor cores (mma.sync m16n8k32,
// s32 accumulators in registers); K runs in chunks of 64 through a two-
// stage pipeline: the int8 weight chunk by cp.async, the bf16 activation
// chunk through registers, quantized as it is stored to shared memory. Any
// M is masked (the cross-attention K/V at M = N·77 runs here too); C must
// be a multiple of 16 and O of 8. wgmma and TMA are later work.

#include "int8_mma.cuh"

using polyp::bf16;

namespace {

constexpr int kBM = 64;        // rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 64;        // K chunk
constexpr int kThreads = 256;  // 8 warps: 2 row halves × 4 column quarters
constexpr int LDK = kBK + 16;  // int8 stride of a shared tile row (≡ 16 mod 32)

template <bool kQuantX>
__global__ void __launch_bounds__(kThreads)
dense_q8_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ sw, const bf16* __restrict__ bias,
                const float* __restrict__ sx_ptr, bf16* __restrict__ out, int M, int C, int O) {
  __shared__ __align__(16) int8_t sA[2][kBM * LDK];
  __shared__ __align__(16) int8_t sB[2][kBN * LDK];
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4;  // 32-row half
  const int wn = warp % 4;  // 32-column quarter
  const float sx = *sx_ptr;
  const int n_k = (C + kBK - 1) / kBK;

  // bf16 activations: 64 rows × 8 vectors of 8 per chunk, two per thread,
  // loaded to registers one chunk ahead and quantized when stored
  uint4 ra[2];
  auto load_a_regs = [&](int kc) {
    for (int j = 0; j < 2; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = m0 + i / 8;
      const int c = kc * kBK + (i % 8) * 8;
      ra[j] = make_uint4(0u, 0u, 0u, 0u);
      if (r < M && c < C) {
        ra[j] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(x) +
                                                static_cast<long long>(r) * C + c);
      }
    }
  };
  auto store_a = [&](int buf) {
    for (int j = 0; j < 2; ++j) {
      const int i = threadIdx.x + j * kThreads;
      *reinterpret_cast<uint2*>(&sA[buf][(i / 8) * LDK + (i % 8) * 8]) =
          polyp::quant_bf16x8(ra[j], sx);
    }
  };
  auto issue = [&](int kc) {
    const int buf = kc & 1;
    const int k0 = kc * kBK;
    polyp::load_tile_async_s8(sB[buf], LDK, w + static_cast<long long>(n0) * C + k0, C, kBN, kBK,
                              O - n0, C - k0);
    if constexpr (!kQuantX) {
      polyp::load_tile_async_s8(sA[buf], LDK,
                                static_cast<const int8_t*>(x) + static_cast<long long>(m0) * C + k0,
                                C, kBM, kBK, M - m0, C - k0);
    }
  };

  int acc[2][4][4] = {};
  issue(0);
  polyp::cp_async_commit();
  if constexpr (kQuantX) {
    load_a_regs(0);
    store_a(0);
  }
  for (int kc = 0; kc < n_k; ++kc) {
    polyp::cp_async_wait<0>();
    __syncthreads();  // chunk kc is in shared memory; chunk kc - 1 is consumed
    const bool more = kc + 1 < n_k;
    if (more) {
      issue(kc + 1);
      polyp::cp_async_commit();
      if constexpr (kQuantX) load_a_regs(kc + 1);
    }
    const int buf = kc & 1;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) polyp::load_a_frag(a[mt], sA[buf], LDK, wm * 32 + mt * 16, kk);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) polyp::load_b_frag(b[nt], sB[buf], LDK, wn * 32 + nt * 8, kk);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) polyp::mma_s8_16832(acc[mt][nt], a[mt], b[nt]);
      }
    }
    if constexpr (kQuantX) {
      if (more) store_a((kc + 1) & 1);
    }
  }

  // epilogue: per-channel dequantize + bias, two adjacent columns a store
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = n0 + wn * 32 + nt * 8 + 2 * t;
    if (c >= O) continue;  // O is even, so c + 1 < O too
    const float s0 = sx * sw[c];
    const float s1 = sx * sw[c + 1];
    const float b0 = bias ? __bfloat162float(bias[c]) : 0.f;
    const float b1 = bias ? __bfloat162float(bias[c + 1]) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm * 32 + mt * 16 + g + half * 8;
        if (r >= M) continue;
        const int* v = acc[mt][nt] + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(r) * O + c) =
            __floats2bfloat162_rn(static_cast<float>(v[0]) * s0 + b0,
                                  static_cast<float>(v[1]) * s1 + b1);
      }
    }
  }
}

}  // namespace

extern "C" int polyp_w8a8_dense(const void* x, int x_is_int8, const void* w, const void* sw,
                                const void* bias, const void* sx, void* out, int m, int c, int o,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((m + kBM - 1) / kBM, (o + kBN - 1) / kBN);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* swp = static_cast<const float*>(sw);
  const bf16* bp = static_cast<const bf16*>(bias);
  const float* sxp = static_cast<const float*>(sx);
  bf16* op = static_cast<bf16*>(out);
  if (x_is_int8) {
    dense_q8_kernel<false><<<grid, kThreads, 0, s>>>(x, wq, swp, bp, sxp, op, m, c, o);
  } else {
    dense_q8_kernel<true><<<grid, kThreads, 0, s>>>(x, wq, swp, bp, sxp, op, m, c, o);
  }
  return cudaGetLastError();
}
