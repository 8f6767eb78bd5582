// GroupNorm(+SiLU) for Hopper (sm_90a) over NCHW-contiguous tensors.
//
// Replaces the TPU kernel polyp_tpu/ops/fused_gn.py::fused_group_norm (body
// _gn_kernel, pallas_call in fused_group_norm), int8 epilogue included. It
// computes what polyp_tpu/ops/groupnorm.py defines: fp32 sums of x and x^2
// per (sample, group), var = E[x^2] - E[x]^2 clamped at 0, then per-channel
// scale and offset, then SiLU if asked; the output has the input's type
// (fp32 or bf16), or, given an activation scale s (w8a8_static's
// producer-side handoff to the consuming int8 conv), is the int8 code
// clip(rint(y / s), -127, 127) of the fp32 y, in the same NCHW layout. s is
// read from device memory (a per-timestep gather), so no host sync.
//
// What bounds it on the H100: bytes. It does about 10 FLOP per element and
// moves 2 (bf16) or 4 (fp32) bytes in and out, far below the ~295 FLOP per
// byte where compute would limit. Design: in NCHW one group of one sample is
// one contiguous run of (C/G)*H*W elements, so one block per (n, group)
// reads it once for the statistics and once more to normalise; the second
// read of a run of at most a few MB usually hits the 50 MB L2. No per-sample
// size cap, unlike the TPU kernel (MAX_SAMPLE_ELEMENTS): the VAE decoder's
// [2, 128, 256, 256] runs here too. Blocks are few at small batch (N*32),
// which limits it on the large VAE tensors; a split reduction is later work.

#include "int8_mma.cuh"

using polyp::bf16;

namespace {

constexpr int kThreads = 512;

template <typename T, bool kQ8>
__global__ void __launch_bounds__(kThreads)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, void* __restrict__ y, int C, int HW, int G,
                  float eps, int silu, const float* __restrict__ act_scale) {
  __shared__ float red[2][kThreads / 32];
  __shared__ float stats[2];
  const int n = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int cg = C / G;
  const long long cnt = static_cast<long long>(cg) * HW;
  const long long base = (static_cast<long long>(n) * C + static_cast<long long>(g) * cg) * HW;
  const T* xg = x + base;

  float s1 = 0.f, s2 = 0.f;
  for (long long i = threadIdx.x; i < cnt; i += kThreads) {
    const float v = polyp::to_float(xg[i]);
    s1 += v;
    s2 += v * v;
  }
  s1 = polyp::warp_sum(s1);
  s2 = polyp::warp_sum(s2);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < kThreads / 32 ? red[0][lane] : 0.f;
    s2 = lane < kThreads / 32 ? red[1][lane] : 0.f;
    s1 = polyp::warp_sum(s1);
    s2 = polyp::warp_sum(s2);
    if (lane == 0) {
      const float mean = s1 / static_cast<float>(cnt);
      const float var = fmaxf(s2 / static_cast<float>(cnt) - mean * mean, 0.f);
      stats[0] = mean;
      stats[1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mean = stats[0];
  const float rstd = stats[1];
  const float q_scale = kQ8 ? *act_scale : 0.f;

  for (long long i = threadIdx.x; i < cnt; i += kThreads) {
    const int c = g * cg + static_cast<int>(i / HW);
    const float mul = rstd * gamma[c];
    const float add = beta[c] - mean * mul;
    float v = polyp::to_float(xg[i]) * mul + add;
    if (silu) v = v / (1.f + __expf(-v));
    if constexpr (kQ8) {
      static_cast<int8_t*>(y)[base + i] = static_cast<int8_t>(polyp::quant_s8(v, q_scale));
    } else {
      static_cast<T*>(y)[base + i] = polyp::from_float<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch_gn(const void* x, const float* gamma, const float* beta, void* y, int N, int C,
                      int HW, int G, float eps, int silu, const float* act_scale,
                      cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  if (act_scale) {
    group_norm_kernel<T, true><<<N * G, kThreads, 0, stream>>>(xp, gamma, beta, y, C, HW, G, eps,
                                                               silu, act_scale);
  } else {
    group_norm_kernel<T, false><<<N * G, kThreads, 0, stream>>>(xp, gamma, beta, y, C, HW, G,
                                                                eps, silu, nullptr);
  }
  return cudaGetLastError();
}

}  // namespace

// act_scale: nullptr for an output in x's type, else the int8 epilogue's
// device-resident fp32 scale.
extern "C" int polyp_group_norm(const void* x, const void* gamma, const void* beta, void* y,
                                int n, int c, int hw, int groups, float eps, int silu,
                                int is_bf16, const void* act_scale, void* stream) {
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  const float* sp = static_cast<const float*>(act_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_gn<bf16>(x, gp, bp, y, n, c, hw, groups, eps, silu, sp, s);
  return launch_gn<float>(x, gp, bp, y, n, c, hw, groups, eps, silu, sp, s);
}
