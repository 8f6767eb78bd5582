// Flash-attention forward for Hopper (sm_90a): non-causal
// softmax(Q K^T / sqrt(d)) V over [N, T, H, D] (BTHD) bf16 tensors.
//
// Replaces the TPU kernel polyp_tpu/ops/flash_attention.py::flash_attention
// (body _flash_kernel, pallas_call in _flash_impl). Like it, the T x T score
// matrix never reaches device memory: K/V tiles stream through shared memory
// and an fp32 online softmax (running max, running sum, accumulator) folds
// each tile into the output.
//
// What bounds it on the H100: at the SD level-0 shape (N=4, T=1024, H=8,
// D=40) the work is 4*N*H*T*T*D = 5.4 GFLOP against 3 MB of Q/K/V, so the
// kernel is compute-bound; the score tile is recomputed per query block
// rather than stored. Design: one block of 4 warps per (n*h, 64 query rows);
// each warp owns 16 query rows end to end, so the softmax needs no block
// barrier. Q K^T and P V run on the tensor cores through WMMA bf16 fragments
// (16x16x16, fp32 accumulate). The head dimension is a template parameter
// (40, 64, 80, 128, 160); shared tiles are padded to the next multiple of 16
// with zeros that the loads mask in, so no padded copy of Q/K/V is made and
// the scale uses the true d. Ragged T (not a multiple of 64) is masked.
// Simple first: tiles are loaded with 16-byte vector loads (no cp.async/TMA
// pipeline) and the accumulator lives in shared memory, rescaled per tile.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using polyp::bf16;

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = kBlockQ / 16;

template <int D>
struct FlashShape {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded for WMMA
  static constexpr int LDH = DP + 8;             // bf16 row stride: Q, K, V
  static constexpr int LDS = kBlockK + 4;        // fp32 row stride: scores
  static constexpr int LDP = kBlockK + 8;        // bf16 row stride: probs
  static constexpr int LDO = DP + 4;             // fp32 row stride: output
  static constexpr size_t kSmem =
      sizeof(bf16) * ((kBlockQ + 2 * kBlockK) * LDH + kBlockQ * LDP) +
      sizeof(float) * (kBlockQ * LDS + kBlockQ * LDO + 2 * kBlockQ);
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Tq,
                 int Tk, float scale) {
  using S = FlashShape<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBlockQ * S::LDH;
  bf16* sV = sK + kBlockK * S::LDH;
  bf16* sP = sV + kBlockK * S::LDH;
  float* sS = reinterpret_cast<float*>(sP + kBlockQ * S::LDP);
  float* sO = sS + kBlockQ * S::LDS;
  float* sM = sO + kBlockQ * S::LDO;
  float* sL = sM + kBlockQ;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int n = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * kBlockQ;
  const long long row = static_cast<long long>(H) * D;  // token stride
  const bf16* qb = q + (static_cast<long long>(n) * Tq) * row + h * D;
  const bf16* kb = k + (static_cast<long long>(n) * Tk) * row + h * D;
  const bf16* vb = v + (static_cast<long long>(n) * Tk) * row + h * D;
  bf16* ob = o + (static_cast<long long>(n) * Tq) * row + h * D;

  polyp::load_tile_vec8(sQ, S::LDH, qb + q0 * row, row, kBlockQ, S::DP, Tq - q0, D);
  for (int i = threadIdx.x; i < kBlockQ * S::LDO; i += blockDim.x) sO[i] = 0.f;
  for (int i = threadIdx.x; i < kBlockQ; i += blockDim.x) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  const int r0 = warp * 16;  // this warp's query rows
  for (int k0 = 0; k0 < Tk; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    polyp::load_tile_vec8(sK, S::LDH, kb + k0 * row, row, kBlockK, S::DP, Tk - k0, D);
    polyp::load_tile_vec8(sV, S::LDH, vb + k0 * row, row, kBlockK, S::DP, Tk - k0, D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (K tile in shared memory is K^T
    // stored column-major).
    for (int j = 0; j < kBlockK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < S::DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQ + r0 * S::LDH + kk * 16, S::LDH);
        wmma::load_matrix_sync(b, sK + (j * 16) * S::LDH + kk * 16, S::LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + r0 * S::LDS + j * 16, acc, S::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time; each lane takes two key columns.
    const int kvalid = min(kBlockK, Tk - k0);
    for (int r = r0; r < r0 + 16; ++r) {
      const float s0 = lane < kvalid ? sS[r * S::LDS + lane] * scale : -INFINITY;
      const float s1 = lane + 32 < kvalid ? sS[r * S::LDS + lane + 32] * scale : -INFINITY;
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, polyp::warp_max(fmaxf(s0, s1)));
      const float p0 = __expf(s0 - m_new);
      const float p1 = __expf(s1 - m_new);
      const float alpha = __expf(m_old - m_new);
      const float psum = polyp::warp_sum(p0 + p1);
      sP[r * S::LDP + lane] = __float2bfloat16(p0);
      sP[r * S::LDP + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < S::DP; c += 32) sO[r * S::LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + psum;
      }
    }
    __syncwarp();

    // O += P V for this warp's rows; the accumulator round-trips through
    // shared memory so the per-row rescale above can reach it.
    for (int j = 0; j < S::DP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + r0 * S::LDO + j * 16, S::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + r0 * S::LDP + kk * 16, S::LDP);
        wmma::load_matrix_sync(b, sV + (kk * 16) * S::LDH + j * 16, S::LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sO + r0 * S::LDO + j * 16, acc, S::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int r = r0; r < r0 + 16; ++r) {
    const int t = q0 + r;
    if (t >= Tq) break;
    const float inv = 1.f / sL[r];
    for (int c = lane; c < D; c += 32) {
      ob[t * row + c] = __float2bfloat16(sO[r * S::LDO + c] * inv);
    }
  }
}

template <int D>
cudaError_t launch_flash(const bf16* q, const bf16* k, const bf16* v, bf16* o, int N, int H,
                         int Tq, int Tk, float scale, cudaStream_t stream) {
  const size_t smem = FlashShape<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(N * H, (Tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D><<<grid, kWarps * 32, smem, stream>>>(q, k, v, o, H, Tq, Tk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int polyp_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int n, int h, int tq, int tk, int d, float scale,
                                         void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return launch_flash<40>(qp, kp, vp, op, n, h, tq, tk, scale, s);
    case 64: return launch_flash<64>(qp, kp, vp, op, n, h, tq, tk, scale, s);
    case 80: return launch_flash<80>(qp, kp, vp, op, n, h, tq, tk, scale, s);
    case 128: return launch_flash<128>(qp, kp, vp, op, n, h, tq, tk, scale, s);
    case 160: return launch_flash<160>(qp, kp, vp, op, n, h, tq, tk, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
