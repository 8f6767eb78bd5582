// Fused multi-head attention block for Hopper (sm_90a):
//   out = softmax((x Wq^T)(ctx Wk^T)^T / sqrt(d)) (ctx Wv^T) Wo^T
// over bf16 x [B, Tq, C], ctx [B, Tk, Ckv], with torch Linear weights
// Wq [H*D, C], Wk and Wv [H*D, Ckv], Wo [Co, H*D]; out [B, Tq, Co] bf16,
// fp32 accumulation throughout. The caller adds the out-projection bias.
//
// Replaces the TPU kernel polyp_tpu/ops/fused_mha.py::fused_mha (body
// _mha_kernel, pallas_call in _fused_mha_impl). Like it, the projections, an
// fp32 online softmax with ragged keys masked to -inf before the max, and
// the output projection summed over heads run in this file; neither the
// T x T scores nor a per-head output reaches device memory, and the softmax
// scale is folded into Q before Q's bf16 rounding.
//
// What bounds it on the H100: at the distilled batch ([16, 1024, 320],
// H = 8, d = 40) the work is 13.4 GFLOP of projections and 21.5 GFLOP of
// attention (about 35 us at 989 TFLOP/s) against about 21 MB of x and out,
// so it is compute-bound. Its design, and what it does about that:
//
// * K and V are projected once per (b, head) by a first launch into a bf16
//   workspace [B, Tk, H*D] that the wrapper allocates (21 MB at the
//   distilled batch). The TPU kernel recomputed them for every q-block,
//   which cost nothing there (one 1024-row q-block at T = 1024); with this
//   kernel's 64-row q tiles the recompute would cost C/64 times the
//   attention's own FLOPs (5x at C = 320), so K/V round trips through
//   device memory (read from L2 by every q tile) replace it.
// * The sum over heads. The TPU ran its grid over heads in order and
//   accumulated the output projection in VMEM; blocks on the card run in no
//   order. Here one block owns (b, 64 query rows) and loops over the heads:
//   each head's normalised output is rounded to bf16 (as the TPU kernel
//   rounds o_h before its dot) into a [64, H*D] shared tile, and after the
//   last head one product with Wo^T over the whole H*D reduction writes the
//   output. That is the same fp32 sum over heads in a fixed order, with no
//   atomics and no fp32 [64, Co] accumulator (160 KB at Co = 640), and the
//   per-head fp32 partials of a split route (168 MB of traffic at the
//   distilled batch) never exist. Runs repeat bit for bit.
// * Head dims 40 and 80 are no multiple of the mma k-step: as in
//   flash_attention.cu the head dim is a template parameter (40, 64, 80)
//   and shared tiles are padded to the next multiple of 16 with zeros that
//   the masked loads put there; the weights are read in place (Wq, Wk, Wv
//   rows of a head are contiguous; Wo is read in [64 x 64] tiles over its
//   H*D columns), so no padded or transposed weight copy is made.
// * Products run on the tensor cores through WMMA bf16 fragments (16x16x16,
//   fp32 accumulate); operand chunks of the projections stream through a
//   two-stage cp.async pipeline. Simple first: four warps a block, the
//   softmax state in shared memory as in flash_attention.cu, no TMA/wgmma.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using polyp::bf16;

namespace {

constexpr int kRows = 64;      // query rows per block; KV rows per tile
constexpr int kThreads = 128;  // four warps, 16 query rows each
constexpr int kChunk = 64;     // reduction chunk of the projections
constexpr int LDC = kChunk + 8;
constexpr int LDF = 64 + 4;    // fp32 stride of a 64-column scratch tile
constexpr int LDP = 64 + 8;    // bf16 stride of the probabilities

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int D>
struct MhaShape {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded for WMMA
  static constexpr int LDH = DP + 8;             // bf16 stride: Q, K, V tiles
  static constexpr int LDO = DP + 4;             // fp32 stride: accumulator
  // Region U holds, one phase at a time: the Q-projection stages (x chunk
  // + Wq chunk, twice), the flash tiles (K, V, scores, probabilities), or
  // the out-projection stages (Wo tile, twice) and the fp32 out tile.
  static constexpr size_t kStageQ = sizeof(bf16) * (kRows + DP) * LDC;
  static constexpr size_t kFlash = align128(sizeof(bf16) * 2 * kRows * LDH) +
                                   align128(sizeof(float) * kRows * LDF) +
                                   align128(sizeof(bf16) * kRows * LDP);
  static constexpr size_t kStageO = sizeof(bf16) * 64 * LDC;
  static constexpr size_t kOutTile = sizeof(float) * kRows * LDF;
  static constexpr size_t kU0 = 2 * align128(kStageQ);
  static constexpr size_t kU1 = 2 * align128(kStageO) + align128(kOutTile);
  static constexpr size_t kU = align128(kU0 > kFlash ? (kU0 > kU1 ? kU0 : kU1)
                                                     : (kFlash > kU1 ? kFlash : kU1));
  static constexpr size_t kFixed = align128(sizeof(bf16) * kRows * LDH) +   // sQ
                                   align128(sizeof(float) * kRows * LDO) +  // sO
                                   align128(sizeof(float) * 2 * kRows);     // sM, sL
  // the [64, H*D] bf16 tile of every head's output, padded to whole chunks
  __host__ __device__ static int lda(int hd) { return (hd + kChunk - 1) / kChunk * kChunk + 8; }
  static size_t smem(int hd) { return kU + kFixed + align128(sizeof(bf16) * kRows * lda(hd)); }
};

// out[M, N] = a[M, K] @ w[N, K]^T for w = wk (blockIdx.z == 0) or wv (1),
// bf16 out with fp32 accumulation: the K and V projections, [B*Tk, H*D].
__global__ void __launch_bounds__(kThreads)
kv_project_kernel(const bf16* __restrict__ a, const bf16* __restrict__ wk,
                  const bf16* __restrict__ wv, bf16* __restrict__ k_out,
                  bf16* __restrict__ v_out, int M, int N, int K) {
  constexpr size_t kStage = align128(sizeof(bf16) * 2 * 64 * LDC);
  extern __shared__ __align__(128) unsigned char smem[];
  float* sC = reinterpret_cast<float*>(smem + 2 * kStage);
  const bf16* w = blockIdx.z == 0 ? wk : wv;
  bf16* out = blockIdx.z == 0 ? k_out : v_out;
  const int m0 = blockIdx.x * 64;
  const int n0 = blockIdx.y * 64;
  const int warp = threadIdx.x / 32;

  auto stage = [&](int s) { return reinterpret_cast<bf16*>(smem + (s & 1) * kStage); };
  auto issue = [&](int step) {
    const int k0 = step * kChunk;
    bf16* sA = stage(step);
    bf16* sW = sA + 64 * LDC;
    polyp::load_tile_async_vec8(sA, LDC, a + static_cast<long long>(m0) * K + k0, K, 64, kChunk,
                                M - m0, K - k0);
    polyp::load_tile_async_vec8(sW, LDC, w + static_cast<long long>(n0) * K + k0, K, 64, kChunk,
                                N - n0, K - k0);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
  #pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  const int n_steps = (K + kChunk - 1) / kChunk;
  issue(0);
  polyp::cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      issue(step + 1);
      polyp::cp_async_commit();
      polyp::cp_async_wait<1>();
    } else {
      polyp::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sA = stage(step);
    const bf16* sW = sA + 64 * LDC;
    #pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sA + (warp * 16) * LDC + kk * 16, LDC);
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, sW + (j * 16) * LDC + kk * 16, LDC);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();  // this stage may be refilled
  }
  #pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(sC + (warp * 16) * LDF + j * 16, acc[j], LDF, wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = threadIdx.x % 32; i < 16 * 64; i += 32) {
    const int r = warp * 16 + i / 64;
    const int c = i % 64;
    if (m0 + r < M && n0 + c < N) {
      out[static_cast<long long>(m0 + r) * N + n0 + c] = __float2bfloat16(sC[r * LDF + c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fused_mha_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                 const bf16* __restrict__ kws, const bf16* __restrict__ vws,
                 const bf16* __restrict__ wo, bf16* __restrict__ out, int H, int Tq, int Tk,
                 int C, int Co, float scale) {
  using S = MhaShape<D>;
  constexpr int DP = S::DP;
  const int HD = H * D;
  const int LDA = S::lda(HD);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* U = smem;
  bf16* sQ = reinterpret_cast<bf16*>(smem + S::kU);
  float* sO = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sQ) +
                                       align128(sizeof(bf16) * kRows * S::LDH));
  float* sM = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sO) +
                                       align128(sizeof(float) * kRows * S::LDO));
  float* sL = sM + kRows;
  bf16* sA = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sM) +
                                     align128(sizeof(float) * 2 * kRows));
  // flash tiles inside U
  bf16* sK = reinterpret_cast<bf16*>(U);
  bf16* sV = sK + kRows * S::LDH;
  float* sS = reinterpret_cast<float*>(U + align128(sizeof(bf16) * 2 * kRows * S::LDH));
  bf16* sP = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sS) +
                                     align128(sizeof(float) * kRows * LDF));

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's query rows
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const bf16* xb = x + (static_cast<long long>(b) * Tq + q0) * C;
  const bf16* kb = kws + static_cast<long long>(b) * Tk * HD;
  const bf16* vb = vws + static_cast<long long>(b) * Tk * HD;

  // every head's output lands in sA; its padding columns stay zero
  for (int i = threadIdx.x; i < kRows * LDA; i += kThreads) sA[i] = __float2bfloat16(0.f);

  const int n_c = (C + kChunk - 1) / kChunk;
  for (int h = 0; h < H; ++h) {
    // ---- Q_h = x_tile @ Wq[h*D .. h*D+D)^T, C streamed in chunks through
    // two cp.async stages of U; rows of Wq past D load as zeros.
    auto stage_q = [&](int s) {
      return reinterpret_cast<bf16*>(U + (s & 1) * align128(S::kStageQ));
    };
    auto issue_q = [&](int step) {
      const int c0 = step * kChunk;
      bf16* sX = stage_q(step);
      bf16* sW = sX + kRows * LDC;
      polyp::load_tile_async_vec8(sX, LDC, xb + c0, C, kRows, kChunk, Tq - q0, C - c0);
      polyp::load_tile_async_vec8(sW, LDC, wq + static_cast<long long>(h) * D * C + c0, C, DP,
                                  kChunk, D, C - c0);
    };
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> qacc[DP / 16];
    #pragma unroll
    for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(qacc[j], 0.f);
    __syncthreads();  // U is free: the previous head's flash tiles are done
    issue_q(0);
    polyp::cp_async_commit();
    for (int step = 0; step < n_c; ++step) {
      if (step + 1 < n_c) {
        issue_q(step + 1);
        polyp::cp_async_commit();
        polyp::cp_async_wait<1>();
      } else {
        polyp::cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sX = stage_q(step);
      const bf16* sW = sX + kRows * LDC;
      #pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sX + r0 * LDC + kk * 16, LDC);
        #pragma unroll
        for (int j = 0; j < DP / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, sW + (j * 16) * LDC + kk * 16, LDC);
          wmma::mma_sync(qacc[j], fa, fb, qacc[j]);
        }
      }
      __syncthreads();  // this stage may be refilled
    }
    // scale folded in before the bf16 rounding, as the TPU kernel does; sO
    // is this warp's scratch for it before it becomes the accumulator
    #pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      wmma::store_matrix_sync(sO + r0 * S::LDO + j * 16, qacc[j], S::LDO, wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = r0 + i / DP;
      const int c = i % DP;
      sQ[r * S::LDH + c] = __float2bfloat16(sO[r * S::LDO + c] * scale);
      sO[r * S::LDO + c] = 0.f;
    }
    for (int r = r0 + lane; r < r0 + 16; r += 32) {
      sM[r] = -INFINITY;
      sL[r] = 0.f;
    }
    __syncwarp();

    // ---- online softmax over 64-key tiles of this head's K and V
    for (int k0 = 0; k0 < Tk; k0 += kRows) {
      __syncthreads();  // every warp is done with the previous K/V tile
      polyp::load_tile_vec8(sK, S::LDH, kb + static_cast<long long>(k0) * HD + h * D, HD, kRows,
                            DP, Tk - k0, D);
      polyp::load_tile_vec8(sV, S::LDH, vb + static_cast<long long>(k0) * HD + h * D, HD, kRows,
                            DP, Tk - k0, D);
      __syncthreads();

      #pragma unroll
      for (int j = 0; j < kRows / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        #pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, sQ + r0 * S::LDH + kk * 16, S::LDH);
          wmma::load_matrix_sync(fb, sK + (j * 16) * S::LDH + kk * 16, S::LDH);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(sS + r0 * LDF + j * 16, acc, LDF, wmma::mem_row_major);
      }
      __syncwarp();

      // masked key columns (past Tk) are -inf before the max
      const int kvalid = min(kRows, Tk - k0);
      for (int r = r0; r < r0 + 16; ++r) {
        const float s0 = lane < kvalid ? sS[r * LDF + lane] : -INFINITY;
        const float s1 = lane + 32 < kvalid ? sS[r * LDF + lane + 32] : -INFINITY;
        const float m_old = sM[r];
        const float m_new = fmaxf(m_old, polyp::warp_max(fmaxf(s0, s1)));
        const float p0 = __expf(s0 - m_new);
        const float p1 = __expf(s1 - m_new);
        const float alpha = __expf(m_old - m_new);
        const float psum = polyp::warp_sum(p0 + p1);
        sP[r * LDP + lane] = __float2bfloat16(p0);
        sP[r * LDP + lane + 32] = __float2bfloat16(p1);
        for (int c = lane; c < DP; c += 32) sO[r * S::LDO + c] *= alpha;
        __syncwarp();
        if (lane == 0) {
          sM[r] = m_new;
          sL[r] = sL[r] * alpha + psum;
        }
      }
      __syncwarp();

      #pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, sO + r0 * S::LDO + j * 16, S::LDO, wmma::mem_row_major);
        #pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, sP + r0 * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(fb, sV + (kk * 16) * S::LDH + j * 16, S::LDH);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(sO + r0 * S::LDO + j * 16, acc, S::LDO, wmma::mem_row_major);
      }
      __syncwarp();
    }

    // ---- this head's output, normalised and rounded to bf16, into its
    // columns of sA (each warp writes only its own rows)
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = r0 + i / D;
      const int c = i % D;
      sA[r * LDA + h * D + c] = __float2bfloat16(sO[r * S::LDO + c] / sL[r]);
    }
  }

  // ---- out[64, Co] = sA[64, H*D] @ Wo^T: one column tile of 64 outputs at
  // a time, Wo's [64 x 64] tiles through two cp.async stages of U
  __syncthreads();  // every head's columns of sA are written; U is free
  float* sC = reinterpret_cast<float*>(U + 2 * align128(S::kStageO));
  const int n_k = LDA / kChunk;  // chunks over the padded H*D
  const int n_n = (Co + 63) / 64;
  const int n_steps = n_n * n_k;
  auto stage_o = [&](int s) { return reinterpret_cast<bf16*>(U + (s & 1) * align128(S::kStageO)); };
  auto issue_o = [&](int step) {
    const int n0 = (step / n_k) * 64;
    const int k0 = (step % n_k) * kChunk;
    polyp::load_tile_async_vec8(stage_o(step), LDC, wo + static_cast<long long>(n0) * HD + k0, HD,
                                64, kChunk, Co - n0, HD - k0);
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[4];
  issue_o(0);
  polyp::cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int n0 = (step / n_k) * 64;
    const int ki = step % n_k;
    if (ki == 0) {
      #pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(oacc[j], 0.f);
    }
    if (step + 1 < n_steps) {
      issue_o(step + 1);
      polyp::cp_async_commit();
      polyp::cp_async_wait<1>();
    } else {
      polyp::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sW = stage_o(step);
    #pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sA + r0 * LDA + ki * kChunk + kk * 16, LDA);
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, sW + (j * 16) * LDC + kk * 16, LDC);
        wmma::mma_sync(oacc[j], fa, fb, oacc[j]);
      }
    }
    if (ki == n_k - 1) {
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(sC + r0 * LDF + j * 16, oacc[j], LDF, wmma::mem_row_major);
      }
      __syncwarp();
      for (int i = lane; i < 16 * 64; i += 32) {
        const int r = r0 + i / 64;
        const int c = i % 64;
        if (q0 + r < Tq && n0 + c < Co) {
          out[(static_cast<long long>(b) * Tq + q0 + r) * Co + n0 + c] =
              __float2bfloat16(sC[r * LDF + c]);
        }
      }
      __syncwarp();
    }
    __syncthreads();  // this stage may be refilled
  }
}

template <int D>
cudaError_t launch_mha(const bf16* x, const bf16* wq, const bf16* kws, const bf16* vws,
                       const bf16* wo, bf16* out, int B, int H, int Tq, int Tk, int C, int Co,
                       float scale, cudaStream_t stream) {
  const size_t smem = MhaShape<D>::smem(H * D);
  cudaError_t err = cudaFuncSetAttribute(fused_mha_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kRows - 1) / kRows, B);
  fused_mha_kernel<D><<<grid, kThreads, smem, stream>>>(x, wq, kws, vws, wo, out, H, Tq, Tk, C,
                                                        Co, scale);
  return cudaGetLastError();
}

}  // namespace

// ctx [B*Tk, Ckv] -> K and V workspaces [B*Tk, H*D]; then the block kernel.
// Sizes: C, Ckv and H*D multiples of 8, d in {40, 64, 80}; the wrapper
// checks them.
extern "C" int polyp_fused_mha(const void* x, const void* ctx, const void* wq, const void* wk,
                               const void* wv, const void* wo, void* k_ws, void* v_ws, void* out,
                               int b, int tq, int tk, int c, int ckv, int h, int d, int co,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = h * d;
  const int m = b * tk;
  const size_t kv_smem = 2 * align128(sizeof(bf16) * 2 * 64 * LDC) + sizeof(float) * 64 * LDF;
  cudaError_t err = cudaFuncSetAttribute(kv_project_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kv_smem));
  if (err != cudaSuccess) return err;
  dim3 kv_grid((m + 63) / 64, (hd + 63) / 64, 2);
  kv_project_kernel<<<kv_grid, kThreads, kv_smem, s>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<bf16*>(k_ws), static_cast<bf16*>(v_ws), m, hd, ckv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wqp = static_cast<const bf16*>(wq);
  const bf16* kp = static_cast<const bf16*>(k_ws);
  const bf16* vp = static_cast<const bf16*>(v_ws);
  const bf16* wop = static_cast<const bf16*>(wo);
  bf16* op = static_cast<bf16*>(out);
  switch (d) {
    case 40: return launch_mha<40>(xp, wqp, kp, vp, wop, op, b, h, tq, tk, c, co, scale, s);
    case 64: return launch_mha<64>(xp, wqp, kp, vp, wop, op, b, h, tq, tk, c, co, scale, s);
    case 80: return launch_mha<80>(xp, wqp, kp, vp, wop, op, b, h, tq, tk, c, co, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
