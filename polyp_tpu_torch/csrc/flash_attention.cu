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
// bound is the tensor cores' (5.4 us at 989 TFLOP/s). Below that, on
// mma.sync: the QK^T depth is padded from 40 to 48, the softmax's exp runs
// on the 16-a-clock MUFU unit beside the mma, each K/V fragment is read
// from shared memory by ldmatrix, and one warp's S -> softmax -> P V chain
// is serial, so latency needs several warps (or row tiles) in flight.
//
// Design (attention_core.cuh): one block per (n*h, 128 query rows), so
// N = 4 gives 256 blocks, about two for each of the 132 SMs. At d = 40 a
// warp takes 32 rows as two row tiles (4 warps, 3 blocks an SM), so every
// K and V fragment feeds two mma and two independent chains interleave;
// above, 8 warps of 16 rows. Q is loaded once into mma.sync A fragments;
// the scores, the probabilities and the output accumulator stay in
// registers. K/V tiles of 64 keys (32 at d >= 128, where the accumulator
// takes more registers) are double-buffered with cp.async, so the next tile
// loads while this one computes, and the core takes them 32 keys a step
// (no spills at d <= 80). The head dimension is a template parameter (40,
// 64, 80, 128, 160); shared tiles are padded to the next multiple of 16 with
// zeros that the masked loads put there, so no padded copy of Q/K/V is made
// and the scale uses the true d. Ragged Tq and Tk are masked; BTHD strides
// are read in place. Timed against the card's peak and SDPA in PERF.md.

#include "attention_core.cuh"

using polyp::bf16;

namespace {

constexpr int kBlockQ = 128;  // query rows a block

template <int D>
struct FlashShape {
  using H = polyp::attn::Head<D>;
  static constexpr int MT = polyp::attn::rows_per_warp<D>();  // row tiles a warp
  static constexpr int kThreads = 32 * kBlockQ / (16 * MT);
  // blocks an SM must hold: the register cap is 65536 / (threads x this)
  static constexpr int kMinBlocks = D <= 40 ? 3 : D <= 80 ? 2 : 1;
  static constexpr int BK = D <= 80 ? 64 : 32;  // keys a tile
  static constexpr size_t kSmem = sizeof(bf16) * (kBlockQ + 2 * 2 * BK) * H::LD;
};

template <int D>
__global__ void __launch_bounds__(FlashShape<D>::kThreads, FlashShape<D>::kMinBlocks)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Tq, int Tk,
                 float score_log2) {
  using S = FlashShape<D>;
  using Hd = typename S::H;
  constexpr int BK = S::BK;
  constexpr int LD = Hd::LD;
  constexpr int MT = S::MT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + kBlockQ * LD;  // two stages of [K tile; V tile]

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

  auto stage = [&](int it) { return sKV + (it & 1) * 2 * BK * LD; };
  auto issue = [&](int it) {
    const int k0 = it * BK;
    bf16* sK = stage(it);
    polyp::load_tile_async_vec8(sK, LD, kb + k0 * row, row, BK, Hd::DK, Tk - k0, D);
    polyp::load_tile_async_vec8(sK + BK * LD, LD, vb + k0 * row, row, BK, Hd::DK, Tk - k0, D);
  };

  polyp::load_tile_async_vec8(sQ, LD, qb + q0 * row, row, kBlockQ, Hd::DK, Tq - q0, D);
  issue(0);
  polyp::cp_async_commit();

  polyp::attn::WarpAttention<D, MT> wa;
  wa.reset();
  const int r0 = warp * 16 * MT;  // this warp's query rows
  const int n_k = (Tk + BK - 1) / BK;
  for (int it = 0; it < n_k; ++it) {
    if (it + 1 < n_k) {
      issue(it + 1);  // into the stage every warp left at the last barrier
      polyp::cp_async_commit();
      polyp::cp_async_wait<1>();
    } else {
      polyp::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) wa.load_q(sQ + r0 * LD, LD);
    const bf16* sK = stage(it);
    wa.template tile<BK>(sK, sK + BK * LD, LD, Tk - it * BK, score_log2);
    __syncthreads();  // this stage may be refilled
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float inv0, inv1;
    wa.finish(i, inv0, inv1);
    const int r = q0 + r0 + 16 * i + g;
#pragma unroll
    for (int j = 0; j < Hd::DN; ++j) {
      const int c = 8 * j + 2 * t;
      if (r < Tq) {
        *reinterpret_cast<uint32_t*>(ob + r * row + c) = wa.out_pair(i, j, false, inv0, inv1);
      }
      if (r + 8 < Tq) {
        *reinterpret_cast<uint32_t*>(ob + (r + 8) * row + c) =
            wa.out_pair(i, j, true, inv0, inv1);
      }
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
  flash_fwd_kernel<D><<<grid, FlashShape<D>::kThreads, smem, stream>>>(
      q, k, v, o, H, Tq, Tk, scale * polyp::attn::kLog2e);
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

// Dynamic shared memory a flash block takes at head dim d (0 if d is not
// built): chip_smoke.py reports it beside the registers.
extern "C" long long polyp_flash_smem(int d) {
  switch (d) {
    case 40: return FlashShape<40>::kSmem;
    case 64: return FlashShape<64>::kSmem;
    case 80: return FlashShape<80>::kSmem;
    case 128: return FlashShape<128>::kSmem;
    case 160: return FlashShape<160>::kSmem;
    default: return 0;
  }
}
