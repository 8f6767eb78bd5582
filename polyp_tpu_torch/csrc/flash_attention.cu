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
// (no spills at d <= 80). The head width is a template parameter, one of
// attention_core.cuh's padded widths (16, 32, 40, 48, 64, 80, 96, 112, 128)
// or 160, and the true d (a multiple of 8 at most that width; the wrapper
// pads any other d <= 128 to one) comes at run time: shared tiles are filled
// past d to the width padded to 16 with zeros that the masked loads put
// there, stores stop at d, so no padded copy of Q/K/V is made and the scale
// uses the true d. Ragged Tq and Tk are masked; BTHD strides
// are read in place. Timed against the card's peak and SDPA in PERF.md.
//
// fp32 form (polyp_flash_attention_f32_fwd, namespace f32): replaces the same
// Pallas kernel (polyp_tpu/ops/flash_attention.py::_flash_impl, :185) for
// fp32 q, k, v, which it takes as well, keeping p in fp32 for fp32 v
// (:84-85); an fp32 model (an SD UNet loaded in fp32, run without autograd)
// takes this form. It computes what the bf16 form does: fp32 scores, the
// online softmax in exp2 of log2-scaled scores (max in raw scores), p kept
// in fp32, the T x T matrix never in device memory, any Tq and Tk (ragged
// tiles masked), the same head widths. Its core, 3xTF32 mma.sync with P
// kept in registers, is attention_core.cuh's f32::WarpAttention (the fused
// MHA's fp32 form runs it too), whose comment gives the plan; PERF.md §6
// has the plans it was timed against. What bounds it: 4·N·H·T²·D
// operations (2.7 GFLOP at [2, 1024, 8, 40]) at 495 / 3 = 165 TFLOP/s, its
// 3xTF32 ceiling (16 us there), beside the 67 TFLOP/s fp32 rate of the
// CUDA cores (40 us); on this card mma.sync's tf32 rate peaks at 299
// TFLOP/s (tools/mma_rate.py), so about 100 in 3xTF32. Registers
// (-Xptxas -v, sm_90a): 228, 194, 212, 169, 184 a thread at d = 40, 64,
// 80, 128, 160, 137-196 at the other widths, no spills.

#include "attention_core.cuh"

using polyp::bf16;

namespace {

constexpr int kBlockQ = 128;  // query rows a block

// The width a head dim d (a multiple of 8) runs at: attention_core.cuh's
// padded widths up to 128, and 160 for d = 160 alone; 0 for any other d.
int width_of(int d) { return d == 160 ? 160 : polyp::attn::padded_width(d); }

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
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H, int d, int Tq,
                 int Tk, float score_log2) {
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
  const long long row = static_cast<long long>(H) * d;  // token stride
  const bf16* qb = q + (static_cast<long long>(n) * Tq) * row + h * d;
  const bf16* kb = k + (static_cast<long long>(n) * Tk) * row + h * d;
  const bf16* vb = v + (static_cast<long long>(n) * Tk) * row + h * d;
  bf16* ob = o + (static_cast<long long>(n) * Tq) * row + h * d;

  auto stage = [&](int it) { return sKV + (it & 1) * 2 * BK * LD; };
  auto issue = [&](int it) {
    const int k0 = it * BK;
    bf16* sK = stage(it);
    polyp::load_tile_async_vec8(sK, LD, kb + k0 * row, row, BK, Hd::DK, Tk - k0, d);
    polyp::load_tile_async_vec8(sK + BK * LD, LD, vb + k0 * row, row, BK, Hd::DK, Tk - k0, d);
  };

  polyp::load_tile_async_vec8(sQ, LD, qb + q0 * row, row, kBlockQ, Hd::DK, Tq - q0, d);
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
      if (8 * j >= d) break;  // the padding columns (d a multiple of 8)
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
                         int d, int Tq, int Tk, float scale, cudaStream_t stream) {
  const size_t smem = FlashShape<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(N * H, (Tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D><<<grid, FlashShape<D>::kThreads, smem, stream>>>(
      q, k, v, o, H, d, Tq, Tk, scale * polyp::attn::kLog2e);
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
  if (d < 8 || d % 8) return cudaErrorInvalidValue;
#define FLASH(W) return launch_flash<W>(qp, kp, vp, op, n, h, d, tq, tk, scale, s)
  switch (width_of(d)) {
    POLYP_ATTN_WIDTH_CASES(FLASH)
    case 160: FLASH(160);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH
}

namespace {

namespace f32 {

using polyp::attn::f32::kBlockQ;
template <int D>
using Plan = polyp::attn::f32::Plan<D>;  // 64-key tiles

template <int D>
constexpr size_t kSmem = sizeof(float) * (Plan<D>::kQ + 2 * Plan<D>::kStage);

template <int D>
__global__ void __launch_bounds__(Plan<D>::kThreads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int d, int Tq, int Tk,
                 float score_log2) {
  using P = Plan<D>;
  constexpr int BK = P::BK, KW = P::KW, LD = P::LD, RW = P::kRowWarps, MT = P::MT;
  extern __shared__ __align__(16) float fsmem[];
  float* sQ = fsmem;              // [kBlockQ][LD]
  float* sKV = sQ + P::kQ;        // two stages of [K tile; V tile], [BK][LD] each

  const int warp = threadIdx.x / 32;
  const int rw = warp % RW;               // this warp's rows: 16 MT rw .. + 16 MT
  const int kw0 = (warp / RW) * KW;       // its first key of each tile
  const int bh = blockIdx.x;
  const int n = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * kBlockQ;
  const long long row = static_cast<long long>(H) * d;  // token stride
  const float* qb = q + (static_cast<long long>(n) * Tq) * row + h * d;
  const float* kb = k + (static_cast<long long>(n) * Tk) * row + h * d;
  const float* vb = v + (static_cast<long long>(n) * Tk) * row + h * d;
  float* ob = o + (static_cast<long long>(n) * Tq + q0) * row + h * d;

  auto stage = [&](int it) { return sKV + (it & 1) * P::kStage; };
  auto issue = [&](int it) {
    const int k0 = it * BK;
    float* sK = stage(it);
    polyp::load_tile_async_f32(sK, LD, kb + k0 * row, row, BK, D, Tk - k0, d, true);
    polyp::load_tile_async_f32(sK + BK * LD, LD, vb + k0 * row, row, BK, D, Tk - k0, d, true);
  };

  polyp::load_tile_async_f32(sQ, LD, qb + q0 * row, row, kBlockQ, D, Tq - q0, d, true);
  issue(0);
  polyp::cp_async_commit();

  const float* q_row = sQ + 16 * MT * rw * LD;  // the warp's first row
  polyp::attn::f32::WarpAttention<D, BK> wa;
  wa.reset();
  const int n_k = (Tk + BK - 1) / BK;
  for (int it = 0; it < n_k; ++it) {
    if (it + 1 < n_k) {
      issue(it + 1);  // into the stage every thread left at the last barrier
      polyp::cp_async_commit();
      polyp::cp_async_wait<1>();
    } else {
      polyp::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) wa.load_q(q_row);
    const float* st = stage(it);
    const int kvalid = Tk - it * BK - kw0;  // this warp's valid keys in the tile
    if (kvalid > 0) wa.tile(q_row, st + kw0 * LD, st + (BK + kw0) * LD, kvalid, score_log2);
    __syncthreads();  // this stage may be refilled
  }

  // the second key group's state joins the first's (the stages are free),
  // and the first group's warps write the rows
  if (wa.join(sKV, score_log2)) wa.store(ob, row, rw, Tq - q0, d);
}

template <int D>
cudaError_t launch_flash_f32(const float* q, const float* k, const float* v, float* o, int N,
                             int H, int d, int Tq, int Tk, float scale, cudaStream_t stream) {
  using P = Plan<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem<D>));
  if (err != cudaSuccess) return err;
  dim3 grid(N * H, (Tq + kBlockQ - 1) / kBlockQ);
  flash_f32_kernel<D><<<grid, P::kThreads, kSmem<D>, stream>>>(q, k, v, o, H, d, Tq, Tk,
                                                               scale * polyp::attn::kLog2e);
  return cudaGetLastError();
}

template <int D>
void plan_of(long long* out) {
  using P = Plan<D>;
  out[0] = kBlockQ;
  out[1] = P::BK;
  out[2] = P::kThreads;
  out[3] = P::KS;
  out[4] = kSmem<D>;
  out[5] = P::MT;
}

}  // namespace f32

}  // namespace

// The fp32 form: q, k, v, o fp32 [N, T, H, D].
extern "C" int polyp_flash_attention_f32_fwd(const void* q, const void* k, const void* v,
                                             void* o, int n, int h, int tq, int tk, int d,
                                             float scale, void* stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 8 || d % 8) return cudaErrorInvalidValue;
#define FLASH_F32(W) return f32::launch_flash_f32<W>(qp, kp, vp, op, n, h, d, tq, tk, scale, s)
  switch (width_of(d)) {
    POLYP_ATTN_WIDTH_CASES(FLASH_F32)
    case 160: FLASH_F32(160);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_F32
}

// Dynamic shared memory a flash block takes at head dim d (a multiple of 8;
// 0 if no width takes it): chip_smoke.py reports it beside the registers.
extern "C" long long polyp_flash_smem(int d) {
#define SMEM(W) return FlashShape<W>::kSmem
  switch (d % 8 ? 0 : width_of(d)) {
    POLYP_ATTN_WIDTH_CASES(SMEM)
    case 160: SMEM(160);
    default: return 0;
  }
#undef SMEM
}

// ... and the fp32 form's plan at d: out[6] = query rows a block, keys a
// tile, threads a block, key groups a row tile, dynamic shared memory
// bytes, row tiles a warp; returns 0, or -1 if no width takes d
extern "C" int polyp_flash_f32_plan(int d, long long* out) {
#define PLAN(W) f32::plan_of<W>(out); return 0
  switch (d % 8 ? 0 : width_of(d)) {
    POLYP_ATTN_WIDTH_CASES(PLAN)
    case 160: PLAN(160);
    default: return -1;
  }
#undef PLAN
}

extern "C" long long polyp_flash_f32_smem(int d) {
  long long plan[6];
  return polyp_flash_f32_plan(d, plan) == 0 ? plan[4] : 0;
}
