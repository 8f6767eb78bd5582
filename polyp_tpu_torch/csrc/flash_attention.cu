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
//
// fp32 form (polyp_flash_attention_f32_fwd): the Pallas kernel takes any
// dtype and keeps p in fp32 for fp32 v (flash_attention.py:84), so an fp32
// model (an SD UNet loaded in fp32, run without autograd) takes this form.
// It computes what the bf16 form does: fp32 scores, the online softmax in
// exp2 of log2-scaled scores, p kept in fp32, the T x T matrix never in
// device memory. Products in full fp32 on the CUDA cores (FFMA): TF32 tensor
// cores keep 10 mantissa bits, about 5e-4 of a product, and the check is
// 1e-4 of max |y|. So the bound is the fp32 rate, 67 TFLOP/s: 4*N*H*T*T*D =
// 2.7 GFLOP at [2, 1024, 8, 40], 40 us. Design: a block owns 64 query rows
// of one (n, h); its 256 threads form a 16 x 16 grid, each thread 4 query
// rows x BK/16 keys of the scores (keys tx, tx + 16, ...), so a row's 16
// threads are one half-warp and its max and sum reduce by shuffles. Q stays
// in shared memory; K/V tiles of BK keys (64; 32 at d >= 128) are
// double-buffered with cp.async. Rows of every tile are padded to d + 4
// floats, which makes the float4 reads along d free of bank conflicts. P
// goes to shared memory (each half-warp writes and reads only its own
// rows, so a __syncwarp orders it) and P V accumulates 4 rows x ceil(d/16)
// output columns a thread in registers. Any Tq and Tk; d = 40, 64, 80, 128,
// 160.

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

namespace {

namespace f32 {

constexpr int kBlockQ = 64;  // query rows a block
constexpr int kThreads = 256;

template <int D>
struct Shape {
  static constexpr int BK = D <= 80 ? 64 : 32;  // keys a tile
  static constexpr int KJ = BK / 16;            // keys a thread
  static constexpr int NC = (D + 15) / 16;      // output columns a thread
  static constexpr int LD = D + 4;              // floats a row of Q, K, V
  static constexpr int LDP = BK + 4;            // floats a row of P
  static constexpr size_t kSmem = sizeof(float) * ((kBlockQ + 4 * BK) * LD + kBlockQ * LDP);
};

// two blocks an SM: at most 128 registers a thread (the compiler's own
// choice spilled at d = 40, 80 and 128)
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int Tq, int Tk,
                 float score_log2) {
  using S = Shape<D>;
  constexpr int BK = S::BK, KJ = S::KJ, NC = S::NC, LD = S::LD, LDP = S::LDP;
  extern __shared__ __align__(16) float fsmem[];
  float* sQ = fsmem;                    // [kBlockQ][LD]
  float* sKV = sQ + kBlockQ * LD;       // two stages of [K tile; V tile], [BK][LD] each
  float* sP = sKV + 4 * BK * LD;        // [kBlockQ][LDP]

  const int tx = threadIdx.x % 16;  // keys tx + 16 j; output columns tx + 16 c
  const int ty = threadIdx.x / 16;  // query rows 4 ty .. 4 ty + 3
  const int bh = blockIdx.x;
  const int n = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * kBlockQ;
  const long long row = static_cast<long long>(H) * D;  // token stride
  const float* qb = q + (static_cast<long long>(n) * Tq) * row + h * D;
  const float* kb = k + (static_cast<long long>(n) * Tk) * row + h * D;
  const float* vb = v + (static_cast<long long>(n) * Tk) * row + h * D;
  float* ob = o + (static_cast<long long>(n) * Tq) * row + h * D;

  auto stage = [&](int it) { return sKV + (it & 1) * 2 * BK * LD; };
  auto issue = [&](int it) {
    const int k0 = it * BK;
    float* sK = stage(it);
    polyp::load_tile_async_f32(sK, LD, kb + k0 * row, row, BK, D, Tk - k0, D, true);
    polyp::load_tile_async_f32(sK + BK * LD, LD, vb + k0 * row, row, BK, D, Tk - k0, D, true);
  };

  polyp::load_tile_async_f32(sQ, LD, qb + q0 * row, row, kBlockQ, D, Tq - q0, D, true);
  issue(0);
  polyp::cp_async_commit();

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
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
    const float* sK = stage(it);
    const float* sV = sK + BK * LD;

    // scores of rows 4 ty + i, keys tx + 16 j, summed over d in order
    float s[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 4) {
      float4 kv[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LD + kk);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * LD + kk);
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = polyp::dot4(s[i][j], qv, kv[j]);
      }
    }

    // the online softmax; keys past Tk get p = 0 (their V rows are zeros)
    const int k_valid = Tk - it * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = tx + 16 * j < k_valid ? s[i][j] * score_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        sP[(4 * ty + i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // this half-warp's P rows, written and read by it alone

    // O += P V over the tile's keys, in key order
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * LDP + kk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = tx + 16 * c;
          vv[c] = (D % 16 == 0 || col < D) ? sV[(kk + u) * LD + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();  // this stage, and P, may be refilled
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= Tq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (D % 16 == 0 || col < D) ob[r * row + col] = acc[i][c] * inv;
    }
  }
}

template <int D>
cudaError_t launch_flash_f32(const float* q, const float* k, const float* v, float* o, int N,
                             int H, int Tq, int Tk, float scale, cudaStream_t stream) {
  const size_t smem = Shape<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(N * H, (Tq + kBlockQ - 1) / kBlockQ);
  flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, o, H, Tq, Tk,
                                                        scale * polyp::attn::kLog2e);
  return cudaGetLastError();
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
  switch (d) {
    case 40: return f32::launch_flash_f32<40>(qp, kp, vp, op, n, h, tq, tk, scale, s);
    case 64: return f32::launch_flash_f32<64>(qp, kp, vp, op, n, h, tq, tk, scale, s);
    case 80: return f32::launch_flash_f32<80>(qp, kp, vp, op, n, h, tq, tk, scale, s);
    case 128: return f32::launch_flash_f32<128>(qp, kp, vp, op, n, h, tq, tk, scale, s);
    case 160: return f32::launch_flash_f32<160>(qp, kp, vp, op, n, h, tq, tk, scale, s);
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

// ... and a block of the fp32 form
extern "C" long long polyp_flash_f32_smem(int d) {
  switch (d) {
    case 40: return f32::Shape<40>::kSmem;
    case 64: return f32::Shape<64>::kSmem;
    case 80: return f32::Shape<80>::kSmem;
    case 128: return f32::Shape<128>::kSmem;
    case 160: return f32::Shape<160>::kSmem;
    default: return 0;
  }
}
