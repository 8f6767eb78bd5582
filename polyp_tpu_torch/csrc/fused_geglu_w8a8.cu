// W8A8 fused GEGLU feed-forward for Hopper (sm_90a), in two forms:
//
//  * static (kPT = false): replaces polyp_tpu/ops/fused_geglu.py::
//    fused_geglu_w8a8 (body _geglu_q_kernel). x is quantized with one
//    calibrated scale sx, h with one scale sh; the second product
//    accumulates in int32 across the hidden dimension (exact: ≤ 127²·H ≈
//    8e7 ≪ 2³¹) and is dequantized once: out = bf16(acc * (sh * sw2[c]) + b2).
//  * per-token (kPT = true): replaces fused_geglu_w8a8_pt (body
//    _geglu_q_pt_kernel). Each token row of x takes its own scale from its
//    amax, and h is quantized per (row, group of block_h hidden units) with
//    that group's row amax; each group's product is dequantized with its
//    own row scales and the groups add in fp32, in order.
//
// Both: [a | gate] = dequant(q(x) · W1q) + b1 with per-channel weight scales
// sw1, kept in fp32 (not rounded to bf16), h = a * gelu_erf(gate) in fp32,
// then quantized to int8 for the second s8×s8→s32 product with W2q. Weights
// are in torch layout and quantized once outside (W1q [2H, C], a = rows
// 0..H-1; W2q [C, H]); scales sx, sh are read from device memory.
//
// What bounds it on the H100: the FF is the UNet's largest share of
// operations (10 GOP per call at each SD level at 256px), work for the
// integer tensor cores (mma.sync m16n8k32 s8, s32 accumulators). As in the
// bf16 kernel (fused_geglu.cu), the hidden dimension is split across blocks,
// since blocks run in parallel where the TPU grid ran in order: a block
// (kT tokens × one split of hidden units) quantizes its tokens once into
// shared memory, makes its int8 slice of h there (phase 1: W1 chunks of
// a and gate through a two-stage cp.async pipeline, GELU and the quantize
// applied to the accumulators in registers), then multiplies it into every
// output column tile (phase 2: W2 slices through the same pipeline) and
// stores partials to a workspace; a second kernel adds the splits in a
// fixed order (int32 for the static form, fp32 per group for per-token) and
// applies b2. The [T, 2H] intermediate never reaches device memory.
//
// The per-token form needs each quantization group's row amax before it can
// quantize h, and the groups are exactly the TPU kernel's hidden tiles
// (block_h = 640 at C=320, 512 at 640 and 1280: the reference's _BLOCKS
// through _tile), whatever this kernel's own tiling: so a block owns one
// whole group (split = block_h), keeps the group's h in fp32 in shared
// memory while it takes the row amax, and quantizes it after. It uses 32
// token rows per block to leave room for that fp32 slice; the static form
// uses 64. Any T is masked; C and H must be multiples of 16. wgmma and TMA
// are later work.

#include "int8_mma.cuh"

using polyp::bf16;

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kHT = 64;                // hidden units per phase-1 tile
constexpr int kC = 64;                 // C chunk of phase 1
constexpr int kN = 128;                // output columns per phase-2 tile
constexpr int LDK = 80;                // int8 stride of a streamed weight row (64 + 16)
constexpr int kStage = 2 * kHT * LDK;  // one stage: Wa + Wg chunks, or one W2 slice
constexpr int kSplitStatic = 256;      // most hidden units per block, static form
constexpr int kMaxSmem = 227 * 1024;
static_assert(kN * LDK <= kStage, "a W2 slice fits a stage");

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Dynamic shared memory of one block, in bytes: two weight stages, the
// quantized tokens sX, the int8 h slice sHq and, per-token only, the fp32 h
// slice sHf and three per-row arrays (x scales, h scales, h amax).
struct Layout {
  int ldx, ldh, ldhf;
  int off_x, off_hq, off_hf, off_stats, bytes;
};

template <int kT, bool kPT>
Layout layout_of(int c, int split) {
  Layout L;
  L.ldx = round_up(c, kC) + 16;
  L.ldh = round_up(split, kHT) + 16;
  L.ldhf = round_up(split, kHT) + 4;
  L.off_x = 2 * kStage;
  L.off_hq = L.off_x + kT * L.ldx;
  L.off_hf = L.off_hq + kT * L.ldh;
  L.off_stats = L.off_hf + (kPT ? kT * L.ldhf * 4 : 0);
  L.bytes = L.off_stats + (kPT ? 3 * kT * 4 : 0);
  return L;
}

struct Plan {
  int split, splits, t_pad, c_pad;
  long long elems() const { return static_cast<long long>(splits) * t_pad * c_pad; }
};

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// block_h == 0: the static form (64 rows; split 256, halved down to 64
// while the grid would leave SMs idle). Otherwise per-token: 32 rows, one
// block_h group per block.
Plan plan_of(int t, int c, int h, int block_h) {
  const int rows = block_h ? 32 : 64;
  const int tiles = (t + rows - 1) / rows;
  int split = block_h;
  if (!block_h) {
    const int sms = sm_count();
    split = kSplitStatic;
    while (split > kHT && tiles * ((h + split - 1) / split) < sms) split /= 2;
  }
  return {split, (h + split - 1) / split, tiles * rows, round_up(c, kN)};
}

template <int kT, bool kPT>
__global__ void __launch_bounds__(kThreads)
geglu_q8_partial_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w1,
                        const float* __restrict__ sw1, const bf16* __restrict__ b1,
                        const int8_t* __restrict__ w2, const float* __restrict__ sw2,
                        const float* __restrict__ sx_ptr, const float* __restrict__ sh_ptr,
                        void* __restrict__ ws, int T, int C, int H, int split, int c_pad,
                        long long split_stride, Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* stages = reinterpret_cast<int8_t*>(smem);
  int8_t* sX = reinterpret_cast<int8_t*>(smem + L.off_x);
  int8_t* sHq = reinterpret_cast<int8_t*>(smem + L.off_hq);
  float* sHf = reinterpret_cast<float*>(smem + L.off_hf);
  float* sXs = reinterpret_cast<float*>(smem + L.off_stats);
  float* sHs = sXs + kT;
  unsigned* sAmax = reinterpret_cast<unsigned*>(sHs + kT);  // |h| max as float bits

  const int t0 = blockIdx.x * kT;
  const int hs0 = blockIdx.y * split;
  const int nh = min(split, H - hs0);  // hidden units of this block
  const int n_ht = (nh + kHT - 1) / kHT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int cp = round_up(C, kC);

  // ---- phase 0: the block's tokens quantized once into sX (zero past T
  // and past C up to whole chunks)
  float sx = 0.f, sh = 0.f;
  if constexpr (kPT) {
    for (int r = warp; r < kT; r += kThreads / 32) {
      float m = 0.f;
      if (t0 + r < T) {
        const bf16* row = x + static_cast<long long>(t0 + r) * C;
        for (int v = lane; v < C / 8; v += 32) {
          m = fmaxf(m, polyp::absmax_bf16x8(*reinterpret_cast<const uint4*>(row + v * 8)));
        }
      }
      m = polyp::warp_max(m);
      if (lane == 0) {
        sXs[r] = fmaxf(m, 1e-12f) / 127.f;
        sAmax[r] = 0u;
      }
    }
    __syncthreads();
  } else {
    sx = *sx_ptr;
    sh = *sh_ptr;
  }
  const int vpr = cp / 8;
  for (int i = threadIdx.x; i < kT * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i % vpr) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T && c < C) {
      v = *reinterpret_cast<const uint4*>(x + static_cast<long long>(t0 + r) * C + c);
    }
    *reinterpret_cast<uint2*>(sX + r * L.ldx + c) = polyp::quant_bf16x8(v, kPT ? sXs[r] : sx);
  }

  // ---- phase 1: h for hidden tile ht (64 units) of this block's split.
  // Step s covers tile s / n_c and C chunk s % n_c; its Wa and Wg chunks go
  // into stage s % 2 while step s - 1 computes. Warps: kT/16 row blocks of
  // 16 × (8 / (kT/16)) column blocks.
  constexpr int WM1 = kT / 16;
  constexpr int WN1 = 8 / WM1;
  constexpr int COLS1 = kHT / WN1;
  constexpr int NT1 = COLS1 / 8;
  const int wr = warp % WM1;
  const int wc = warp / WM1;
  const int n_c = cp / kC;
  const int n_steps = n_ht * n_c;
  auto issue1 = [&](int step) {
    const int h0 = hs0 + (step / n_c) * kHT;
    const int c0 = (step % n_c) * kC;
    int8_t* sWa = stages + (step & 1) * kStage;
    polyp::load_tile_async_s8(sWa, LDK, w1 + static_cast<long long>(h0) * C + c0, C, kHT, kC,
                              H - h0, C - c0);
    polyp::load_tile_async_s8(sWa + kHT * LDK, LDK, w1 + static_cast<long long>(H + h0) * C + c0,
                              C, kHT, kC, H - h0, C - c0);
  };

  float rmax[2] = {0.f, 0.f};  // per-token: |h| max of rows g and g + 8
  int acc_a[NT1][4], acc_g[NT1][4];
  issue1(0);
  polyp::cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int ht = step / n_c;
    const int ci = step % n_c;
    if (ci == 0) {
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_a[nt][i] = acc_g[nt][i] = 0;
      }
    }
    if (step + 1 < n_steps) {
      issue1(step + 1);
      polyp::cp_async_commit();
      polyp::cp_async_wait<1>();  // all but the step just issued have landed
    } else {
      polyp::cp_async_wait<0>();
    }
    __syncthreads();

    const int8_t* sWa = stages + (step & 1) * kStage;
    const int8_t* sWg = sWa + kHT * LDK;
#pragma unroll
    for (int kk = 0; kk < kC; kk += 32) {
      uint32_t a[4];
      polyp::load_a_frag(a, sX, L.ldx, wr * 16, ci * kC + kk);
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
        uint32_t b[2];
        polyp::load_b_frag(b, sWa, LDK, wc * COLS1 + nt * 8, kk);
        polyp::mma_s8_16832(acc_a[nt], a, b);
        polyp::load_b_frag(b, sWg, LDK, wc * COLS1 + nt * 8, kk);
        polyp::mma_s8_16832(acc_g[nt], a, b);
      }
    }

    if (ci == n_c - 1) {
      // h = (a·sx·sa + b1a) * gelu(gate·sx·sg + b1g), straight from the
      // accumulators; 0 past this block's hidden units
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wr * 16 + g + (i >> 1) * 8;
          const int hl = ht * kHT + wc * COLS1 + nt * 8 + 2 * tq + (i & 1);
          float hv = 0.f;
          if (hl < nh) {
            const int hh = hs0 + hl;
            const float s = kPT ? sXs[r] : sx;
            const float av = static_cast<float>(acc_a[nt][i]) * (s * sw1[hh]) +
                             __bfloat162float(b1[hh]);
            const float gv = static_cast<float>(acc_g[nt][i]) * (s * sw1[H + hh]) +
                             __bfloat162float(b1[H + hh]);
            hv = av * (0.5f * gv * (1.f + erff(gv * 0.70710678118654752f)));
          }
          if constexpr (kPT) {
            sHf[r * L.ldhf + hl] = hv;
            rmax[i >> 1] = fmaxf(rmax[i >> 1], fabsf(hv));
          } else {
            sHq[r * L.ldh + hl] = static_cast<int8_t>(polyp::quant_s8(hv, sh));
          }
        }
      }
    }
    __syncthreads();  // this stage may be refilled
  }

  if constexpr (kPT) {
    // row amax of the group → row scales → quantize the fp32 slice
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float m = rmax[j];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (tq == 0) atomicMax(&sAmax[wr * 16 + g + j * 8], __float_as_uint(m));
    }
    __syncthreads();
    for (int r = threadIdx.x; r < kT; r += kThreads) {
      sHs[r] = fmaxf(__uint_as_float(sAmax[r]), 1e-12f) / 127.f;
    }
    __syncthreads();
    const int hp = n_ht * kHT;
    for (int i = threadIdx.x; i < kT * hp; i += kThreads) {
      const int r = i / hp;
      const int c = i % hp;
      sHq[r * L.ldh + c] = static_cast<int8_t>(polyp::quant_s8(sHf[r * L.ldhf + c], sHs[r]));
    }
    __syncthreads();
  }

  // ---- phase 2: ws[split, t0 + r, n0 + c] = sHq @ W2q[n0.., hs0..]ᵀ for
  // every output column tile n0. Step s covers column tile s / n_ht and
  // hidden tile s % n_ht. Warps: 2 row halves × 4 column quarters.
  constexpr int ROWS2 = kT / 2;
  constexpr int MT2 = ROWS2 / 16;
  const int wm2 = warp / 4;
  const int wn2 = warp % 4;
  const int n_steps2 = ((C + kN - 1) / kN) * n_ht;
  auto issue2 = [&](int step) {
    const int n0 = (step / n_ht) * kN;
    const int h0 = hs0 + (step % n_ht) * kHT;
    polyp::load_tile_async_s8(stages + (step & 1) * kStage, LDK,
                              w2 + static_cast<long long>(n0) * H + h0, H, kN, kHT, C - n0, H - h0);
  };

  int acc[MT2][4][4];
  issue2(0);
  polyp::cp_async_commit();
  for (int step = 0; step < n_steps2; ++step) {
    const int n0 = (step / n_ht) * kN;
    const int kt = step % n_ht;
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < MT2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
        }
      }
    }
    if (step + 1 < n_steps2) {
      issue2(step + 1);
      polyp::cp_async_commit();
      polyp::cp_async_wait<1>();
    } else {
      polyp::cp_async_wait<0>();
    }
    __syncthreads();

    const int8_t* sW2 = stages + (step & 1) * kStage;
#pragma unroll
    for (int kk = 0; kk < kHT; kk += 32) {
      uint32_t a[MT2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < MT2; ++mt) {
        polyp::load_a_frag(a[mt], sHq, L.ldh, wm2 * ROWS2 + mt * 16, kt * kHT + kk);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) polyp::load_b_frag(b[nt], sW2, LDK, wn2 * 32 + nt * 8, kk);
#pragma unroll
      for (int mt = 0; mt < MT2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) polyp::mma_s8_16832(acc[mt][nt], a[mt], b[nt]);
      }
    }
    if (kt == n_ht - 1) {
      // padded rows and columns of the workspace take the masked tile edges
#pragma unroll
      for (int mt = 0; mt < MT2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = wm2 * ROWS2 + mt * 16 + g + (i >> 1) * 8;
            const int c = n0 + wn2 * 32 + nt * 8 + 2 * tq + (i & 1);
            const long long off = blockIdx.y * split_stride +
                                  static_cast<long long>(t0 + r) * c_pad + c;
            if constexpr (kPT) {
              static_cast<float*>(ws)[off] =
                  c < C ? static_cast<float>(acc[mt][nt][i]) * (sHs[r] * sw2[c]) : 0.f;
            } else {
              static_cast<int*>(ws)[off] = acc[mt][nt][i];
            }
          }
        }
      }
    }
    __syncthreads();  // this stage may be refilled
  }
}

// out[t, c]: the splits added in order, then b2 (static: the int32 sum
// dequantized once with sh · sw2[c]; per-token: fp32 partials).
template <bool kPT>
__global__ void geglu_q8_reduce_kernel(const void* __restrict__ ws, const float* __restrict__ sw2,
                                       const bf16* __restrict__ b2, const float* __restrict__ sh_ptr,
                                       bf16* __restrict__ out, int T, int C, int splits, int c_pad,
                                       long long split_stride) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(T) * C) return;
  const int t = static_cast<int>(i / C);
  const int c = static_cast<int>(i % C);
  const long long base = static_cast<long long>(t) * c_pad + c;
  float v;
  if constexpr (kPT) {
    v = 0.f;
    for (int s = 0; s < splits; ++s) v += static_cast<const float*>(ws)[base + s * split_stride];
  } else {
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += static_cast<const int*>(ws)[base + s * split_stride];
    v = static_cast<float>(acc) * (*sh_ptr * sw2[c]);
  }
  out[i] = __float2bfloat16(v + __bfloat162float(b2[c]));
}

template <int kT, bool kPT>
cudaError_t launch(const void* x, const void* w1, const void* sw1, const void* b1, const void* w2,
                   const void* sw2, const void* b2, const void* sx, const void* sh, void* ws,
                   void* out, int t, int c, int h, int block_h, void* stream) {
  const Plan p = plan_of(t, c, h, block_h);
  const Layout L = layout_of<kT, kPT>(c, p.split);
  if (L.bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(geglu_q8_partial_kernel<kT, kPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  const long long split_stride = static_cast<long long>(p.t_pad) * p.c_pad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(p.t_pad / kT, p.splits);
  geglu_q8_partial_kernel<kT, kPT><<<grid, kThreads, L.bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w1), static_cast<const float*>(sw1),
      static_cast<const bf16*>(b1), static_cast<const int8_t*>(w2), static_cast<const float*>(sw2),
      static_cast<const float*>(sx), static_cast<const float*>(sh), ws, t, c, h, p.split, p.c_pad,
      split_stride, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(t) * c;
  geglu_q8_reduce_kernel<kPT><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      ws, static_cast<const float*>(sw2), static_cast<const bf16*>(b2),
      static_cast<const float*>(sh), static_cast<bf16*>(out), t, c, p.splits, p.c_pad,
      split_stride);
  return cudaGetLastError();
}

}  // namespace

// 4-byte elements of workspace the int8 GEGLU needs (int32 partials for the
// static form, block_h == 0; fp32 for per-token).
extern "C" long long polyp_geglu_w8a8_workspace(int t, int c, int h, int block_h) {
  return plan_of(t, c, h, block_h).elems();
}

extern "C" int polyp_geglu_w8a8(const void* x, const void* w1, const void* sw1, const void* b1,
                                const void* w2, const void* sw2, const void* b2, const void* sx,
                                const void* sh, void* ws, void* out, int t, int c, int h,
                                void* stream) {
  return launch<64, false>(x, w1, sw1, b1, w2, sw2, b2, sx, sh, ws, out, t, c, h, 0, stream);
}

extern "C" int polyp_geglu_w8a8_pt(const void* x, const void* w1, const void* sw1, const void* b1,
                                   const void* w2, const void* sw2, const void* b2, void* ws,
                                   void* out, int t, int c, int h, int block_h, void* stream) {
  return launch<32, true>(x, w1, sw1, b1, w2, sw2, b2, nullptr, nullptr, ws, out, t, c, h,
                          block_h, stream);
}
