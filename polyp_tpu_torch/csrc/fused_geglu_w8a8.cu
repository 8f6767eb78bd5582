// W8A8 fused GEGLU feed-forward for Hopper (sm_90a), in two forms:
//
//  * static: replaces polyp_tpu/ops/fused_geglu.py::fused_geglu_w8a8 (body
//    _geglu_q_kernel). x is quantized with one calibrated scale sx, h with
//    one scale sh; the second product accumulates in int32 across the
//    hidden dimension (exact: ≤ 127²·H ≈ 8e7 ≪ 2³¹) and is dequantized
//    once: out = bf16(acc * (sh * sw2[c]) + b2).
//  * per-token: replaces fused_geglu_w8a8_pt (body _geglu_q_pt_kernel).
//    Each token row of x takes its own scale from its amax, and h is
//    quantized per (row, group of block_h hidden units) with that group's
//    row amax; each group's product is dequantized with its own row scales
//    and the groups add in fp32, in order.
//
// Both: [a | gate] = dequant(q(x) · W1q) + b1 with per-channel weight scales
// sw1, kept in fp32 (not rounded to bf16), h = a * gelu_erf(gate) in fp32,
// then quantized to int8 for the second s8×s8→s32 product with W2q. Weights
// are in torch layout and quantized once outside (W1q [2H, C], a = rows
// 0..H-1; W2q [C, H]); scales sx, sh are read from device memory.
//
// What bounds it on the H100: the integer tensor cores (6·T·C·H operations:
// 80 GOP at level 0 of the distilled batch 32, 41 µs at 1,979 TOP/s) and the
// epilogue of the first product, an erf GELU and a quantize for each of the
// T·H hidden activations; its bytes in device memory are tens of MB.
//
// The static form runs in two launches of the GEMM core (gemm_core.cuh):
// * Launch 1, h codes [T, H] int8 (policy GegluQ8Up): a block owns a panel
//   of 128 tokens (64 where C > 640 or the 128-token panels would cover
//   under a quarter of the SMs) and a share of its hidden tiles of 64
//   units. It quantizes its panel of x once, with quant_s8_bits, into
//   shared memory in the 128-byte-swizzled K-major layout that the wgmma
//   descriptor reads (the core's A-stationary panel), so both s8 operands
//   come from shared memory (wgmma m64n64k32, s8_ss) and x is quantized
//   once per block, not once per hidden tile. Only W1q streams: the
//   producer warp brings each C chunk of rows h0.. and H+h0.. by TMA. The
//   two consumer warpgroups take alternate tiles, each from a ring of its
//   own, so that one's epilogue (the erf GELU of every hidden activation:
//   the launch's largest cost) runs while the other's products do; two s32
//   accumulators a row block hold a and gate of the same (token, unit). The
//   epilogue dequantizes both with the tile's sw1 and b1 (fetched by
//   cp.async while the products run), applies the erf GELU in fp32,
//   quantizes h with sh (no branch an element: the division only for a
//   column pair too near a tie) and stages the codes in the tile's last
//   stage for coalesced 16-byte stores of int8: half the bytes of the bf16
//   kernel's h, and the [T, 2H] intermediate never reaches device memory.
//   Where the panels are fewer than the SMs, a panel's hidden tiles are
//   split over several blocks, each quantizing the panel once.
// * Launch 2, out = codes · W2qᵀ dequantized with sh · sw2, + b2: the W8A8
//   dense's int8-input path under its own name (fused_dense.cuh,
//   GegluQ8Down) with act_scale = sh, K split over a cluster where its
//   tiles are few.
// Sums run in a fixed order, so runs repeat bit for bit. Any T; C and H
// multiples of 16, C at most 2,560 (the panel beside two rings of two
// stages: the core refuses wider).

// The per-token form (on mma.sync) needs each quantization group's row
// amax before it can quantize h, and the groups are exactly the TPU
// kernel's hidden tiles (block_h = 640 at C=320, 512 at 640 and 1280: the
// reference's _BLOCKS through _tile), whatever this kernel's own tiling: a
// block (32 tokens × one group) quantizes its tokens once into shared
// memory, makes its group of h there in fp32 (phase 1: W1 chunks of a and
// gate through a two-stage cp.async pipeline on mma.sync m16n8k32), takes
// the row amax and quantizes it, then multiplies it into every output
// column tile (phase 2: W2 slices through the same pipeline) and stores
// fp32 partials to a workspace; a second kernel adds the groups in a fixed
// order and applies b2. Any T; C and H multiples of 16.

#include "fused_dense.cuh"
#include "gemm_core.cuh"
#include "int8_mma.cuh"

using polyp::bf16;
namespace gemm = polyp::gemm;

namespace {

// ---------------------------------------------------------------- static

// a * gelu(gate) in fp32, gelu in its exact erf form
__device__ __forceinline__ float gelu_gate(float a, float g) {
  return a * (0.5f * g * (1.f + erff(g * 0.70710678118654752f)));
}

// Launch 1 of the static form, a GEMM core policy: the codes of h for BM
// tokens × 64 hidden units, an A-stationary panel of quantized x, the two
// consumer warpgroups on alternate tiles (each all BM rows, in BM / 64
// wgmma row blocks) with a ring each. acc[2b] and acc[2b + 1] hold a and
// gate of row block b.
template <int BM>
struct GegluQ8Up : gemm::Policy {
  static constexpr int kRows = BM, kBN = 64, kRings = 2, kInFlight = 1, kBlocksPerSM = 1;
  static constexpr int kRowBlocks = BM / gemm::kWgRows;
  static constexpr int kAcc = 2 * kRowBlocks;
  using Acc = int;
  static constexpr int kWBytes = kBN * gemm::kChunkBytes;       // one W1 half's chunk
  static constexpr int kStageBytes = 2 * kWBytes;                // a and gate chunks
  static constexpr int kPanelChunkBytes = BM * gemm::kChunkBytes;
  // a tile's columns of sw1 (a, gate: fp32) and b1 (a, gate: bf16)
  static constexpr int kScratchBytes = 2 * kBN * 4 + 2 * kBN * 2;
  static constexpr int kLd = kBN + 16;  // a staged code row
  static_assert(BM * kLd <= kStageBytes, "the staged codes take the tile's last stage");
  struct Params {
    CUtensorMap w1;  // W1q [2H, C] int8, boxes of [64 rows][128 B]
    const bf16* x;   // [T, C]
    const float* sw1;
    const bf16* b1;
    const float* sx;
    const float* sh;
    int8_t* out;    // codes [T, H]
    int m, n, n_k;  // T, H, C chunks
    int c;
  };
  __device__ static void load(const Params& p, unsigned char* st, int kc, int, int n0,
                              uint64_t* bar) {
    gemm::tma_load(st, &p.w1, bar, kc * gemm::kChunkBytes, n0);
    gemm::tma_load(st + kWBytes, &p.w1, bar, kc * gemm::kChunkBytes, p.n + n0);
  }
  // the panel, quantized once by both warpgroups: 8 codes a thread a step
  // from one 16-byte load of x; zeros past T and past C up to whole chunks
  __device__ static void panel(const Params& p, unsigned char* dst, int m0) {
    const float sx = *p.sx;
    const float inv_x = 1.f / sx;
    const int vecs = p.n_k * (gemm::kChunkBytes / 8);  // 8-code vectors a row
    for (int v = threadIdx.x; v < BM * vecs; v += gemm::consumers<GegluQ8Up>()) {
      const int r = v / vecs;
      const int col = (v % vecs) * 8;
      uint2 codes = make_uint2(0u, 0u);
      if (m0 + r < p.m && col < p.c) {
        codes = polyp::quant_bf16x8_bits(
            *reinterpret_cast<const uint4*>(p.x + static_cast<long long>(m0 + r) * p.c + col), sx,
            inv_x);
      }
      *reinterpret_cast<uint2*>(dst + (col / gemm::kChunkBytes) * kPanelChunkBytes +
                                gemm::swizzle128(r, col % gemm::kChunkBytes)) = codes;
    }
  }
  __device__ static void mma(const Params&, unsigned char* st, const unsigned char* x,
                             int (&acc)[kAcc][kBN / 2]) {
    gemm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 32 bytes a k32 step
      const uint64_t wa = gemm::smem_desc(st + kk * 32);
      const uint64_t wgate = gemm::smem_desc(st + kWBytes + kk * 32);
#pragma unroll
      for (int b = 0; b < kRowBlocks; ++b) {
        const uint64_t a = gemm::smem_desc(x + b * (gemm::kWgRows * gemm::kChunkBytes) + kk * 32);
        gemm::Wgmma<kBN>::s8_ss(acc[2 * b], a, wa, 1);
        gemm::Wgmma<kBN>::s8_ss(acc[2 * b + 1], a, wgate, 1);
      }
    }
    gemm::wgmma_commit();
  }
  // the epilogue's scales and biases, in flight while the products run:
  // 16-byte copies (zeros past H, a multiple of 16), sw1 a and gate, then
  // b1 a and gate
  __device__ static void tile_begin(const Params& p, unsigned char* scratch, int n0) {
    const int tid = threadIdx.x & 127;
    if (tid < 48) {
      const int part = tid < 32 ? tid / 16 : 2 + (tid - 32) / 8;  // sa, sg, ba, bg
      const int v = tid < 32 ? tid % 16 : (tid - 32) % 8;          // 16-byte vector
      const int per = part < 2 ? 4 : 8;                            // elements a vector
      const int col = n0 + v * per;
      const int src = (part & 1) * p.n + col;
      const void* from = part < 2 ? static_cast<const void*>(p.sw1 + src)
                                  : static_cast<const void*>(p.b1 + src);
      unsigned char* to = scratch + (part < 2 ? part * kBN * 4 + v * 16
                                              : 2 * kBN * 4 + (part - 2) * kBN * 2 + v * 16);
      polyp::cp_async16(to, col < p.n ? from : p.sw1, col < p.n);
    }
    polyp::cp_async_commit();
  }
  // h codes of columns n0 + 8jj + c, +1 (0 past H) at rows 64b + r, +8,
  // staged, then copied out 16 codes a store (rows past T and columns past
  // H, a multiple of 16, left out). Codes come from
  // quant_s8_bits, with no branch an element; where one of a column pair's
  // values lies too near a tie (rare), the pair's codes are made again
  // through the division
  __device__ static void store(const Params& p, int (&acc)[kAcc][kBN / 2], unsigned char* staged,
                               const unsigned char* scratch, int m0, int n0) {
    const float* p_sa = reinterpret_cast<const float*>(scratch);
    const float* p_sg = p_sa + kBN;
    const bf16* p_ba = reinterpret_cast<const bf16*>(p_sg + kBN);
    const bf16* p_bg = p_ba + kBN;
    const float sx = *p.sx;
    const float sh = *p.sh;
    const float inv_h = 1.f / sh;
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r = (tid >> 5) * 16 + (lane >> 2);
    const int c = (lane & 3) * 2;
    // the scratch has landed for every thread, and every wgmma of the
    // warpgroup has read the stage the codes take
    polyp::cp_async_wait<0>();
    gemm::tile_sync<GegluQ8Up>();
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj) {
      const int lc = 8 * jj + c;  // the tile's column
      const bool in = n0 + lc < p.n;
      const float2 sa = *reinterpret_cast<const float2*>(p_sa + lc);
      const float2 sg = *reinterpret_cast<const float2*>(p_sg + lc);
      const float2 ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p_ba + lc));
      const float2 bg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p_bg + lc));
      const float ma[2] = {sx * sa.x, sx * sa.y}, mg[2] = {sx * sg.x, sx * sg.y};
      const float ab[2] = {ba.x, ba.y}, gb[2] = {bg.x, bg.y};
      float hv[kRowBlocks][2][2];
      uint32_t q[kRowBlocks][2][2];
      bool near = false;
#pragma unroll
      for (int b = 0; b < kRowBlocks; ++b) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * half + e;
            hv[b][half][e] = gelu_gate(static_cast<float>(acc[2 * b][idx]) * ma[e] + ab[e],
                                       static_cast<float>(acc[2 * b + 1][idx]) * mg[e] + gb[e]);
            bool tie;
            q[b][half][e] = polyp::quant_s8_bits(hv[b][half][e], inv_h, &tie);
            near |= tie;
          }
        }
      }
      if (near) {
#pragma unroll
        for (int b = 0; b < kRowBlocks; ++b) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              q[b][half][e] = static_cast<uint32_t>(polyp::quant_s8(hv[b][half][e], sh));
            }
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kRowBlocks; ++b) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<uint16_t*>(staged + (64 * b + r + 8 * half) * kLd + 8 * jj + c) =
              in ? static_cast<uint16_t>((q[b][half][0] & 0xffu) | ((q[b][half][1] & 0xffu) << 8))
                 : uint16_t{0};
        }
      }
    }
    gemm::tile_sync<GegluQ8Up>();
    constexpr int kVecs = kBN / 16;  // 16 codes a store
#pragma unroll
    for (int q = 0; q < BM * kVecs / 128; ++q) {
      const int v = tid + q * 128;
      const int row = m0 + v / kVecs;
      const int col = n0 + (v % kVecs) * 16;
      if (row < p.m && col < p.n) {
        *reinterpret_cast<uint4*>(p.out + static_cast<long long>(row) * p.n + col) =
            *reinterpret_cast<const uint4*>(staged + (v / kVecs) * kLd + (v % kVecs) * 16);
      }
    }
  }
};

template <int BM>
cudaError_t launch_up(const void* x, const void* w1, const void* sw1, const void* b1,
                      const void* sx, const void* sh, int8_t* h, int t, int c, int hidden,
                      cudaStream_t stream) {
  using P = GegluQ8Up<BM>;
  typename P::Params p{};
  const cudaError_t err = gemm::weight_map(&p.w1, w1, true, 2LL * hidden, c, P::kBN);
  if (err != cudaSuccess) return err;
  p.x = static_cast<const bf16*>(x);
  p.sw1 = static_cast<const float*>(sw1);
  p.b1 = static_cast<const bf16*>(b1);
  p.sx = static_cast<const float*>(sx);
  p.sh = static_cast<const float*>(sh);
  p.out = h;
  p.m = t;
  p.n = hidden;
  p.n_k = (c + gemm::kChunkBytes - 1) / gemm::kChunkBytes;
  p.c = c;
  return gemm::launch<P>(p, stream);
}

// -------------------------------------------------------------- per-token

constexpr int kThreads = 256;          // 8 warps
constexpr int kT = 32;                 // token rows a block
constexpr int kHT = 64;                // hidden units per phase-1 tile
constexpr int kC = 64;                 // C chunk of phase 1
constexpr int kN = 128;                // output columns per phase-2 tile
constexpr int LDK = 80;                // int8 stride of a streamed weight row (64 + 16)
constexpr int kStage = 2 * kHT * LDK;  // one stage: Wa + Wg chunks, or one W2 slice
constexpr int kMaxSmem = 227 * 1024;
static_assert(kN * LDK <= kStage, "a W2 slice fits a stage");

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Dynamic shared memory of one block, in bytes: two weight stages, the
// quantized tokens sX, the int8 h group sHq, the fp32 h group sHf and three
// per-row arrays (x scales, h scales, h amax).
struct Layout {
  int ldx, ldh, ldhf;
  int off_x, off_hq, off_hf, off_stats, bytes;
};

Layout layout_of(int c, int split) {
  Layout L;
  L.ldx = round_up(c, kC) + 16;
  L.ldh = round_up(split, kHT) + 16;
  L.ldhf = round_up(split, kHT) + 4;
  L.off_x = 2 * kStage;
  L.off_hq = L.off_x + kT * L.ldx;
  L.off_hf = L.off_hq + kT * L.ldh;
  L.off_stats = L.off_hf + kT * L.ldhf * 4;
  L.bytes = L.off_stats + 3 * kT * 4;
  return L;
}

struct Plan {
  int split, splits, t_pad, c_pad;
  long long elems() const { return static_cast<long long>(splits) * t_pad * c_pad; }
};

// one block_h group per block, 32 rows
Plan plan_of(int t, int c, int h, int block_h) {
  return {block_h, (h + block_h - 1) / block_h, (t + kT - 1) / kT * kT, round_up(c, kN)};
}

__global__ void __launch_bounds__(kThreads)
geglu_q8_pt_partial_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w1,
                           const float* __restrict__ sw1, const bf16* __restrict__ b1,
                           const int8_t* __restrict__ w2, const float* __restrict__ sw2,
                           float* __restrict__ ws, int T, int C, int H, int split, int c_pad,
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

  // ---- phase 0: the row scales, then the block's tokens quantized once
  // into sX (zero past T and past C up to whole chunks)
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
  const int vpr = cp / 8;
  for (int i = threadIdx.x; i < kT * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i % vpr) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T && c < C) {
      v = *reinterpret_cast<const uint4*>(x + static_cast<long long>(t0 + r) * C + c);
    }
    *reinterpret_cast<uint2*>(sX + r * L.ldx + c) = polyp::quant_bf16x8(v, sXs[r]);
  }

  // ---- phase 1: h for hidden tile ht (64 units) of this block's group.
  // Step s covers tile s / n_c and C chunk s % n_c; its Wa and Wg chunks go
  // into stage s % 2 while step s - 1 computes. Warps: 2 row blocks of 16 ×
  // 4 column blocks.
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

  float rmax[2] = {0.f, 0.f};  // |h| max of rows g and g + 8
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
            const float s = sXs[r];
            const float av = static_cast<float>(acc_a[nt][i]) * (s * sw1[hh]) +
                             __bfloat162float(b1[hh]);
            const float gv = static_cast<float>(acc_g[nt][i]) * (s * sw1[H + hh]) +
                             __bfloat162float(b1[H + hh]);
            hv = gelu_gate(av, gv);
          }
          sHf[r * L.ldhf + hl] = hv;
          rmax[i >> 1] = fmaxf(rmax[i >> 1], fabsf(hv));
        }
      }
    }
    __syncthreads();  // this stage may be refilled
  }

  // row amax of the group → row scales → quantize the fp32 group
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

  // ---- phase 2: ws[group, t0 + r, n0 + c] = sHq @ W2q[n0.., hs0..]ᵀ ·
  // (row scale · sw2) for every output column tile n0. Step s covers column
  // tile s / n_ht and hidden tile s % n_ht. Warps: 2 row halves × 4 column
  // quarters.
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
            ws[off] = c < C ? static_cast<float>(acc[mt][nt][i]) * (sHs[r] * sw2[c]) : 0.f;
          }
        }
      }
    }
    __syncthreads();  // this stage may be refilled
  }
}

// out[t, c]: the groups' fp32 partials added in order, then b2.
__global__ void geglu_q8_pt_reduce_kernel(const float* __restrict__ ws,
                                          const bf16* __restrict__ b2, bf16* __restrict__ out,
                                          int T, int C, int splits, int c_pad,
                                          long long split_stride) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(T) * C) return;
  const int t = static_cast<int>(i / C);
  const int c = static_cast<int>(i % C);
  const long long base = static_cast<long long>(t) * c_pad + c;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += ws[base + s * split_stride];
  out[i] = __float2bfloat16(v + __bfloat162float(b2[c]));
}

}  // namespace

// Bytes of workspace the int8 GEGLU needs: the static form's h codes [T, H]
// (block_h == 0), or the per-token form's fp32 partials.
extern "C" long long polyp_geglu_w8a8_workspace(int t, int c, int h, int block_h) {
  if (block_h == 0) return static_cast<long long>(t) * h;
  return plan_of(t, c, h, block_h).elems() * 4;
}

extern "C" int polyp_geglu_w8a8(const void* x, const void* w1, const void* sw1, const void* b1,
                                const void* w2, const void* sw2, const void* b2, const void* sx,
                                const void* sh, void* ws, void* out, int t, int c, int h,
                                void* stream) {
  if (t == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* codes = static_cast<int8_t*>(ws);
  // 128-token panels (a W1 tile serves twice the tokens) where the panel
  // leaves deep rings and the panels cover a quarter of the SMs; else 64
  // (more panels, so fewer blocks quantize the same one)
  const bool wide = c <= 640 && (t + 127) / 128 * 4 >= gemm::sm_count();
  const cudaError_t err = wide ? launch_up<128>(x, w1, sw1, b1, sx, sh, codes, t, c, h, s)
                               : launch_up<64>(x, w1, sw1, b1, sx, sh, codes, t, c, h, s);
  if (err != cudaSuccess) return err;
  return polyp::geglu_q8_down(codes, w2, sw2, b2, sh, out, t, h, c, s);
}

extern "C" int polyp_geglu_w8a8_pt(const void* x, const void* w1, const void* sw1, const void* b1,
                                   const void* w2, const void* sw2, const void* b2, void* ws,
                                   void* out, int t, int c, int h, int block_h, void* stream) {
  const Plan p = plan_of(t, c, h, block_h);
  const Layout L = layout_of(c, p.split);
  if (L.bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(geglu_q8_pt_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  const long long split_stride = static_cast<long long>(p.t_pad) * p.c_pad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partials = static_cast<float*>(ws);
  geglu_q8_pt_partial_kernel<<<dim3(p.t_pad / kT, p.splits), kThreads, L.bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w1), static_cast<const float*>(sw1),
      static_cast<const bf16*>(b1), static_cast<const int8_t*>(w2), static_cast<const float*>(sw2),
      partials, t, c, h, p.split, p.c_pad, split_stride, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(t) * c;
  geglu_q8_pt_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      partials, static_cast<const bf16*>(b2), static_cast<bf16*>(out), t, c, p.splits, p.c_pad,
      split_stride);
  return cudaGetLastError();
}
