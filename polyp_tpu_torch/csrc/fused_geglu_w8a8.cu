// W8A8 fused GEGLU feed-forward for Hopper (sm_90a), in two forms:
//
//  * static: replaces polyp_tpu/ops/fused_geglu.py::fused_geglu_w8a8 (body
//    _geglu_q_kernel). x is quantized with one calibrated scale sx, h with
//    one scale sh; the second product accumulates in int32 across the
//    hidden dimension (exact: ≤ 127²·H ≈ 8e7 ≪ 2³¹) and is dequantized
//    once: out = bf16(acc * (sh * sw2[c]) + b2).
//  * per-token: replaces fused_geglu_w8a8_pt (body _geglu_q_pt_kernel).
//    Each token row t of x takes its own scale sx[t] = max(|x[t, :]|, 1e-12)
//    / 127, and h is quantized per (row, group g of block_h hidden units)
//    with sh[t, g] = max(|h[t, group g]|, 1e-12) / 127; each group's int32
//    product (≤ 127²·block_h < 2²⁴: exact in fp32) is dequantized with
//    sh[t, g]·sw2 and the groups add in fp32, in order g = 0, 1, ..., then
//    + b2, rounded once to bf16. block_h is the reference's tile (640 at
//    C = 320, 512 at 640 and 1280; ops/fused_geglu.py::block_h), whatever
//    this kernel's own tiling.
//
// Both: [a | gate] = dequant(q(x) · W1q) + b1 with per-channel weight scales
// sw1, kept in fp32 (not rounded to bf16), h = a * gelu_erf(gate) in fp32,
// then quantized to int8 for the second s8×s8→s32 product with W2q. Weights
// are in torch layout and quantized once outside (W1q [2H, C], a = rows
// 0..H-1; W2q [C, H]).
//
// What bounds it on the H100: the integer tensor cores (6·T·C·H operations:
// 80 GOP at level 0 of the distilled batch 32, 41 µs at 1,979 TOP/s) and the
// epilogue of the first product, an erf GELU and a quantize for each of the
// T·H hidden activations; its bytes in device memory are tens of MB.
//
// Each form runs in two launches of the GEMM core (gemm_core.cuh):
// * Launch 1, h codes [T, H] int8: a block owns a panel of tokens (static:
//   128, or 64 where C > 640 or the 128-token panels would cover under a
//   quarter of the SMs; per-token: 64) and a share of its hidden tiles of 64
//   units. It quantizes its panel of x once, with quant_s8_bits, into shared
//   memory in the 128-byte-swizzled K-major layout that the wgmma descriptor
//   reads (the core's A-stationary panel), so both s8 operands come from
//   shared memory (wgmma m64n64k32, s8_ss) and x is quantized once per
//   block, not once per hidden tile. Only W1q streams: the producer warp
//   brings each C chunk of rows h0.. and H+h0.. by TMA. The two consumer
//   warpgroups take alternate tiles, each from a ring of its own, so that
//   one's epilogue (the erf GELU of every hidden activation: the launch's
//   largest cost) runs while the other's products do; two s32 accumulators
//   a row block hold a and gate of the same (token, unit). The epilogue
//   dequantizes both with the tile's sw1 and b1 (fetched by cp.async while
//   the products run) and applies the erf GELU in fp32. Where the panels are
//   fewer than the SMs, a panel's hidden tiles are split over several
//   blocks, each quantizing the panel once.
//   - static (GegluQ8Up): the epilogue quantizes h with sh (no branch an
//     element: the division only for a column pair too near a tie) and
//     stages the codes in the tile's last stage for coalesced 16-byte
//     stores of int8.
//   - per-token (GegluQ8PtUp): the panel first takes each row's amax and
//     keeps sx[t] in the panel's extra room, then quantizes each row with
//     its own scale; both passes read x with eight loads in flight a
//     thread (one at a time, the panel took over a quarter of the launch
//     at C = 1280).
//     A group's amax spans 8-10 hidden tiles, which the two warpgroups take
//     in turns, and its fp32 h does not fit in shared memory beside the
//     panel and the rings (128-160 KB at 64 rows), so a block owns whole
//     groups (a panel splits over blocks by groups, the core's tile units)
//     and each block has a slot of its own in an fp32 workspace, 64 ×
//     block_h (21 MB at CFG level 0): each tile's epilogue writes its h
//     there and raises the rows' running |h| max in shared memory
//     (atomicMax on the float bits); after the group's last tile both
//     warpgroups meet (unit_end), take sh, read the slot back and quantize
//     it with quant_s8_bits (the division near a tie), storing the codes 16
//     a store and sh[t, g]. The dequantize rounds the scale product, the
//     product and the bias add apart, as the plain version does.
// * Launch 2, out from the codes: the W8A8 dense's int8-input path
//   (fused_dense.cuh). Static: GegluQ8Down, out = codes · W2qᵀ dequantized
//   with sh · sw2, + b2, K split over a cluster where its tiles are few.
//   Per-token: GegluQ8PtDown, int32 sums over one group's K chunks at a
//   time, folded into fp32 sums with sh[t, g] · sw2 at each group's end; K
//   stays whole, so the groups add in the plain version's order.
// Sums run in a fixed order, so runs repeat bit for bit. Any T; C and H
// multiples of 16; C at most 2,560 (static) or 2,432 (per-token: the panel
// and its row statistics beside two rings of two stages; the core refuses
// wider).
//
// The fp32 forms (GegluQ8UpF32 and GegluQ8DownF32; GegluQ8PtUpF32 and
// GegluQ8PtDownF32) take fp32 x, b1 and b2 and write fp32, as the TPU
// kernels do for an fp32 model (they quantize x.astype(float32) and return
// x's dtype). The int32 products, h in fp32 and its codes are the bf16
// forms': launch 1 reads its panel of x as fp32 (eight values, two 16-byte
// loads, a step: polyp::X8), and the per-token form takes each row's amax
// from fp32 loads; the panel holds codes, so its size, and the widest C,
// do not change. Launch 1 reads b1 as fp32 straight from device memory in
// its epilogue, not through the scratch (fp32 b1 there would leave the
// static form one stage at C = 2,560). Launch 2 adds an fp32 b2 and writes
// fp32. What bounds them: the same integer products and erf epilogue, and
// bytes that fp32 x and out double (at 4096×320→2560: 10.5 MB of x and
// out, 3.1 µs at 3.35 TB/s, against the products' 2.6 µs).

#include <type_traits>

#include "fused_dense.cuh"
#include "gemm_core.cuh"
#include "int8_mma.cuh"

using polyp::bf16;
namespace gemm = polyp::gemm;

namespace {

// a * gelu(gate) in fp32, gelu in its exact erf form
__device__ __forceinline__ float gelu_gate(float a, float g) {
  return a * (0.5f * g * (1.f + erff(g * 0.70710678118654752f)));
}

// Launch 1's products, shared by both forms (a GEMM core policy without its
// panel and store): BM tokens × 64 hidden units from an A-stationary panel
// of quantized x, the two consumer warpgroups on alternate tiles (each all
// BM rows, in BM / 64 wgmma row blocks) with a ring each. acc[2b] and
// acc[2b + 1] hold a and gate of row block b. X is the type of x and b1:
// bf16, or fp32 (the fp32 forms).
template <int BM, class X>
struct Q8Up : gemm::Policy {
  static constexpr int kRows = BM, kBN = 64, kRings = 2, kInFlight = 1, kBlocksPerSM = 1;
  static constexpr int kRowBlocks = BM / gemm::kWgRows;
  static constexpr int kAcc = 2 * kRowBlocks;
  static constexpr bool kF32 = std::is_same_v<X, float>;
  using Acc = int;
  static constexpr int kWBytes = kBN * gemm::kChunkBytes;       // one W1 half's chunk
  static constexpr int kStageBytes = 2 * kWBytes;                // a and gate chunks
  static constexpr int kPanelChunkBytes = BM * gemm::kChunkBytes;
  // a tile's columns of sw1 (a, gate: fp32) and, in the bf16 forms, of b1
  // (a, gate: bf16; the fp32 forms read theirs in the epilogue)
  static constexpr int kScratchBytes = kF32 ? 2 * kBN * 4 : 2 * kBN * 4 + 2 * kBN * 2;
  template <class Params>
  __device__ static void load(const Params& p, unsigned char* st, int kc, int, int n0,
                              uint64_t* bar) {
    gemm::tma_load(st, &p.w1, bar, kc * gemm::kChunkBytes, n0);
    gemm::tma_load(st + kWBytes, &p.w1, bar, kc * gemm::kChunkBytes, p.n + n0);
  }
  template <class Params>
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
  // (bf16 forms) b1 a and gate
  template <class Params>
  __device__ static void tile_begin(const Params& p, unsigned char* scratch, int n0) {
    const int tid = threadIdx.x & 127;
    if (tid < (kF32 ? 32 : 48)) {
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
  // b1 (a: part 0, gate: part 1) of the tile's columns lc, lc + 1, as fp32:
  // from the scratch (bf16 forms) or from device memory (fp32 forms), 0 past
  // H
  template <class Params>
  __device__ static float2 b1_pair(const Params& p, const unsigned char* scratch, int n0, int lc,
                                   int part) {
    if constexpr (kF32) {
      return n0 + lc < p.n ? __ldg(reinterpret_cast<const float2*>(p.b1 + part * p.n + n0 + lc))
                           : make_float2(0.f, 0.f);
    } else {
      return polyp::load_pair(reinterpret_cast<const bf16*>(scratch + 2 * kBN * 4) +
                              part * kBN + lc);
    }
  }
};

// Launch 1 of the static form, a GEMM core policy: the codes of h for BM
// tokens × 64 hidden units, from x and b1 of type X.
template <int BM, class X>
struct GegluQ8UpT : Q8Up<BM, X> {
  using Base = Q8Up<BM, X>;
  using Base::kBN;
  using Base::kPanelChunkBytes;
  using Base::kRowBlocks;
  using Base::kStageBytes;
  static constexpr int kLd = kBN + 16;  // a staged code row
  static_assert(BM * kLd <= kStageBytes, "the staged codes take the tile's last stage");
  struct Params {
    CUtensorMap w1;  // W1q [2H, C] int8, boxes of [64 rows][128 B]
    const X* x;      // [T, C]
    const float* sw1;
    const X* b1;
    const float* sx;
    const float* sh;
    int8_t* out;    // codes [T, H]
    int m, n, n_k;  // T, H, C chunks
    int c;
  };
  // the panel, quantized once by both warpgroups: 8 codes a thread a step
  // from one 16-byte load of x; zeros past T and past C up to whole chunks
  __device__ static void panel(const Params& p, unsigned char* dst, int m0) {
    const float sx = *p.sx;
    const float inv_x = 1.f / sx;
    const int vecs = p.n_k * (gemm::kChunkBytes / 8);  // 8-code vectors a row
    for (int v = threadIdx.x; v < BM * vecs; v += gemm::consumers<GegluQ8UpT>()) {
      const int r = v / vecs;
      const int col = (v % vecs) * 8;
      uint2 codes = make_uint2(0u, 0u);
      if (m0 + r < p.m && col < p.c) {
        codes = polyp::X8<X>::load(p.x + static_cast<long long>(m0 + r) * p.c + col)
                    .codes(sx, inv_x);
      }
      *reinterpret_cast<uint2*>(dst + (col / gemm::kChunkBytes) * kPanelChunkBytes +
                                gemm::swizzle128(r, col % gemm::kChunkBytes)) = codes;
    }
  }
  // h codes of columns n0 + 8jj + c, +1 (0 past H) at rows 64b + r, +8,
  // staged, then copied out 16 codes a store (rows past T and columns past
  // H, a multiple of 16, left out). Codes come from
  // quant_s8_bits, with no branch an element; where one of a column pair's
  // values lies too near a tie (rare), the pair's codes are made again
  // through the division
  __device__ static void store(const Params& p, int (&acc)[Base::kAcc][kBN / 2],
                               unsigned char* staged, const unsigned char* scratch,
                               unsigned char*, int m0, int n0) {
    const float* p_sa = reinterpret_cast<const float*>(scratch);
    const float* p_sg = p_sa + kBN;
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
    gemm::tile_sync<GegluQ8UpT>();
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj) {
      const int lc = 8 * jj + c;  // the tile's column
      const bool in = n0 + lc < p.n;
      const float2 sa = *reinterpret_cast<const float2*>(p_sa + lc);
      const float2 sg = *reinterpret_cast<const float2*>(p_sg + lc);
      const float2 ba = Base::b1_pair(p, scratch, n0, lc, 0);
      const float2 bg = Base::b1_pair(p, scratch, n0, lc, 1);
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
    gemm::tile_sync<GegluQ8UpT>();
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
struct GegluQ8Up : GegluQ8UpT<BM, bf16> {};
template <int BM>
struct GegluQ8UpF32 : GegluQ8UpT<BM, float> {};

template <class P>
cudaError_t launch_up(const void* x, const void* w1, const void* sw1, const void* b1,
                      const void* sx, const void* sh, int8_t* h, int t, int c, int hidden,
                      cudaStream_t stream) {
  using X = std::remove_cv_t<std::remove_pointer_t<decltype(P::Params::x)>>;
  typename P::Params p{};
  const cudaError_t err = gemm::weight_map(&p.w1, w1, true, 2LL * hidden, c, P::kBN);
  if (err != cudaSuccess) return err;
  p.x = static_cast<const X*>(x);
  p.sw1 = static_cast<const float*>(sw1);
  p.b1 = static_cast<const X*>(b1);
  p.sx = static_cast<const float*>(sx);
  p.sh = static_cast<const float*>(sh);
  p.out = h;
  p.m = t;
  p.n = hidden;
  p.n_k = (c + gemm::kChunkBytes - 1) / gemm::kChunkBytes;
  p.c = c;
  return gemm::launch<P>(p, stream);
}

// Launch 1 of the per-token form, a GEMM core policy: the codes of h and
// the group scales sh for BM tokens, a block's hidden tiles in whole groups
// (the core's units), from x and b1 of type X. The panel's extra room holds
// three rows of BM values: sx, the running |h| max of the group (float
// bits) and the group's sh.
template <int BM, class X>
struct GegluQ8PtUpT : Q8Up<BM, X> {
  using Base = Q8Up<BM, X>;
  using Base::kBN;
  using Base::kPanelChunkBytes;
  using Base::kRowBlocks;
  static constexpr bool kUnits = true;
  static constexpr int kPanelExtraBytes = 3 * BM * 4;
  static constexpr int kThreads = gemm::consumers<Base>();
  // a barrier of both consumer warpgroups (the id of the core's panel one)
  static constexpr int kBarrier = Base::kRings + 1;
  struct Params {
    CUtensorMap w1;  // W1q [2H, C] int8, boxes of [64 rows][128 B]
    const X* x;      // [T, C]
    const float* sw1;
    const X* b1;
    int8_t* out;    // codes [T, H]
    float* sh;      // [T, groups]
    float* slots;   // a block's fp32 h of one group: [blocks][BM][block_h]
    int m, n, n_k;  // T, H, C chunks
    int c, block_h, groups;
  };
  // a group's hidden tiles (block_h is a multiple of 128, or H itself)
  __host__ __device__ static int tile_unit(const Params& p) { return (p.block_h + kBN - 1) / kBN; }
  __device__ static float* row_scales(unsigned char* extra) {
    return reinterpret_cast<float*>(extra);
  }
  __device__ static unsigned* row_max(unsigned char* extra) {
    return reinterpret_cast<unsigned*>(extra + BM * 4);
  }
  __device__ static float* group_scales(unsigned char* extra) {
    return reinterpret_cast<float*>(extra + 2 * BM * 4);
  }
  __device__ static float* slot(const Params& p) {
    return p.slots + static_cast<long long>(blockIdx.x) * BM * p.block_h;
  }
  // the row scales, then the panel quantized with them. Each pass is
  // latency-bound (x is read from L2, 16 bytes a load), so every thread
  // issues kBatch independent loads of eight values (one 16-byte load of
  // bf16, two of fp32) before it uses any: four threads a row for the amax
  // (rows past T take 1e-12 / 127), then the codes 8 a vector (zeros past T
  // and past C up to whole chunks)
  __device__ static void panel(const Params& p, unsigned char* dst, int m0) {
    constexpr int kBatch = 8;
    static_assert(kThreads == 4 * BM, "four threads a row");
    unsigned char* extra = dst + p.n_k * kPanelChunkBytes;
    float* sx = row_scales(extra);
    unsigned* amax = row_max(extra);
    const int x_vecs = p.c / 8;  // 8-element vectors a row of x
    {
      const int r = threadIdx.x / 4, part = threadIdx.x % 4;
      const X* row = p.x + static_cast<long long>(m0 + r) * p.c;
      const bool live = m0 + r < p.m;
      float m = 0.f;
      for (int v0 = part; v0 < x_vecs; v0 += 4 * kBatch) {
        polyp::X8<X> raw[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int v = v0 + 4 * u;
          raw[u] = live && v < x_vecs ? polyp::X8<X>::load(row + v * 8) : polyp::X8<X>::zero();
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) m = fmaxf(m, raw[u].absmax());
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (part == 0) {
        sx[r] = fmaxf(m, 1e-12f) / 127.f;
        amax[r] = 0u;
      }
    }
    gemm::named_sync(kBarrier, kThreads);
    const int vecs = p.n_k * (gemm::kChunkBytes / 8);  // 8-code vectors a panel row
    for (int v0 = threadIdx.x; v0 < BM * vecs; v0 += kBatch * kThreads) {
      polyp::X8<X> raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int v = v0 + u * kThreads;
        const int r = v / vecs, col = (v % vecs) * 8;
        const X* src = p.x + static_cast<long long>(m0 + r) * p.c + col;
        raw[u] = v < BM * vecs && m0 + r < p.m && col < p.c ? polyp::X8<X>::load(src)
                                                             : polyp::X8<X>::zero();
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int v = v0 + u * kThreads;
        if (v >= BM * vecs) break;
        const int r = v / vecs, col = (v % vecs) * 8;
        const float s = sx[r];
        *reinterpret_cast<uint2*>(dst + (col / gemm::kChunkBytes) * kPanelChunkBytes +
                                  gemm::swizzle128(r, col % gemm::kChunkBytes)) =
            col < p.c ? raw[u].codes(s, 1.f / s) : make_uint2(0u, 0u);
      }
    }
  }
  // h of columns n0 + 8jj + c, +1 at rows 64b + r, +8 into the block's slot
  // (columns past H left out, a multiple of 16), and the rows' |h| max
  // raised in shared memory
  __device__ static void store(const Params& p, int (&acc)[Base::kAcc][kBN / 2], unsigned char*,
                               const unsigned char* scratch, unsigned char* extra, int,
                               int n0) {
    const float* p_sa = reinterpret_cast<const float*>(scratch);
    const float* p_sg = p_sa + kBN;
    const float* sx = row_scales(extra);
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r = (tid >> 5) * 16 + (lane >> 2);
    const int c = (lane & 3) * 2;
    float* h = slot(p) + (n0 - n0 / p.block_h * p.block_h);  // the tile's first column
    // the scratch has landed for every thread of the warpgroup
    polyp::cp_async_wait<0>();
    gemm::tile_sync<GegluQ8PtUpT>();
    float rmax[kRowBlocks][2] = {};
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj) {
      const int lc = 8 * jj + c;  // the tile's column
      if (n0 + lc >= p.n) continue;
      const float2 sa = *reinterpret_cast<const float2*>(p_sa + lc);
      const float2 sg = *reinterpret_cast<const float2*>(p_sg + lc);
      const float2 ba = Base::b1_pair(p, scratch, n0, lc, 0);
      const float2 bg = Base::b1_pair(p, scratch, n0, lc, 1);
      const float wa[2] = {sa.x, sa.y}, wg[2] = {sg.x, sg.y};
      const float ab[2] = {ba.x, ba.y}, gb[2] = {bg.x, bg.y};
#pragma unroll
      for (int b = 0; b < kRowBlocks; ++b) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 64 * b + r + 8 * half;
          const float s = sx[row];
          float hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * half + e;
            const float a = __fadd_rn(
                __fmul_rn(static_cast<float>(acc[2 * b][idx]), __fmul_rn(s, wa[e])), ab[e]);
            const float g = __fadd_rn(
                __fmul_rn(static_cast<float>(acc[2 * b + 1][idx]), __fmul_rn(s, wg[e])), gb[e]);
            hv[e] = gelu_gate(a, g);
          }
          *reinterpret_cast<float2*>(h + static_cast<long long>(row) * p.block_h + lc) =
              make_float2(hv[0], hv[1]);
          rmax[b][half] = fmaxf(rmax[b][half], fmaxf(fabsf(hv[0]), fabsf(hv[1])));
        }
      }
    }
    unsigned* amax = row_max(extra);
#pragma unroll
    for (int b = 0; b < kRowBlocks; ++b) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float m = rmax[b][half];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if ((lane & 3) == 0) atomicMax(&amax[64 * b + r + 8 * half], __float_as_uint(m));
      }
    }
  }
  // after group g's last tile, both warpgroups: sh from the rows' max, then
  // the slot read back and quantized, 16 codes a thread a step
  __device__ static void unit_end(const Params& p, unsigned char* extra, int m0, int g) {
    unsigned* amax = row_max(extra);
    float* sh = group_scales(extra);
    __threadfence_block();
    gemm::named_sync(kBarrier, kThreads);  // the group's h and maxima are complete
    if (threadIdx.x < BM) {
      const int r = threadIdx.x;
      const float s = fmaxf(__uint_as_float(amax[r]), 1e-12f) / 127.f;
      sh[r] = s;
      amax[r] = 0u;
      if (m0 + r < p.m) p.sh[static_cast<long long>(m0 + r) * p.groups + g] = s;
    }
    gemm::named_sync(kBarrier, kThreads);  // sh is set, the maxima restart
    const float* h = slot(p);
    const int vecs = p.block_h / 16;
    for (int v = threadIdx.x; v < BM * vecs; v += kThreads) {
      const int r = v / vecs;
      const int col = (v % vecs) * 16;
      if (m0 + r >= p.m) continue;
      const float s = sh[r];
      const float inv = 1.f / s;
      const float4* src =
          reinterpret_cast<const float4*>(h + static_cast<long long>(r) * p.block_h + col);
      float e[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 f = src[i];
        e[4 * i] = f.x;
        e[4 * i + 1] = f.y;
        e[4 * i + 2] = f.z;
        e[4 * i + 3] = f.w;
      }
      uint32_t q[16];
      bool near = false;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        bool tie;
        q[i] = polyp::quant_s8_bits(e[i], inv, &tie);
        near |= tie;
      }
      if (near) {
#pragma unroll
        for (int i = 0; i < 16; ++i) q[i] = static_cast<uint32_t>(polyp::quant_s8(e[i], s));
      }
      *reinterpret_cast<uint4*>(p.out + static_cast<long long>(m0 + r) * p.n + g * p.block_h +
                                col) =
          make_uint4(polyp::pack_low_bytes(q[0], q[1], q[2], q[3]),
                     polyp::pack_low_bytes(q[4], q[5], q[6], q[7]),
                     polyp::pack_low_bytes(q[8], q[9], q[10], q[11]),
                     polyp::pack_low_bytes(q[12], q[13], q[14], q[15]));
    }
    gemm::named_sync(kBarrier, kThreads);  // the slot is read before the next group's h
  }
};

template <int BM>
struct GegluQ8PtUp : GegluQ8PtUpT<BM, bf16> {};
template <int BM>
struct GegluQ8PtUpF32 : GegluQ8PtUpT<BM, float> {};

using PtUp = GegluQ8PtUp<64>;
using PtUpF32 = GegluQ8PtUpF32<64>;

// The per-token form's workspace, in bytes: the codes [T, H] int8, sh
// [T, H / block_h] fp32 and launch 1's slots, one a block (each offset a
// multiple of 16). The fp32 form's plan has the same blocks.
struct PtWorkspace {
  long long sh, slots, bytes;
};

PtWorkspace pt_workspace(int t, int c, int h, int block_h) {
  const int n_k = (c + gemm::kChunkBytes - 1) / gemm::kChunkBytes;
  const int unit = (block_h + PtUp::kBN - 1) / PtUp::kBN;
  const gemm::Plan pl = gemm::plan<PtUp>(t, h, n_k, unit);
  PtWorkspace w;
  w.sh = (static_cast<long long>(t) * h + 15) / 16 * 16;
  w.slots = w.sh + (static_cast<long long>(t) * (h / block_h) * 4 + 15) / 16 * 16;
  w.bytes = w.slots + static_cast<long long>(pl.blocks) * PtUp::kRows * block_h * 4;
  return w;
}

bool pt_shape_ok(int h, int block_h) {
  return block_h > 0 && block_h % 16 == 0 && h % block_h == 0;
}

// Both launches of the static form, x and the biases of type X.
template <class X>
int geglu_w8a8(const void* x, const void* w1, const void* sw1, const void* b1, const void* w2,
               const void* sw2, const void* b2, const void* sx, const void* sh, void* ws,
               void* out, int t, int c, int h, cudaStream_t s) {
  constexpr bool kF32 = std::is_same_v<X, float>;
  using Wide = std::conditional_t<kF32, GegluQ8UpF32<128>, GegluQ8Up<128>>;
  using Narrow = std::conditional_t<kF32, GegluQ8UpF32<64>, GegluQ8Up<64>>;
  if (t == 0) return cudaSuccess;
  int8_t* codes = static_cast<int8_t*>(ws);
  // 128-token panels (a W1 tile serves twice the tokens) where the panel
  // leaves deep rings and the panels cover a quarter of the SMs; else 64
  // (more panels, so fewer blocks quantize the same one)
  const bool wide = c <= 640 && (t + 127) / 128 * 4 >= gemm::sm_count();
  const cudaError_t err = wide ? launch_up<Wide>(x, w1, sw1, b1, sx, sh, codes, t, c, h, s)
                               : launch_up<Narrow>(x, w1, sw1, b1, sx, sh, codes, t, c, h, s);
  if (err != cudaSuccess) return err;
  return polyp::geglu_q8_down(codes, w2, sw2, b2, sh, out, t, h, c, kF32, s);
}

// Launch 1 of the per-token form alone, x and b1 of type X.
template <class P>
int geglu_w8a8_pt_up(const void* x, const void* w1, const void* sw1, const void* b1, void* ws,
                     int t, int c, int h, int block_h, cudaStream_t stream) {
  using X = std::remove_cv_t<std::remove_pointer_t<decltype(P::Params::x)>>;
  if (!pt_shape_ok(h, block_h)) return cudaErrorInvalidValue;
  if (t == 0) return cudaSuccess;
  const PtWorkspace w = pt_workspace(t, c, h, block_h);
  typename P::Params p{};
  const cudaError_t err = gemm::weight_map(&p.w1, w1, true, 2LL * h, c, P::kBN);
  if (err != cudaSuccess) return err;
  unsigned char* base = static_cast<unsigned char*>(ws);
  p.x = static_cast<const X*>(x);
  p.sw1 = static_cast<const float*>(sw1);
  p.b1 = static_cast<const X*>(b1);
  p.out = static_cast<int8_t*>(ws);
  p.sh = reinterpret_cast<float*>(base + w.sh);
  p.slots = reinterpret_cast<float*>(base + w.slots);
  p.m = t;
  p.n = h;
  p.n_k = (c + gemm::kChunkBytes - 1) / gemm::kChunkBytes;
  p.c = c;
  p.block_h = block_h;
  p.groups = h / block_h;
  return gemm::launch<P>(p, stream);
}

// Both launches of the per-token form, x and the biases of type X.
template <class P>
int geglu_w8a8_pt(const void* x, const void* w1, const void* sw1, const void* b1, const void* w2,
                  const void* sw2, const void* b2, void* ws, void* out, int t, int c, int h,
                  int block_h, cudaStream_t stream) {
  using X = std::remove_cv_t<std::remove_pointer_t<decltype(P::Params::x)>>;
  const cudaError_t err = static_cast<cudaError_t>(
      geglu_w8a8_pt_up<P>(x, w1, sw1, b1, ws, t, c, h, block_h, stream));
  if (err != cudaSuccess || t == 0) return err;
  unsigned char* base = static_cast<unsigned char*>(ws);
  return polyp::geglu_q8_pt_down(base, base + pt_workspace(t, c, h, block_h).sh, w2, sw2, b2, out,
                                 t, h, c, block_h, std::is_same_v<X, float>, stream);
}

}  // namespace

// Bytes of workspace the int8 GEGLU needs: the static form's h codes [T, H]
// (block_h == 0), or the per-token form's codes, group scales and slots
// (0 for a block_h it cannot take). The same for both dtypes.
extern "C" long long polyp_geglu_w8a8_workspace(int t, int c, int h, int block_h) {
  if (block_h == 0) return static_cast<long long>(t) * h;
  return pt_shape_ok(h, block_h) ? pt_workspace(t, c, h, block_h).bytes : 0;
}

extern "C" int polyp_geglu_w8a8(const void* x, const void* w1, const void* sw1, const void* b1,
                                const void* w2, const void* sw2, const void* b2, const void* sx,
                                const void* sh, void* ws, void* out, int t, int c, int h,
                                void* stream) {
  return geglu_w8a8<bf16>(x, w1, sw1, b1, w2, sw2, b2, sx, sh, ws, out, t, c, h,
                          static_cast<cudaStream_t>(stream));
}

// The static form's fp32 form: fp32 x, b1, b2 and out; the h codes at the
// workspace's start, as in the bf16 form.
extern "C" int polyp_geglu_w8a8_f32(const void* x, const void* w1, const void* sw1,
                                    const void* b1, const void* w2, const void* sw2,
                                    const void* b2, const void* sx, const void* sh, void* ws,
                                    void* out, int t, int c, int h, void* stream) {
  return geglu_w8a8<float>(x, w1, sw1, b1, w2, sw2, b2, sx, sh, ws, out, t, c, h,
                           static_cast<cudaStream_t>(stream));
}

// Launch 1 of the per-token form alone: the codes at the workspace's start
// ([T, H] int8) and sh after them ([T, H / block_h] fp32, at the first
// multiple of 16 bytes past T·H).
extern "C" int polyp_geglu_w8a8_pt_up(const void* x, const void* w1, const void* sw1,
                                      const void* b1, void* ws, int t, int c, int h, int block_h,
                                      void* stream) {
  return geglu_w8a8_pt_up<PtUp>(x, w1, sw1, b1, ws, t, c, h, block_h,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int polyp_geglu_w8a8_pt(const void* x, const void* w1, const void* sw1, const void* b1,
                                   const void* w2, const void* sw2, const void* b2, void* ws,
                                   void* out, int t, int c, int h, int block_h, void* stream) {
  return geglu_w8a8_pt<PtUp>(x, w1, sw1, b1, w2, sw2, b2, ws, out, t, c, h, block_h,
                             static_cast<cudaStream_t>(stream));
}

// The per-token form's fp32 form: fp32 x, b1, b2 and out; the codes and sh
// in the workspace as in the bf16 form.
extern "C" int polyp_geglu_w8a8_pt_f32(const void* x, const void* w1, const void* sw1,
                                       const void* b1, const void* w2, const void* sw2,
                                       const void* b2, void* ws, void* out, int t, int c, int h,
                                       int block_h, void* stream) {
  return geglu_w8a8_pt<PtUpF32>(x, w1, sw1, b1, w2, sw2, b2, ws, out, t, c, h, block_h,
                                static_cast<cudaStream_t>(stream));
}
