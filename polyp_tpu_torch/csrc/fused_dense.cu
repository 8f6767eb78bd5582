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
// into the product and never stored as int8 in device memory, and the
// dequantize and bias run in the epilogue.
//
// What bounds it on the H100: bytes, the quantize, and latency. At SD widths
// a call does at most a few GOP of int8 (a few µs of the card's 1,979
// TOP/s) against its bf16 activations in and out (to_q at the distilled
// batch 32: 42 MB, 12.5 µs at 3.35 TB/s), quantizes every activation once
// for each 160-column tile, and at the CFG batch's small M is a handful of
// tiles. The earlier mma.sync kernel paid one memory latency for each of
// its 5-20 K chunks in series. Design: the GEMM core (gemm_core.cuh), 64 rows × 160
// (O = 320, 640, 1280), 128 or 64 columns a tile, two blocks an SM. TMA
// brings the bf16 (or int8) activation chunk and the int8 weight chunk
// into the ring, which streams the chunks behind one latency. The consumer
// warpgroup builds wgmma's 8-bit A fragment in registers straight from the
// bf16 tile: each thread reads its own 4-element groups from the swizzled
// tile, quantizes them with quant_s8_bits (a multiply and adds on the ALU,
// not the division and the conversion unit; bit-equal to quant_s8 and
// torch.round, the division itself taken for the rare value near a tie)
// and packs four codes a register, with no int8 copy of the tile; B (the
// weight) comes from shared memory by descriptor, as m64nNk32 s8 requires
// both K-major. An int8 x is an ordinary TMA tile read into the same
// fragment. K is split over a cluster where the tiles are few. Any M; C a
// multiple of 16 and O of 8.

#include "fused_dense.cuh"
#include "gemm_core.cuh"
#include "int8_mma.cuh"

using polyp::bf16;
namespace gemm = polyp::gemm;

namespace {

constexpr int kChunk = gemm::kChunkBytes;  // int8 K chunk (128 elements)
constexpr int kBox = gemm::kWgRows * gemm::kChunkBytes;  // one [64 rows][128 B] box

// The four bf16 elements 32(s%2) + 16h + 4t .. +3 of row r + 8rr (j = 2h +
// rr) of a [64 rows][64] bf16 box: one 8-byte load from the swizzled tile.
__device__ __forceinline__ uint2 raw_of(const unsigned char* box, int r, int s, int j, int t) {
  return *reinterpret_cast<const uint2*>(
      box + gemm::swizzle128(r + 8 * (j & 1), (s & 1) * 64 + (j >> 1) * 32 + t * 8));
}

template <int BN, bool kQuantX_>
struct Dense : gemm::Policy {
  static constexpr bool kQuantX = kQuantX_;
  static constexpr int kRows = gemm::kWgRows, kBN = BN, kAcc = 1, kInFlight = 0;
  static constexpr int kBlocksPerSM = 2;
  using Acc = int;
  // A: two bf16 boxes of 64 elements (quantized here) or one int8 box
  static constexpr int kABytes = kQuantX ? 2 * kBox : kBox;
  static constexpr int kStageBytes = kABytes + BN * gemm::kChunkBytes;
  struct Params {
    CUtensorMap x, w;
    const float* sw;
    const bf16* bias;  // or null
    const float* sx;
    bf16* out;
    int m, n, n_k;  // M, O, C chunks
  };
  __device__ static void load(const Params& p, unsigned char* st, int kc, int m0, int n0,
                              uint64_t* bar) {
    gemm::tma_load(st, &p.x, bar, kc * kChunk, m0);
    if constexpr (kQuantX) gemm::tma_load(st + kBox, &p.x, bar, kc * kChunk + kChunk / 2, m0);
    gemm::tma_load(st + kABytes, &p.w, bar, kc * kChunk, n0);
  }
  __device__ static void mma(const Params& p, unsigned char* st, int (&acc)[1][BN / 2]) {
    const int lane = threadIdx.x & 31;
    const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);  // rows r and r + 8
    const int t = lane & 3;
    // a[s][2h + rr]: k32 step s, k half h (+16), row r + 8·rr
    uint32_t a[4][4];
    if constexpr (kQuantX) {
      const float sx = *p.sx;
      const float inv = 1.f / sx;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const unsigned char* box = st + (s >> 1) * kBox;  // elements 0-63, 64-127
        bool near = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // j = 2h + rr
          const uint2 raw = raw_of(box, r, s, j, t);
          const bf16* e = reinterpret_cast<const bf16*>(&raw);
          uint32_t q[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            bool tie;
            q[i] = polyp::quant_s8_bits(__bfloat162float(e[i]), inv, &tie);
            near |= tie;
          }
          a[s][j] = polyp::pack_low_bytes(q[0], q[1], q[2], q[3]);
        }
        if (near) {  // rare: the division itself where the product is too near a tie
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint2 raw = raw_of(box, r, s, j, t);
            const bf16* e = reinterpret_cast<const bf16*>(&raw);
            a[s][j] = polyp::pack_s8x4(polyp::quant_s8(__bfloat162float(e[0]), sx),
                                       polyp::quant_s8(__bfloat162float(e[1]), sx),
                                       polyp::quant_s8(__bfloat162float(e[2]), sx),
                                       polyp::quant_s8(__bfloat162float(e[3]), sx));
          }
        }
      }
    } else {
      codes_of(st, r, t, a);
    }
    gemm::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      gemm::Wgmma<BN>::s8_rs(acc[0], a[s], gemm::smem_desc(st + kABytes + s * 32), 1);
    }
    gemm::wgmma_commit();
  }
  // wgmma's 8-bit A fragments of rows r and r + 8 of an int8 box, all four
  // k32 steps: a[s][2h + rr] holds row r + 8·rr, k 32s + 16h + 4t .. +3
  __device__ static void codes_of(const unsigned char* box, int r, int t, uint32_t (&a)[4][4]) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          a[s][2 * h + rr] = *reinterpret_cast<const uint32_t*>(
              box + gemm::swizzle128(r + 8 * rr, s * 32 + h * 16 + t * 4));
        }
      }
    }
  }
  __device__ static __nv_bfloat162 epilogue(const Params& p, int col, const int (&v)[1][2]) {
    const float sx = *p.sx;
    const float2 sw = *reinterpret_cast<const float2*>(p.sw + col);
    const float2 b = p.bias ? __bfloat1622float2(
                                  *reinterpret_cast<const __nv_bfloat162*>(p.bias + col))
                            : make_float2(0.f, 0.f);
    return __floats2bfloat162_rn(static_cast<float>(v[0][0]) * (sx * sw.x) + b.x,
                                 static_cast<float>(v[0][1]) * (sx * sw.y) + b.y);
  }
};

// The static int8 GEGLU's second product: the int8-input dense under a
// name of its own, so that a profile tells its launches from the dense's.
template <int BN>
struct GegluQ8Down : Dense<BN, false> {};

// The per-token int8 GEGLU's second product, out = Σ_g float(codes_g ·
// W2q_gᵀ) · (sh[t, g] · sw2[n]) + b2 over the hidden groups g of
// `group_chunks` K chunks (block_h / 128: every group boundary is a chunk
// boundary, or there is one group): the int8-input dense's loads and
// products, whose int32 sums (acc[0]) cover one group only. At each group's
// last chunk, chunk_done folds them into fp32 sums (acc[1], kept as float
// bits in the core's int accumulators) in the plain version's order and
// roundings — the scale product, the product, the add, no FMA — and
// restarts them; K stays whole (kGroupedK), so the groups add in order g = 0,
// 1, ... and, given the same codes and scales, the output equals the plain
// version's bit for bit. The epilogue adds b2 and rounds once to bf16.
template <int BN>
struct GegluQ8PtDown : Dense<BN, false> {
  using Base = Dense<BN, false>;
  static constexpr int kAcc = 2;
  static constexpr bool kGroupedK = true;
  struct Params : Base::Params {
    const float* sh;  // [m, groups]
    int groups, group_chunks;
  };
  __device__ static void mma(const Params& p, unsigned char* st, int (&acc)[2][BN / 2]) {
    const int lane = threadIdx.x & 31;
    uint32_t a[4][4];
    Base::codes_of(st, (threadIdx.x >> 5) * 16 + (lane >> 2), lane & 3, a);
    gemm::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      gemm::Wgmma<BN>::s8_rs(acc[0], a[s], gemm::smem_desc(st + Base::kABytes + s * 32), 1);
    }
    gemm::wgmma_commit();
  }
  __device__ static void chunk_done(const Params& p, int kc, int m0, int n0,
                                    int (&acc)[2][BN / 2]) {
    if ((kc + 1) % p.group_chunks != 0 && kc + 1 != p.n_k) return;
    gemm::fence_regs(acc[0]);  // the group's products have completed
    const int g = kc / p.group_chunks;
    const int lane = threadIdx.x & 31;
    const int r = m0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const int c = (lane & 3) * 2;
    float sh[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r + 8 * half;
      sh[half] = row < p.m ? p.sh[static_cast<long long>(row) * p.groups + g] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + c;
      const float2 sw = col < p.n ? *reinterpret_cast<const float2*>(p.sw + col)
                                  : make_float2(0.f, 0.f);
      const float swe[2] = {sw.x, sw.y};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * half + e;
          const float part =
              __fmul_rn(static_cast<float>(acc[0][idx]), __fmul_rn(sh[half], swe[e]));
          acc[1][idx] = __float_as_int(__fadd_rn(__int_as_float(acc[1][idx]), part));
          acc[0][idx] = 0;
        }
      }
    }
  }
  __device__ static __nv_bfloat162 epilogue(const Params& p, int col, const int (&v)[2][2]) {
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bias + col));
    return __floats2bfloat162_rn(__fadd_rn(__int_as_float(v[1][0]), b.x),
                                 __fadd_rn(__int_as_float(v[1][1]), b.y));
  }
};

template <int BN>
cudaError_t launch_pt_down(const void* codes, const void* sh, const void* w, const void* sw,
                           const void* bias, void* out, int m, int h, int o, int block_h,
                           cudaStream_t stream) {
  using P = GegluQ8PtDown<BN>;
  typename P::Params p{};
  cudaError_t err = gemm::encode_map(&p.x, codes, true, m, h, gemm::kWgRows);
  if (err == cudaSuccess) err = gemm::weight_map(&p.w, w, true, o, h, BN);
  if (err != cudaSuccess) return err;
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const bf16*>(bias);
  p.out = static_cast<bf16*>(out);
  p.m = m;
  p.n = o;
  p.n_k = (h + kChunk - 1) / kChunk;
  p.sh = static_cast<const float*>(sh);
  p.groups = h / block_h;
  p.group_chunks = (block_h + kChunk - 1) / kChunk;
  return gemm::launch<P>(p, stream);
}

template <int BN>
using DenseBf16 = Dense<BN, true>;
template <int BN>
using DenseInt8 = Dense<BN, false>;

template <class P>
cudaError_t launch_dense(const void* x, const void* w, const void* sw, const void* bias,
                         const void* sx, void* out, int m, int c, int o, cudaStream_t stream) {
  typename P::Params p{};
  cudaError_t err = gemm::encode_map(&p.x, x, !P::kQuantX, m, c, gemm::kWgRows);
  if (err == cudaSuccess) err = gemm::weight_map(&p.w, w, true, o, c, P::kBN);
  if (err != cudaSuccess) return err;
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const bf16*>(bias);
  p.sx = static_cast<const float*>(sx);
  p.out = static_cast<bf16*>(out);
  p.m = m;
  p.n = o;
  p.n_k = (c + kChunk - 1) / kChunk;
  return gemm::launch<P>(p, stream);
}

template <template <int> class D>
cudaError_t dispatch(const void* x, const void* w, const void* sw, const void* bias,
                     const void* sx, void* out, int m, int c, int o, cudaStream_t stream) {
  switch (gemm::pick_width(o)) {
    case 160:
      return launch_dense<D<160>>(x, w, sw, bias, sx, out, m, c, o, stream);
    case 128:
      return launch_dense<D<128>>(x, w, sw, bias, sx, out, m, c, o, stream);
    default:
      return launch_dense<D<64>>(x, w, sw, bias, sx, out, m, c, o, stream);
  }
}

}  // namespace

cudaError_t polyp::geglu_q8_down(const void* x, const void* w, const void* sw, const void* bias,
                                 const void* sx, void* out, int m, int c, int o,
                                 cudaStream_t stream) {
  return dispatch<GegluQ8Down>(x, w, sw, bias, sx, out, m, c, o, stream);
}

cudaError_t polyp::geglu_q8_pt_down(const void* codes, const void* sh, const void* w,
                                    const void* sw, const void* bias, void* out, int m, int h,
                                    int o, int block_h, cudaStream_t stream) {
  // 64 columns a tile: with K whole, the tiles alone fill the SMs, and at
  // 128 the fp32 sums beside the int32 ones spill at the register cap
  return launch_pt_down<64>(codes, sh, w, sw, bias, out, m, h, o, block_h, stream);
}

extern "C" int polyp_w8a8_dense(const void* x, int x_is_int8, const void* w, const void* sw,
                                const void* bias, const void* sx, void* out, int m, int c, int o,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_int8 ? dispatch<DenseInt8>(x, w, sw, bias, sx, out, m, c, o, s)
                   : dispatch<DenseBf16>(x, w, sw, bias, sx, out, m, c, o, s);
}
