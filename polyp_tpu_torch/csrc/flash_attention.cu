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
// fp32 form (polyp_flash_attention_f32_fwd, namespace f32): replaces the same
// Pallas kernel (polyp_tpu/ops/flash_attention.py::_flash_impl, :185) for
// fp32 q, k, v, which it takes as well, keeping p in fp32 for fp32 v
// (:84-85); an fp32 model (an SD UNet loaded in fp32, run without autograd)
// takes this form. It computes what the bf16 form does: fp32 scores, the
// online softmax in exp2 of log2-scaled scores (attention_core.cuh's, max
// in raw scores), p kept in fp32, the T x T matrix never in device memory,
// any Tq and Tk (ragged tiles masked), d = 40, 64, 80, 128, 160.
//
// Products on the tensor cores in 3xTF32: each operand split into a tf32
// big part and a tf32 remainder, big·big + big·small + small·big, small
// terms first, summed in fp32 (mma.sync m16n8k8). One tf32 product keeps 10
// mantissa bits, about 5e-4 of a product: emulated on the CPU its output is
// 3.8e-4 of max |y| from float64 at [128 x 256, d = 40] against 3.2e-7 in
// 3xTF32 (tests/test_torch_port_flash_f32.py), and the check is 1e-4.
// What bounds it: 4·N·H·T²·D operations (2.7 GFLOP at [2, 1024, 8, 40]) at
// 495 / 3 = 165 TFLOP/s, its 3xTF32 ceiling (16 us there), beside the 67
// TFLOP/s fp32 rate of the CUDA cores (40 us); on this card mma.sync's tf32
// rate peaks at 299 TFLOP/s (tools/mma_rate.py), so about 100 in 3xTF32.
//
// Plan (PERF.md §6 has the ones it was timed against): a block owns 64 query
// rows of one (n, h) and streams 64-key K/V tiles through two cp.async
// stages, rows padded to d + 4 floats. Its warps are two key groups (each
// takes 32 keys of every tile; their states are added at the end through
// shared memory, group 0's then group 1's, so a run repeats bit for bit)
// times the row warps: at d <= 80 two warps of two 16-row tiles each (128
// threads; every K and V fragment read and split feeds both tiles), at d >=
// 128 four warps of one tile (256 threads, the accumulator's registers).
// Q is split once into registers where they allow it (d = 40), else read
// from the Q tile and split at each use. The fragments: lane g of an 8-key
// n-tile reads K row 0, 4, 1, 5, 2, 6, 3, 7 (key_of_lane), so the score
// accumulator gives lane (g, t) keys t and t + 4, which is where P V's A
// fragment wants them: P stays in registers, split there, and V's rows are
// read in order; K and V come in float4 reads along d (lanes' 4-column
// groups 0, 4, 1, 5, ... for V), conflict-free at that row stride. The
// split is done on the bits (an integer add and mask, cvt.rna's rounding):
// the conversion unit cvt runs on issues at a quarter of the pipes' rate.
// K and V split per fragment as they are read beat split planes in shared
// memory (twice the bytes, a pass and a barrier a tile). Registers (-Xptxas -v, sm_90a): 228, 198,
// 216, 166, 184 a thread at d = 40, 64, 80, 128, 160, no spills. wgmma is
// not used: its tf32 form takes K-major operands only, so V would need a
// transposed copy, and the split parts would have to be planes in shared
// memory.

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

using polyp::split_tf32_bits;  // the 3xTF32 split, on the bits (common.cuh)

constexpr int kBlockQ = 64;  // query rows a block

// The fp32 form's tile plan at head dim D: MT 16-row tiles a warp (the
// block's rows over 4 / MT warps), and two key groups a row tile, each
// warp taking half of every key tile's keys (their states are added at
// the end).
template <int D>
struct Plan {
  static_assert(D % 8 == 0, "d a multiple of 8");
  static constexpr int MT = D <= 80 ? 2 : 1;    // 16-row tiles a warp
  static constexpr int KS = 2;                  // key groups
  static constexpr int kRowWarps = 4 / MT;      // warps along the rows
  static constexpr int BK = 64;                 // keys a tile
  static constexpr int KW = BK / KS;            // keys a warp takes of each tile
  static constexpr int NK = KW / 8;             // its n8 score tiles
  static constexpr int kThreads = 32 * kRowWarps * KS;
  static constexpr int LD = D + 4;              // floats a row of Q, K, V in shared memory
  static constexpr int KP = D / 16;             // k8 step pairs of QK^T (float4 reads)
  static constexpr bool kTail = D % 16 != 0;    // one more k8 step (float2 reads; d = 40)
  static constexpr int DN = D / 8;              // n8 tiles of the output
  static constexpr int G4 = D / 32;             // 32-column groups of P V (float4 reads)
  static constexpr int R = D % 32;              // then 8 (d = 40, scalar) or 16 (d = 80, float2)
  static constexpr bool kQRegs = MT * D <= 80;  // Q split once into registers (else per use)
  static constexpr int kQ = kBlockQ * LD;       // floats of the Q tile
  static constexpr int kStage = 2 * BK * LD;    // floats of a [K tile; V tile] stage
  static constexpr size_t kSmem = sizeof(float) * (kQ + 2 * kStage);
  static constexpr int kState = MT * (4 + 4 * DN);  // floats of a lane's softmax state
  static_assert(32 * kRowWarps * kState <= 2 * kStage, "the key groups' states fit");
};

// W consecutive floats at p (W = 4 and 2: one 16- or 8-byte read)
template <int W>
__device__ __forceinline__ void load_w(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  } else if constexpr (W == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x, x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

// W consecutive floats of a K or V tile at p, split into tf32 big and small
// parts
template <int W>
__device__ __forceinline__ void load_split(const float* p, uint32_t (&big)[W],
                                           uint32_t (&small)[W]) {
  float x[W];
  load_w<W>(p, x);
#pragma unroll
  for (int i = 0; i < W; ++i) split_tf32_bits(x[i], big[i], small[i]);
}

// The key a lane's B fragment of QK^T reads in its n8 tile: lanes g = 0..7
// take keys 0, 4, 1, 5, 2, 6, 3, 7. So the m16n8 score tile gives lane
// (g, t) keys t and t + 4 (columns 2t, 2t + 1), which is where the m16n8k8
// A fragment of P V wants them: P is reused in registers with V's rows in
// order, and a half-warp's float4 reads of K rows fall in distinct banks.
__device__ __forceinline__ int key_of_lane(int g) { return 4 * (g & 1) + (g >> 1); }
// The 4-column group of a 32-column V slice that lane g reads as a float4
// (its column n = g of four n8 tiles): g = 0..7 take groups 0, 4, 1, 5, 2,
// 6, 3, 7, so a half-warp's reads fall in distinct banks, and lane (g, t)
// holds output columns 4t..4t+3 and 16+4t..16+4t+3 of the slice.
__device__ __forceinline__ int vgroup_of_lane(int g) { return (g >> 1) + 4 * (g & 1); }

// c[i] += a · b[i] in 3xTF32 for N tiles that share the A fragment: each
// term (small terms first) over all N tiles before the next, so that N
// independent mma are in flight between two into the same accumulator
template <int N>
__device__ __forceinline__ void mma3_tiles(float (*c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t (*bb)[2],
                                           uint32_t (*bs)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) polyp::mma_tf32(c[i], as, bb[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) polyp::mma_tf32(c[i], ab, bs[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) polyp::mma_tf32(c[i], ab, bb[i]);
}

template <int D>
__global__ void __launch_bounds__(Plan<D>::kThreads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int Tq, int Tk,
                 float score_log2) {
  using P = Plan<D>;
  constexpr int BK = P::BK, KW = P::KW, NK = P::NK, LD = P::LD, KP = P::KP, DN = P::DN;
  constexpr int G4 = P::G4, R = P::R, RW = P::kRowWarps, MT = P::MT;
  extern __shared__ __align__(16) float fsmem[];
  float* sQ = fsmem;              // [kBlockQ][LD]
  float* sKV = sQ + P::kQ;        // two stages of [K tile; V tile], [BK][LD] each

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group and thread
  const int rw = warp % RW;               // this warp's rows: 16 MT rw .. + 16 MT
  const int kw0 = (warp / RW) * KW;       // its first key of each tile
  const int bh = blockIdx.x;
  const int n = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * kBlockQ;
  const long long row = static_cast<long long>(H) * D;  // token stride
  const float* qb = q + (static_cast<long long>(n) * Tq) * row + h * D;
  const float* kb = k + (static_cast<long long>(n) * Tk) * row + h * D;
  const float* vb = v + (static_cast<long long>(n) * Tk) * row + h * D;
  float* ob = o + (static_cast<long long>(n) * Tq) * row + h * D;

  auto stage = [&](int it) { return sKV + (it & 1) * P::kStage; };
  auto issue = [&](int it) {
    const int k0 = it * BK;
    float* sK = stage(it);
    polyp::load_tile_async_f32(sK, LD, kb + k0 * row, row, BK, D, Tk - k0, D, true);
    polyp::load_tile_async_f32(sK + BK * LD, LD, vb + k0 * row, row, BK, D, Tk - k0, D, true);
  };

  polyp::load_tile_async_f32(sQ, LD, qb + q0 * row, row, kBlockQ, D, Tq - q0, D, true);
  issue(0);
  polyp::cp_async_commit();

  // Q's A fragments: step s < 2 KP takes dims 16 (s / 2) + 4t + 2 (s % 2)
  // + {0, 1} as its k = t, t + 4 (a pair of steps is one float4 a row), the
  // tail step 16 KP + 2t + {0, 1}. q_frags gives row tile i's fragments of
  // a pair's two steps (x0, x1 float[4]: rows g, g + 8 at column `col`) or
  // of the tail's (float[2]), split once into registers at the first tile
  // (kQRegs) or read from the Q tile and split as they are used.
  const float* q_row = sQ + (16 * MT * rw + g) * LD;
  uint32_t qbig[P::kQRegs ? MT : 1][P::kQRegs ? DN : 1][4];
  uint32_t qsmall[P::kQRegs ? MT : 1][P::kQRegs ? DN : 1][4];
  auto q_frags = [&](int i, int col, auto& x0, auto& x1, uint32_t (&a0b)[4],
                     uint32_t (&a0s)[4], uint32_t (&a1b)[4], uint32_t (&a1s)[4]) {
    load_w(q_row + 16 * i * LD + col, x0);
    load_w(q_row + (16 * i + 8) * LD + col, x1);
    split_tf32_bits(x0[0], a0b[0], a0s[0]);
    split_tf32_bits(x1[0], a0b[1], a0s[1]);
    split_tf32_bits(x0[1], a0b[2], a0s[2]);
    split_tf32_bits(x1[1], a0b[3], a0s[3]);
    if constexpr (sizeof(x0) == 4 * sizeof(float)) {
      split_tf32_bits(x0[2], a1b[0], a1s[0]);
      split_tf32_bits(x1[2], a1b[1], a1s[1]);
      split_tf32_bits(x0[3], a1b[2], a1s[2]);
      split_tf32_bits(x1[3], a1b[3], a1s[3]);
    }
  };
  // row tile i's fragments of step pair p (or, p = KP, the tail step)
  auto q_pair = [&](int i, int p, uint32_t (&a0b)[4], uint32_t (&a0s)[4],
                    uint32_t (&a1b)[4], uint32_t (&a1s)[4]) {
    if constexpr (P::kQRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a0b[e] = qbig[i][2 * p][e], a0s[e] = qsmall[i][2 * p][e];
        if (p < KP) a1b[e] = qbig[i][2 * p + 1][e], a1s[e] = qsmall[i][2 * p + 1][e];
      }
    } else if (p < KP) {
      float x0[4], x1[4];
      q_frags(i, 16 * p + 4 * t, x0, x1, a0b, a0s, a1b, a1s);
    } else {
      float x0[2], x1[2];
      q_frags(i, 16 * KP + 2 * t, x0, x1, a0b, a0s, a1b, a1s);
    }
  };

  // the online softmax state of each row tile's rows g and g + 8: running
  // max (raw scores), this lane's part of the running sums, the output tiles
  float m[MT][2], l[MT][2], acc[MT][DN][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
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
    float* st = stage(it);
    if constexpr (P::kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int p = 0; p < KP; ++p) {
            float x0[4], x1[4];
            q_frags(i, 16 * p + 4 * t, x0, x1, qbig[i][2 * p], qsmall[i][2 * p],
                    qbig[i][2 * p + 1], qsmall[i][2 * p + 1]);
          }
          if constexpr (P::kTail) {
            float x0[2], x1[2];
            q_frags(i, 16 * KP + 2 * t, x0, x1, qbig[i][DN - 1], qsmall[i][DN - 1],
                    qbig[i][DN - 1], qsmall[i][DN - 1]);
          }
        }
      }
    }
    const int kvalid = Tk - it * BK - kw0;  // this warp's valid keys in the tile
    if (kvalid > 0) {
      const float* sK = st + kw0 * LD;
      const float* sV = st + (BK + kw0) * LD;

      // S = Q K^T over the warp's KW keys, 3xTF32, dims in step order;
      // each K fragment serves the MT row tiles
      float s[MT][NK][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NK; ++j) s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
      }
      const float* kr = sK + key_of_lane(g) * LD;
      constexpr int JC = NK < 4 ? NK : 4;  // score tiles a batch of mma
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        uint32_t a0b[MT][4], a0s[MT][4], a1b[MT][4], a1s[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) q_pair(i, p, a0b[i], a0s[i], a1b[i], a1s[i]);
#pragma unroll
        for (int j0 = 0; j0 < NK; j0 += JC) {
          uint32_t b0b[JC][2], b0s[JC][2], b1b[JC][2], b1s[JC][2];
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            uint32_t xb[4], xs[4];
            load_split<4>(kr + 8 * (j0 + j) * LD + 16 * p + 4 * t, xb, xs);
            b0b[j][0] = xb[0], b0b[j][1] = xb[1], b1b[j][0] = xb[2], b1b[j][1] = xb[3];
            b0s[j][0] = xs[0], b0s[j][1] = xs[1], b1s[j][0] = xs[2], b1s[j][1] = xs[3];
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma3_tiles<JC>(&s[i][j0], a0b[i], a0s[i], b0b, b0s);
            mma3_tiles<JC>(&s[i][j0], a1b[i], a1s[i], b1b, b1s);
          }
        }
      }
      if constexpr (P::kTail) {
        uint32_t ab[MT][4], as[MT][4], unused[2][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) q_pair(i, KP, ab[i], as[i], unused[0], unused[1]);
#pragma unroll
        for (int j0 = 0; j0 < NK; j0 += JC) {
          uint32_t bb[JC][2], bs[JC][2];
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            load_split<2>(kr + 8 * (j0 + j) * LD + 16 * KP + 2 * t, bb[j], bs[j]);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) mma3_tiles<JC>(&s[i][j0], ab[i], as[i], bb, bs);
        }
      }

      // lane (g, t) holds keys 8j + t (e = 0, 2) and 8j + t + 4 (e = 1, 3)
      // of rows g (e = 0, 1) and g + 8 (e = 2, 3); keys at or past kvalid
      // are -inf before the max, so their p is exactly 0
      if (kvalid < KW) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int j = 0; j < NK; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (8 * j + t + 4 * (e & 1) >= kvalid) s[i][j][e] = -INFINITY;
            }
          }
        }
      }

      // the online softmax (attention_core.cuh's): max in raw scores, the
      // scale and log2 e folded into one exponent
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[i][j][0], s[i][j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[i][j][2], s[i][j][3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m[i][0], mx0), mn1 = fmaxf(m[i][1], mx1);
        // a row with no valid key so far subtracts 0 rather than -inf
        const float base0 = mn0 == -INFINITY ? 0.f : mn0 * score_log2;
        const float base1 = mn1 == -INFINITY ? 0.f : mn1 * score_log2;
        const float alpha0 = polyp::attn::fast_exp2(m[i][0] * score_log2 - base0);
        const float alpha1 = polyp::attn::fast_exp2(m[i][1] * score_log2 - base1);
        m[i][0] = mn0;
        m[i][1] = mn1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          s[i][j][0] = polyp::attn::fast_exp2(fmaf(s[i][j][0], score_log2, -base0));
          s[i][j][1] = polyp::attn::fast_exp2(fmaf(s[i][j][1], score_log2, -base0));
          s[i][j][2] = polyp::attn::fast_exp2(fmaf(s[i][j][2], score_log2, -base1));
          s[i][j][3] = polyp::attn::fast_exp2(fmaf(s[i][j][3], score_log2, -base1));
          ps0 += s[i][j][0] + s[i][j][1];
          ps1 += s[i][j][2] + s[i][j][3];
        }
        l[i][0] = l[i][0] * alpha0 + ps0;
        l[i][1] = l[i][1] * alpha1 + ps1;
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          acc[i][j][0] *= alpha0;
          acc[i][j][1] *= alpha0;
          acc[i][j][2] *= alpha1;
          acc[i][j][3] *= alpha1;
        }
      }

      // O += P V, 3xTF32: the scores' registers, split, are the A
      // fragment of each 8-key step (k = t, t + 4 -> keys t, t + 4); each V
      // fragment serves the MT row tiles
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t pb[MT][4], pq[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          split_tf32_bits(s[i][j][0], pb[i][0], pq[i][0]);
          split_tf32_bits(s[i][j][2], pb[i][1], pq[i][1]);
          split_tf32_bits(s[i][j][1], pb[i][2], pq[i][2]);
          split_tf32_bits(s[i][j][3], pb[i][3], pq[i][3]);
        }
        const float* v0 = sV + (8 * j + t) * LD;
        const float* v1 = v0 + 4 * LD;
        // the B fragments of one 32-column group's four tiles (lane g's
        // float4 of rows t and t + 4), and after the last group the rest's
        auto group = [&](int c, uint32_t (*bb)[2], uint32_t (*bs)[2]) {
          uint32_t xb[4], xs[4], yb[4], ys[4];
          load_split<4>(v0 + 32 * c + 4 * vgroup_of_lane(g), xb, xs);
          load_split<4>(v1 + 32 * c + 4 * vgroup_of_lane(g), yb, ys);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            bb[u][0] = xb[u], bb[u][1] = yb[u], bs[u][0] = xs[u], bs[u][1] = ys[u];
          }
        };
#pragma unroll
        for (int c = 0; c + 1 < G4; ++c) {
          uint32_t bb[4][2], bs[4][2];
          group(c, bb, bs);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma3_tiles<4>(&acc[i][4 * c], pb[i], pq[i], bb, bs);
        }
        constexpr int NT = 4 + R / 8;  // the last group's tiles and the rest's
        uint32_t bb[NT][2], bs[NT][2];
        group(G4 - 1, bb, bs);
        if constexpr (R == 16) {  // lane g reads columns 2g, 2g + 1
          uint32_t xb[2], xs[2], yb[2], ys[2];
          load_split<2>(v0 + 32 * G4 + 2 * g, xb, xs);
          load_split<2>(v1 + 32 * G4 + 2 * g, yb, ys);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            bb[4 + u][0] = xb[u], bb[4 + u][1] = yb[u];
            bs[4 + u][0] = xs[u], bs[4 + u][1] = ys[u];
          }
        } else if constexpr (R == 8) {  // lane g reads column g
          uint32_t xb[1], xs[1], yb[1], ys[1];
          load_split<1>(v0 + 32 * G4 + g, xb, xs);
          load_split<1>(v1 + 32 * G4 + g, yb, ys);
          bb[4][0] = xb[0], bb[4][1] = yb[0], bs[4][0] = xs[0], bs[4][1] = ys[0];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma3_tiles<NT>(&acc[i][4 * (G4 - 1)], pb[i], pq[i], bb, bs);
        }
      }
    }
    __syncthreads();  // this stage may be refilled
  }

  {  // the second key group's state joins the first's
    float* x = sKV;  // free now; value e of lane slot at x[e * kSlots + slot]
    constexpr int kSlots = 32 * RW;
    const int slot = threadIdx.x % kSlots;
    if (warp >= RW) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float* xi = x + i * (4 + 4 * DN) * kSlots;
        xi[slot] = m[i][0];
        xi[kSlots + slot] = m[i][1];
        xi[2 * kSlots + slot] = l[i][0];
        xi[3 * kSlots + slot] = l[i][1];
#pragma unroll
        for (int j = 0; j < DN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) xi[(4 + 4 * j + e) * kSlots + slot] = acc[i][j][e];
        }
      }
    }
    __syncthreads();
    if (warp >= RW) return;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* xi = x + i * (4 + 4 * DN) * kSlots;
      float a[2], b[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = xi[r * kSlots + slot];
        const float mn = fmaxf(m[i][r], m1);
        const float base = mn == -INFINITY ? 0.f : mn * score_log2;
        a[r] = polyp::attn::fast_exp2(m[i][r] * score_log2 - base);
        b[r] = polyp::attn::fast_exp2(m1 * score_log2 - base);
        l[i][r] = l[i][r] * a[r] + xi[(2 + r) * kSlots + slot] * b[r];
      }
#pragma unroll
      for (int j = 0; j < DN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] =
              acc[i][j][e] * a[e >> 1] + xi[(4 + 4 * j + e) * kSlots + slot] * b[e >> 1];
        }
      }
    }
  }

  // 1 / row sum (the quad's parts added), and the rows out
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[i][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float f = 1.f / sum;
      const int qr = q0 + 16 * (MT * rw + i) + g + 8 * r;
      if (qr >= Tq) continue;
      float* out = ob + qr * row;
      const int e0 = 2 * r, e1 = 2 * r + 1;  // columns 2t and 2t + 1 of each tile
      const float(&a)[DN][4] = acc[i];
#pragma unroll
      for (int c = 0; c < G4; ++c) {
        *reinterpret_cast<float4*>(out + 32 * c + 4 * t) =
            make_float4(a[4 * c][e0] * f, a[4 * c + 1][e0] * f, a[4 * c + 2][e0] * f,
                        a[4 * c + 3][e0] * f);
        *reinterpret_cast<float4*>(out + 32 * c + 16 + 4 * t) =
            make_float4(a[4 * c][e1] * f, a[4 * c + 1][e1] * f, a[4 * c + 2][e1] * f,
                        a[4 * c + 3][e1] * f);
      }
      if constexpr (R == 16) {
        *reinterpret_cast<float4*>(out + 32 * G4 + 4 * t) = make_float4(
            a[4 * G4][e0] * f, a[4 * G4 + 1][e0] * f, a[4 * G4][e1] * f, a[4 * G4 + 1][e1] * f);
      } else if constexpr (R == 8) {
        *reinterpret_cast<float2*>(out + 32 * G4 + 2 * t) =
            make_float2(a[4 * G4][e0] * f, a[4 * G4][e1] * f);
      }
    }
  }
}

template <int D>
cudaError_t launch_flash_f32(const float* q, const float* k, const float* v, float* o, int N,
                             int H, int Tq, int Tk, float scale, cudaStream_t stream) {
  using P = Plan<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(P::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid(N * H, (Tq + kBlockQ - 1) / kBlockQ);
  flash_f32_kernel<D><<<grid, P::kThreads, P::kSmem, stream>>>(q, k, v, o, H, Tq, Tk,
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
  out[4] = P::kSmem;
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

// ... and the fp32 form's plan at d: out[6] = query rows a block, keys a
// tile, threads a block, key groups a row tile, dynamic shared memory
// bytes, row tiles a warp; returns 0, or -1 if d is not built
extern "C" int polyp_flash_f32_plan(int d, long long* out) {
  switch (d) {
    case 40: f32::plan_of<40>(out); return 0;
    case 64: f32::plan_of<64>(out); return 0;
    case 80: f32::plan_of<80>(out); return 0;
    case 128: f32::plan_of<128>(out); return 0;
    case 160: f32::plan_of<160>(out); return 0;
    default: return -1;
  }
}

extern "C" long long polyp_flash_f32_smem(int d) {
  long long plan[6];
  return polyp_flash_f32_plan(d, plan) == 0 ? plan[4] : 0;
}
