// The attention cores shared by flash_attention.cu and fused_mha.cu: one
// warp's query rows of softmax(Q K^T) V, in the FlashAttention-2 manner,
// with the scores, the probabilities and the output accumulator held in the
// registers of mma.sync fragments. Nothing of S, P or O goes through shared
// memory. Two cores, one for each input dtype:
//
// bf16 (WarpAttention): 16 * MT query rows a warp.
// * Q: the warp's A fragments for the whole K loop, loaded once with
//   ldmatrix (load_q) or built from a projection's accumulator (set_q).
// * S = Q K^T with mma.sync m16n8k16 (bf16 in, fp32 out), 32 keys a step;
//   K fragments come from a [key][dim] shared tile through ldmatrix, and
//   each feeds all MT row tiles of the warp.
// * The online softmax runs on the accumulator fragments. Each thread holds
//   parts of rows g and g+8 (g = lane / 4), so a row max is two shuffles
//   within the quad. Key columns at or past `kvalid` are -inf before the
//   max (the rule of the TPU kernel, polyp_tpu/ops/fused_mha.py:120-123):
//   their probability is exactly 0, and a row that has seen no valid key
//   subtracts 0 rather than -inf, so no NaN can arise. The row max is kept
//   in raw scores; the caller's factor (the softmax scale, if any, times
//   log2 e) is folded into one FFMA before a single ex2.approx. The row sum
//   stays a per-thread partial until finish().
// * O += P V: the m16n8k16 accumulator layout of two neighbouring n8 score
//   tiles is the A layout of one k16 step, so P is packed to bf16 in
//   registers; V fragments come from ldmatrix.trans of a [key][dim] tile.
//
// fp32 (f32::WarpAttention, 3xTF32 on mma.sync m16n8k8): the same online
// softmax over a block of 64 query rows whose warps are row warps times two
// key groups; f32::Plan below says how, and why.
//
// Head dims: both cores take a padded width D as a template parameter, and
// the kernels the true d (a multiple of 8, d <= D) at run time: their
// masked loads fill the columns [d, D) of every Q, K and V tile with zeros,
// which add nothing to QK^T and give zero output columns there, and their
// stores stop at d. padded_width() picks the width a d runs at. The bf16
// core's QK^T depth is D padded to 16 (DK), P V covers D / 8 n8 tiles;
// shared tiles have a row stride of DK + 8 bf16 (an odd multiple of 16
// bytes), so the eight rows an ldmatrix phase reads fall in distinct banks.
#pragma once

#include "common.cuh"

namespace polyp {
namespace attn {

constexpr float kLog2e = 1.4426950408889634f;

// The padded head widths both attention kernels are built for (16, 32,
// 40, 48, 64, 80, 96, 112, 128), and the one a head dim d (a multiple of
// 8) runs at: the least at or above it; 0 past 128. Each width costs one
// instantiation a kernel and form (build time); the widths the SD UNets
// run (40, 64, 80, 128) run unpadded.
__host__ __device__ constexpr int padded_width(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 40 ? 40 : d <= 48 ? 48 : d <= 64 ? 64
       : d <= 80 ? 80 : d <= 96 ? 96 : d <= 112 ? 112 : d <= 128 ? 128 : 0;
}

// `case W: CALL(W)` for every padded width: a switch over
// padded_width(d) dispatches to the instantiation of that width.
#define POLYP_ATTN_WIDTH_CASES(CALL)                                        \
  case 16: CALL(16); case 32: CALL(32); case 40: CALL(40); case 48: CALL(48); \
  case 64: CALL(64); case 80: CALL(80); case 96: CALL(96); case 112: CALL(112); \
  case 128: CALL(128);

template <int D>
struct Head {
  static constexpr int DK = (D + 15) / 16 * 16;  // QK^T depth, zero-padded
  static constexpr int KS = DK / 16;             // k16 steps of QK^T
  static constexpr int DN = D / 8;               // n8 tiles of P V
  static constexpr int LD = DK + 8;              // shared row stride (bf16)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a × b over one m16n8k16 tile, bf16 in, fp32 accumulate. Fragments
// (PTX ISA, "Matrix Fragments for mma.m16n8k16"), g = lane / 4, t = lane % 4:
//   A: a0 = A[g][2t, 2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B: b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C: c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ldmatrix addresses, one row of 16 bytes a lane (lane = threadIdx.x % 32):
// A of a 16 x 16 tile at (row 0, col k0) of a row-major [m][k] tile
__device__ __forceinline__ const bf16* a_frag_ptr(const bf16* s, int ld, int k0) {
  const int lane = threadIdx.x & 31;
  return s + (lane & 15) * ld + k0 + ((lane >> 4) << 3);
}
// B of the n8 tiles n0 and n0 + 8 (x4; x2: n0 only) at depth k0 of a [n][k]
// tile: tile n0 is {r0, r1}, tile n0 + 8 is {r2, r3}
__device__ __forceinline__ const bf16* b_frag_ptr(const bf16* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + (((lane >> 3) & 1) << 3);
}
// B of the n8 tiles n0 and n0 + 8 (x4.trans; x2.trans: n0 only) at depth k0
// of a [k][n] tile (ldmatrix.trans)
__device__ __forceinline__ const bf16* bt_frag_ptr(const bf16* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 + ((lane >> 4) << 3);
}

// acc[i][j] += A_i (16 x 16 at depth k0 of row tile i) × B (n8 tile j of a
// [n][k] tile), for the MT row tiles and N8 column tiles of a warp: the
// projections' inner step. Each B fragment serves all MT row tiles.
template <int MT, int N8>
__device__ __forceinline__ void mma_rows_nk(float (&acc)[MT][N8][4], const uint32_t (&a)[MT][4],
                                            const bf16* sB, int ld, int k0) {
#pragma unroll
  for (int jn = 0; jn < N8 / 2; ++jn) {
    uint32_t b[4];
    ldsm_x4(b, b_frag_ptr(sB, ld, 16 * jn, k0));
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma_16816(acc[i][2 * jn], a[i], b[0], b[1]);
      mma_16816(acc[i][2 * jn + 1], a[i], b[2], b[3]);
    }
  }
  if (N8 & 1) {
    uint32_t b[2];
    ldsm_x2(b, b_frag_ptr(sB, ld, 8 * (N8 - 1), k0));
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_16816(acc[i][N8 - 1], a[i], b[0], b[1]);
  }
}

// Row tiles of 16 a warp takes at head dim D: two at d = 40, where the
// registers allow it, so each K and V fragment read from shared memory
// feeds two mma (shared-memory bandwidth and the latency of one chain
// bound a warp with one), one above.
template <int D>
constexpr int rows_per_warp() { return D <= 40 ? 2 : 1; }

// One warp's 16 * MT query rows.
template <int D, int MT>
struct WarpAttention {
  using S = Head<D>;
  static constexpr int kSub = 32;  // keys a step: 16 fp32 scores a row tile
  uint32_t q[MT][S::KS][4];
  float o[MT][S::DN][4];
  float m[MT][2];  // running max of rows g and g + 8 (raw scores)
  float l[MT][2];  // this thread's part of the running sums

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < S::DN; ++j) o[i][j][0] = o[i][j][1] = o[i][j][2] = o[i][j][3] = 0.f;
      m[i][0] = m[i][1] = -INFINITY;
      l[i][0] = l[i][1] = 0.f;
    }
  }

  // Q from the warp's 16 * MT rows of a row-major shared tile (DK columns).
  __device__ __forceinline__ void load_q(const bf16* sQ, int ld) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int kk = 0; kk < S::KS; ++kk) {
        ldsm_x4(q[i][kk], a_frag_ptr(sQ + 16 * i * ld, ld, 16 * kk));
      }
    }
  }

  // Q from [16 x D] fp32 accumulators (c), times `scale`, rounded to bf16:
  // the C layout of n8 tiles 2kk and 2kk + 1 is the A layout of k16 step kk.
  __device__ __forceinline__ void set_q(const float (&c)[MT][S::DN][4], float scale) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int kk = 0; kk < S::KS; ++kk) {
        const int j0 = 2 * kk < S::DN ? 2 * kk : 0;  // in bounds; the
        const int j1 = 2 * kk + 1 < S::DN ? 2 * kk + 1 : 0;  // padding is 0
        const bool v0 = 2 * kk < S::DN, v1 = 2 * kk + 1 < S::DN;
        q[i][kk][0] = v0 ? pack_bf16(c[i][j0][0] * scale, c[i][j0][1] * scale) : 0u;
        q[i][kk][1] = v0 ? pack_bf16(c[i][j0][2] * scale, c[i][j0][3] * scale) : 0u;
        q[i][kk][2] = v1 ? pack_bf16(c[i][j1][0] * scale, c[i][j1][1] * scale) : 0u;
        q[i][kk][3] = v1 ? pack_bf16(c[i][j1][2] * scale, c[i][j1][3] * scale) : 0u;
      }
    }
  }

  // Fold a tile of BK keys into the state, kSub keys a step: sK, sV are
  // [BK][ld] shared tiles; keys at or past kvalid are masked (steps wholly
  // past it are skipped); score_log2 turns raw scores into the log2 domain
  // (the softmax scale, if any, times log2 e).
  template <int BK>
  __device__ __forceinline__ void tile(const bf16* sK, const bf16* sV, int ld, int kvalid,
                                       float score_log2) {
    static_assert(BK % kSub == 0, "key tiles are whole steps");
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += kSub) {
      if (k0 < kvalid) step(sK + k0 * ld, sV + k0 * ld, ld, kvalid - k0, score_log2);
    }
  }

  __device__ __forceinline__ void step(const bf16* sK, const bf16* sV, int ld, int kvalid,
                                       float score_log2) {
    constexpr int N8 = kSub / 8;
    const int t = threadIdx.x & 3;
    float s[MT][N8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < N8; ++j) s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < S::KS; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][e] = q[i][kk][e];
      }
      mma_rows_nk<MT, N8>(s, a, sK, ld, 16 * kk);
    }
    if (kvalid < kSub) {  // the ragged last step only
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < N8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (8 * j + 2 * t + (e & 1) >= kvalid) s[i][j][e] = -INFINITY;
          }
        }
      }
    }

    uint32_t p[MT][kSub / 16][4];  // P as the A fragments of P V
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[i][j][0], s[i][j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[i][j][2], s[i][j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m[i][0], mx0), mn1 = fmaxf(m[i][1], mx1);
      // a row with no valid key so far subtracts 0 rather than -inf, so
      // every p is exp2(-inf) = 0 and no -inf - (-inf) is formed
      const float base0 = mn0 == -INFINITY ? 0.f : mn0 * score_log2;
      const float base1 = mn1 == -INFINITY ? 0.f : mn1 * score_log2;
      const float alpha0 = fast_exp2(m[i][0] * score_log2 - base0);
      const float alpha1 = fast_exp2(m[i][1] * score_log2 - base1);
      m[i][0] = mn0;
      m[i][1] = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        const float p0 = fast_exp2(fmaf(s[i][j][0], score_log2, -base0));
        const float p1 = fast_exp2(fmaf(s[i][j][1], score_log2, -base0));
        const float p2 = fast_exp2(fmaf(s[i][j][2], score_log2, -base1));
        const float p3 = fast_exp2(fmaf(s[i][j][3], score_log2, -base1));
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        // n8 tiles 2kk and 2kk + 1 make the A fragment of k16 step kk
        p[i][j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        p[i][j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l[i][0] = l[i][0] * alpha0 + ps0;
      l[i][1] = l[i][1] * alpha1 + ps1;
#pragma unroll
      for (int j = 0; j < S::DN; ++j) {
        o[i][j][0] *= alpha0;
        o[i][j][1] *= alpha0;
        o[i][j][2] *= alpha1;
        o[i][j][3] *= alpha1;
      }
    }

#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
#pragma unroll
      for (int jn = 0; jn < S::DN / 2; ++jn) {
        uint32_t b[4];
        ldsm_x4_trans(b, bt_frag_ptr(sV, ld, 16 * jn, 16 * kk));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_16816(o[i][2 * jn], p[i][kk], b[0], b[1]);
          mma_16816(o[i][2 * jn + 1], p[i][kk], b[2], b[3]);
        }
      }
      if (S::DN & 1) {
        uint32_t b[2];
        ldsm_x2_trans(b, bt_frag_ptr(sV, ld, 8 * (S::DN - 1), 16 * kk));
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_16816(o[i][S::DN - 1], p[i][kk], b[0], b[1]);
      }
    }
  }

  // 1 / row sum of rows g and g + 8 of row tile i (the quad's partial sums
  // added).
  __device__ __forceinline__ void finish(int i, float& inv0, float& inv1) const {
    float l0 = l[i][0], l1 = l[i][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    inv0 = 1.f / l0;
    inv1 = 1.f / l1;
  }

  // The normalised output of row tile i, rounded to bf16, as 32-bit pairs:
  // row g (hi = false) or g + 8 (hi = true) of n8 tile j, columns 8j + 2t
  // and 8j + 2t + 1.
  __device__ __forceinline__ uint32_t out_pair(int i, int j, bool hi, float inv0,
                                               float inv1) const {
    return hi ? pack_bf16(o[i][j][2] * inv1, o[i][j][3] * inv1)
              : pack_bf16(o[i][j][0] * inv0, o[i][j][1] * inv0);
  }
};

// ---------------------------------------------------------------------------
// The fp32 core (flash's fp32 form; the fused MHA's fp32 form
// shares it). Products on the tensor cores in 3xTF32: each operand split
// into a tf32 big part and a tf32 remainder, big·big + big·small +
// small·big, small terms first, summed in fp32 (mma.sync m16n8k8). One tf32
// product keeps 10 mantissa bits, about 5e-4 of a product: emulated on the
// CPU its output is 3.8e-4 of max |y| from float64 at [128 x 256, d = 40]
// against 3.2e-7 in 3xTF32 (tests/test_torch_port_flash_f32.py), and the
// checks are 1e-4.
//
// Plan: a block owns 64 query rows and streams BK-key K/V tiles through two
// cp.async stages, rows padded to D + 4 floats. Its warps are two key
// groups (each takes half of every tile's keys; their states are added at
// the end through shared memory, group 0's then group 1's, so a run
// repeats bit for bit) times the row warps: at D <= 80 two warps of two
// 16-row tiles each (128 threads; every K and V fragment read and split
// feeds both tiles), above four warps of one tile (256 threads, the
// accumulator's registers). Q is split once into registers where they
// allow it (MT * D <= 80), else read from the block's Q tile and split at
// each use. The fragments: lane g of an 8-key n-tile reads K row 0, 4, 1,
// 5, 2, 6, 3, 7 (key_of_lane), so the score accumulator gives lane (g, t)
// keys t and t + 4, which is where P V's A fragment wants them: P stays in
// registers, split there, and V's rows are read in order; K and V come in
// float4 reads along d (lanes' 4-column groups 0, 4, 1, 5, ... for V),
// conflict-free at that row stride. The split is done on the bits (an
// integer add and mask, cvt.rna's rounding): the conversion unit cvt runs
// on issues at a quarter of the pipes' rate. K and V split per fragment as
// they are read beat split planes in shared memory (twice the bytes, a pass
// and a barrier a tile). wgmma is not used: its tf32 form takes K-major
// operands only, so V would need a transposed copy, and the split parts
// would have to be planes in shared memory.
namespace f32 {

using polyp::split_tf32_bits;  // the 3xTF32 split, on the bits (common.cuh)

constexpr int kBlockQ = 64;  // query rows a block

// The tile plan at padded head width D with BK-key tiles: MT 16-row tiles a
// warp (the block's rows over 4 / MT warps), and two key groups a row tile,
// each warp taking half of every key tile's keys.
template <int D, int BK_ = 64>
struct Plan {
  static_assert(D % 8 == 0, "d a multiple of 8");
  static constexpr int MT = D <= 80 ? 2 : 1;    // 16-row tiles a warp
  static constexpr int KS = 2;                  // key groups
  static constexpr int kRowWarps = 4 / MT;      // warps along the rows
  static constexpr int BK = BK_;                // keys a tile
  static constexpr int KW = BK / KS;            // keys a warp takes of each tile
  static constexpr int NK = KW / 8;             // its n8 score tiles
  static constexpr int kThreads = 32 * kRowWarps * KS;
  static constexpr int LD = D + 4;              // floats a row of Q, K, V in shared memory
  static constexpr int KP = D / 16;             // k8 step pairs of QK^T (float4 reads)
  static constexpr bool kTail = D % 16 != 0;    // one more k8 step (float2 reads; d = 40)
  static constexpr int DN = D / 8;              // n8 tiles of the output
  static constexpr int G4 = D / 32;             // 32-column groups of P V (float4 reads)
  static constexpr int R = D % 32;              // then 8 (d = 40, scalar) or 16 (float2)
  static_assert(R == 0 || R == 8 || R == 16, "a width the P V reads cover");
  static constexpr bool kQRegs = MT * D <= 80;  // Q split once into registers (else per use)
  static constexpr int kQ = kBlockQ * LD;       // floats of the Q tile
  static constexpr int kStage = 2 * BK * LD;    // floats of a [K tile; V tile] stage
  static constexpr int kState = MT * (4 + 4 * DN);  // floats of a lane's softmax state
  static_assert(32 * kRowWarps * kState <= 2 * kStage, "the key groups' states fit");
};

// W consecutive floats at p (W = 4 and 2: one 16- or 8-byte read); p may
// lie in another block's shared memory (distributed shared memory)
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

// The A fragments of one k8 step pair (float4 reads, W = 4: depths
// col .. col + 3 of rows g and g + 8 of `rows`, as steps col, col + 2 with
// k = t, t + 4 taking depths +0, +1 and +2, +3) or of one k8 step (float2
// reads, W = 2: depths col, col + 1 as k = t, t + 4), split
template <int W>
__device__ __forceinline__ void a_frags(const float* rows, int ld, int col, uint32_t (&a0b)[4],
                                        uint32_t (&a0s)[4], uint32_t (&a1b)[4],
                                        uint32_t (&a1s)[4]) {
  const int g = (threadIdx.x & 31) >> 2;
  float x0[W], x1[W];
  load_w<W>(rows + g * ld + col, x0);
  load_w<W>(rows + (g + 8) * ld + col, x1);
  split_tf32_bits(x0[0], a0b[0], a0s[0]);
  split_tf32_bits(x1[0], a0b[1], a0s[1]);
  split_tf32_bits(x0[1], a0b[2], a0s[2]);
  split_tf32_bits(x1[1], a0b[3], a0s[3]);
  if constexpr (W == 4) {
    split_tf32_bits(x0[2], a1b[0], a1s[0]);
    split_tf32_bits(x1[2], a1b[1], a1s[1]);
    split_tf32_bits(x0[3], a1b[2], a1s[2]);
    split_tf32_bits(x1[3], a1b[3], a1s[3]);
  }
}

// acc[j] += A · B_j^T over one step pair (depths col .. col + 3 of each
// lane, as a_frags<4> gives A's) or one tail step (W = 2: depths col, col
// + 1) for JB n8 tiles, B_j's rows at b + (8 j + n) * ldb
template <int W, int JB>
__device__ __forceinline__ void rows_batch(float (*acc)[4], const uint32_t (&a0b)[4],
                                           const uint32_t (&a0s)[4], const uint32_t (&a1b)[4],
                                           const uint32_t (&a1s)[4], const float* b, int ldb,
                                           int col) {
  const int g = (threadIdx.x & 31) >> 2;
  uint32_t b0b[JB][2], b0s[JB][2], b1b[JB][2], b1s[JB][2];
#pragma unroll
  for (int j = 0; j < JB; ++j) {
    uint32_t xb[W], xs[W];
    load_split<W>(b + (8 * j + g) * ldb + col, xb, xs);
    b0b[j][0] = xb[0], b0b[j][1] = xb[1], b0s[j][0] = xs[0], b0s[j][1] = xs[1];
    if constexpr (W == 4) {
      b1b[j][0] = xb[2], b1b[j][1] = xb[3], b1s[j][0] = xs[2], b1s[j][1] = xs[3];
    }
  }
  mma3_tiles<JB>(acc, a0b, a0s, b0b, b0s);
  if constexpr (W == 4) mma3_tiles<JB>(acc, a1b, a1s, b1b, b1s);
}

// acc[j] += A · B_j^T over depth KD in 3xTF32, for one warp: A is 16 rows
// (row r at a + r * lda), B_j the 8 rows of n8 tile j (row n at b + (8 j +
// n) * ldb), both row-major along the depth (KD a multiple of 8), in the
// depth order of the core's QK^T (lane t reads depths 16 p + 4 t .. + 3 as
// a float4, a tail of 8 as float2s); four tiles a batch of mma. The fused
// MHA's fp32 projections use it; either operand may lie in distributed
// shared memory.
template <int NT, int KD>
__device__ __forceinline__ void mma3_rows(float (&acc)[NT][4], const float* a, int lda,
                                          const float* b, int ldb) {
  const int t = threadIdx.x & 3;
  constexpr int JC = 4, NR = NT % JC, NF = NT - NR;  // whole batches, then the rest
#pragma unroll
  for (int p = 0; p < KD / 16; ++p) {
    uint32_t a0b[4], a0s[4], a1b[4], a1s[4];
    a_frags<4>(a, lda, 16 * p + 4 * t, a0b, a0s, a1b, a1s);
#pragma unroll
    for (int j0 = 0; j0 < NF; j0 += JC) {
      rows_batch<4, JC>(&acc[j0], a0b, a0s, a1b, a1s, b + 8 * j0 * ldb, ldb, 16 * p + 4 * t);
    }
    if constexpr (NR > 0) {
      rows_batch<4, NR>(&acc[NF], a0b, a0s, a1b, a1s, b + 8 * NF * ldb, ldb, 16 * p + 4 * t);
    }
  }
  if constexpr (KD % 16 == 8) {
    constexpr int c0 = KD / 16 * 16;
    uint32_t ab[4], as[4], unused[2][4];
    a_frags<2>(a, lda, c0 + 2 * t, ab, as, unused[0], unused[1]);
#pragma unroll
    for (int j0 = 0; j0 < NF; j0 += JC) {
      rows_batch<2, JC>(&acc[j0], ab, as, unused[0], unused[1], b + 8 * j0 * ldb, ldb,
                        c0 + 2 * t);
    }
    if constexpr (NR > 0) {
      rows_batch<2, NR>(&acc[NF], ab, as, unused[0], unused[1], b + 8 * NF * ldb, ldb,
                        c0 + 2 * t);
    }
  }
}

// One warp's share of a block's 64 query rows: row tiles 16 MT rw .. of
// the Q tile, keys kw0 .. kw0 + KW of every key tile (its key group).
template <int D, int BK>
struct WarpAttention {
  using P = Plan<D, BK>;
  static constexpr int MT = P::MT, DN = P::DN, KP = P::KP, LD = P::LD, NK = P::NK;
  static constexpr int G4 = P::G4, R = P::R, RW = P::kRowWarps;
  // the online softmax state of each row tile's rows g and g + 8: running
  // max (raw scores), this lane's part of the running sums, the output tiles
  float m[MT][2], l[MT][2], acc[MT][DN][4];
  uint32_t qbig[P::kQRegs ? MT : 1][P::kQRegs ? DN : 1][4];
  uint32_t qsmall[P::kQRegs ? MT : 1][P::kQRegs ? DN : 1][4];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      m[i][0] = m[i][1] = -INFINITY;
      l[i][0] = l[i][1] = 0.f;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    }
  }

  // Q's A fragments: step s < 2 KP takes dims 16 (s / 2) + 4t + 2 (s % 2)
  // + {0, 1} as its k = t, t + 4 (a pair of steps is one float4 a row), the
  // tail step 16 KP + 2t + {0, 1}. q_row is row 0 of this warp's rows in
  // the Q tile; with kQRegs split once into registers (before the first
  // tile), else read and split at each use.
  __device__ __forceinline__ void load_q(const float* q_row) {
    if constexpr (P::kQRegs) {
      const int t = threadIdx.x & 3;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int p = 0; p < KP; ++p) {
          a_frags<4>(q_row + 16 * i * LD, LD, 16 * p + 4 * t, qbig[i][2 * p], qsmall[i][2 * p],
                     qbig[i][2 * p + 1], qsmall[i][2 * p + 1]);
        }
        if constexpr (P::kTail) {
          a_frags<2>(q_row + 16 * i * LD, LD, 16 * KP + 2 * t, qbig[i][DN - 1], qsmall[i][DN - 1],
                     qbig[i][DN - 1], qsmall[i][DN - 1]);
        }
      }
    }
  }

  // row tile i's fragments of step pair p (or, p = KP, the tail step)
  __device__ __forceinline__ void q_pair(const float* q_row, int i, int p, uint32_t (&a0b)[4],
                                         uint32_t (&a0s)[4], uint32_t (&a1b)[4],
                                         uint32_t (&a1s)[4]) const {
    const int t = threadIdx.x & 3;
    if constexpr (P::kQRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a0b[e] = qbig[i][2 * p][e], a0s[e] = qsmall[i][2 * p][e];
        if (p < KP) a1b[e] = qbig[i][2 * p + 1][e], a1s[e] = qsmall[i][2 * p + 1][e];
      }
    } else if (p < KP) {
      a_frags<4>(q_row + 16 * i * LD, LD, 16 * p + 4 * t, a0b, a0s, a1b, a1s);
    } else {
      a_frags<2>(q_row + 16 * i * LD, LD, 16 * KP + 2 * t, a0b, a0s, a1b, a1s);
    }
  }

  // Fold this warp's keys of one K/V tile into the state: sK and sV are
  // its first key's rows of the stage's K and V tiles, kvalid its keys
  // there that are valid (> 0); score_log2 turns raw scores into the log2
  // domain (the softmax scale, if not folded into Q, times log2 e).
  __device__ __forceinline__ void tile(const float* q_row, const float* sK, const float* sV,
                                       int kvalid, float score_log2) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;

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
      for (int i = 0; i < MT; ++i) q_pair(q_row, i, p, a0b[i], a0s[i], a1b[i], a1s[i]);
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
      for (int i = 0; i < MT; ++i) q_pair(q_row, i, KP, ab[i], as[i], unused[0], unused[1]);
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
    if (kvalid < P::KW) {
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

    // the online softmax (the bf16 core's): max in raw scores, the scale
    // and log2 e folded into one exponent
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
      const float alpha0 = fast_exp2(m[i][0] * score_log2 - base0);
      const float alpha1 = fast_exp2(m[i][1] * score_log2 - base1);
      m[i][0] = mn0;
      m[i][1] = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[i][j][0] = fast_exp2(fmaf(s[i][j][0], score_log2, -base0));
        s[i][j][1] = fast_exp2(fmaf(s[i][j][1], score_log2, -base0));
        s[i][j][2] = fast_exp2(fmaf(s[i][j][2], score_log2, -base1));
        s[i][j][3] = fast_exp2(fmaf(s[i][j][3], score_log2, -base1));
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

    // O += P V, 3xTF32: the scores' registers, split, are the A fragment
    // of each 8-key step (k = t, t + 4 -> keys t, t + 4); each V fragment
    // serves the MT row tiles
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
      // the last group's tiles (if any) and the rest's, in one batch
      constexpr int o = G4 > 0 ? 4 : 0;
      constexpr int NT = o + R / 8;
      uint32_t bb[NT][2], bs[NT][2];
      if constexpr (G4 > 0) group(G4 - 1, bb, bs);
      if constexpr (R == 16) {  // lane g reads columns 2g, 2g + 1
        uint32_t xb[2], xs[2], yb[2], ys[2];
        load_split<2>(v0 + 32 * G4 + 2 * g, xb, xs);
        load_split<2>(v1 + 32 * G4 + 2 * g, yb, ys);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          bb[o + u][0] = xb[u], bb[o + u][1] = yb[u];
          bs[o + u][0] = xs[u], bs[o + u][1] = ys[u];
        }
      } else if constexpr (R == 8) {  // lane g reads column g
        uint32_t xb[1], xs[1], yb[1], ys[1];
        load_split<1>(v0 + 32 * G4 + g, xb, xs);
        load_split<1>(v1 + 32 * G4 + g, yb, ys);
        bb[o][0] = xb[0], bb[o][1] = yb[0], bs[o][0] = xs[0], bs[o][1] = ys[0];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) mma3_tiles<NT>(&acc[i][DN - NT], pb[i], pq[i], bb, bs);
    }
  }

  // The second key group's state joins the first's through `x` (shared
  // memory of at least 32 * RW * kState floats, free until the caller's
  // next barrier): returns whether this warp holds the joined state (the
  // first key group's warps). Every thread of the block calls it.
  __device__ __forceinline__ bool join(float* x, float score_log2) {
    const int warp = threadIdx.x / 32;
    constexpr int kSlots = 32 * RW;  // value e of lane slot at x[e * kSlots + slot]
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
    if (warp >= RW) return false;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* xi = x + i * (4 + 4 * DN) * kSlots;
      float a[2], b[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = xi[r * kSlots + slot];
        const float mn = fmaxf(m[i][r], m1);
        const float base = mn == -INFINITY ? 0.f : mn * score_log2;
        a[r] = fast_exp2(m[i][r] * score_log2 - base);
        b[r] = fast_exp2(m1 * score_log2 - base);
        l[i][r] = l[i][r] * a[r] + xi[(2 + r) * kSlots + slot] * b[r];
      }
#pragma unroll
      for (int j = 0; j < DN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] = acc[i][j][e] * a[e >> 1] + xi[(4 + 4 * j + e) * kSlots + slot] * b[e >> 1];
        }
      }
    }
    return true;
  }

  // The joined state's rows, each divided by its sum (the quad's parts
  // added), into `out`: row r of the block's 64 at out + r * ld; rows at or
  // past `rows` and columns at or past `cols` (a multiple of 4) are not
  // written. rw is this warp's row warp.
  __device__ __forceinline__ void store(float* out, long long ld, int rw, int rows,
                                        int cols) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = l[i][r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float f = 1.f / sum;
        const int qr = 16 * (MT * rw + i) + g + 8 * r;
        if (qr >= rows) continue;
        float* o = out + qr * ld;
        const int e0 = 2 * r, e1 = 2 * r + 1;  // columns 2t and 2t + 1 of each tile
        const float(&a)[DN][4] = acc[i];
#pragma unroll
        for (int c = 0; c < G4; ++c) {
          if (32 * c + 4 * t < cols) {
            *reinterpret_cast<float4*>(o + 32 * c + 4 * t) =
                make_float4(a[4 * c][e0] * f, a[4 * c + 1][e0] * f, a[4 * c + 2][e0] * f,
                            a[4 * c + 3][e0] * f);
          }
          if (32 * c + 16 + 4 * t < cols) {
            *reinterpret_cast<float4*>(o + 32 * c + 16 + 4 * t) =
                make_float4(a[4 * c][e1] * f, a[4 * c + 1][e1] * f, a[4 * c + 2][e1] * f,
                            a[4 * c + 3][e1] * f);
          }
        }
        if constexpr (R == 16) {
          if (32 * G4 + 4 * t < cols) {
            *reinterpret_cast<float4*>(o + 32 * G4 + 4 * t) = make_float4(
                a[4 * G4][e0] * f, a[4 * G4 + 1][e0] * f, a[4 * G4][e1] * f, a[4 * G4 + 1][e1] * f);
          }
        } else if constexpr (R == 8) {
          if (32 * G4 + 2 * t < cols) {
            *reinterpret_cast<float2*>(o + 32 * G4 + 2 * t) =
                make_float2(a[4 * G4][e0] * f, a[4 * G4][e1] * f);
          }
        }
      }
    }
  }
};

}  // namespace f32

}  // namespace attn
}  // namespace polyp
