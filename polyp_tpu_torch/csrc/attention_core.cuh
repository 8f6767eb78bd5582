// The attention core shared by flash_attention.cu and fused_mha.cu: one
// warp's 16 * MT query rows of softmax(Q K^T) V, in the FlashAttention-2
// manner, with the scores, the probabilities and the output accumulator
// held in the registers of mma.sync fragments. Nothing of S, P or O goes
// through shared memory.
//
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
// Head dims: D is a template parameter. The QK^T depth is D padded to 16
// (DK; the tiles' padding columns must hold zeros), P V covers D / 8 n8
// tiles. Shared tiles have a row stride of DK + 8 bf16 (an odd multiple of
// 16 bytes), so the eight rows an ldmatrix phase reads fall in distinct
// banks.
#pragma once

#include "common.cuh"

namespace polyp {
namespace attn {

constexpr float kLog2e = 1.4426950408889634f;

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

}  // namespace attn
}  // namespace polyp
