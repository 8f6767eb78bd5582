// The int8 GEGLU's second products on the W8A8 dense's int8-input path
// (fused_dense.cu, Dense<BN, false> on the GEMM core): the static form's is
// the same policy under its own kernel name (GegluQ8Down), the per-token
// form's adds its hidden groups in fp32 (GegluQ8PtDown), so that a profile
// counts each with its GEGLU and not with the dense. Each has an fp32 form
// (an fp32 bias and out): GegluQ8DownF32, GegluQ8PtDownF32.
#pragma once

#include "common.cuh"

namespace polyp {

// out[m, n] = bf16(acc · (sx · sw[n]) + bias[n]), acc = Σ_k x[m, k] · w[n, k]
// (s8×s8→s32) with x [m, c] int8 codes already quantized with sx (a device
// pointer), w [o, c] int8, sw [o] fp32, bias [o] bf16 or null; c a multiple
// of 16, o of 8, x and w 16-byte aligned. With f32 (GegluQ8DownF32) the
// bias and out are fp32 and out is not rounded.
cudaError_t geglu_q8_down(const void* x, const void* w, const void* sw, const void* bias,
                          const void* sx, void* out, int m, int c, int o, bool f32,
                          cudaStream_t stream);

// The per-token int8 GEGLU's second product (GegluQ8PtDown):
// out[m, n] = bf16(Σ_g float(acc_g) · (sh[m, g] · sw[n]) + bias[n]), acc_g =
// Σ_{k in group g} codes[m, k] · w[n, k] (s8×s8→s32), the groups of block_h
// hidden units added in order g = 0, 1, ...; codes [m, h] int8, sh [m, h /
// block_h] fp32, w [o, h] int8, sw [o] fp32, bias [o] bf16; h a multiple of
// 16 and of block_h, o of 8, pointers 16-byte aligned. With f32
// (GegluQ8PtDownF32) the bias and out are fp32: out = the sum + bias[n].
cudaError_t geglu_q8_pt_down(const void* codes, const void* sh, const void* w, const void* sw,
                             const void* bias, void* out, int m, int h, int o, int block_h,
                             bool f32, cudaStream_t stream);

}  // namespace polyp
