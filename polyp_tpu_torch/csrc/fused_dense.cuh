// The W8A8 dense's int8-input path (fused_dense.cu, Dense<BN, false> on the
// GEMM core) as the static int8 GEGLU's second product: the same policy
// under its own kernel name (GegluQ8Down), so that a profile counts it with
// the GEGLU and not with the dense.
#pragma once

#include "common.cuh"

namespace polyp {

// out[m, n] = bf16(acc · (sx · sw[n]) + bias[n]), acc = Σ_k x[m, k] · w[n, k]
// (s8×s8→s32) with x [m, c] int8 codes already quantized with sx (a device
// pointer), w [o, c] int8, sw [o] fp32, bias [o] bf16 or null; c a multiple
// of 16, o of 8, x and w 16-byte aligned.
cudaError_t geglu_q8_down(const void* x, const void* w, const void* sw, const void* bias,
                          const void* sx, void* out, int m, int c, int o, cudaStream_t stream);

}  // namespace polyp
