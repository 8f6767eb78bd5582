// Fused GEGLU feed-forward for Hopper (sm_90a):
//   out = bf16(a * gelu_erf(gate)) @ W2^T + b2,  [a | gate] = x @ W1^T + b1,
// with torch-layout weights W1 [2H, C] (a = rows 0..H-1, gate = rows
// H..2H-1, diffusers' chunk(2) order) and W2 [C, H]; x and out are [T, C],
// bf16.
//
// Replaces the TPU kernel polyp_tpu/ops/fused_geglu.py::fused_geglu (body
// _geglu_kernel, pallas_call in fused_geglu), and computes what it does: a
// and gate in fp32, h = a * gelu(gate) rounded to bf16 before the second
// product, that product summed in fp32 over the whole hidden dimension, b2
// added and the result rounded once. gelu uses erff, the exact form, where
// the TPU kernel needed a polynomial because Mosaic has no erf.
//
// What bounds it on the H100: the tensor cores, and the L2 bandwidth that
// feeds them. The FF is the UNet's largest FLOP share (6·T·C·H: 40 GFLOP at
// level 0 of the distilled batch 16, a 41 µs bound at 989 TFLOP/s); its
// bytes in device memory (x, the weights, h, out) are tens of MB. Design:
// two launches of the GEMM core (gemm_core.cuh: TMA into a ring of stages,
// wgmma from shared memory, accumulators in registers).
// * Launch 1, h = bf16(a * gelu(gate)): a block owns 128 tokens (two
//   warpgroups sharing each weight tile) × 128 hidden units, or 64 tokens
//   (and 64 units) where those tiles would leave SMs idle. Each stage
//   brings one x chunk and the two matching W1 chunks, rows h0.. and H+h0..
//   of the weight as it lies. Two wgmma accumulators hold a and gate of the
//   same (token, unit) in the same registers' positions; the epilogue adds
//   b1, applies the gate in fp32, rounds h to bf16 and writes it to the
//   [T, H] workspace the wrapper allocates. The [T, 2H] intermediate never
//   reaches device memory, as in the TPU kernel.
// * Launch 2, out = h @ W2^T + b2: each output tile reduces over all of H in
//   its block, or over K slices of a thread-block cluster added in a fixed
//   order where the tiles are few (gemm::plan).
// The earlier WMMA design split H across blocks and wrote fp32 partials of [T, C]
// per 256 hidden units; at the distilled batch 16 those were 105 MB written
// and read back a call, above the whole call's bound. The bf16 h written
// here is 2.5-10x smaller and read once. Sums run in a fixed order (so
// runs repeat bit for bit), but not the TPU's hidden-tile order. Any T; C
// and H multiples of 8 (TMA's 16-byte strides).
//
// fp32 form (polyp_fused_geglu_f32), for the fp32 models the TPU kernel also
// took (the tiny UNets of the distillation A/B): the same two launches on
// CUDA cores, h kept in fp32 as the plain version keeps it for fp32 inputs.
// Each block computes a 64 x 64 output tile from 16-wide K slices staged in
// shared memory, 4 x 4 outputs a thread (two accumulator sets for a and gate
// in the first launch), each sum in K order. Simple, not tuned: those
// models' FFs are a few MFLOP. Any T, C and H.

#include "gemm_core.cuh"

using polyp::bf16;
namespace gemm = polyp::gemm;

namespace {

constexpr int kChunk = gemm::kChunkBytes / 2;  // bf16 K chunk
// the calling warpgroup's 64 rows of a [rows][128 B] activation chunk
__device__ __forceinline__ const unsigned char* wg_rows(const unsigned char* st) {
  return st + (threadIdx.x >> 7) * (gemm::kWgRows * gemm::kChunkBytes);
}

// a * gelu(gate) in fp32, gelu in its exact erf form
__device__ __forceinline__ float gelu_gate(float a, float g) {
  return a * (0.5f * g * (1.f + erff(g * 0.70710678118654752f)));
}

// Launch 1: [a | gate] of BN hidden units for BM tokens, then h.
template <int BM, int BN>
struct GegluUp : gemm::Policy {
  static constexpr int kRows = BM, kBN = BN, kAcc = 2, kInFlight = 1;
  static constexpr int kBlocksPerSM = BM == gemm::kWgRows ? 2 : 1;
  using Acc = float;
  static constexpr int kXBytes = BM * gemm::kChunkBytes;  // the x chunk
  static constexpr int kWBytes = BN * gemm::kChunkBytes;  // one W1 half's chunk
  static constexpr int kStageBytes = kXBytes + 2 * kWBytes;
  struct Params {
    CUtensorMap x, w1;
    const bf16* b1;
    bf16* out;      // h [T, H]
    int m, n, n_k;  // T, H, C chunks
  };
  __device__ static void load(const Params& p, unsigned char* st, int kc, int m0, int n0,
                              uint64_t* bar) {
    gemm::tma_load(st, &p.x, bar, kc * kChunk, m0);
    gemm::tma_load(st + kXBytes, &p.w1, bar, kc * kChunk, n0);
    gemm::tma_load(st + kXBytes + kWBytes, &p.w1, bar, kc * kChunk, p.n + n0);
  }
  __device__ static void mma(const Params&, unsigned char* st, float (&acc)[2][BN / 2]) {
    const unsigned char* x = wg_rows(st);
    gemm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {  // 32 bytes a k16 step
      const uint64_t a = gemm::smem_desc(x + kk * 32);
      gemm::Wgmma<BN>::bf16_ss(acc[0], a, gemm::smem_desc(st + kXBytes + kk * 32), 1);
      gemm::Wgmma<BN>::bf16_ss(acc[1], a, gemm::smem_desc(st + kXBytes + kWBytes + kk * 32), 1);
    }
    gemm::wgmma_commit();
  }
  __device__ static __nv_bfloat162 epilogue(const Params& p, int col, const float (&v)[2][2]) {
    const float2 ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.b1 + col));
    const float2 bg =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.b1 + p.n + col));
    return __floats2bfloat162_rn(gelu_gate(v[0][0] + ba.x, v[1][0] + bg.x),
                                 gelu_gate(v[0][1] + ba.y, v[1][1] + bg.y));
  }
};

// Launch 2: out = h @ W2^T + b2 for BM tokens × BN output columns.
template <int BM, int BN>
struct GegluDown : gemm::Policy {
  static constexpr int kRows = BM, kBN = BN, kAcc = 1, kInFlight = 1;
  static constexpr int kBlocksPerSM = BM == gemm::kWgRows ? 2 : 1;
  using Acc = float;
  static constexpr int kXBytes = BM * gemm::kChunkBytes;  // the h chunk
  static constexpr int kStageBytes = kXBytes + BN * gemm::kChunkBytes;
  struct Params {
    CUtensorMap h, w2;
    const bf16* b2;
    bf16* out;
    int m, n, n_k;  // T, C, H chunks
  };
  __device__ static void load(const Params& p, unsigned char* st, int kc, int m0, int n0,
                              uint64_t* bar) {
    gemm::tma_load(st, &p.h, bar, kc * kChunk, m0);
    gemm::tma_load(st + kXBytes, &p.w2, bar, kc * kChunk, n0);
  }
  __device__ static void mma(const Params&, unsigned char* st, float (&acc)[1][BN / 2]) {
    gemm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      gemm::Wgmma<BN>::bf16_ss(acc[0], gemm::smem_desc(wg_rows(st) + kk * 32),
                               gemm::smem_desc(st + kXBytes + kk * 32), 1);
    }
    gemm::wgmma_commit();
  }
  __device__ static __nv_bfloat162 epilogue(const Params& p, int col, const float (&v)[1][2]) {
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.b2 + col));
    return __floats2bfloat162_rn(v[0][0] + b.x, v[0][1] + b.y);
  }
};

template <int BM, int BN>
cudaError_t launch_up(const void* x, const void* w1, const void* b1, bf16* h, int t, int c,
                      int hidden, cudaStream_t stream) {
  using P = GegluUp<BM, BN>;
  typename P::Params p{};
  cudaError_t err = gemm::encode_map(&p.x, x, false, t, c, BM);
  if (err == cudaSuccess) err = gemm::weight_map(&p.w1, w1, false, 2LL * hidden, c, BN);
  if (err != cudaSuccess) return err;
  p.b1 = static_cast<const bf16*>(b1);
  p.out = h;
  p.m = t;
  p.n = hidden;
  p.n_k = (c + kChunk - 1) / kChunk;
  return gemm::launch<P>(p, stream);
}

template <int BM, int BN>
cudaError_t launch_down(const bf16* h, const void* w2, const void* b2, void* out, int t, int c,
                        int hidden, cudaStream_t stream) {
  using P = GegluDown<BM, BN>;
  typename P::Params p{};
  cudaError_t err = gemm::encode_map(&p.h, h, false, t, hidden, BM);
  if (err == cudaSuccess) err = gemm::weight_map(&p.w2, w2, false, c, hidden, BN);
  if (err != cudaSuccess) return err;
  p.b2 = static_cast<const bf16*>(b2);
  p.out = static_cast<bf16*>(out);
  p.m = t;
  p.n = c;
  p.n_k = (hidden + kChunk - 1) / kChunk;
  return gemm::launch<P>(p, stream);
}

// 128 rows a block (two warpgroups sharing each weight tile, half the
// weight's reads from L2) where T has them and the tiles still cover a
// quarter of the SMs (a K split can take them further); else 64.
bool wide_rows(int t, int n, int bn) {
  const long long tiles = static_cast<long long>((t + 127) / 128) * ((n + bn - 1) / bn);
  return t >= 128 && tiles * 4 >= gemm::sm_count();
}

template <int BM>
cudaError_t launch_down_at(const bf16* h, const void* w2, const void* b2, void* out, int t, int c,
                           int hidden, cudaStream_t stream) {
  switch (gemm::pick_width(c)) {
    case 160:
      return launch_down<BM, 160>(h, w2, b2, out, t, c, hidden, stream);
    case 128:
      return launch_down<BM, 128>(h, w2, b2, out, t, c, hidden, stream);
    default:
      return launch_down<BM, 64>(h, w2, b2, out, t, c, hidden, stream);
  }
}

}  // namespace

// bf16 elements of the h workspace [T, H] that polyp_fused_geglu needs.
extern "C" long long polyp_fused_geglu_workspace(int t, int c, int h) {
  (void)c;
  return static_cast<long long>(t) * h;
}

extern "C" int polyp_fused_geglu(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* ws, void* out, int t, int c, int h,
                                 void* stream) {
  if (t == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* hs = static_cast<bf16*>(ws);
  // launch 1: 128 hidden units a block, 64 where the tiles are too few
  cudaError_t err;
  if (wide_rows(t, h, 128)) {
    err = launch_up<128, 128>(x, w1, b1, hs, t, c, h, s);
  } else if (static_cast<long long>((t + 63) / 64) * ((h + 127) / 128) >= gemm::sm_count()) {
    err = launch_up<64, 128>(x, w1, b1, hs, t, c, h, s);
  } else {
    err = launch_up<64, 64>(x, w1, b1, hs, t, c, h, s);
  }
  if (err != cudaSuccess) return err;
  return wide_rows(t, c, gemm::pick_width(c)) ? launch_down_at<128>(hs, w2, b2, out, t, c, h, s)
                                               : launch_down_at<64>(hs, w2, b2, out, t, c, h, s);
}


namespace {

namespace f32 {

constexpr int kTile = 64, kSlice = 16, kThreads = 256, kPer = kTile / 16;

// kGated: out[T, N] = (x W[:N]^T + b[:N]) * gelu(x W[N:]^T + b[N:]) (launch 1,
// W is w1 [2N, K]); else out[T, N] = x W^T + b (launch 2, W is w2 [N, K]).
template <bool kGated>
__global__ void __launch_bounds__(kThreads)
    geglu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ out, int m, int n, int k) {
  constexpr int kAcc = kGated ? 2 : 1;
  __shared__ float xs[kSlice][kTile + 4];  // [k][row]
  __shared__ float ws[kAcc][kSlice][kTile + 4];  // [k][column]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[kAcc][kPer][kPer] = {};
  for (int k0 = 0; k0 < k; k0 += kSlice) {
    for (int i = threadIdx.x; i < kTile * kSlice; i += kThreads) {
      const int r = i / kSlice, kk = i % kSlice, gk = k0 + kk;
      xs[kk][r] = (m0 + r < m && gk < k) ? x[static_cast<long long>(m0 + r) * k + gk] : 0.f;
#pragma unroll
      for (int g = 0; g < kAcc; ++g) {
        ws[g][kk][r] = (n0 + r < n && gk < k)
                           ? w[static_cast<long long>(g * n + n0 + r) * k + gk]
                           : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlice; ++kk) {
      float xr[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) xr[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int g = 0; g < kAcc; ++g) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float wv = ws[g][kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kPer; ++i) acc[g][i][j] = fmaf(xr[i], wv, acc[g][i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = n0 + tx + 16 * j;
      if (row >= m || col >= n) continue;
      float v = acc[0][i][j] + b[col];
      if constexpr (kGated) v = gelu_gate(v, acc[kAcc - 1][i][j] + b[n + col]);
      out[static_cast<long long>(row) * n + col] = v;
    }
  }
}

}  // namespace f32

}  // namespace

// fp32 elements of the h workspace [T, H] that polyp_fused_geglu_f32 needs.
extern "C" long long polyp_fused_geglu_f32_workspace(int t, int c, int h) {
  (void)c;
  return static_cast<long long>(t) * h;
}

// The fp32 form: x and out [T, C], w1 [2H, C], b1 [2H], w2 [C, H], b2 [C],
// all fp32; ws holds h [T, H].
extern "C" int polyp_fused_geglu_f32(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* ws, void* out,
                                     int t, int c, int h, void* stream) {
  if (t == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hs = static_cast<float*>(ws);
  const dim3 block(f32::kThreads);
  const int row_tiles = (t + f32::kTile - 1) / f32::kTile;
  f32::geglu_f32_kernel<true><<<dim3((h + f32::kTile - 1) / f32::kTile, row_tiles), block, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), hs, t, h, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  f32::geglu_f32_kernel<false><<<dim3((c + f32::kTile - 1) / f32::kTile, row_tiles), block, 0, s>>>(
      hs, static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(out), t, c, h);
  return cudaGetLastError();
}
