// Fused GEGLU feed-forward for Hopper (sm_90a):
//   out = (a * gelu_erf(gate)) @ W2^T + b2,  [a | gate] = x @ W1^T + b1,
// with torch-layout weights W1 [2H, C] (a = rows 0..H-1, gate = rows H..2H-1,
// diffusers' chunk(2) order) and W2 [C, H]; x and out are [T, C], bf16.
//
// Replaces the TPU kernel polyp_tpu/ops/fused_geglu.py::fused_geglu (body
// _geglu_kernel, pallas_call in fused_geglu). Like it, the [T, 2H]
// intermediate never reaches device memory: each hidden tile of a and gate
// is made in fp32, turned into h = a * gelu(gate) and rounded to bf16 (as the
// TPU kernel rounds h before its second dot) in shared memory, where the
// second product reads it. gelu uses erff, the exact form, where the TPU
// kernel needed a polynomial because Mosaic has no erf.
//
// What bounds it on the H100: the FF is the UNet's largest FLOP share
// (about 10 GFLOP per call at each SD level), work for the tensor cores, so
// no product may be computed twice and every SM needs work. The TPU kernel
// carried its fp32 accumulator across a sequential grid over the hidden
// dimension; blocks here run in parallel, so the hidden dimension is split
// across blocks instead. Block (64 tokens, a split of 256 hidden units, or
// 128 or 64 where T is too small to fill the SMs otherwise) makes its slice
// of h once (phase 1: x and W1 chunks through a two-stage cp.async
// pipeline), keeps it in shared memory, and multiplies it into every output
// column tile (phase 2: W2 slices through the same pipeline), storing fp32
// partial sums [split, token, column] to a workspace the wrapper allocates.
// A second kernel adds the splits in a fixed order, plus b2, and rounds to
// bf16: deterministic, no atomics. Both products run on the tensor cores
// through WMMA bf16 fragments with fp32 accumulation. The workspace costs
// 4 bytes per (split, token, column) written and read once, which is far
// less than the product's work at SD widths. Any T is masked, so the
// mid-block FF at batch 2 (64 tokens), which the TPU package left on XLA,
// runs here too; C and H must be multiples of 8. wgmma and TMA are later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using polyp::bf16;

namespace {

constexpr int kT = 64;         // token rows per block
constexpr int kSplit = 256;    // most hidden units per block (one split)
constexpr int kH = 64;         // hidden units per tile inside a split
constexpr int kC = 64;         // reduction chunk over C in phase 1
constexpr int kN = 128;        // output columns per tile in phase 2
constexpr int kThreads = 256;  // 8 warps: 4 row blocks x 2 column halves
constexpr int LDX = kC + 8;    // bf16 strides in shared memory
constexpr int LDW1 = kC + 8;
constexpr int LDW2 = kH + 8;
constexpr int LDH = kSplit + 8;
constexpr int LDAG = kH + 4;   // fp32 stride of the a / gate tiles
// one phase-1 pipeline stage: the x chunk and the matching Wa and Wg chunks;
// in phase 2 the same memory holds two W2 slices [kN x kH]
constexpr int kStage = kT * LDX + 2 * kH * LDW1;
constexpr size_t kSmemBf16 = sizeof(bf16) * (2 * kStage + kT * LDH);
constexpr size_t kSmem = kSmemBf16 + sizeof(float) * kT * LDAG;
// Two blocks fit on an SM (2 x 104 KB of its 227 KB) because the a tile
// borrows the stage just consumed.
static_assert(sizeof(float) * kT * LDAG <= sizeof(bf16) * kStage, "a tile fits a stage");
static_assert(kN * LDW2 <= kStage, "a W2 slice fits a stage");
static_assert(kSplit % kH == 0, "a split is whole hidden tiles");

struct Workspace {
  int split, splits, t_pad, c_pad;
  long long floats() const { return static_cast<long long>(splits) * t_pad * c_pad; }
};

// Hidden units per block: kSplit, halved (down to kH) while the grid would
// leave SMs idle, which happens at small T. A smaller split means more
// partial sums to store and reduce, so it is taken only there.
Workspace workspace_of(int t, int c, int h) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int tiles = (t + kT - 1) / kT;
  int split = kSplit;
  while (split > kH && tiles * ((h + split - 1) / split) < sms) split /= 2;
  return {split, (h + split - 1) / split, tiles * kT, (c + kN - 1) / kN * kN};
}

__global__ void __launch_bounds__(kThreads, 2)
geglu_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                     float* __restrict__ ws, int T, int C, int H, int split, int c_pad,
                     long long split_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  bf16* sH = stages + 2 * kStage;
  float* sG = reinterpret_cast<float*>(smem + kSmemBf16);

  const int t0 = blockIdx.x * kT;
  const int hs0 = blockIdx.y * split;
  const int warp = threadIdx.x / 32;
  const int wr = warp % 4;  // 16-row block of the token tile
  const int wc = warp / 4;  // column half
  const int n_ht = (min(split, H - hs0) + kH - 1) / kH;  // hidden tiles here

  // ---- phase 1: sH[:, j*kH ...] = bf16(a * gelu(gate)) for hidden tile j.
  // Step s covers hidden tile s / n_c and C chunk s % n_c; its tiles are
  // copied with cp.async into stage s % 2 while step s - 1 computes.
  const int n_c = (C + kC - 1) / kC;
  const int n_steps = n_ht * n_c;
  auto issue_step = [&](int step) {
    const int h0 = hs0 + (step / n_c) * kH;
    const int c0 = (step % n_c) * kC;
    bf16* sX = stages + (step & 1) * kStage;
    bf16* sWa = sX + kT * LDX;
    bf16* sWg = sWa + kH * LDW1;
    polyp::load_tile_async_vec8(sX, LDX, x + static_cast<long long>(t0) * C + c0, C, kT, kC,
                                T - t0, C - c0);
    polyp::load_tile_async_vec8(sWa, LDW1, w1 + static_cast<long long>(h0) * C + c0, C, kH,
                                kC, H - h0, C - c0);
    polyp::load_tile_async_vec8(sWg, LDW1, w1 + static_cast<long long>(H + h0) * C + c0, C,
                                kH, kC, H - h0, C - c0);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_a[2], acc_g[2];
  issue_step(0);
  polyp::cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int ht = step / n_c;
    const int ci = step % n_c;
    if (ci == 0) {
      for (int j = 0; j < 2; ++j) {
        wmma::fill_fragment(acc_a[j], 0.f);
        wmma::fill_fragment(acc_g[j], 0.f);
      }
    }
    if (step + 1 < n_steps) {
      issue_step(step + 1);
      polyp::cp_async_commit();
      polyp::cp_async_wait<1>();  // all but the step just issued have landed
    } else {
      polyp::cp_async_wait<0>();
    }
    __syncthreads();

    // a and gate for this hidden tile: each warp makes 16 rows x 32 columns
    // of both. W1 rows are hidden units, so the [C x 64] operand is the
    // shared tile read column-major.
    const bf16* sX = stages + (step & 1) * kStage;
    const bf16* sWa = sX + kT * LDX;
    const bf16* sWg = sWa + kH * LDW1;
    for (int kk = 0; kk < kC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sX + (wr * 16) * LDX + kk * 16, LDX);
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        const int col = wc * 32 + j * 16;
        wmma::load_matrix_sync(b, sWa + col * LDW1 + kk * 16, LDW1);
        wmma::mma_sync(acc_a[j], a, b, acc_a[j]);
        wmma::load_matrix_sync(b, sWg + col * LDW1 + kk * 16, LDW1);
        wmma::mma_sync(acc_g[j], a, b, acc_g[j]);
      }
    }

    if (ci == n_c - 1) {
      // every warp is done reading this stage: the a tile takes its place
      __syncthreads();
      float* sA = reinterpret_cast<float*>(stages + (step & 1) * kStage);
      for (int j = 0; j < 2; ++j) {
        const int off = (wr * 16) * LDAG + wc * 32 + j * 16;
        wmma::store_matrix_sync(sA + off, acc_a[j], LDAG, wmma::mem_row_major);
        wmma::store_matrix_sync(sG + off, acc_g[j], LDAG, wmma::mem_row_major);
      }
      __syncthreads();
      // h = (a + b1a) * gelu(gate + b1g), rounded to bf16; 0 past H
      const int h0 = hs0 + ht * kH;
      for (int i = threadIdx.x; i < kT * kH; i += kThreads) {
        const int r = i / kH;
        const int c = i % kH;
        const int hh = h0 + c;
        float hv = 0.f;
        if (hh < H) {
          const float a = sA[r * LDAG + c] + __bfloat162float(b1[hh]);
          const float g = sG[r * LDAG + c] + __bfloat162float(b1[H + hh]);
          hv = a * (0.5f * g * (1.f + erff(g * 0.70710678118654752f)));
        }
        sH[r * LDH + ht * kH + c] = __float2bfloat16(hv);
      }
    }
    __syncthreads();  // this stage may be refilled
  }

  // ---- phase 2: ws[split, t0.., n0..] = sH @ W2[n0.., hs0..]^T for every
  // output column tile n0. Step s covers column tile s / n_ht and hidden
  // tile s % n_ht; its W2 slice [kN x kH] (rows are output columns: read
  // column-major) goes into stage s % 2.
  const int n_steps2 = ((C + kN - 1) / kN) * n_ht;
  auto issue_w2 = [&](int step) {
    const int n0 = (step / n_ht) * kN;
    const int h0 = hs0 + (step % n_ht) * kH;
    polyp::load_tile_async_vec8(stages + (step & 1) * kStage, LDW2,
                                w2 + static_cast<long long>(n0) * H + h0, H, kN, kH, C - n0,
                                H - h0);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
  issue_w2(0);
  polyp::cp_async_commit();
  for (int step = 0; step < n_steps2; ++step) {
    const int n0 = (step / n_ht) * kN;
    const int ht = step % n_ht;
    if (ht == 0) {
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    }
    if (step + 1 < n_steps2) {
      issue_w2(step + 1);
      polyp::cp_async_commit();
      polyp::cp_async_wait<1>();
    } else {
      polyp::cp_async_wait<0>();
    }
    __syncthreads();

    const bf16* sW2 = stages + (step & 1) * kStage;
    for (int kk = 0; kk < kH / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sH + (wr * 16) * LDH + ht * kH + kk * 16, LDH);
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, sW2 + (wc * 64 + j * 16) * LDW2 + kk * 16, LDW2);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    if (ht == n_ht - 1) {
      // padded rows and columns of the workspace take the masked tile edges
      float* dst = ws + blockIdx.y * split_stride + static_cast<long long>(t0 + wr * 16) * c_pad +
                   n0 + wc * 64;
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(dst + j * 16, acc[j], c_pad, wmma::mem_row_major);
      }
    }
    __syncthreads();  // this stage may be refilled
  }
}

// out[t, c] = bf16(b2[c] + sum over splits of ws[s, t, c]), splits in order.
__global__ void geglu_reduce_kernel(const float* __restrict__ ws, const bf16* __restrict__ b2,
                                    bf16* __restrict__ out, int T, int C, int splits, int c_pad,
                                    long long split_stride) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(T) * C) return;
  const int t = static_cast<int>(i / C);
  const int c = static_cast<int>(i % C);
  const float* p = ws + static_cast<long long>(t) * c_pad + c;
  float sum = __bfloat162float(b2[c]);
  for (int s = 0; s < splits; ++s) sum += p[s * split_stride];
  out[i] = __float2bfloat16(sum);
}

}  // namespace

// Floats of fp32 workspace that polyp_fused_geglu needs for these sizes.
extern "C" long long polyp_fused_geglu_workspace(int t, int c, int h) {
  return workspace_of(t, c, h).floats();
}

extern "C" int polyp_fused_geglu(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* ws, void* out, int t, int c, int h,
                                 void* stream) {
  const Workspace w = workspace_of(t, c, h);
  const long long split_stride = static_cast<long long>(w.t_pad) * w.c_pad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(geglu_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid(w.t_pad / kT, w.splits);
  geglu_partial_kernel<<<grid, kThreads, kSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<float*>(ws), t, c, h, w.split, w.c_pad,
      split_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(t) * c;
  geglu_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const bf16*>(b2), static_cast<bf16*>(out), t, c,
      w.splits, w.c_pad, split_stride);
  return cudaGetLastError();
}
