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
// took (the tiny UNets of the distillation A/B; an SD UNet loaded in fp32),
// h kept in fp32 as the plain version keeps it for fp32 inputs. Products
// to fp32 accuracy on the tensor cores in 3xTF32: each operand split into
// a tf32 big part and a tf32 remainder, big·big + big·small + small·big
// summed in fp32 accumulators (plain TF32 keeps 10 mantissa bits, about
// 5e-4 of a product), the split rounded on the bits (common.cuh). Its
// bound is 6·T·C·H at the 3xTF32 peak, 495 / 3 TFLOP/s (30 us at SD level
// 0, 2,048 x 320 -> 2,560; 75 us at the 67 TFLOP/s fp32 rate the plain
// version runs at), or the weights' bytes where T is small. Its shapes have few tokens
// (256-2,048) and, in the A/B, narrow C (32-64), so output tiles alone
// leave most SMs idle. Design: one launch, and h never leaves the SM, as in
// the TPU kernel (grid token tiles x hidden tiles, the second product
// accumulated in VMEM). A block owns BM tokens (32 or 16) and a slice of
// the hidden units; a thread-block cluster of up to 8 blocks along y (16
// where few tokens leave SMs idle and the card places such a cluster)
// splits H, so T = 256-2,048 gives 64-512 blocks (plan()). A block walks its slice
// in chunks of 64 hidden units: a and gate for its rows (x and the chunk's
// two W1 row ranges streamed through shared memory in 32-wide slices of
// C), the erf gate in fp32, h split and kept in shared memory, then its
// rows' partial output += h_chunk · W2[:, chunk]^T, W2 streamed in blocks
// of 64 output columns, the partial sums in shared memory. Every slice and
// block is a job of one cp.async ring (2-3 stages, one barrier a job), so
// the next jobs' tiles load while this one computes. Within a job each
// warp owns 16 rows x 8 or 16 columns as m16n8k8 mma.sync tiles, its
// fragments read from rows padded by 4 floats (no bank conflicts). Then
// the cluster adds its blocks' partial outputs in rank order through
// distributed shared memory (each block a share of the columns), adds b2
// and writes: no atomics, so runs repeat bit for bit. Any T, C and H: C
// wider than the accumulator that fits in shared memory runs in panels of
// output columns (h recomputed for each; 1,280 columns at BM = 32, 2,496
// at 16), and C or H not a multiple of 4 take 4-byte copies.

#include "gemm_core.cuh"

using polyp::bf16;
namespace cg = cooperative_groups;
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
  cudaError_t err = gemm::encode_map(&p.x, x, gemm::Elem::kBf16, t, c, BM);
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
  cudaError_t err = gemm::encode_map(&p.h, h, gemm::Elem::kBf16, t, hidden, BM);
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

constexpr int kThreads = 256;
constexpr int kHC = 64;          // hidden units a chunk
constexpr int kKS = 32;          // C a first-product slice
constexpr int kCB = 64;          // output columns a second-product block
constexpr int kLDK = kKS + 4;    // floats a staged row of x and W1
constexpr int kLDH = kHC + 4;    // floats a row of h and of a staged W2 block
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kWideCluster = 16; // the non-portable one, where the card takes it

template <int BM>
struct Tiles {
  // warps: WM along the rows (16 each, one mma row tile), WN along the 64
  // columns of a chunk or block, NT n8 tiles a warp
  static constexpr int WM = BM / 16, WN = 8 / WM, NT = kHC / WN / 8;
  // stages of the ring: as many as leave two blocks an SM room at SD
  // level 0 (BM = 32) and level 1 (BM = 16)
  static constexpr int S = BM == 32 ? 2 : 3;
  static constexpr int kX = (BM + 2 * kHC) * kLDK;    // x slice + W1 a and gate slices
  static constexpr int kStage = kX > kCB * kLDH ? kX : kCB * kLDH;  // floats
  static constexpr int kFixed = S * kStage + 2 * BM * kLDH;  // the ring, h big and small
  // bytes of shared memory with an accumulator of `cp` columns
  static size_t smem(int cp) { return sizeof(float) * (kFixed + BM * (cp + 8)); }
};

// the 3xTF32 arithmetic: common.cuh
using polyp::mma3_tf32;
using polyp::split_tf32_bits;

// the B fragment of an m16n8k8 tile, split: rows n of a [n][k] tile (W
// as it lies), k = k0 + t and k0 + t + 4
__device__ __forceinline__ void b_frag(const float* w, int ld, int n, int k0, int t,
                                       uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  split_tf32_bits(w[n * ld + k0 + t], bb[0], bs[0]);
  split_tf32_bits(w[n * ld + k0 + t + 4], bb[1], bs[1]);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
geglu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ out, int T, int C, int H,
                 int cp, int vec4) {
  using G = Tiles<BM>;
  constexpr int NT = G::NT;
  constexpr int W = 8 * NT;  // columns a warp
  extern __shared__ __align__(16) float gsmem[];
  float* ring = gsmem;                  // S stages of kStage floats
  float* sHb = ring + G::S * G::kStage; // h of the chunk [BM][kLDH], tf32 big part
  float* sHs = sHb + BM * kLDH;         // ... and small part
  float* sAcc = sHs + BM * kLDH;        // partial output [BM][cp + 8]
  const int ld_acc = cp + 8;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane >> 2, t4 = lane & 3;  // the mma fragments' group and thread
  const int r0 = 16 * (warp / G::WN) + g8;  // fragment rows r0 and r0 + 8
  const int c0 = (warp % G::WN) * W;        // the warp's first column
  // this block's chunks of H: [ch0, ch0 + my_ch)
  const int n_ch = (H + kHC - 1) / kHC;
  const int ch0 = rank * (n_ch / cs) + min(rank, n_ch % cs);
  const int my_ch = n_ch / cs + (rank < n_ch % cs ? 1 : 0);
  const int n_s = (C + kKS - 1) / kKS;
  const bool v4 = vec4 != 0;

  for (int p0 = 0; p0 < C; p0 += cp) {  // panels of output columns
    const int pw = min(cp, C - p0);
    const int n_b = (pw + kCB - 1) / kCB;
    const int per_ch = n_s + n_b;  // jobs a chunk: n_s slices, then n_b blocks
    const int n_jobs = my_ch * per_ch;
    for (int i = threadIdx.x; i < BM * ld_acc; i += kThreads) sAcc[i] = 0.f;

    auto issue = [&](int j) {
      const int h0 = (ch0 + j / per_ch) * kHC;
      const int s = j % per_ch;
      float* st = ring + (j % G::S) * G::kStage;
      if (s < n_s) {
        const int k0 = s * kKS;
        polyp::load_tile_async_f32(st, kLDK, x + static_cast<long long>(m0) * C + k0, C, BM,
                                   kKS, T - m0, C - k0, v4);
        polyp::load_tile_async_f32(st + BM * kLDK, kLDK, w1 + static_cast<long long>(h0) * C + k0,
                                   C, kHC, kKS, H - h0, C - k0, v4);
        polyp::load_tile_async_f32(st + (BM + kHC) * kLDK, kLDK,
                                   w1 + (static_cast<long long>(H) + h0) * C + k0, C, kHC, kKS,
                                   H - h0, C - k0, v4);
      } else {
        const int col0 = p0 + (s - n_s) * kCB;
        polyp::load_tile_async_f32(st, kLDH, w2 + static_cast<long long>(col0) * H + h0, H, kCB,
                                   kHC, p0 + pw - col0, H - h0, v4);
      }
    };

    float ca[NT][4], cg_[NT][4];  // a and gate of the chunk, mma accumulator tiles
    // S - 1 jobs in flight; a group is committed for every job, empty past
    // the last, so "job j has landed" is always wait<S - 2>
#pragma unroll
    for (int j = 0; j < G::S - 1; ++j) {
      if (j < n_jobs) issue(j);
      polyp::cp_async_commit();
    }
    for (int j = 0; j < n_jobs; ++j) {
      polyp::cp_async_wait<G::S - 2>();
      __syncthreads();  // job j has landed, and every thread is done with job j - 1
      if (j + G::S - 1 < n_jobs) issue(j + G::S - 1);  // into job j - 1's stage
      polyp::cp_async_commit();
      const int s = j % per_ch;
      const float* st = ring + (j % G::S) * G::kStage;
      if (s < n_s) {  // a and gate over this slice of C, in order
        if (s == 0) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) ca[nt][e] = cg_[nt][e] = 0.f;
          }
        }
        const float* sx = st;
        const float* swa = st + BM * kLDK;
        const float* swg = swa + kHC * kLDK;
#pragma unroll
        for (int k = 0; k < kKS; k += 8) {
          uint32_t ab[4], as[4];
          split_tf32_bits(sx[r0 * kLDK + k + t4], ab[0], as[0]);
          split_tf32_bits(sx[(r0 + 8) * kLDK + k + t4], ab[1], as[1]);
          split_tf32_bits(sx[r0 * kLDK + k + t4 + 4], ab[2], as[2]);
          split_tf32_bits(sx[(r0 + 8) * kLDK + k + t4 + 4], ab[3], as[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bb[2], bs[2];
            b_frag(swa, kLDK, c0 + 8 * nt + g8, k, t4, bb, bs);
            mma3_tf32(ca[nt], ab, as, bb, bs);
            b_frag(swg, kLDK, c0 + 8 * nt + g8, k, t4, bb, bs);
            mma3_tf32(cg_[nt], ab, as, bb, bs);
          }
        }
        if (s == n_s - 1) {  // h of the chunk (0 past H), split for the second product
          const int h0 = (ch0 + j / per_ch) * kHC;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = c0 + 8 * nt + 2 * t4;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int hid = h0 + col + e;
                v[e] = hid < H ? gelu_gate(ca[nt][2 * half + e] + b1[hid],
                                           cg_[nt][2 * half + e] + b1[H + hid])
                               : 0.f;
              }
              uint32_t big[2], small[2];
              split_tf32_bits(v[0], big[0], small[0]);
              split_tf32_bits(v[1], big[1], small[1]);
              const int at = (r0 + 8 * half) * kLDH + col;
              *reinterpret_cast<float2*>(sHb + at) =
                  make_float2(__uint_as_float(big[0]), __uint_as_float(big[1]));
              *reinterpret_cast<float2*>(sHs + at) =
                  make_float2(__uint_as_float(small[0]), __uint_as_float(small[1]));
            }
          }
        }
      } else {  // this block's partial output += h · W2 block^T over the chunk
        float co[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) co[nt][e] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < kHC; k += 8) {
          const int at[4] = {r0 * kLDH + k + t4, (r0 + 8) * kLDH + k + t4,
                             r0 * kLDH + k + t4 + 4, (r0 + 8) * kLDH + k + t4 + 4};
          uint32_t ab[4], as[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ab[e] = __float_as_uint(sHb[at[e]]);
            as[e] = __float_as_uint(sHs[at[e]]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bb[2], bs[2];
            b_frag(st, kLDH, c0 + 8 * nt + g8, k, t4, bb, bs);
            mma3_tf32(co[nt], ab, as, bb, bs);
          }
        }
        float* acc = sAcc + (s - n_s) * kCB + c0 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2* p = reinterpret_cast<float2*>(acc + (r0 + 8 * half) * ld_acc + 8 * nt);
            float2 v = *p;
            v.x += co[nt][2 * half];
            v.y += co[nt][2 * half + 1];
            *p = v;
          }
        }
      }
    }

    // the cluster's partial outputs added in rank order: this block takes
    // columns [c_lo, c_lo + width) of the panel
    cluster.sync();
    const int per = (pw + cs - 1) / cs;
    const int c_lo = min(pw, rank * per);
    const int width = min(pw, c_lo + per) - c_lo;
    for (int e = threadIdx.x; e < BM * width; e += kThreads) {
      const int r = e / width;
      const int c = c_lo + e % width;
      if (m0 + r >= T) continue;
      float v = 0.f;
      for (int q = 0; q < cs; ++q) v += cluster.map_shared_rank(sAcc, q)[r * ld_acc + c];
      out[static_cast<long long>(m0 + r) * C + p0 + c] = v + b2[p0 + c];
    }
    cluster.sync();  // the peers have read this accumulator
  }
}

// The launch's plan (timed on the H100 at distill_ab's and SD's shapes,
// PERF.md): the cluster splits H into up to 8 slices of whole chunks; the
// row tile is 32 tokens where that gives every SM two blocks, else 16 where
// that gives it one. With fewer tokens (SD's level 2 and mid) the cluster
// grows to 16 slices where the card can place such a cluster, and wide
// weights (C >= 256, tens of MB, read once per row tile) take 32-token
// tiles where a quarter of the SMs still get a block.
struct Plan {
  int bm, cs;
};

template <int BM>
struct Launch {
  using G = Tiles<BM>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  int cp = 0;

  // the configuration, the widest panel (a multiple of kCB) whose
  // accumulator fits, and the cluster (16 falls back to 8 where the card
  // cannot place it)
  cudaError_t prepare(int t, int c, int cs, int max_smem, cudaStream_t stream) {
    cp = (c + kCB - 1) / kCB * kCB;
    while (cp > kCB && G::smem(cp) > static_cast<size_t>(max_smem)) cp -= kCB;
    const size_t smem = G::smem(cp);
    auto kernel = geglu_f32_kernel<BM>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess && cs > kMaxCluster) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3((t + BM - 1) / BM, cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = cs;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cs > kMaxCluster) {
      int clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess ||
          clusters < 1) {
        cudaGetLastError();  // clear a refusal of the query
        cfg.gridDim.y = kMaxCluster;
        attr[0].val.clusterDim.y = kMaxCluster;
      }
    }
    return cudaSuccess;
  }
};

int max_smem() {
  int device = 0, bytes = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

Plan plan(int t, int c, int h) {
  Plan p;
  const int n_ch = (h + kHC - 1) / kHC;
  const long long sms = gemm::sm_count();
  auto blocks = [&](int bm, int cs) { return static_cast<long long>((t + bm - 1) / bm) * cs; };
  p.cs = n_ch < kMaxCluster ? n_ch : kMaxCluster;
  if (blocks(32, p.cs) >= 2 * sms) {
    p.bm = 32;
  } else if (blocks(16, p.cs) >= sms) {
    p.bm = 16;
  } else {
    p.cs = n_ch < kWideCluster ? n_ch : kWideCluster;
    p.bm = c >= 256 && blocks(32, p.cs) * 4 >= sms ? 32 : 16;
  }
  return p;
}

template <int BM>
cudaError_t launch(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, float* out, int t, int c, int h, int cs,
                   cudaStream_t stream) {
  Launch<BM> l;
  cudaError_t err = l.prepare(t, c, cs, max_smem(), stream);
  if (err != cudaSuccess) return err;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
        reinterpret_cast<uintptr_t>(w2)) % 16) == 0;
  const int vec4 = c % 4 == 0 && h % 4 == 0 && aligned ? 1 : 0;
  err = cudaLaunchKernelEx(&l.cfg, geglu_f32_kernel<BM>, x, w1, b1, w2, b2, out, t, c, h, l.cp,
                           vec4);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BM>
cudaError_t describe(int t, int c, int cs, int* out) {
  Launch<BM> l;
  cudaError_t err = l.prepare(t, c, cs, max_smem(), nullptr);
  out[0] = BM;
  out[1] = static_cast<int>(l.cfg.gridDim.y);
  out[2] = l.cp;
  out[3] = static_cast<int>(l.cfg.dynamicSmemBytes);
  return err;
}

}  // namespace f32

}  // namespace

// The fp32 form: x and out [T, C], w1 [2H, C], b1 [2H], w2 [C, H], b2 [C],
// all fp32; one launch, no workspace.
extern "C" int polyp_fused_geglu_f32(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* out, int t, int c,
                                     int h, void* stream) {
  if (t == 0) return cudaSuccess;
  if (c < 1 || h < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const f32::Plan p = f32::plan(t, c, h);
  const auto* xp = static_cast<const float*>(x);
  const auto* w1p = static_cast<const float*>(w1);
  const auto* b1p = static_cast<const float*>(b1);
  const auto* w2p = static_cast<const float*>(w2);
  const auto* b2p = static_cast<const float*>(b2);
  auto* op = static_cast<float*>(out);
  return p.bm == 32 ? f32::launch<32>(xp, w1p, b1p, w2p, b2p, op, t, c, h, p.cs, s)
                    : f32::launch<16>(xp, w1p, b1p, w2p, b2p, op, t, c, h, p.cs, s);
}

// The fp32 form's launch for [t, c] x h, without launching it: out =
// {tokens a block, the cluster's blocks, the panel's columns, dynamic shared
// memory bytes}; chip_smoke.py prints it beside the kernel's times.
extern "C" int polyp_fused_geglu_f32_plan(int t, int c, int h, int* out) {
  const f32::Plan p = f32::plan(t, c, h);
  return p.bm == 32 ? f32::describe<32>(t, c, p.cs, out) : f32::describe<16>(t, c, p.cs, out);
}
