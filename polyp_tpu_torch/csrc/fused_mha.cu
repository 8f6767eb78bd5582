// Fused multi-head attention block for Hopper (sm_90a):
//   out = softmax((x Wq^T)(ctx Wk^T)^T / sqrt(d)) (ctx Wv^T) Wo^T
// over bf16 x [B, Tq, C], ctx [B, Tk, Ckv], with torch Linear weights
// Wq [H*D, C], Wk and Wv [H*D, Ckv], Wo [Co, H*D]; out [B, Tq, Co] bf16,
// fp32 accumulation throughout. The caller adds the out-projection bias.
//
// Replaces the TPU kernel polyp_tpu/ops/fused_mha.py::fused_mha (body
// _mha_kernel, pallas_call in _fused_mha_impl). Like it, the projections, an
// fp32 online softmax with ragged keys masked to -inf before the max, and
// the output projection summed over heads run in this file; neither the
// T x T scores nor a per-head output reaches device memory, the softmax
// scale is folded into Q before Q's bf16 rounding, and each head's output
// is rounded to bf16 before its product with Wo.
//
// What bounds it on the H100: at the distilled batch ([16, 1024, 320],
// H = 8, d = 40) the work is 13.4 GFLOP of projections and 21.5 GFLOP of
// attention (about 35 us at 989 TFLOP/s) against about 21 MB of x and out:
// the tensor cores, on paper. In practice its three phases besides the
// attention (the K/V projection, the per-head Q projection and the sum over
// heads) are short reductions whose loads wait on L2 or on another SM's
// shared memory; PERF.md times each phase. The TPU ran its grid over heads
// in order and summed the output projection in VMEM; blocks on the card run
// in no order. The design, and what it does about each limit:
//
// * K and V are projected once per (b, head) by a first launch
//   (kv_project_kernel: mma.sync m16n8k16 from ldmatrix, one 128 x 64 tile
//   of both K and V a block, so the ctx tile is read once for the two) into
//   a bf16 workspace [B, Tk, H*D] that the wrapper allocates. The TPU
//   kernel recomputed them per q-block, which cost nothing at its one
//   1024-row q-block; with 128-row q tiles the recompute would cost C/128
//   times the attention's own work.
// * The heads run in parallel on a thread-block cluster. The grid is
//   (Tq/128, cluster, B) with a cluster of min(H, 8) blocks along the head
//   axis (a block takes ceil(H/8) heads in order when H > 8), launched with
//   cudaLaunchKernelEx: 1,024 blocks at the distilled batch and 256 at the
//   CFG batch. Each block projects
//   Q_h = x_tile Wq_h^T on mma.sync, builds the attention core's A
//   fragments straight from that accumulator (the scale folded in before
//   the bf16 rounding), runs the core (attention_core.cuh: scores,
//   probabilities and the output accumulator in registers, K/V tiles
//   double-buffered with cp.async) over its head's columns of the
//   workspace, and writes o_h, normalised and rounded to bf16, into its own
//   shared memory. At d = 40 a warp takes 32 rows (4 warps), above 16 (8).
// * The sum over heads. After a cluster barrier block j writes the output
//   columns [j*n, (j+1)*n) (n = Co / cluster rounded up to 8; ragged Co
//   masked): the sum over h = 0 .. H-1 in order of o_h (copied from the
//   owning block through distributed shared memory, 16 bytes a load, each
//   warp its own rows) times Wo[cols, h*D:(h+1)*D]^T (all heads' rows of the
//   slice in shared memory by one cp.async batch), the fp32 sum in
//   registers. Fixed order, no atomics: runs repeat bit for bit. A second
//   cluster barrier keeps every block's shared memory alive until no block
//   reads it.
// * Shared memory: one region serves in turn the Q-projection stages, the
//   K/V stages and the out projection's Wo slice and o_h copy, beside the
//   block's o_h tiles: 65 KB at d = 40 (3 blocks of 4 warps an SM) and
//   86 KB at d = 80 (2 blocks of 8 warps).
// * Head dims 40 and 80 are no multiple of the mma k-step: d is a template
//   parameter (40, 64, 80) and shared tiles are padded to the next multiple
//   of 16 with zeros that the masked loads put there; the weights are read
//   in place, so no padded or transposed weight copy is made.

#include <cooperative_groups.h>

#include <algorithm>

#include "attention_core.cuh"

namespace cg = cooperative_groups;
using polyp::bf16;
using polyp::attn::a_frag_ptr;
using polyp::attn::ldsm_x4;
using polyp::attn::mma_rows_nk;

namespace {

constexpr int kRows = 128;     // query rows per block
constexpr int kKeys = 64;      // K/V rows per tile
constexpr int kThreadsKV = 256;  // the K/V projection: eight warps
constexpr int kChunk = 64;     // reduction chunk of the projections
constexpr int kOutCols = 64;   // most output columns an out-projection chunk (registers)
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int LDC = kChunk + 8;

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int D>
struct MhaShape {
  using H = polyp::attn::Head<D>;
  static constexpr int MT = polyp::attn::rows_per_warp<D>();  // row tiles a warp
  static constexpr int kThreads = 32 * kRows / (16 * MT);
  // Region U holds, one phase at a time: two stages of the Q projection's
  // x chunk and Wq_h chunk; two stages of the K and V tiles; or the out
  // projection's chunk of Wo (out_bytes) and its copy of one o_h.
  static constexpr size_t kStageQ = align128(sizeof(bf16) * (kRows + D) * LDC);
  static constexpr size_t kStageKV = align128(sizeof(bf16) * 2 * kKeys * H::LD);
  static constexpr size_t kU = 2 * (kStageQ > kStageKV ? kStageQ : kStageKV);
  // one [kRows, DK] bf16 tile of o_h per head the block takes
  static constexpr size_t kHeadOut = align128(sizeof(bf16) * kRows * H::LD);
};

// How the heads spread over a cluster, and the out projection's chunks.
struct HeadSplit {
  int per_block;  // heads a block takes, in order
  int cluster;    // blocks of a cluster
  int cols;       // output columns a block writes, a multiple of 8
  int wo_rows;    // Wo rows (output columns) a chunk, a multiple of 16
  int wo_ld;      // row stride of a Wo chunk in shared memory: H * DK + 8
  size_t u_bytes;  // region U: MhaShape::kU or the out projection's need, the larger
  size_t smem;    // dynamic shared memory a block: U, then the o_h tiles
};

template <int D>
HeadSplit head_split(int h, int co) {
  using S = MhaShape<D>;
  HeadSplit s;
  s.per_block = (h + kMaxCluster - 1) / kMaxCluster;
  s.cluster = (h + s.per_block - 1) / s.per_block;
  s.cols = ((co + s.cluster - 1) / s.cluster + 7) / 8 * 8;
  s.wo_ld = h * S::H::DK + 8;
  // a whole column slice a chunk where it fits 64 columns and 48 KB
  const int fit = static_cast<int>(48 * 1024 / (sizeof(bf16) * s.wo_ld)) / 16 * 16;
  s.wo_rows = std::max(16, std::min({(s.cols + 15) / 16 * 16, kOutCols, fit}));
  const size_t out_bytes = align128(sizeof(bf16) * s.wo_rows * s.wo_ld) + S::kHeadOut;
  s.u_bytes = std::max(S::kU, out_bytes);
  s.smem = s.u_bytes + s.per_block * S::kHeadOut;
  return s;
}

// k_out[M, N] = a[M, K] @ wk[N, K]^T and v_out likewise with wv, bf16 out
// with fp32 accumulation: the K and V projections, [B*Tk, H*D]. A block
// takes 128 rows x 64 columns of both, so each a tile is read once for K
// and V: warps 0-3 make K, warps 4-7 V, each 32 rows (two row tiles, so
// every B fragment feeds two mma). N is a multiple of 8.
constexpr int kKvRows = 128;
constexpr size_t kKvStage = align128(sizeof(bf16) * (kKvRows + 2 * 64) * LDC);

__global__ void __launch_bounds__(kThreadsKV, 2)
kv_project_kernel(const bf16* __restrict__ a, const bf16* __restrict__ wk,
                  const bf16* __restrict__ wv, bf16* __restrict__ k_out,
                  bf16* __restrict__ v_out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * kKvRows;
  const int n0 = blockIdx.y * 64;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int which = warp / 4;  // 0: K, 1: V
  bf16* out = which == 0 ? k_out : v_out;

  auto stage = [&](int s) { return reinterpret_cast<bf16*>(smem + (s & 1) * kKvStage); };
  auto issue = [&](int step) {
    const int k0 = step * kChunk;
    bf16* sA = stage(step);
    bf16* sW = sA + kKvRows * LDC;
    polyp::load_tile_async_vec8(sA, LDC, a + static_cast<long long>(m0) * K + k0, K, kKvRows,
                                kChunk, M - m0, K - k0);
    polyp::load_tile_async_vec8(sW, LDC, wk + static_cast<long long>(n0) * K + k0, K, 64, kChunk,
                                N - n0, K - k0);
    polyp::load_tile_async_vec8(sW + 64 * LDC, LDC, wv + static_cast<long long>(n0) * K + k0, K,
                                64, kChunk, N - n0, K - k0);
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  const int n_steps = (K + kChunk - 1) / kChunk;
  issue(0);
  polyp::cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      issue(step + 1);
      polyp::cp_async_commit();
      polyp::cp_async_wait<1>();
    } else {
      polyp::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sA = stage(step) + (warp % 4) * 32 * LDC;
    const bf16* sW = stage(step) + (kKvRows + which * 64) * LDC;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t fa[2][4];
      ldsm_x4(fa[0], a_frag_ptr(sA, LDC, 16 * kk));
      ldsm_x4(fa[1], a_frag_ptr(sA + 16 * LDC, LDC, 16 * kk));
      mma_rows_nk<2, 8>(acc, fa, sW, LDC, 16 * kk);
    }
    __syncthreads();  // this stage may be refilled
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + (warp % 4) * 32 + 16 * i + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      if (n0 + 8 * j >= N) continue;
      if (r < M) {
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r) * N + c) =
            polyp::attn::pack_bf16(acc[i][j][0], acc[i][j][1]);
      }
      if (r + 8 < M) {
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r + 8) * N + c) =
            polyp::attn::pack_bf16(acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MhaShape<D>::kThreads, D <= 40 ? 3 : 2)
fused_mha_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                 const bf16* __restrict__ kws, const bf16* __restrict__ vws,
                 const bf16* __restrict__ wo, bf16* __restrict__ out, int H, int per_block,
                 int Tq, int Tk, int C, int Co, int cols, int wo_rows, int wo_ld, int u_bytes,
                 float scale) {
  using S = MhaShape<D>;
  using Hd = typename S::H;
  constexpr int LD = Hd::LD;
  constexpr int DN = Hd::DN;
  constexpr int MT = S::MT;
  constexpr int kThreads = S::kThreads;
  constexpr size_t kTile = S::kHeadOut / sizeof(bf16);  // elements of an o_h tile
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* U = smem;
  bf16* sOut = reinterpret_cast<bf16*>(smem + u_bytes);  // per_block [kRows, LD] tiles of o_h

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 * MT;  // this warp's query rows
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int HD = H * D;
  const bf16* xb = x + (static_cast<long long>(b) * Tq + q0) * C;
  const bf16* kb = kws + static_cast<long long>(b) * Tk * HD;
  const bf16* vb = vws + static_cast<long long>(b) * Tk * HD;

  // the padding columns [D, DK) of the o_h tiles are the out-projection's
  // zero depth
  if (Hd::DK > D) {
    for (int i = threadIdx.x; i < per_block * kRows; i += kThreads) {
      *reinterpret_cast<uint4*>(sOut + i * LD + D) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const int h_begin = rank * per_block;
  const int h_end = min(H, h_begin + per_block);
  const int n_c = (C + kChunk - 1) / kChunk;
  const int n_k = (Tk + kKeys - 1) / kKeys;
  for (int h = h_begin; h < h_end; ++h) {
    // ---- Q_h = x_tile @ Wq[h*D .. h*D+D)^T, C streamed in chunks through
    // two cp.async stages of U
    auto stage_q = [&](int s) { return reinterpret_cast<bf16*>(U + (s & 1) * S::kStageQ); };
    auto issue_q = [&](int step) {
      const int c0 = step * kChunk;
      bf16* sX = stage_q(step);
      polyp::load_tile_async_vec8(sX, LDC, xb + c0, C, kRows, kChunk, Tq - q0, C - c0);
      polyp::load_tile_async_vec8(sX + kRows * LDC, LDC,
                                  wq + static_cast<long long>(h) * D * C + c0, C, D, kChunk, D,
                                  C - c0);
    };
    float qacc[MT][DN][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        qacc[i][j][0] = qacc[i][j][1] = qacc[i][j][2] = qacc[i][j][3] = 0.f;
      }
    }
    __syncthreads();  // U is free: the previous head's K/V tiles are done
    issue_q(0);
    polyp::cp_async_commit();
    for (int step = 0; step < n_c; ++step) {
      if (step + 1 < n_c) {
        issue_q(step + 1);
        polyp::cp_async_commit();
        polyp::cp_async_wait<1>();
      } else {
        polyp::cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sX = stage_q(step);
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t fa[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          ldsm_x4(fa[i], a_frag_ptr(sX + (r0 + 16 * i) * LDC, LDC, 16 * kk));
        }
        mma_rows_nk<MT, DN>(qacc, fa, sX + kRows * LDC, LDC, 16 * kk);
      }
      __syncthreads();  // this stage may be refilled
    }

    // ---- the attention core over 64-key tiles of this head's K and V
    polyp::attn::WarpAttention<D, MT> wa;
    wa.set_q(qacc, scale);
    wa.reset();
    auto stage_kv = [&](int s) { return reinterpret_cast<bf16*>(U + (s & 1) * S::kStageKV); };
    auto issue_kv = [&](int it) {
      const long long k0 = static_cast<long long>(it) * kKeys;
      bf16* sK = stage_kv(it);
      polyp::load_tile_async_vec8(sK, LD, kb + k0 * HD + h * D, HD, kKeys, Hd::DK,
                                  Tk - static_cast<int>(k0), D);
      polyp::load_tile_async_vec8(sK + kKeys * LD, LD, vb + k0 * HD + h * D, HD, kKeys, Hd::DK,
                                  Tk - static_cast<int>(k0), D);
    };
    issue_kv(0);
    polyp::cp_async_commit();
    for (int it = 0; it < n_k; ++it) {
      if (it + 1 < n_k) {
        issue_kv(it + 1);
        polyp::cp_async_commit();
        polyp::cp_async_wait<1>();
      } else {
        polyp::cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sK = stage_kv(it);
      wa.template tile<kKeys>(sK, sK + kKeys * LD, LD, Tk - it * kKeys, polyp::attn::kLog2e);
      __syncthreads();  // this stage may be refilled
    }

    // ---- o_h, normalised and rounded to bf16, into this block's tile
    bf16* tile = sOut + (h - h_begin) * kTile;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float inv0, inv1;
      wa.finish(i, inv0, inv1);
      bf16* lo = tile + (r0 + 16 * i + g) * LD + 2 * t;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        *reinterpret_cast<uint32_t*>(lo + 8 * j) = wa.out_pair(i, j, false, inv0, inv1);
        *reinterpret_cast<uint32_t*>(lo + 8 * LD + 8 * j) = wa.out_pair(i, j, true, inv0, inv1);
      }
    }
  }

  cluster.sync();  // every o_h of the cluster is written; U is free

  // ---- out[kRows, cols of this block] = sum over h in order of o_h Wo_h^T,
  // in chunks of wo_rows columns. The chunk's Wo rows for every head come
  // in by one cp.async batch ([wo_rows][H * DK + 8], each head's DK columns
  // side by side); then each warp takes its own rows with no block barrier:
  // it copies its rows of o_h from the block that owns head h into its own
  // slice of U (16-byte reads of distributed shared memory, the next head's
  // in flight while this one multiplies) and multiplies them by the chunk.
  const int c_begin = rank * cols;
  const int c_end = min(Co, c_begin + cols);
  constexpr int kVecRow = Hd::DK / 8;            // 16-byte vectors a row of o_h
  constexpr int kVec = 16 * MT * kVecRow / 32;   // a lane's vectors of the warp's rows
  static_assert(16 * MT * kVecRow % 32 == 0, "whole vectors a lane");
  bf16* sW = reinterpret_cast<bf16*>(U);
  bf16* sA = reinterpret_cast<bf16*>(U + align128(sizeof(bf16) * wo_rows * wo_ld)) + r0 * LD;
  auto fetch = [&](uint4 (&buf)[kVec], int hh) {
    const bf16* oh =
        cluster.map_shared_rank(sOut + (hh % per_block) * kTile, hh / per_block) + r0 * LD;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int v = lane + 32 * u;
      buf[u] = *reinterpret_cast<const uint4*>(oh + (v / kVecRow) * LD + v % kVecRow * 8);
    }
  };
  for (int n0 = c_begin; n0 < c_end; n0 += wo_rows) {
    const int n_end = min(c_end, n0 + wo_rows);
    __syncthreads();  // every warp is done with the previous chunk
    for (int hh = 0; hh < H; ++hh) {
      polyp::load_tile_async_vec8(sW + hh * Hd::DK, wo_ld,
                                  wo + static_cast<long long>(n0) * HD + hh * D, HD, wo_rows,
                                  Hd::DK, n_end - n0, D);
    }
    polyp::cp_async_commit();
    uint4 buf[kVec];
    fetch(buf, 0);
    polyp::cp_async_wait<0>();
    __syncthreads();

    float acc[MT][kOutCols / 8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < kOutCols / 8; ++j) {
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
      }
    }
    for (int hh = 0; hh < H; ++hh) {
      __syncwarp();  // the warp is done with the previous head's copy
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int v = lane + 32 * u;
        *reinterpret_cast<uint4*>(sA + (v / kVecRow) * LD + v % kVecRow * 8) = buf[u];
      }
      __syncwarp();
      if (hh + 1 < H) fetch(buf, hh + 1);
#pragma unroll
      for (int kk = 0; kk < Hd::KS; ++kk) {
        uint32_t fa[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) ldsm_x4(fa[i], a_frag_ptr(sA + 16 * i * LD, LD, 16 * kk));
#pragma unroll
        for (int jn = 0; jn < kOutCols / 16; ++jn) {
          if (n0 + 16 * jn >= n_end) break;  // uniform over the block
          uint32_t bw[4];
          ldsm_x4(bw, polyp::attn::b_frag_ptr(sW + hh * Hd::DK, wo_ld, 16 * jn, 16 * kk));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            polyp::attn::mma_16816(acc[i][2 * jn], fa[i], bw[0], bw[1]);
            polyp::attn::mma_16816(acc[i][2 * jn + 1], fa[i], bw[2], bw[3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = q0 + r0 + 16 * i + g;
#pragma unroll
      for (int j = 0; j < kOutCols / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = r + (e >> 1) * 8;
          const int c = n0 + 8 * j + 2 * t + (e & 1);
          if (rr < Tq && c < n_end) {
            out[(static_cast<long long>(b) * Tq + rr) * Co + c] = __float2bfloat16(acc[i][j][e]);
          }
        }
      }
    }
  }

  cluster.sync();  // no block leaves while another reads its o_h tiles
}

template <int D>
cudaError_t launch_mha(const bf16* x, const bf16* wq, const bf16* kws, const bf16* vws,
                       const bf16* wo, bf16* out, int B, int H, int Tq, int Tk, int C, int Co,
                       float scale, cudaStream_t stream) {
  const HeadSplit split = head_split<D>(H, Co);
  const size_t smem = split.smem;
  cudaError_t err = cudaFuncSetAttribute(fused_mha_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Tq + kRows - 1) / kRows, split.cluster, B);
  cfg.blockDim = dim3(MhaShape<D>::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_mha_kernel<D>, x, wq, kws, vws, wo, out, H,
                           split.per_block, Tq, Tk, C, Co, split.cols, split.wo_rows,
                           split.wo_ld, static_cast<int>(split.u_bytes), scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// ctx [B*Tk, Ckv] -> K and V workspaces [B*Tk, H*D]; then the cluster
// kernel. Sizes: C, Ckv and H*D multiples of 8, d in {40, 64, 80}; the
// wrapper checks them.
extern "C" int polyp_fused_mha(const void* x, const void* ctx, const void* wq, const void* wk,
                               const void* wv, const void* wo, void* k_ws, void* v_ws, void* out,
                               int b, int tq, int tk, int c, int ckv, int h, int d, int co,
                               float scale, void* stream) {
  if (d != 40 && d != 64 && d != 80) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = h * d;
  const int m = b * tk;
  const size_t kv_smem = 2 * kKvStage;
  cudaError_t err = cudaFuncSetAttribute(kv_project_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kv_smem));
  if (err != cudaSuccess) return err;
  dim3 kv_grid((m + kKvRows - 1) / kKvRows, (hd + 63) / 64);
  kv_project_kernel<<<kv_grid, kThreadsKV, kv_smem, s>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<bf16*>(k_ws), static_cast<bf16*>(v_ws), m, hd, ckv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wqp = static_cast<const bf16*>(wq);
  const bf16* kp = static_cast<const bf16*>(k_ws);
  const bf16* vp = static_cast<const bf16*>(v_ws);
  const bf16* wop = static_cast<const bf16*>(wo);
  bf16* op = static_cast<bf16*>(out);
  switch (d) {
    case 40: return launch_mha<40>(xp, wqp, kp, vp, wop, op, b, h, tq, tk, c, co, scale, s);
    case 64: return launch_mha<64>(xp, wqp, kp, vp, wop, op, b, h, tq, tk, c, co, scale, s);
    default: return launch_mha<80>(xp, wqp, kp, vp, wop, op, b, h, tq, tk, c, co, scale, s);
  }
}

// Dynamic shared memory a fused MHA block takes at h heads of d and co
// output columns (0 if d is not built): chip_smoke.py reports it beside the
// registers.
extern "C" long long polyp_fused_mha_smem(int h, int d, int co) {
  switch (d) {
    case 40: return head_split<40>(h, co).smem;
    case 64: return head_split<64>(h, co).smem;
    case 80: return head_split<80>(h, co).smem;
    default: return 0;
  }
}
