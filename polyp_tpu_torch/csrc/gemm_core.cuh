// One GEMM core for Hopper (sm_90a), shared by the bf16 GEGLU
// (fused_geglu.cu: its two products), the W8A8 dense (fused_dense.cu) and
// both int8 GEGLU forms (fused_geglu_w8a8.cu: two products each):
//   D[m, n] = sum_k A[m, k] * B[n, k],
// A [M, K] row-major activations and B [N, K] torch-layout weights ([out,
// in], read in place), both K-major, as 8-bit wgmma requires. The sums stay
// in registers and go to the caller's epilogue with their columns.
//
// What bounds these products on the H100: the GEGLU's are work for the
// tensor cores (6·T·C·H: 40 GFLOP a call at level 0 of the distilled batch
// 16), fed from L2, whose bandwidth a small tile exhausts first (a 64-row
// tile re-reads all of W1 every 64 tokens); the dense's are bytes (bf16 in
// and out at C, O <= 1280), its quantize and, at the few tiles of small M,
// latency. The design:
// * TMA copies each tile (cp.async.bulk.tensor.2d, 128-byte swizzle) into
//   a ring of up to kMaxStages stages in dynamic shared memory, one K chunk
//   of 128 bytes a row (64 bf16 or 128 int8) a stage, each stage with a full
//   and an empty mbarrier, issued by one producer warp. TMA's zero fill past
//   a tensor's edge masks ragged M, N and K: the kernels have no masking
//   code of their own.
// * One or two consumer warpgroups a block issue wgmma.mma_async on 64 rows
//   each and BN columns (BN in {64, 128, 160}; 2 x 160 covers O = 320
//   exactly): bf16 x bf16 -> fp32 (m64nNk16) with both operands read from
//   shared memory through matrix descriptors that match the TMA swizzle, or
//   s8 x s8 -> s32 (m64nNk32) with A built in registers by the caller (the
//   dense quantizes its bf16 activations on the way) and B from shared
//   memory. Two warpgroups share each B tile: half the weight's reads from
//   L2 a FLOP.
// * Persistent blocks walk the output tiles; the producer streams on across
//   tile boundaries, so a tile's first chunks load while the previous
//   tile's epilogue runs. The epilogue turns the sums into outputs in
//   registers (bf16, or fp32 for the int8 kernels' fp32 forms: the policy's
//   Out), stages them in shared memory (in the tile's last ring stage where
//   it fits) and writes them out in coalesced 16-byte stores.
// * An A-stationary mode (the int8 GEGLU's first product, whose epilogue
//   dominates): a block keeps its row panel of A, all of K, in shared
//   memory, written once by its own threads, and walks that panel's column
//   tiles with only B streaming; its two consumer warpgroups take alternate
//   tiles, each from a ring of its own, so one's epilogue overlaps the
//   other's products. The per-token form also keeps row statistics beside
//   the panel and takes its tiles in units (its quantization groups), which
//   a panel's split over blocks keeps whole and whose end every consumer
//   thread marks; its second product folds each group's int32 sums into
//   fp32 ones after the group's last K chunk, with K never split.
// * A tile plan per shape (plan()): where the output tiles cannot fill the
//   SMs (the CFG batch's level 2 and mid block, the cross-attention K/V at
//   M = N·77), K is split across a thread-block cluster of up to 8 blocks
//   instead; the cluster's slices are added in rank order through
//   distributed shared memory, each block finishing its own rows: a fixed
//   order, no atomics, no workspace, so runs repeat bit for bit.
// * Tensor maps are built on the host with cuTensorMapEncodeTiled, reached
//   through the runtime's driver entry point so the library links without
//   -lcuda, and passed as __grid_constant__ kernel parameters. A weight's
//   maps are cached by (pointer, shape, box); an activation's are built each
//   call.
// setmaxnreg is not used: with it, ptxas budgets registers by whole
// warpgroups (a 288-thread block counts as 384), which capped the
// two-warpgroup kernels at 168 registers and made them spill, and a
// one-warp producer has too few registers to release to raise the
// consumers back.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace polyp {
namespace gemm {

namespace cg = cooperative_groups;

constexpr int kWgRows = 64;                // rows of a consumer warpgroup (128 threads)
constexpr int kChunkBytes = 128;           // a tile row of one K chunk: one swizzle row
constexpr int kAlign = 1024;               // a swizzle atom: 8 rows of 128 bytes
constexpr int kMaxStages = 8;
constexpr int kMaxCluster = 8;             // the portable cluster size
// dynamic shared memory a block may ask for (227 KB), less the static
// barriers' room; and the share of an SM's 228 KB that lets `blocks` share
// it (each also holds 1 KB the system reserves and the static barriers)
constexpr int kSmemLimit = 232448 - 256;
constexpr int smem_share(int blocks) {
  return blocks == 1 ? kSmemLimit : 233472 / blocks - 1024 - 256;
}

// ------------------------------------------------------------------ device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed. A wrong
// parity would wait forever: after about 2.5 s (2^32 clocks) the kernel
// traps instead, so a fault ends the launch with an error, never a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// One TMA tile copy: the box of `map` at (column c0, row c1) into `dst`,
// completing on `bar` with the box's bytes (zeros past the tensor's edge).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The wgmma matrix descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (stride
// byte offset), layout type 1 (128B). A K step inside the row moves the
// start address by its bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{kAlign >> 4} << 32) | (uint64_t{1} << 62);
}

// Byte offset of byte `b` (0..127) of row `r` in a TMA 128-byte-swizzled
// tile (1024-byte aligned): the 16-byte unit index is XORed with r mod 8.
__device__ __forceinline__ int swizzle128(int r, int b) {
  return r * kChunkBytes + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma's wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// a barrier of the block's consumer warpgroups only
template <int kThreadsSynced>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreadsSynced) : "memory");
}

// a barrier of `threads` threads (a multiple of 32) on barrier `id`
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma on one 64-row warpgroup tile, N columns: bf16_ss reads A and B
// through descriptors (fp32 sums); s8_rs takes A as the four 32-bit
// registers of wgmma's 8-bit A fragment (PTX ISA, "Register fragment for
// matrix A", k32: with g = lane / 4 and t = lane % 4 of warp w, a0 holds
// row 16w+g, k 4t..4t+3; a1 row +8; a2 and a3 the same rows at k + 16) and
// B through a descriptor (s32 sums); s8_ss (width 64) reads both through
// descriptors (integer wgmma takes no scale or transpose
// immediates). The sums D are laid out as the mma.sync
// C fragments of warp w, one per 8 columns: d[4j..4j+3] = (row 16w+g, column
// 8j+2t, +1), (row 16w+g+8, same columns). scale_d = 0 would overwrite D.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ static void bf16_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static void s8_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
        ", {%32, %33, %34, %35}, %36, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
          "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
          "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
  __device__ static void s8_ss(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
        ", %32, %33, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
          "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ static void bf16_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static void s8_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
        ", {%64, %65, %66, %67}, %68, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
          "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
          "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
          "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
          "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
          "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
          "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<160> {
  __device__ static void bf16_ss(float (&d)[80], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79} "
        ", %80, %81, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static void s8_rs(int (&d)[80], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79} "
        ", {%80, %81, %82, %83}, %84, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
          "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
          "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
          "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
          "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
          "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
          "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),
          "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),
          "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),
          "+r"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// --------------------------------------------------------------- the kernel
//
// A problem P (a policy class of the calling .cu, deriving from Policy for
// the defaults of the last three entries) gives:
//   kRows, kBN       the block's tile: kRows rows and a width of 64, 128 or
//                    160;
//   kAcc             accumulators of kBN / 2 sums a thread (2: the GEGLU's
//                    a and gate of the same columns), Acc (float or int);
//   kBlocksPerSM     blocks that share an SM (its registers and shared
//                    memory are sized for that many; more hide one block's
//                    epilogue behind another's products);
//   kStageBytes      one stage's tiles (a multiple of kAlign);
//   kInFlight        wgmma groups left running while the next stage is
//                    awaited: 1 where both operands are in shared memory, 0
//                    where the caller builds A in registers;
//   Params           the tensor maps, the output `out` [m, n] and m, n, n_k
//                    (K chunks);
//   load(p, stage, kc, m0, n0, bar)   the TMA copies of chunk kc;
//   mma(p, stage, acc)                fence, wgmma over the chunk for the
//                                     calling warpgroup's rows, commit;
//   epilogue(p, col, v)               the outputs of columns col and col + 1
//                                     (an OutPair<Out>) from v[kAcc][2],
//                                     their sums;
//   Out              bf16 (Policy) or float: the type of `out` and of the
//                    staged output tile;
//   kRings           1 (Policy): one or two consumer warpgroups share each
//                    tile, 64 rows each (two halve B's reads from L2), fed
//                    by one ring. 2: two warpgroups take alternate tiles,
//                    all kRows rows each, each fed by a ring of its own, so
//                    that one's epilogue runs while the other's products
//                    do (on one ring, a warpgroup could wait on a stage
//                    whose phase is two behind: the parities alias). Such a
//                    P stores its tiles itself:
//                    tile_begin(p, scratch, n0)  before the tile's products
//                                     (kScratchBytes a warpgroup);
//                    store(p, acc, staged, scratch, extra, m0, n0)  the
//                                     outputs, staged in the tile's last
//                                     stage (extra: the panel's, below);
//   kPanelChunkBytes 0 (Policy), or an A-stationary panel: the block keeps
//                    its kRows rows of A, all of K, in shared memory, where
//                    panel(p, panel, m0) writes them once (K chunks of
//                    kPanelChunkBytes, laid out as the wgmma descriptor
//                    reads them), walks column tiles of that row panel only
//                    and streams B alone; mma(p, stage, panel_chunk, acc).
//                    kPanelExtraBytes of block-wide room follow the chunks
//                    (row statistics: the per-token GEGLU's row scales and
//                    running maxima); store() gets them as `extra`;
//   kUnits           false (Policy), or a panel's column tiles come in units
//                    of tile_unit(p) tiles (the per-token GEGLU's h
//                    quantization groups): the panel splits over blocks by
//                    whole units, and after a unit's last tile every
//                    consumer thread, whichever warpgroup took the tile,
//                    calls unit_end(p, extra, m0, u), u the unit's index in
//                    the panel;
//   kGroupedK        false (Policy), or after each K chunk's products have
//                    completed (kInFlight 0) the consumers call
//                    chunk_done(p, kc, m0, n0, acc) (the per-token GEGLU's
//                    second product folds each group's int32 sums into
//                    fp32 ones there), and K is never split over a
//                    cluster, so the folds keep their order.
struct Policy {
  using Out = bf16;
  static constexpr int kRings = 1;
  static constexpr int kPanelChunkBytes = 0;
  static constexpr int kPanelExtraBytes = 0;
  static constexpr int kScratchBytes = 0;
  static constexpr bool kUnits = false;
  static constexpr bool kGroupedK = false;
  template <class Params>
  __host__ __device__ static int tile_unit(const Params&) { return 1; }
};

// The panel's chunks and its extra room, rounded up so that the rings after
// them keep the swizzle atoms aligned.
template <class P>
__host__ __device__ constexpr int panel_bytes(int n_k) {
  return (n_k * P::kPanelChunkBytes + P::kPanelExtraBytes + kAlign - 1) / kAlign * kAlign;
}

// Consumer threads: 128 a warpgroup, 64 rows each where they share a tile.
template <class P>
__host__ __device__ constexpr int consumers() {
  return P::kRings > 1 ? P::kRings * 128 : P::kRows * 2;
}

// A barrier of the consumer threads of one tile: all of them where the
// warpgroups share a tile, else the calling warpgroup's (ids 1, 2, ...).
template <class P>
__device__ __forceinline__ void tile_sync() {
  if constexpr (P::kRings > 1) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
  } else {
    consumer_sync<consumers<P>()>();
  }
}

// A ring of `stages` stages, each with a full and an empty mbarrier, at
// slots [first, first + stages) of the block's stages and barriers: its
// i-th chunk takes slot first + i % stages in phase i / stages. The
// producer's wait for a slot to empty (the phase before) and the consumer's
// for it to fill take their parities from here only. It holds two integers
// and no pointers: the kernels' main loops are near their register limits.
struct Ring {
  int first, stages;

  __device__ int slot(int i) const { return first + i % stages; }
  __device__ uint32_t parity(int i) const { return (i / stages) & 1; }
  // the producer: wait for chunk i - stages to be consumed
  __device__ void wait_empty(uint64_t* empty, int i) const {
    if (i >= stages) mbar_wait(&empty[slot(i)], parity(i) ^ 1);
  }
  __device__ void wait_full(uint64_t* full, int i) const { mbar_wait(&full[slot(i)], parity(i)); }
};

// Two outputs of an epilogue, of the policy's output type: bf16 (the
// default) or fp32 (the int8 kernels' fp32 forms).
template <class T>
struct OutPair;
template <>
struct OutPair<bf16> {
  using type = __nv_bfloat162;
  __device__ static type of(float a, float b) { return __floats2bfloat162_rn(a, b); }
};
template <>
struct OutPair<float> {
  using type = float2;
  __device__ static type of(float a, float b) { return make_float2(a, b); }
};

// The staged output tile [kRows][kBN + 8] of P::Out (the padding puts the
// eight rows of a fragment on distinct banks: for bf16 pairs, and for the
// fp32 pairs of each half-warp's store phase). It takes the stage of the
// tile's last chunk, held back from the producer until the tile is written
// out, where the stage is large enough, and room after the ring where not:
// an fp32 tile takes twice a bf16 one's bytes.
template <class P>
__host__ __device__ constexpr int out_tile_bytes() {
  return P::kRows * (P::kBN + 8) * static_cast<int>(sizeof(typename P::Out));
}
template <class P>
__host__ __device__ constexpr bool out_in_stage() {
  return out_tile_bytes<P>() <= P::kStageBytes;
}

// The epilogue of a tile whose K is not split: each thread turns its own
// column pairs into outputs (columns past n left out; n is a multiple of 8,
// so a pair is wholly in or out), all of them before it writes any, so the
// epilogue's loads (bias, scales) issue together rather than one after each
// store; then into the staged tile, and the consumers copy the tile out in
// coalesced 16-byte stores, rows past m left out.
template <class P>
__device__ __forceinline__ void store_tile(const typename P::Params& p,
                                           typename P::Acc (&acc)[P::kAcc][P::kBN / 2],
                                           typename P::Out* tile, int m0, int n0) {
  using Pair = typename OutPair<typename P::Out>::type;
  constexpr int LD = P::kBN + 8;
  constexpr int kVecs = P::kBN / 8;
  // 16-byte vectors of a staged row: kVecs of bf16, twice as many of fp32
  constexpr int kRowVecs = P::kBN * static_cast<int>(sizeof(typename P::Out)) / 16;
  constexpr int kPer = 16 / static_cast<int>(sizeof(typename P::Out));
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int c = (lane & 3) * 2;
  Pair out[kVecs][2];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      typename P::Acc v[P::kAcc][2];
#pragma unroll
      for (int a = 0; a < P::kAcc; ++a) {
        v[a][0] = acc[a][4 * j + 2 * half];
        v[a][1] = acc[a][4 * j + 2 * half + 1];
      }
      out[j][half] = n0 + 8 * j + c < p.n ? P::epilogue(p, n0 + 8 * j + c, v)
                                          : OutPair<typename P::Out>::of(0.f, 0.f);
    }
  }
  // every wgmma of the block has read the stage the tile may take, and the
  // previous tile's copy is done with a tile after the ring
  consumer_sync<consumers<P>()>();
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      *reinterpret_cast<Pair*>(tile + (r + 8 * half) * LD + 8 * j + c) = out[j][half];
    }
  }
  consumer_sync<consumers<P>()>();
  // kRows · kRowVecs / consumers = kRowVecs / 2 vectors a thread
#pragma unroll
  for (int q = 0; q < kRowVecs / 2; ++q) {
    const int i = threadIdx.x + q * consumers<P>();
    const int row = m0 + i / kRowVecs;
    const int col = n0 + (i % kRowVecs) * kPer;
    if (row < p.m && col < p.n) {
      *reinterpret_cast<uint4*>(p.out + static_cast<long long>(row) * p.n + col) =
          *reinterpret_cast<const uint4*>(tile + (i / kRowVecs) * LD + (i % kRowVecs) * kPer);
    }
  }
}

// Where K is split over a cluster: the block's sums to shared memory, kAcc
// tiles [kRows][kBN + 4] (the padding puts the eight rows of a fragment
// store on distinct banks) ...
template <class P>
__device__ __forceinline__ void stash(typename P::Acc* red,
                                      typename P::Acc (&acc)[P::kAcc][P::kBN / 2]) {
  using T = typename P::Acc;
  constexpr int LD = P::kBN + 4;
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int a = 0; a < P::kAcc; ++a) {
    T* tile = red + a * P::kRows * LD;
#pragma unroll
    for (int j = 0; j < P::kBN / 8; ++j) {
      T* p0 = tile + r * LD + 8 * j + c;
      p0[0] = acc[a][4 * j];
      p0[1] = acc[a][4 * j + 1];
      p0[8 * LD] = acc[a][4 * j + 2];
      p0[8 * LD + 1] = acc[a][4 * j + 3];
    }
  }
}

// ... and rows [rank·kRows/cluster, (rank+1)·kRows/cluster) of the tile: each
// thread takes 8 columns of a row, adds the cluster's slices of them in rank
// order through distributed shared memory, and stores their outputs.
template <class P>
__device__ __forceinline__ void reduce_store(const typename P::Params& p,
                                             typename P::Acc* red, int cluster, int rank,
                                             int m0, int n0) {
  using T = typename P::Acc;
  constexpr int LD = P::kBN + 4;
  constexpr int kVecs = P::kBN / 8;
  const int rows = P::kRows / cluster;
  for (int i = threadIdx.x; i < rows * kVecs; i += consumers<P>()) {
    const int r = rank * rows + i / kVecs;
    const int c = (i % kVecs) * 8;
    if (m0 + r >= p.m || n0 + c >= p.n) continue;
    T v[P::kAcc][8] = {};
    for (int q = 0; q < cluster; ++q) {
      const T* src = cg::this_cluster().map_shared_rank(red, q);
#pragma unroll
      for (int a = 0; a < P::kAcc; ++a) {
        const uint4* s =
            reinterpret_cast<const uint4*>(src + a * P::kRows * LD + r * LD + c);
        const uint4 lo = s[0], hi = s[1];
        const T* e0 = reinterpret_cast<const T*>(&lo);
        const T* e1 = reinterpret_cast<const T*>(&hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[a][e] += e0[e];
          v[a][4 + e] += e1[e];
        }
      }
    }
    // the 8 outputs: one 16-byte store of bf16, two of fp32
    using Pair = typename OutPair<typename P::Out>::type;
    constexpr int kStores = static_cast<int>(sizeof(Pair)) * 4 / 16;
    uint4 packed[kStores];
    Pair* o = reinterpret_cast<Pair*>(packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      T pair[P::kAcc][2];
#pragma unroll
      for (int a = 0; a < P::kAcc; ++a) {
        pair[a][0] = v[a][2 * e];
        pair[a][1] = v[a][2 * e + 1];
      }
      o[e] = P::epilogue(p, n0 + c + 2 * e, pair);
    }
    uint4* dst = reinterpret_cast<uint4*>(p.out + static_cast<long long>(m0 + r) * p.n + n0 + c);
#pragma unroll
    for (int u = 0; u < kStores; ++u) dst[u] = packed[u];
  }
}

// How a launch divides the work (plan()): a cluster of `cluster` K slices a
// tile, or persistent blocks; with a panel, `splits` blocks a row panel.
struct Schedule {
  int cluster, stages, splits;
};

// After tile t of a panel: where t is its unit's last tile, the policy's
// unit_end, called by every consumer thread.
template <class P>
__device__ __forceinline__ void end_unit(const typename P::Params& p, unsigned char* extra, int t,
                                         int n_tiles) {
  const int tp = t % n_tiles;
  const int unit = P::tile_unit(p);
  if ((tp + 1) % unit == 0 || tp + 1 == n_tiles) {
    P::unit_end(p, extra, t / n_tiles * P::kRows, tp / unit);
  }
}

// Tiles of kRows rows × kBN columns, column tiles fastest. With cluster == 1
// the blocks are persistent: block b takes tiles b, b + grid, ..., and the
// producer runs ahead across tile boundaries, so a tile's first chunks load
// while the previous tile's epilogue runs. With a cluster of K slices the
// grid is one cluster a tile, the cluster's blocks consecutive in x. With a
// panel, block b takes the column tiles of share b % splits of row panel
// b / splits, in order. Dynamic shared memory: the panel, the rings, the
// warpgroups' scratch (and the output tile where it takes no stage).
template <class P>
__global__ void __launch_bounds__(consumers<P>() + 32, P::kBlocksPerSM)
    gemm_kernel(const __grid_constant__ typename P::Params p, Schedule sched) {
  static_assert(P::kStageBytes % kAlign == 0, "stages keep the swizzle atoms aligned");
  static_assert(P::kPanelChunkBytes % kAlign == 0, "so do the panel's chunks");
  constexpr bool kPanel = P::kPanelChunkBytes > 0;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  unsigned char* smem = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const int cluster = sched.cluster;
  const int stages = sched.stages;  // a ring
  unsigned char* rings = smem + (kPanel ? panel_bytes<P>(p.n_k) : 0);
  uint64_t* full = bars;
  uint64_t* empty = bars + kMaxStages;

  const int n_tiles = (p.n + P::kBN - 1) / P::kBN;
  const int rank = blockIdx.x % cluster;
  int t_begin, t_end, t_step;
  if constexpr (kPanel) {
    // share s of a panel: units [s·units/splits, (s+1)·units/splits)
    const int panel = blockIdx.x / sched.splits, share = blockIdx.x % sched.splits;
    const int unit = P::tile_unit(p);
    const int units = (n_tiles + unit - 1) / unit;
    t_begin = panel * n_tiles + min(share * units / sched.splits * unit, n_tiles);
    t_end = panel * n_tiles + min((share + 1) * units / sched.splits * unit, n_tiles);
    t_step = 1;
  } else {
    t_begin = blockIdx.x / cluster;
    t_end = (p.m + P::kRows - 1) / P::kRows * n_tiles;
    t_step = gridDim.x / cluster;
  }
  const int k_begin = rank * p.n_k / cluster;
  const int n_chunks = (rank + 1) * p.n_k / cluster - k_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kRings * stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers<P>() / P::kRings);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers<P>()) {
    // the producer warp: one thread keeps the rings full, the block's
    // tiles in order, tile q into ring q % kRings, of which it is the
    // (q / kRings)-th tile: that count sets each stage's phase
    if (threadIdx.x == consumers<P>()) {
      int q = 0;
      for (int t = t_begin; t < t_end; t += t_step, ++q) {
        const int m0 = t / n_tiles * P::kRows;
        const int n0 = t % n_tiles * P::kBN;
        const Ring r{q % P::kRings * stages, stages};
        for (int k = 0; k < n_chunks; ++k) {
          const int i = q / P::kRings * n_chunks + k;
          const int s = r.slot(i);
          r.wait_empty(empty, i);
          mbar_expect_tx(&full[s], P::kStageBytes);
          P::load(p, rings + s * P::kStageBytes, k_begin + k, m0, n0, &full[s]);
        }
      }
    }
    __syncwarp();
    if (cluster > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  const int wg = P::kRings > 1 ? threadIdx.x >> 7 : 0;
  const Ring r{wg * stages, stages};
  if constexpr (kPanel) {
    P::panel(p, smem, t_begin / n_tiles * P::kRows);
    // the wgmma reads the panel through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(P::kRings + 1, consumers<P>());
  }
  // this warpgroup's scratch, after the rings
  unsigned char* scratch = rings + (P::kRings * stages * P::kStageBytes + wg * P::kScratchBytes);
  // the panel's extra room
  unsigned char* extra = smem + p.n_k * P::kPanelChunkBytes;
  int i = 0;  // chunks taken from the ring
  int q = 0;
  for (int t = t_begin; t < t_end; t += t_step, ++q) {
    if (q % P::kRings != wg) {
      if constexpr (P::kUnits) end_unit<P>(p, extra, t, n_tiles);
      continue;
    }
    const int m0 = t / n_tiles * P::kRows;
    const int n0 = t % n_tiles * P::kBN;
    if constexpr (P::kRings > 1) P::tile_begin(p, scratch, n0);
    typename P::Acc acc[P::kAcc][P::kBN / 2];
#pragma unroll
    for (int a = 0; a < P::kAcc; ++a) {
#pragma unroll
      for (int e = 0; e < P::kBN / 2; ++e) acc[a][e] = 0;
    }
    for (int k = 0; k < n_chunks; ++k, ++i) {
      r.wait_full(full, i);
      unsigned char* st = rings + r.slot(i) * P::kStageBytes;
      if constexpr (kPanel) {
        P::mma(p, st, smem + (k_begin + k) * P::kPanelChunkBytes, acc);
      } else {
        P::mma(p, st, acc);
      }
      wgmma_wait<P::kInFlight>();
      if constexpr (P::kGroupedK) P::chunk_done(p, k_begin + k, m0, n0, acc);
      // release the chunk before this one (or this one, with nothing in
      // flight), but never the tile's last: the epilogue may use its stage
      const int done = k - P::kInFlight;
      if (done >= 0 && done < n_chunks - 1) mbar_arrive(&empty[r.slot(i - P::kInFlight)]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < P::kAcc; ++a) fence_regs(acc[a]);
    const int last = r.slot(i - 1);
    if constexpr (P::kRings == 1) {
      if (cluster > 1) {
        // one tile a cluster: the stash may take the ring's memory
        consumer_sync<consumers<P>()>();  // every wgmma of the block has read its stages
        typename P::Acc* red = reinterpret_cast<typename P::Acc*>(smem);
        stash<P>(red, acc);
        cluster_sync();  // every block's stash is written
        reduce_store<P>(p, red, cluster, rank, m0, n0);
        cluster_sync();  // no block leaves while another reads its stash
        continue;
      }
      unsigned char* out = out_in_stage<P>() ? rings + last * P::kStageBytes : scratch;
      store_tile<P>(p, acc, reinterpret_cast<typename P::Out*>(out), m0, n0);
    } else {
      P::store(p, acc, rings + last * P::kStageBytes, scratch, extra, m0, n0);
    }
    // the stage goes back to the producer, whose TMA (the async proxy) may
    // overwrite it: order this thread's reads and writes of it first
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&empty[last]);
    if constexpr (P::kUnits) end_unit<P>(p, extra, t, n_tiles);
  }
}

// -------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// A tensor map's element type, by its bytes.
enum class Elem { kInt8 = 1, kBf16 = 2, kFp32 = 4 };

// The map of a row-major [rows, cols] tensor of int8, bf16 or fp32, read in
// boxes of [box_rows, 128 bytes] (128, 64 or 32 elements) with the 128-byte
// swizzle. The base must be 16-byte aligned and a row a multiple of 16
// bytes.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, Elem type, long long rows,
                              long long cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int elem = static_cast<int>(type);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * elem)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunkBytes / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUtensorMapDataType dtype = type == Elem::kInt8   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                    : type == Elem::kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = fn(map, dtype, 2, const_cast<void*>(base), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A weight's map, built once for each (pointer, type, shape, box) and kept:
// the map holds nothing but these, so a cached one is always right.
inline cudaError_t weight_map(CUtensorMap* map, const void* base, bool int8, long long rows,
                              long long cols, int box_rows) {
  using Key = std::tuple<const void*, bool, long long, long long, int>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  const Key key{base, int8, rows, cols, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end()) {
    CUtensorMap fresh;
    const cudaError_t err =
        encode_map(&fresh, base, int8 ? Elem::kInt8 : Elem::kBf16, rows, cols, box_rows);
    if (err != cudaSuccess) return err;
    it = cache.emplace(key, fresh).first;
  }
  *map = it->second;
  return cudaSuccess;
}

// Of the widths {160, 128, 64}: the one that pads n the least, the widest
// of those.
inline int pick_width(int n) {
  int best = 0;
  long long best_cols = -1;
  for (int bn : {160, 128, 64}) {
    const long long cols = static_cast<long long>((n + bn - 1) / bn) * bn;
    if (best_cols < 0 || cols < best_cols) {
      best = bn;
      best_cols = cols;
    }
  }
  return best;
}

inline int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

struct Plan {
  int blocks;
  Schedule sched;
  size_t smem;
};

// Bytes of the epilogue's stash: kAcc fp32/s32 tiles [kRows][kBN + 4].
template <class P>
__host__ __device__ constexpr int stash_bytes() { return P::kAcc * P::kRows * (P::kBN + 4) * 4; }

// The tile plan of P's [m, n] output with n_k K chunks (stages < 2: P
// cannot take it). With a panel: each row panel's column tiles split, by
// whole units of `unit` tiles, over as many blocks as fill the SMs once (at
// least one unit each), and rings as
// deep as fit beside the panel and the scratch. Otherwise K is split over a
// cluster (doubling up to 8) while the tiles, so multiplied, still fit the
// SMs and every block keeps at least two chunks; then a cluster takes one
// tile and its ring holds every chunk of its slice where it fits. Otherwise
// persistent blocks (kBlocksPerSM an SM) walk the tiles, each with the
// deepest ring that lets them share the SM: the producer streams on across
// tiles, so the ring is not cut to one tile's chunks.
template <class P>
Plan plan(int m, int n, int n_k, int unit = 1) {
  Plan pl;
  const int n_tiles = (n + P::kBN - 1) / P::kBN;
  const long long tiles = static_cast<long long>((m + P::kRows - 1) / P::kRows) * n_tiles;
  const int sms = sm_count();
  pl.sched = {1, 0, 1};
  if constexpr (P::kPanelChunkBytes > 0) {
    const int panels = (m + P::kRows - 1) / P::kRows;
    const int units = (n_tiles + unit - 1) / unit;
    const int fill = panels > 0 ? sms / panels : 1;
    pl.sched.splits = fill < 1 ? 1 : (fill < units ? fill : units);
    pl.blocks = panels * pl.sched.splits;
    const int fixed = kAlign + panel_bytes<P>(n_k) + P::kRings * P::kScratchBytes;
    pl.sched.stages = (kSmemLimit - fixed) / (P::kRings * P::kStageBytes);
    if (pl.sched.stages > kMaxStages / P::kRings) pl.sched.stages = kMaxStages / P::kRings;
    pl.smem = fixed + P::kRings * pl.sched.stages * P::kStageBytes;
    return pl;
  }
  while (!P::kGroupedK && pl.sched.cluster < kMaxCluster && tiles * pl.sched.cluster * 2 <= sms &&
         n_k >= 4 * pl.sched.cluster) {
    pl.sched.cluster *= 2;
  }
  int chunks;
  int budget = kSmemLimit;
  if (pl.sched.cluster > 1) {
    pl.blocks = static_cast<int>(tiles) * pl.sched.cluster;
    chunks = (n_k + pl.sched.cluster - 1) / pl.sched.cluster;
  } else {
    const long long slots = static_cast<long long>(sms) * P::kBlocksPerSM;
    pl.blocks = static_cast<int>(tiles < slots ? tiles : slots);
    chunks = static_cast<int>((tiles + pl.blocks - 1) / pl.blocks) * n_k;
    budget = smem_share(P::kBlocksPerSM);
  }
  // a cluster's stash overlays the ring; otherwise the output tile takes a
  // stage or follows the ring
  const int out = pl.sched.cluster > 1 || out_in_stage<P>() ? 0 : out_tile_bytes<P>();
  int fit = (budget - kAlign - out) / P::kStageBytes;
  if (fit < 2) fit = (kSmemLimit - kAlign - out) / P::kStageBytes;
  pl.sched.stages = chunks < fit ? chunks : fit;
  if (pl.sched.stages > kMaxStages) pl.sched.stages = kMaxStages;
  const int used = pl.sched.stages * P::kStageBytes + out;
  pl.smem = kAlign + (used > stash_bytes<P>() ? used : stash_bytes<P>());
  return pl;
}

template <class P>
cudaError_t launch(const typename P::Params& p, cudaStream_t stream) {
  const Plan pl = plan<P>(p.m, p.n, p.n_k, P::tile_unit(p));
  if (pl.blocks == 0) return cudaSuccess;
  if (pl.sched.stages < 2 && P::kPanelChunkBytes > 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.blocks);
  cfg.blockDim = dim3(consumers<P>() + 32);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.sched.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.sched.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, gemm_kernel<P>, p, pl.sched);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gemm
}  // namespace polyp
