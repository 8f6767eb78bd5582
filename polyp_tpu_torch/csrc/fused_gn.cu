// GroupNorm(+SiLU) for Hopper (sm_90a) over NCHW-contiguous tensors.
//
// Replaces the TPU kernel polyp_tpu/ops/fused_gn.py::fused_group_norm (body
// _gn_kernel, pallas_call in fused_group_norm), int8 epilogue included. It
// computes what polyp_tpu/ops/groupnorm.py defines: fp32 sums of x and x^2
// per (sample, group), var = E[x^2] - E[x]^2 clamped at 0, then per-channel
// scale and offset, then SiLU if asked; the output has the input's type
// (fp32 or bf16), or, given an activation scale s (w8a8_static's
// producer-side handoff to the consuming int8 conv), is the int8 code
// clip(rint(y / s), -127, 127) of the fp32 y, in the same NCHW layout. s is
// read from device memory (a per-timestep gather), so no host sync.
//
// What bounds it on the H100: bytes. It does about 10 FLOP per element and
// moves 2 (bf16) or 4 (fp32) bytes in and out, far below the ~295 FLOP per
// byte where compute would limit: x read once and y written once is the
// bound. In NCHW one group of one sample is one contiguous run of (C/G)·H·W
// elements. Design:
// * Where a group is larger than 64 KB (the VAE decoder's 64², 128² and
//   256² levels: 128 KB to 1 MB a group in bf16, 64 groups at batch 2, one
//   block each leaving half the SMs idle), a thread-block cluster of k ∈
//   {2, 4, 8} blocks shares it, each block a contiguous slice of its run of
//   at most 64 KB where k = 8 allows. Small groups (every UNet shape) keep
//   one block a group.
// * Each block reads its slice once, in 16-byte loads (8 bf16 or 4 fp32 a
//   thread), keeps up to 64 KB of it in shared memory (three blocks an SM:
//   keeping a whole 128 KB slice left one block an SM and measured slower
//   than reading it twice), and takes its partial (Σx, Σx²) in fp32. The
//   cluster adds the partials in rank order through distributed shared
//   memory: a fixed order, no atomics, so runs repeat bit for bit and every
//   block holds the same statistics.
// * Each block then normalises its slice, the kept part from shared memory
//   and the rest (the 1 MB bf16 and the fp32 groups) read again, from L2
//   where it stayed there, with the channel's multiply and add, computed
//   once a vector (not a division an element; a per-channel table in
//   shared memory measured no faster), and writes y once, 16 bytes (or the
//   int8 codes) a thread.
// H·W not a multiple of the vector width takes the same path one element a
// thread. No per-sample size cap, unlike the TPU kernel
// (MAX_SAMPLE_ELEMENTS).

#include <cooperative_groups.h>

#include "int8_mma.cuh"

using polyp::bf16;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCluster = 8;
constexpr long long kSliceCache = 64 * 1024;   // most bytes of x a block keeps
constexpr long long kSmallGroup = 64 * 1024;   // bytes one block reads fast enough alone

// V elements of T, one aligned load or store
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One block: the slice [rank·nv/k, (rank+1)·nv/k) of the V-element vectors
// of group blockIdx.x / k, with k = the cluster's size, the first kept_vecs of
// them kept in shared memory.
template <typename T, int V, bool kQ8>
__global__ void __launch_bounds__(kThreads)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, void* __restrict__ y, int C, int HW, int G,
                  int cluster, int kept_vecs, float eps, int silu,
                  const float* __restrict__ act_scale) {
  using In = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][kThreads / 32];
  const int threads = blockDim.x;
  __shared__ float partial[2];  // this block's (Σx, Σx²), read by the cluster
  __shared__ float stats[2];
  const int group = blockIdx.x / cluster;
  const int rank = blockIdx.x % cluster;
  const int n = group / G;
  const int g = group % G;
  const int cg_ = C / G;
  const long long cnt = static_cast<long long>(cg_) * HW;
  const long long base = (static_cast<long long>(n) * C + static_cast<long long>(g) * cg_) * HW;
  // a group's vectors fit an int: 2^31 elements would be 4 GB of bf16
  const int nv = static_cast<int>(cnt / V);
  const int v0 = static_cast<int>(static_cast<long long>(rank) * nv / cluster);
  const int v1 = static_cast<int>(static_cast<long long>(rank + 1) * nv / cluster);
  const In* xv = reinterpret_cast<const In*>(x + base);
  In* kept = reinterpret_cast<In*>(smem);

  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int i = v0 + threadIdx.x; i < v1; i += threads) {
    const In p = xv[i];
    if (i - v0 < kept_vecs) kept[i - v0] = p;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = polyp::to_float(p.v[e]);
      s1 += v;
      s2 += v * v;
    }
  }
  s1 = polyp::warp_sum(s1);
  s2 = polyp::warp_sum(s2);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < threads / 32 ? red[0][lane] : 0.f;
    s2 = lane < threads / 32 ? red[1][lane] : 0.f;
    s1 = polyp::warp_sum(s1);
    s2 = polyp::warp_sum(s2);
    if (lane == 0) {
      partial[0] = s1;
      partial[1] = s2;
    }
  }
  if (cluster > 1) {
    cluster_arrive();  // every block's partial is written
    cluster_wait();
  }
  if (threadIdx.x == 0) {
    // the partials added in rank order, the same order in every block
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < cluster; ++q) {
      const float* their = cluster > 1 ? cg::this_cluster().map_shared_rank(partial, q) : partial;
      t1 += their[0];
      t2 += their[1];
    }
    const float mean = t1 / static_cast<float>(cnt);
    const float var = fmaxf(t2 / static_cast<float>(cnt) - mean * mean, 0.f);
    stats[0] = mean;
    stats[1] = rsqrtf(var + eps);
  }
  // no block leaves (its partial with it) before every block has read it:
  // the matching wait is the kernel's last step
  if (cluster > 1) cluster_arrive();
  __syncthreads();
  const float mean = stats[0], rstd = stats[1];

  const float q_scale = kQ8 ? *act_scale : 0.f;
  const int hw_v = HW / V;  // a vector never straddles channels
#pragma unroll 4
  for (int i = v0 + threadIdx.x; i < v1; i += threads) {
    const In p = i - v0 < kept_vecs ? kept[i - v0] : xv[i];
    // the channel's multiply and add, once a vector of its elements
    const int c = g * cg_ + i / hw_v;
    const float m = rstd * gamma[c];
    const float a = beta[c] - mean * m;
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float v = polyp::to_float(p.v[e]) * m + a;
      if (silu) v = v / (1.f + __expf(-v));
      o[e] = v;
    }
    if constexpr (kQ8) {
      Pack<int8_t, V> q;
#pragma unroll
      for (int e = 0; e < V; ++e) q.v[e] = static_cast<int8_t>(polyp::quant_s8(o[e], q_scale));
      reinterpret_cast<Pack<int8_t, V>*>(static_cast<int8_t*>(y) + base)[i] = q;
    } else {
      In q;
#pragma unroll
      for (int e = 0; e < V; ++e) q.v[e] = polyp::from_float<T>(o[e]);
      reinterpret_cast<In*>(static_cast<T*>(y) + base)[i] = q;
    }
  }
  if (cluster > 1) cluster_wait();
}

// The plan of one launch: the cluster size k (doubling up to 8 while a
// slice is larger than kSmallGroup: a block streams that much about as
// fast as the card allows, and a large group alone on one SM, as the VAE's
// 64 groups at batch 2 are, leaves the others idle), the largest slice's
// vectors and those a block keeps in shared memory, and the threads of a
// block.
struct Plan {
  int cluster, vecs, kept, threads;
  size_t smem;
};

Plan plan(long long cnt, int elem, int vec) {
  const long long bytes = cnt * elem;
  Plan p{1, 0, 0, 0, 0};
  while (p.cluster < kMaxCluster && bytes / p.cluster > kSmallGroup) p.cluster *= 2;
  p.vecs = static_cast<int>((cnt / vec + p.cluster - 1) / p.cluster);  // ceil(nv / k)
  const int room = static_cast<int>(kSliceCache / (vec * elem));
  p.kept = p.vecs < room ? p.vecs : room;
  p.smem = static_cast<size_t>(p.kept) * vec * elem;
  // a thread a vector up to kThreads: the tiny groups (the UNet's 4x4 and
  // 8x8 levels) run fewer warps through the reductions
  p.threads = p.vecs >= kThreads ? kThreads : (p.vecs + 31) / 32 * 32;
  return p;
}

// The elements a thread loads at once: 16 bytes where H·W and the pointers
// allow them, single elements otherwise.
int vec_of(int elem, int hw, bool aligned) {
  const int v = 16 / elem;
  return hw % v == 0 && aligned ? v : 1;
}

template <typename T, int V, bool kQ8>
cudaError_t launch_v(const T* x, const float* gamma, const float* beta, void* y, int N, int C,
                     int HW, int G, float eps, int silu, const float* act_scale,
                     cudaStream_t stream) {
  const Plan pl = plan(static_cast<long long>(C / G) * HW, sizeof(T), V);
  auto kernel = group_norm_kernel<T, V, kQ8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * G * pl.cluster);
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, x, gamma, beta, y, C, HW, G, pl.cluster, pl.kept, eps,
                           silu, act_scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool kQ8>
cudaError_t launch_gn(const void* x, const float* gamma, const float* beta, void* y, int N, int C,
                      int HW, int G, float eps, int silu, const float* act_scale,
                      cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec_of(sizeof(T), HW, aligned) == V) {
    return launch_v<T, V, kQ8>(xp, gamma, beta, y, N, C, HW, G, eps, silu, act_scale, stream);
  }
  return launch_v<T, 1, kQ8>(xp, gamma, beta, y, N, C, HW, G, eps, silu, act_scale, stream);
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* gamma, const float* beta, void* y, int N,
                         int C, int HW, int G, float eps, int silu, const float* act_scale,
                         cudaStream_t stream) {
  if (N == 0 || HW == 0) return cudaSuccess;
  if (act_scale) {
    return launch_gn<T, true>(x, gamma, beta, y, N, C, HW, G, eps, silu, act_scale, stream);
  }
  return launch_gn<T, false>(x, gamma, beta, y, N, C, HW, G, eps, silu, nullptr, stream);
}

}  // namespace

// act_scale: nullptr for an output in x's type, else the int8 epilogue's
// device-resident fp32 scale.
extern "C" int polyp_group_norm(const void* x, const void* gamma, const void* beta, void* y,
                                int n, int c, int hw, int groups, float eps, int silu,
                                int is_bf16, const void* act_scale, void* stream) {
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  const float* sp = static_cast<const float*>(act_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_typed<bf16>(x, gp, bp, y, n, c, hw, groups, eps, silu, sp, s);
  return launch_typed<float>(x, gp, bp, y, n, c, hw, groups, eps, silu, sp, s);
}

// The plan of a launch over aligned tensors of C channels in `groups`
// groups at H·W = hw: out = {cluster, the largest slice's vectors, those
// of them kept in shared memory, threads a block}.
extern "C" void polyp_group_norm_plan(int c, int hw, int groups, int is_bf16, long long* out) {
  const int elem = is_bf16 ? 2 : 4;
  const Plan p = plan(static_cast<long long>(c / groups) * hw, elem, vec_of(elem, hw, true));
  out[0] = p.cluster;
  out[1] = p.vecs;
  out[2] = p.kept;
  out[3] = p.threads;
}
