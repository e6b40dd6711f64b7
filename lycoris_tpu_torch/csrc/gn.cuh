// The pieces the GroupNorm kernels (gn_fwd.cu, gn_bwd.cu) share: element
// loads and conversions, warp sums, and for the fast variant the plan of a
// launch, the layout of a CTA's shared memory, the bulk copies that stage a
// slice, the deterministic block and cluster sums, and the clustered
// launch.
//
// Work unit. Under NCHW one (n, g) group is one contiguous run of cg * S
// elements, gvec = cg * S / VEC vectors of 16 bytes. A group is split over
// a thread block cluster of k <= 8 CTAs (k = 1: one CTA, no cluster), rank r
// taking vectors [r * slice, (r + 1) * slice). The grid is persistent: at
// most as many clusters as the card holds at once, cluster c taking groups
// c, c + clusters, ... in turn. The plan is computed in Python
// (ops/group_norm.py `plan`, `grid`) and checked here.
//
// Staging. For each group, thread 0 requests the first ``staged`` vectors
// of its slice (of x, and in the backward of dh) in chunks of ``chunk``
// vectors, each chunk a 1-D bulk copy per tensor completing on an mbarrier
// of its own (one phase a group), and the threads sum each chunk as it
// lands. A slice longer than the plan stages keeps its tail in HBM: it is
// read directly while the chunks land, and read again after the cluster's
// sums, from L2, where the first read left it.

#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <utility>

#include "hopper.cuh"

namespace gnf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use on an H100
constexpr int kMaxCluster = 8;    // the portable cluster size

struct Plan {
  int groups_total;  // N * G
  int groups;        // G: channel j of (n, g) is (n g mod G) * cg + j
  int cg;            // channels per group
  int vpc;           // 16-byte vectors per channel, S / VEC
  int k;             // CTAs per group, one cluster (1: no cluster)
  int slice;         // vectors of one rank's slice of a group (the group when k == 1)
  int staged;        // vectors per tensor a CTA stages in shared memory
  int chunk;         // vectors per tensor per bulk copy
};

__host__ __device__ inline int gvec(const Plan& p) { return p.cg * p.vpc; }
__host__ __device__ inline int nchunks(const Plan& p) { return (p.staged + p.chunk - 1) / p.chunk; }

// Shared memory, in bytes from the base: [tensor][staged vectors][chunk
// mbarriers][block partials, 2 a warp][the CTA's partial pair for its
// cluster peers, two slots][nt + 1 floats a channel of a group].
__host__ __device__ inline int off_bars(const Plan& p, int nt) { return nt * p.staged * 16; }
__host__ __device__ inline int off_red(const Plan& p, int nt) {
  return off_bars(p, nt) + 8 * nchunks(p);
}
__host__ __device__ inline int off_chan(const Plan& p, int nt) {
  return off_red(p, nt) + 4 * (2 * kWarps + 4);
}
__host__ __device__ inline int smem_bytes(const Plan& p, int nt) {
  return off_chan(p, nt) + 4 * (nt + 1) * p.cg;
}

// A plan the kernels take: clusters of at most 8 whole slices covering each
// group with none empty, no more staged than a slice, a chunk within an
// mbarrier phase's transaction count, within shared memory; ``grid`` a
// whole number of clusters.
inline bool plan_ok(const Plan& p, int nt, int grid) {
  const long long gv = (long long)p.cg * p.vpc;
  return p.groups_total >= 1 && p.groups >= 1 && p.cg >= 1 && p.vpc >= 1 && gv <= (1 << 30) &&
         p.k >= 1 && p.k <= kMaxCluster && p.slice >= 1 &&
         (long long)p.slice * (p.k - 1) < gv && (long long)p.slice * p.k >= gv &&
         p.staged >= 0 && p.staged <= p.slice && p.chunk >= 1 &&
         (long long)p.chunk * 16 * nt < (1 << 20) && smem_bytes(p, nt) <= kSmemMax &&
         grid >= p.k && grid % p.k == 0;
}

// Thread 0: request the first ``staged`` vectors of the NT tensors ``src``
// (the slice's first vector) into ``buf`` (tensor t at buf + t * staged),
// chunk c completing on bars[c], which each take one arrival a phase.
template <int NT>
__device__ inline void stage(const uint4* const (&src)[NT], uint4* buf, uint64_t* bars, int staged,
                             int chunk) {
  for (int v0 = 0, c = 0; v0 < staged; v0 += chunk, ++c) {
    const int len = min(chunk, staged - v0);
    hop::mbar_expect_tx(&bars[c], (uint32_t)(len * 16 * NT));
#pragma unroll
    for (int t = 0; t < NT; ++t)
      hop::bulk_load(buf + t * staged + v0, src[t] + v0, (uint32_t)(len * 16), &bars[c]);
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements from p (one 16-byte load when VEC > 1) as floats, and back
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f(*p);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// 16 bytes as VEC floats, and back: bf16 (VEC 8) or fp32 (VEC 4)
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(hop::pack_bf16(v[0], v[1]), hop::pack_bf16(v[2], v[3]),
                    hop::pack_bf16(v[4], v[5]), hop::pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sums of (a, b), the same bits in every thread: warps reduced by
// shuffles, then added in warp order from ``red``. A __syncthreads must
// separate two uses of ``red``.
__device__ inline void block_sum2(float& a, float& b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    red[2 * (threadIdx.x >> 5)] = a;
    red[2 * (threadIdx.x >> 5) + 1] = b;
  }
  __syncthreads();
  a = red[0];
  b = red[1];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    a += red[2 * w];
    b += red[2 * w + 1];
  }
}

// The cluster's sums of the CTAs' (a, b), added in rank order, the same
// bits in every thread of every CTA: each CTA leaves its pair in ``part``
// (one of two slots, alternating group by group), and after a cluster
// barrier lane r of every warp reads rank r's pair through distributed
// shared memory. A slot is written again two groups later, after the next
// group's barrier, which every peer reaches only once it has read this one.
// The kernel ends with one more cluster barrier, so no CTA leaves while a
// peer may still read its pair.
__device__ inline void cluster_sum2(float& a, float& b, float* part, int k) {
  if (threadIdx.x == 0) {
    part[0] = a;
    part[1] = b;
  }
  hop::cluster_arrive();
  hop::cluster_wait();
  const int lane = threadIdx.x & 31;
  float pa = 0.f, pb = 0.f;
  if (lane < k) {
    pa = hop::ld_cluster(part, lane);
    pb = hop::ld_cluster(part + 1, lane);
  }
  a = __shfl_sync(0xffffffffu, pa, 0);
  b = __shfl_sync(0xffffffffu, pb, 0);
  for (int r = 1; r < k; ++r) {
    a += __shfl_sync(0xffffffffu, pa, r);
    b += __shfl_sync(0xffffffffu, pb, r);
  }
}

// The channel of a thread's vectors, stepped without a division: position
// p of the group lies in channel p / vpc; a thread's next vector is
// kThreads further on.
struct Chan {
  int j, rem, vpc, dj, drem;
  __device__ Chan(int p, int vpc_) : vpc(vpc_) {
    j = p / vpc;
    rem = p - j * vpc;
    dj = kThreads / vpc;
    drem = kThreads - dj * vpc;
  }
  __device__ __forceinline__ void step() {
    j += dj;
    rem += drem;
    if (rem >= vpc) {
      rem -= vpc;
      ++j;
    }
  }
};

// SiLU and its derivative. fp32 takes the sigmoid from ex2 and a
// reciprocal (two MUFU operations an element); bf16, whose output keeps 8
// bits, from one tanh.approx (max relative error 2^-11): sigmoid(z) =
// 0.5 + 0.5 tanh(z / 2). The SFU completes 16 such operations a clock on an
// SM, so at the bandwidth bound the two-operation form keeps it about half
// busy in the forward and more in the backward, which evaluates it twice.
__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

template <bool APPROX>
__device__ __forceinline__ float sigmoid(float z) {
  if constexpr (APPROX) return fmaf(0.5f, tanh_approx(0.5f * z), 0.5f);
  return __fdividef(1.f, 1.f + __expf(-z));
}

template <bool APPROX>
__device__ __forceinline__ float silu(float z) {
  return z * sigmoid<APPROX>(z);
}

// d SiLU(z) / dz = s (1 + z (1 - s)), s = sigmoid(z)
template <bool APPROX>
__device__ __forceinline__ float silu_grad(float z) {
  const float s = sigmoid<APPROX>(z);
  return s * (1.f + z * (1.f - s));
}

template <typename T>
constexpr bool kApprox = sizeof(T) == 2;

// Launch ``kernel`` on ``grid`` CTAs of kThreads in clusters of ``k`` with
// ``smem`` bytes of dynamic shared memory on stream ``st``.
template <typename... Exp, typename... Act>
cudaError_t launch(void (*kernel)(Exp...), int grid, int k, int smem, cudaStream_t st,
                   Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = k > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
}

// How many clusters of ``k`` CTAs with ``smem`` bytes each the card holds
// at once (cudaOccupancyMaxActiveClusters), into ``out``.
template <typename... Exp>
cudaError_t max_clusters(void (*kernel)(Exp...), int k, int smem, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

// Allow ``kernel`` the whole of an H100's shared memory, once per kernel.
template <typename... Exp>
cudaError_t allow_smem(void (*kernel)(Exp...), bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  done = e == cudaSuccess;
  return e;
}

}  // namespace gnf
