// GroupNorm forward with an optional folded SiLU: y = act(x * scale_c + shift_c),
// and the fp32 (mean, rstd) of each (n, g) for the backward.
//
// Replaces: lycoris_tpu/ops/group_norm_v2.py `_fwd_impl` -> `_grid_call` of
// `_stats_kernel` and `_apply_kernel` (Pallas, TPU), and serves
// lycoris_tpu/ops/group_norm.py `_group_norm_fwd` (`_sums2` + `_fma1`, the
// same function without the act). Same math: fp32 sums of x and x^2,
// mean = s1 / cnt, var = s2 / cnt - mean^2, rstd = rsqrt(var + eps), then
// scale_c = rstd * gamma_c and shift_c = -mean * rstd * gamma_c + beta_c.
//
// Bound on the H100: memory. The bound counts one read of x and one write
// of y, 4 bytes an element in bf16, against ~10 fp32 operations.
//
// The TPU kernel works on an (S, N, C) view (the TPU's conv layout keeps C
// minor) and carries the sums across its sequential S grid. PyTorch's
// activations are contiguous NCHW: each (n, g) group is one contiguous run
// of cg * S elements. N * G is only 128 at SDXL batch 4 (one group up to
// 30 x 16,384 elements), too few units for 132 SMs.
//
// Fast variant (lyc_gn_fwd_fast, one launch), for bf16 and fp32 rows of
// whole 16-byte vectors, 16-byte aligned. A group of up to 96 KB is taken
// by one CTA; a larger one by a thread block cluster of up to 8 CTAs, each
// taking a slice on 16-byte boundaries (gn.cuh; the plan comes from
// ops/group_norm.py). The grid is persistent: as many clusters as the card
// holds at once, each taking its groups in turn. Each CTA stages its slice
// in shared memory with 1-D bulk copies, one mbarrier a chunk, and sums x
// and x^2 as the chunks land; the CTAs' sums are added in rank order
// through distributed shared memory, so every CTA of the cluster forms the
// same mean and rstd. Gamma and beta are folded into a scale and shift per
// channel once, in shared memory, and y is written from shared memory with
// 16-byte stores, the channel of each vector stepped without a division. x
// is read from HBM once. No atomics: every sum is added in a fixed order,
// so results repeat bit for bit. In bf16 the SiLU's sigmoid comes from one
// tanh.approx (gn.cuh).
//
// What holds it back (PERF.md): a CTA loads its slice, waits for its
// cluster's sums, then writes; with 128 groups a call the CTAs of a call
// move in step, so HBM idles between the reads and the writes of a wave.
// Two buffers, the next group loaded while this one is written, were
// measured slower: they halve the CTAs an SM holds, whose warps hide the
// latency of the SiLU and the stores.
//
// Generic variant (lyc_gn_fwd, three launches), for everything else (odd S,
// unaligned views): one warp sums one part (<= 4096 elements) of one (n, c)
// row with 16-byte loads where it can and writes one fp32 partial pair; a
// second small kernel adds the cg * parts partials of each (n, g), a
// contiguous run, in a fixed order and writes mean and rstd; the apply
// kernel walks the tensor in vectors, reading x a second time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "gn.cuh"

namespace {

using gnf::load_vec;
using gnf::store_vec;
using gnf::to_f;
using gnf::warp_sum;

constexpr int kWarps = 8;
constexpr int kApplyThreads = 256;

// one warp per (row, part): sum x and x^2 over elements [part*p, part*(p+1))
// of the row (row = n * C + c, S elements)
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kWarps)
    gn_fwd_sums_kernel(const T* __restrict__ x, float* __restrict__ p1, float* __restrict__ p2,
                       long long items, int s, int part, int nparts) {
  const long long item = (long long)blockIdx.x * kWarps + threadIdx.y;
  if (item >= items) return;
  const long long row = item / nparts;
  const int begin = (int)(item % nparts) * part;
  const int end = min(s, begin + part);
  const T* xr = x + row * s;
  float a = 0.f, b = 0.f;
  for (int i = begin + threadIdx.x * VEC; i < end; i += 32 * VEC) {
    float v[VEC];
    load_vec<T, VEC>(xr + i, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      a += v[k];
      b += v[k] * v[k];
    }
  }
  a = warp_sum(a);
  b = warp_sum(b);
  if (threadIdx.x == 0) {
    p1[item] = a;
    p2[item] = b;
  }
}

// one warp per (n, g): its cg * nparts partials are one contiguous run
__global__ void __launch_bounds__(32 * kWarps)
    gn_fwd_stats_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                        float* __restrict__ mean, float* __restrict__ rstd, int groups_total,
                        int len, float cnt, float eps) {
  const int ng = blockIdx.x * kWarps + threadIdx.y;
  if (ng >= groups_total) return;
  const float* a = p1 + (long long)ng * len;
  const float* b = p2 + (long long)ng * len;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < len; i += 32) {
    s1 += a[i];
    s2 += b[i];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (threadIdx.x == 0) {
    const float m = s1 / cnt;
    const float var = s2 / cnt - m * m;
    mean[ng] = m;
    rstd[ng] = rsqrtf(var + eps);
  }
}

// y = act(x * scale_c + shift_c), one VEC-element vector per thread step;
// row = n * C + c, so c = row % C and the group index n * G + g = row / cg
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kApplyThreads)
    gn_fwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ b, const float* __restrict__ mean,
                        const float* __restrict__ rstd, T* __restrict__ y, long long nvec, int s,
                        int c, int cg) {
  const int per_row = s / VEC;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * blockDim.x) {
    const long long row = v / per_row;
    const int ch = (int)(row % c);
    const long long ng = row / cg;
    const float r = rstd[ng];
    float sc = r, sh = -mean[ng] * r;
    if (w != nullptr) {
      const float wc = to_f(w[ch]);
      sc *= wc;
      sh *= wc;
    }
    if (b != nullptr) sh += to_f(b[ch]);
    float xv[VEC];
    load_vec<T, VEC>(x + v * VEC, xv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float z = xv[k] * sc + sh;
      xv[k] = SILU ? z / (1.f + expf(-z)) : z;
    }
    store_vec<T, VEC>(y + v * VEC, xv);
  }
}

int apply_blocks(long long nvec) {
  const long long want = (nvec + kApplyThreads - 1) / kApplyThreads;
  return (int)(want < 132 * 16 ? want : 132 * 16);
}

template <typename T, int VEC>
int launch(const void* x, const void* w, const void* b, void* y, float* p1, float* p2,
           float* mean, float* rstd, int n, int c, int s, int groups, int part, int nparts,
           float eps, int act, cudaStream_t st) {
  const long long items = (long long)n * c * nparts;
  gn_fwd_sums_kernel<T, VEC><<<(unsigned)((items + kWarps - 1) / kWarps), dim3(32, kWarps), 0,
                               st>>>(static_cast<const T*>(x), p1, p2, items, s, part, nparts);
  const int cg = c / groups;
  const int groups_total = n * groups;
  gn_fwd_stats_kernel<<<(groups_total + kWarps - 1) / kWarps, dim3(32, kWarps), 0, st>>>(
      p1, p2, mean, rstd, groups_total, cg * nparts, (float)cg * (float)s, eps);
  const long long nvec = (long long)n * c * s / VEC;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  if (act == 1) {
    gn_fwd_apply_kernel<T, VEC, true><<<apply_blocks(nvec), kApplyThreads, 0, st>>>(
        xt, wt, bt, mean, rstd, yt, nvec, s, c, cg);
  } else {
    gn_fwd_apply_kernel<T, VEC, false><<<apply_blocks(nvec), kApplyThreads, 0, st>>>(
        xt, wt, bt, mean, rstd, yt, nvec, s, c, cg);
  }
  return 0;
}

// --- fast variant -----------------------------------------------------------

template <typename T, bool SILU>
__global__ void __launch_bounds__(gnf::kThreads)
    gn_fwd_fast_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ y, float* __restrict__ mean,
                       float* __restrict__ rstd, gnf::Plan p, float cnt, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* sx = reinterpret_cast<uint4*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + gnf::off_bars(p, 1));
  float* red = reinterpret_cast<float*>(smem + gnf::off_red(p, 1));
  float* part = red + 2 * gnf::kWarps;
  float* sc = reinterpret_cast<float*>(smem + gnf::off_chan(p, 1));
  float* sh = sc + p.cg;

  // this rank's slice [lo, lo + len) of every group its cluster takes
  const int gv = gnf::gvec(p), nch = gnf::nchunks(p);
  const int rank = p.k > 1 ? (int)hop::cluster_rank() : 0;
  const int lo = rank * p.slice, len = min(p.slice, gv - lo);
  const int staged = min(p.staged, len);
  const int clusters = gridDim.x / p.k;
  const uint4* xs = reinterpret_cast<const uint4*>(x) + lo;
  uint4* ys = reinterpret_cast<uint4*>(y) + lo;
  if (threadIdx.x == 0) {
    for (int c = 0; c < nch; ++c) hop::mbar_init(&bars[c], 1);
    hop::mbar_fence_init();
  }

  for (int it = 0, ng = blockIdx.x / p.k; ng < p.groups_total; ++it, ng += clusters) {
    __syncthreads();  // the last group's buffer, partials and channel arrays are free
    if (threadIdx.x == 0) {
      const uint4* const src[1] = {xs + (long long)ng * gv};
      gnf::stage<1>(src, sx, bars, staged, p.chunk);
    }
    const uint4* xg = xs + (long long)ng * gv;
    uint4* yg = ys + (long long)ng * gv;

    float s1 = 0.f, s2 = 0.f;
    // the part past the staged one, from HBM, while the chunks land
    for (int v = staged + threadIdx.x; v < len; v += gnf::kThreads) {
      float f[VEC];
      gnf::unpack(__ldg(xg + v), f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1 += f[i];
        s2 += f[i] * f[i];
      }
    }
    for (int c = 0; c * p.chunk < staged; ++c) {
      hop::mbar_wait(&bars[c], it & 1);
      const int hi = min(staged, (c + 1) * p.chunk);
      for (int v = c * p.chunk + threadIdx.x; v < hi; v += gnf::kThreads) {
        float f[VEC];
        gnf::unpack(sx[v], f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s1 += f[i];
          s2 += f[i] * f[i];
        }
      }
    }
    gnf::block_sum2(s1, s2, red);
    if (p.k > 1) gnf::cluster_sum2(s1, s2, part + 2 * (it & 1), p.k);
    const float m = s1 / cnt;
    const float var = s2 / cnt - m * m;
    const float r = rsqrtf(var + eps);
    if (rank == 0 && threadIdx.x == 0) {
      mean[ng] = m;
      rstd[ng] = r;
    }
    const int c0 = (ng % p.groups) * p.cg;
    for (int j = threadIdx.x; j < p.cg; j += gnf::kThreads) {
      float s_ = r, h_ = -m * r;
      if (w != nullptr) {
        const float wc = to_f(w[c0 + j]);
        s_ *= wc;
        h_ *= wc;
      }
      if (b != nullptr) h_ += to_f(b[c0 + j]);
      sc[j] = s_;
      sh[j] = h_;
    }
    __syncthreads();
    gnf::Chan ch(lo + threadIdx.x, p.vpc);
    for (int v = threadIdx.x; v < len; v += gnf::kThreads, ch.step()) {
      float f[VEC];
      gnf::unpack(v < staged ? sx[v] : __ldg(xg + v), f);
      const float s_ = sc[ch.j], h_ = sh[ch.j];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float z = f[i] * s_ + h_;
        f[i] = SILU ? gnf::silu<gnf::kApprox<T>>(z) : z;
      }
      yg[v] = gnf::pack(f);
    }
  }
  if (p.k > 1) {  // no CTA leaves while a peer may read its partials
    hop::cluster_arrive();
    hop::cluster_wait();
  }
}

template <typename T, bool SILU>
int launch_fast(const void* x, const void* w, const void* b, void* y, float* mean, float* rstd,
                const gnf::Plan& p, int grid, float cnt, float eps, cudaStream_t st) {
  static bool smem_allowed = false;
  auto kernel = gn_fwd_fast_kernel<T, SILU>;
  cudaError_t e = gnf::allow_smem(kernel, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = gnf::launch(kernel, grid, p.k, gnf::smem_bytes(p, 1), st, static_cast<const T*>(x),
                  static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(y), mean,
                  rstd, p, cnt, eps);
  return static_cast<int>(e);
}

}  // namespace

// x, y: (N, C, S) contiguous; w, b: (C,) or nullptr; all one dtype (0 =
// float32, 1 = bfloat16). p1/p2: (N * C * nparts) fp32 scratch; mean/rstd:
// (N, G) fp32 outputs. part: elements per partial (a multiple of vec), nparts
// = ceil(S / part). vec: 1, or 16 / sizeof(element) when S is a multiple of
// it and x, y are 16-byte aligned. act: 0 none, 1 SiLU.
extern "C" int lyc_gn_fwd(const void* x, const void* w, const void* b, void* y, float* p1,
                          float* p2, float* mean, float* rstd, int n, int c, int s, int groups,
                          int part, int nparts, float eps, int act, int vec, int dtype,
                          void* stream) {
  if (n < 1 || c < 1 || s < 1 || groups < 1 || c % groups || part < 1 || nparts < 1 ||
      (long long)part * nparts < s || (act != 0 && act != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0 && vec == 4 && s % 4 == 0 && part % 4 == 0) {
    rc = launch<float, 4>(x, w, b, y, p1, p2, mean, rstd, n, c, s, groups, part, nparts, eps,
                          act, st);
  } else if (dtype == 0 && vec == 1) {
    rc = launch<float, 1>(x, w, b, y, p1, p2, mean, rstd, n, c, s, groups, part, nparts, eps,
                          act, st);
  } else if (dtype == 1 && vec == 8 && s % 8 == 0 && part % 8 == 0) {
    rc = launch<__nv_bfloat16, 8>(x, w, b, y, p1, p2, mean, rstd, n, c, s, groups, part,
                                  nparts, eps, act, st);
  } else if (dtype == 1 && vec == 1) {
    rc = launch<__nv_bfloat16, 1>(x, w, b, y, p1, p2, mean, rstd, n, c, s, groups, part,
                                  nparts, eps, act, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The fast variant: x, y (N, C, S) contiguous, 16-byte aligned, S a multiple
// of 16 / sizeof(element); w, b, mean, rstd, eps, act, dtype as in
// lyc_gn_fwd. k, slice, staged, chunk: the plan (ops/group_norm.py
// `plan`, gn.cuh `Plan`); grid: CTAs, whole clusters, at most one
// cluster a group. Refused if the plan does not cover the groups or fit
// shared memory.
extern "C" int lyc_gn_fwd_fast(const void* x, const void* w, const void* b, void* y, float* mean,
                               float* rstd, int n, int c, int s, int groups, int k,
                               int slice, int staged, int chunk, int grid, float eps, int act,
                               int dtype, void* stream) {
  const int es = dtype == 0 ? 4 : 2, vec = 16 / es;
  if (n < 1 || c < 1 || s < 1 || groups < 1 || c % groups || s % vec || (dtype != 0 && dtype != 1) ||
      (act != 0 && act != 1) || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const gnf::Plan p{n * groups, groups, c / groups, s / vec, k, slice, staged, chunk};
  if (!gnf::plan_ok(p, 1, grid) || grid / k > n * groups)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float cnt = (float)(c / groups) * (float)s;
  int rc;
  if (dtype == 0)
    rc = act ? launch_fast<float, true>(x, w, b, y, mean, rstd, p, grid, cnt, eps, st)
             : launch_fast<float, false>(x, w, b, y, mean, rstd, p, grid, cnt, eps, st);
  else
    rc = act ? launch_fast<__nv_bfloat16, true>(x, w, b, y, mean, rstd, p, grid, cnt, eps, st)
             : launch_fast<__nv_bfloat16, false>(x, w, b, y, mean, rstd, p, grid, cnt, eps, st);
  const int last = static_cast<int>(cudaGetLastError());
  return rc != 0 ? rc : last;
}

// How many clusters of the fast forward the card holds at once for the
// plan's k and shared memory (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int lyc_gn_fwd_fast_clusters(int k, int smem, int act, int dtype, int* out) {
  const int grid_ok = k >= 1 && k <= gnf::kMaxCluster && smem >= 0 && smem <= gnf::kSmemMax;
  if (!grid_ok || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  static bool allowed[4] = {false, false, false, false};
  cudaError_t e;
  if (dtype == 0) {
    auto kern = act ? gn_fwd_fast_kernel<float, true> : gn_fwd_fast_kernel<float, false>;
    e = gnf::allow_smem(kern, allowed[act]);
    if (e == cudaSuccess) e = gnf::max_clusters(kern, k, smem, out);
  } else {
    auto kern = act ? gn_fwd_fast_kernel<__nv_bfloat16, true>
                    : gn_fwd_fast_kernel<__nv_bfloat16, false>;
    e = gnf::allow_smem(kern, allowed[2 + act]);
    if (e == cudaSuccess) e = gnf::max_clusters(kern, k, smem, out);
  }
  return static_cast<int>(e);
}
