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
// Bound on the H100: memory. x is read twice (sums, apply) and y written
// once; the bound counts one read and one write, 4 bytes an element in bf16,
// against ~10 fp32 operations.
//
// Design. The TPU kernel works on an (S, N, C) view (the TPU's conv layout
// keeps C minor) and carries the sums across its sequential S grid. PyTorch's
// activations are contiguous NCHW: each (n, c) row is S contiguous elements.
// N*G is only 128 at SDXL batch 4 (one group up to 30 x 16,384 elements),
// far too few blocks for 132 SMs, so the sums are split finer: one warp sums
// one part (<= 4096 elements) of one (n, c) row with 16-byte loads and
// writes one fp32 partial pair; no atomics. A second small kernel adds the
// cg * parts partials of each (n, g), a contiguous run, in a fixed order
// (deterministic) and writes mean and rstd. The apply kernel walks the
// tensor in 16-byte vectors (S is a multiple of 8 at every UNet level, so a
// vector never straddles a channel; cg need not be a power of two).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements from p (one 16-byte load when VEC > 1) as floats
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
