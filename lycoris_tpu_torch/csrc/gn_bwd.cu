// GroupNorm backward with an optional folded SiLU: dx, and optionally dgamma
// and dbeta.
//
// Replaces: lycoris_tpu/ops/group_norm_v2.py `_gn2_bwd` -> `_grid_call` of
// `_tstats_kernel` and `_dx_kernel` (Pallas, TPU), and serves
// lycoris_tpu/ops/group_norm.py `_gn_bwd` (`_sums2` + `_fma2`, no act). Same
// math: with z = x * scale_c + shift_c recomputed from the forward's
// (mean, rstd) and dy = dh * act'(z),
//   t1 = sum dy, t2 = sum dy * x per (n, c);
//   m_dxhat = sum_c w_c t1 / cnt, m_dxhat_xhat = (sum_c w_c t2 - mean * sum_c w_c t1) * rstd / cnt;
//   B_g = -rstd^2 m_dxhat_xhat, C_g = -rstd m_dxhat - mean B_g, A_c = rstd w_c;
//   dx = dy * A_c + x * B_g + C_g;
//   dgamma_c = sum_n (t2 - mean t1) rstd, dbeta_c = sum_n t1.
//
// Bound on the H100: memory. x and dh are read (twice: sums and dx) and dx
// written; the bound counts one read of each and one write, 6 bytes an
// element in bf16, against ~30 fp32 operations with SiLU.
//
// Design. As the forward (gn_fwd.cu): the TPU kernel's (S, N, C) view and
// its accumulation across the sequential S grid are not carried over. One
// warp sums one part (<= 4096 elements) of one contiguous (n, c) row with
// 16-byte loads and writes an fp32 partial pair, so the 128 groups of SDXL
// batch 4 spread over thousands of warps; no atomics. A small kernel (one
// warp per (n, g)) adds each channel's partials in order, then the group's
// channels, into B_g and C_g (and keeps t1, t2 per (n, c) when dgamma/dbeta
// are wanted); the dx kernel walks the tensor in 16-byte vectors and
// recomputes z and act'(z). When the caller needs no dgamma/dbeta (frozen
// norm weights, as on the training path) their kernel is skipped.

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

// d act(z) / dz: SiLU z * sigmoid(z) -> s * (1 + z * (1 - s))
template <bool SILU>
__device__ __forceinline__ float act_grad(float z) {
  if constexpr (SILU) {
    const float s = 1.f / (1.f + expf(-z));
    return s * (1.f + z * (1.f - s));
  } else {
    return 1.f;
  }
}

// (scale_c, shift_c) of row = n * C + c: gamma/beta folded into the group's
// (mean, rstd); the group index n * G + g is row / cg
template <typename T>
__device__ __forceinline__ void scale_shift(const T* w, const T* b, const float* mean,
                                            const float* rstd, long long row, int c, int cg,
                                            float& sc, float& sh) {
  const int ch = (int)(row % c);
  const long long ng = row / cg;
  const float r = rstd[ng];
  sc = r;
  sh = -mean[ng] * r;
  if (w != nullptr) {
    const float wc = to_f(w[ch]);
    sc *= wc;
    sh *= wc;
  }
  if (b != nullptr) sh += to_f(b[ch]);
}

constexpr int kWarps = 8;
constexpr int kDxThreads = 256;

// one warp per (row, part): t1 = sum dy, t2 = sum dy * x over the part
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(32 * kWarps)
    gn_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dh,
                       const T* __restrict__ w, const T* __restrict__ b,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       float* __restrict__ p1, float* __restrict__ p2, long long items, int s,
                       int c, int cg, int part, int nparts) {
  const long long item = (long long)blockIdx.x * kWarps + threadIdx.y;
  if (item >= items) return;
  const long long row = item / nparts;
  const int begin = (int)(item % nparts) * part;
  const int end = min(s, begin + part);
  float sc, sh;
  scale_shift(w, b, mean, rstd, row, c, cg, sc, sh);
  const T* xr = x + row * s;
  const T* dhr = dh + row * s;
  float a = 0.f, bb = 0.f;
  for (int i = begin + threadIdx.x * VEC; i < end; i += 32 * VEC) {
    float xv[VEC], dv[VEC];
    load_vec<T, VEC>(xr + i, xv);
    load_vec<T, VEC>(dhr + i, dv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float dy = dv[k] * act_grad<SILU>(xv[k] * sc + sh);
      a += dy;
      bb += dy * xv[k];
    }
  }
  a = warp_sum(a);
  bb = warp_sum(bb);
  if (threadIdx.x == 0) {
    p1[item] = a;
    p2[item] = bb;
  }
}

// one warp per (n, g): each lane adds the parts of its channels in order,
// then the lanes are added (fixed order); lane 0 writes (B_g, C_g)
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
    gn_bwd_coef_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                       const T* __restrict__ w, const float* __restrict__ mean,
                       const float* __restrict__ rstd, float* __restrict__ coef,
                       float* __restrict__ t1_out, float* __restrict__ t2_out,
                       int groups_total, int c, int cg, int nparts, float cnt) {
  const int ng = blockIdx.x * kWarps + threadIdx.y;
  if (ng >= groups_total) return;
  float wt1 = 0.f, wt2 = 0.f;
  for (int j = threadIdx.x; j < cg; j += 32) {
    const long long row = (long long)ng * cg + j;
    float t1 = 0.f, t2 = 0.f;
    for (int p = 0; p < nparts; ++p) {
      t1 += p1[row * nparts + p];
      t2 += p2[row * nparts + p];
    }
    if (t1_out != nullptr) {
      t1_out[row] = t1;
      t2_out[row] = t2;
    }
    const float wc = w != nullptr ? to_f(w[row % c]) : 1.f;
    wt1 += t1 * wc;
    wt2 += t2 * wc;
  }
  wt1 = warp_sum(wt1);
  wt2 = warp_sum(wt2);
  if (threadIdx.x == 0) {
    const float m = mean[ng], r = rstd[ng];
    const float m_dxhat = wt1 / cnt;
    const float m_dxhat_xhat = (wt2 - m * wt1) * r / cnt;
    const float bg = -(r * r * m_dxhat_xhat);
    coef[2 * ng] = bg;
    coef[2 * ng + 1] = -r * m_dxhat - m * bg;
  }
}

// dx = dy * A_c + x * B_g + C_g with dy = dh * act'(z) recomputed
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kDxThreads)
    gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dh,
                     const T* __restrict__ w, const T* __restrict__ b,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     const float* __restrict__ coef, T* __restrict__ dx, long long nvec, int s,
                     int c, int cg) {
  const int per_row = s / VEC;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * blockDim.x) {
    const long long row = v / per_row;
    const long long ng = row / cg;
    float sc, sh;
    scale_shift(w, b, mean, rstd, row, c, cg, sc, sh);
    const float a = w != nullptr ? rstd[ng] * to_f(w[row % c]) : rstd[ng];
    const float bg = coef[2 * ng], cc = coef[2 * ng + 1];
    float xv[VEC], dv[VEC];
    load_vec<T, VEC>(x + v * VEC, xv);
    load_vec<T, VEC>(dh + v * VEC, dv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float dy = dv[k] * act_grad<SILU>(xv[k] * sc + sh);
      dv[k] = dy * a + xv[k] * bg + cc;
    }
    store_vec<T, VEC>(dx + v * VEC, dv);
  }
}

// one thread per channel: dgamma_c = sum_n (t2 - mean t1) rstd, dbeta_c = sum_n t1
__global__ void gn_bwd_wb_kernel(const float* __restrict__ t1, const float* __restrict__ t2,
                                 const float* __restrict__ mean, const float* __restrict__ rstd,
                                 float* __restrict__ dgamma, float* __restrict__ dbeta, int n,
                                 int c, int groups, int cg) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const int g = ch / cg;
  float dg = 0.f, db = 0.f;
  for (int i = 0; i < n; ++i) {
    const long long row = (long long)i * c + ch;
    const int ng = i * groups + g;
    dg += (t2[row] - mean[ng] * t1[row]) * rstd[ng];
    db += t1[row];
  }
  dgamma[ch] = dg;
  dbeta[ch] = db;
}

int dx_blocks(long long nvec) {
  const long long want = (nvec + kDxThreads - 1) / kDxThreads;
  return (int)(want < 132 * 16 ? want : 132 * 16);
}

template <typename T, int VEC, bool SILU>
void launch(const void* x, const void* dh, const void* w, const void* b, const float* mean,
            const float* rstd, void* dx, float* p1, float* p2, float* coef, float* t1,
            float* t2, float* dgamma, float* dbeta, int n, int c, int s, int groups, int part,
            int nparts, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* dht = static_cast<const T*>(dh);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  const int cg = c / groups;
  const long long items = (long long)n * c * nparts;
  gn_bwd_sums_kernel<T, VEC, SILU><<<(unsigned)((items + kWarps - 1) / kWarps),
                                     dim3(32, kWarps), 0, st>>>(
      xt, dht, wt, bt, mean, rstd, p1, p2, items, s, c, cg, part, nparts);
  const int groups_total = n * groups;
  const bool want_wb = dgamma != nullptr;
  gn_bwd_coef_kernel<T><<<(groups_total + kWarps - 1) / kWarps, dim3(32, kWarps), 0, st>>>(
      p1, p2, wt, mean, rstd, coef, want_wb ? t1 : nullptr, want_wb ? t2 : nullptr,
      groups_total, c, cg, nparts, (float)cg * (float)s);
  const long long nvec = (long long)n * c * s / VEC;
  gn_bwd_dx_kernel<T, VEC, SILU><<<dx_blocks(nvec), kDxThreads, 0, st>>>(
      xt, dht, wt, bt, mean, rstd, coef, static_cast<T*>(dx), nvec, s, c, cg);
  if (want_wb)
    gn_bwd_wb_kernel<<<(c + 127) / 128, 128, 0, st>>>(t1, t2, mean, rstd, dgamma, dbeta, n, c,
                                                      groups, cg);
}

template <typename T, int VEC>
void launch_act(int act, const void* x, const void* dh, const void* w, const void* b,
                const float* mean, const float* rstd, void* dx, float* p1, float* p2,
                float* coef, float* t1, float* t2, float* dgamma, float* dbeta, int n, int c,
                int s, int groups, int part, int nparts, cudaStream_t st) {
  if (act == 1)
    launch<T, VEC, true>(x, dh, w, b, mean, rstd, dx, p1, p2, coef, t1, t2, dgamma, dbeta, n, c,
                         s, groups, part, nparts, st);
  else
    launch<T, VEC, false>(x, dh, w, b, mean, rstd, dx, p1, p2, coef, t1, t2, dgamma, dbeta, n,
                          c, s, groups, part, nparts, st);
}

}  // namespace

// x, dh, dx: (N, C, S) contiguous; w, b: (C,) or nullptr; all one dtype (0 =
// float32, 1 = bfloat16). mean/rstd: (N, G) fp32 from the forward. p1/p2:
// (N * C * nparts) and coef (N * G * 2) fp32 scratch. With dgamma ==
// nullptr only dx is computed; otherwise t1/t2 are (N * C) fp32 scratch and
// dgamma/dbeta (C,) fp32 outputs. part, nparts, vec, act as in lyc_gn_fwd.
extern "C" int lyc_gn_bwd(const void* x, const void* dh, const void* w, const void* b,
                          const float* mean, const float* rstd, void* dx, float* p1, float* p2,
                          float* coef, float* t1, float* t2, float* dgamma, float* dbeta, int n,
                          int c, int s, int groups, int part, int nparts, int act, int vec,
                          int dtype, void* stream) {
  if (n < 1 || c < 1 || s < 1 || groups < 1 || c % groups || part < 1 || nparts < 1 ||
      (long long)part * nparts < s || (act != 0 && act != 1) ||
      (dgamma != nullptr && (t1 == nullptr || t2 == nullptr || dbeta == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4 && s % 4 == 0 && part % 4 == 0) {
    launch_act<float, 4>(act, x, dh, w, b, mean, rstd, dx, p1, p2, coef, t1, t2, dgamma, dbeta,
                         n, c, s, groups, part, nparts, st);
  } else if (dtype == 0 && vec == 1) {
    launch_act<float, 1>(act, x, dh, w, b, mean, rstd, dx, p1, p2, coef, t1, t2, dgamma, dbeta,
                         n, c, s, groups, part, nparts, st);
  } else if (dtype == 1 && vec == 8 && s % 8 == 0 && part % 8 == 0) {
    launch_act<__nv_bfloat16, 8>(act, x, dh, w, b, mean, rstd, dx, p1, p2, coef, t1, t2, dgamma,
                                 dbeta, n, c, s, groups, part, nparts, st);
  } else if (dtype == 1 && vec == 1) {
    launch_act<__nv_bfloat16, 1>(act, x, dh, w, b, mean, rstd, dx, p1, p2, coef, t1, t2, dgamma,
                                 dbeta, n, c, s, groups, part, nparts, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
