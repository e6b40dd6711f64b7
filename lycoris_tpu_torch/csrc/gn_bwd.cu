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
// Bound on the H100: memory. The bound counts one read of x and dh and one
// write of dx, 6 bytes an element in bf16, against ~30 fp32 operations
// with SiLU.
//
// As the forward (gn_fwd.cu): the TPU kernel's (S, N, C) view and its
// accumulation across the sequential S grid are not carried over.
//
// Fast variant (lyc_gn_bwd_fast, one launch for dx), for bf16 and fp32 rows
// of whole 16-byte vectors, 16-byte aligned. Work is split as in the
// forward's fast variant (gn.cuh): a CTA, or a thread block cluster of up
// to 8, per (n, g) group, on a persistent grid. Each CTA stages its slice of
// x and dh in shared memory with 1-D bulk copies (both tensors' chunk on
// one mbarrier) and sums w_c dy and w_c dy x as they land, the channel's
// scale, shift and gamma read from shared memory where they were formed
// once; the cluster adds its CTAs' sums in rank order through distributed
// shared memory, every CTA forms B_g and C_g, and dx is written from shared
// memory, dy recomputed (in bf16 the sigmoid from one tanh.approx, gn.cuh).
// The largest groups (SDXL's 960-channel level: x and dh 1.97 MB a group)
// do not fit 8 CTAs' shared memory, and at 1920 x 64 x 64 and 640 x 128 x
// 128 a slice would fill one SM alone: there a CTA stages 72 KB, so that
// three share an SM, and reads the rest of its slice twice, the second
// time from L2, which the first read just filled (measured faster than
// staging all that fits). dgamma/dbeta only where asked for: then each CTA
// also sums t1 and t2 per channel of its slice (a warp per channel, fixed
// order) into a row of partials per cluster rank, and the small wb kernel adds
// the ranks and the batch in order. No atomics; results repeat bit for
// bit.
//
// Generic variant (lyc_gn_bwd), for everything else: one warp sums one part
// (<= 4096 elements) of one contiguous (n, c) row with 16-byte loads where
// it can and writes an fp32 partial pair; a small kernel (one warp per
// (n, g)) adds each channel's partials in order, then the group's
// channels, into B_g and C_g (and keeps t1, t2 per (n, c) when dgamma/dbeta
// are wanted); the dx kernel walks the tensor in vectors, reading x and dh a
// second time, and recomputes z and act'(z).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "gn.cuh"

namespace {

using gnf::load_vec;
using gnf::store_vec;
using gnf::to_f;
using gnf::warp_sum;

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

// one thread per channel: dgamma_c = sum_n (t2 - mean t1) rstd, dbeta_c = sum_n t1,
// where t1, t2 of (n, c) are the sums of ``parts`` partials, each a row of
// N * C (the fast variant's cluster ranks; the generic variant has one),
// added in order
__global__ void gn_bwd_wb_kernel(const float* __restrict__ t1, const float* __restrict__ t2,
                                 const float* __restrict__ mean, const float* __restrict__ rstd,
                                 float* __restrict__ dgamma, float* __restrict__ dbeta, int n,
                                 int c, int groups, int cg, int parts) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const int g = ch / cg;
  const long long nc = (long long)n * c;
  float dg = 0.f, db = 0.f;
  for (int i = 0; i < n; ++i) {
    const long long row = (long long)i * c + ch;
    const int ng = i * groups + g;
    float a = t1[row], bb = t2[row];
    for (int r = 1; r < parts; ++r) {
      a += t1[r * nc + row];
      bb += t2[r * nc + row];
    }
    dg += (bb - mean[ng] * a) * rstd[ng];
    db += a;
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
                                                      groups, cg, 1);
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

// --- fast variant -----------------------------------------------------------

// dy = dh * act'(z) of one vector, z = x * sc + sh
template <bool SILU, bool APPROX, int VEC>
__device__ __forceinline__ void dy_vec(const float (&xv)[VEC], float (&dv)[VEC], float sc,
                                       float sh) {
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if constexpr (SILU) dv[i] *= gnf::silu_grad<APPROX>(xv[i] * sc + sh);
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(gnf::kThreads)
    gn_bwd_fast_kernel(const T* __restrict__ x, const T* __restrict__ dh,
                       const T* __restrict__ w, const T* __restrict__ b,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       T* __restrict__ dx, float* __restrict__ t1p, float* __restrict__ t2p,
                       gnf::Plan p, float cnt) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr bool APPROX = gnf::kApprox<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* sx = reinterpret_cast<uint4*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + gnf::off_bars(p, 2));
  float* red = reinterpret_cast<float*>(smem + gnf::off_red(p, 2));
  float* part = red + 2 * gnf::kWarps;
  float* sc = reinterpret_cast<float*>(smem + gnf::off_chan(p, 2));
  float* sh = sc + p.cg;
  float* wv = sh + p.cg;

  // this rank's slice [lo, lo + len) of every group its cluster takes
  const int gv = gnf::gvec(p), nch = gnf::nchunks(p);
  const int rank = p.k > 1 ? (int)hop::cluster_rank() : 0;
  const int lo = rank * p.slice, len = min(p.slice, gv - lo);
  const int staged = min(p.staged, len);
  const int clusters = gridDim.x / p.k;
  const uint4* xs = reinterpret_cast<const uint4*>(x) + lo;
  const uint4* ds = reinterpret_cast<const uint4*>(dh) + lo;
  uint4* os = reinterpret_cast<uint4*>(dx) + lo;
  const uint4* sd = sx + staged;  // dh beside x
  if (threadIdx.x == 0) {
    for (int c = 0; c < nch; ++c) hop::mbar_init(&bars[c], 1);
    hop::mbar_fence_init();
  }

  for (int it = 0, ng = blockIdx.x / p.k; ng < p.groups_total; ++it, ng += clusters) {
    const float m = mean[ng], r = rstd[ng];
    __syncthreads();  // the last group's buffer, partials and channel arrays are free
    if (threadIdx.x == 0) {
      const uint4* const src[2] = {xs + (long long)ng * gv, ds + (long long)ng * gv};
      gnf::stage<2>(src, sx, bars, staged, p.chunk);
    }
    const int c0 = (ng % p.groups) * p.cg;
    for (int j = threadIdx.x; j < p.cg; j += gnf::kThreads) {
      float s_ = r, h_ = -m * r, wc = 1.f;
      if (w != nullptr) {
        wc = to_f(w[c0 + j]);
        s_ *= wc;
        h_ *= wc;
      }
      if (b != nullptr) h_ += to_f(b[c0 + j]);
      sc[j] = s_;
      sh[j] = h_;
      wv[j] = wc;
    }
    __syncthreads();
    const uint4* xg = xs + (long long)ng * gv;
    const uint4* dg = ds + (long long)ng * gv;
    uint4* og = os + (long long)ng * gv;

    float t1 = 0.f, t2 = 0.f;
    auto sum = [&](const uint4& rx, const uint4& rd, int j) {
      float xv[VEC], dv[VEC];
      gnf::unpack(rx, xv);
      gnf::unpack(rd, dv);
      dy_vec<SILU, APPROX>(xv, dv, sc[j], sh[j]);
      float u1 = 0.f, u2 = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        u1 += dv[i];
        u2 += dv[i] * xv[i];
      }
      t1 += wv[j] * u1;
      t2 += wv[j] * u2;
    };
    {  // the part past the staged one, from HBM, while the chunks land
      gnf::Chan ch(lo + staged + threadIdx.x, p.vpc);
      for (int v = staged + threadIdx.x; v < len; v += gnf::kThreads, ch.step())
        sum(__ldg(xg + v), __ldg(dg + v), ch.j);
    }
    for (int c = 0; c * p.chunk < staged; ++c) {
      hop::mbar_wait(&bars[c], it & 1);
      const int v0 = c * p.chunk + threadIdx.x, hi = min(staged, (c + 1) * p.chunk);
      gnf::Chan ch(lo + v0, p.vpc);
      for (int v = v0; v < hi; v += gnf::kThreads, ch.step()) sum(sx[v], sd[v], ch.j);
    }
    gnf::block_sum2(t1, t2, red);
    if (p.k > 1) gnf::cluster_sum2(t1, t2, part + 2 * (it & 1), p.k);
    const float m_dxhat = t1 / cnt;
    const float m_dxhat_xhat = (t2 - m * t1) * r / cnt;
    const float bg = -(r * r * m_dxhat_xhat);
    const float cc = -r * m_dxhat - m * bg;
    gnf::Chan ch(lo + threadIdx.x, p.vpc);
    for (int v = threadIdx.x; v < len; v += gnf::kThreads, ch.step()) {
      float xv[VEC], dv[VEC];
      const bool in = v < staged;
      gnf::unpack(in ? sx[v] : __ldg(xg + v), xv);
      gnf::unpack(in ? sd[v] : __ldg(dg + v), dv);
      const float s_ = sc[ch.j];
      dy_vec<SILU, APPROX>(xv, dv, s_, sh[ch.j]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dv[i] = dv[i] * s_ + xv[i] * bg + cc;
      og[v] = gnf::pack(dv);
    }
    if (t1p != nullptr) {
      // t1, t2 of each channel over this rank's part of it: a warp a channel
      const int lane = threadIdx.x & 31;
      const long long nc = (long long)p.groups_total * p.cg;
      for (int j = threadIdx.x >> 5; j < p.cg; j += gnf::kWarps) {
        const int v_lo = max(0, j * p.vpc - lo), v_hi = min(len, (j + 1) * p.vpc - lo);
        float u1 = 0.f, u2 = 0.f;
        for (int v = v_lo + lane; v < v_hi; v += 32) {
          float xv[VEC], dv[VEC];
          gnf::unpack(__ldg(xg + v), xv);
          gnf::unpack(__ldg(dg + v), dv);
          dy_vec<SILU, APPROX>(xv, dv, sc[j], sh[j]);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            u1 += dv[i];
            u2 += dv[i] * xv[i];
          }
        }
        u1 = gnf::warp_sum(u1);
        u2 = gnf::warp_sum(u2);
        if (lane == 0) {
          const long long row = rank * nc + (long long)ng * p.cg + j;
          t1p[row] = u1;
          t2p[row] = u2;
        }
      }
    }
  }
  if (p.k > 1) {  // no CTA leaves while a peer may read its partials
    hop::cluster_arrive();
    hop::cluster_wait();
  }
}

template <typename T, bool SILU>
int launch_fast(const void* x, const void* dh, const void* w, const void* b, const float* mean,
                const float* rstd, void* dx, float* t1p, float* t2p, const gnf::Plan& p,
                int grid, float cnt, cudaStream_t st) {
  static bool smem_allowed = false;
  auto kernel = gn_bwd_fast_kernel<T, SILU>;
  cudaError_t e = gnf::allow_smem(kernel, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = gnf::launch(kernel, grid, p.k, gnf::smem_bytes(p, 2), st, static_cast<const T*>(x),
                  static_cast<const T*>(dh), static_cast<const T*>(w),
                  static_cast<const T*>(b), mean, rstd, static_cast<T*>(dx), t1p, t2p, p, cnt);
  return static_cast<int>(e);
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

// The fast variant: x, dh, dx (N, C, S) contiguous, 16-byte aligned, S a
// multiple of 16 / sizeof(element); w, b, mean, rstd, act, dtype as in
// lyc_gn_bwd. k, slice, staged, chunk, grid: as in lyc_gn_fwd_fast.
// With dgamma == nullptr only dx is computed; otherwise t1p/t2p are (k, N *
// C) fp32 partials and dgamma/dbeta (C,) fp32 outputs.
extern "C" int lyc_gn_bwd_fast(const void* x, const void* dh, const void* w, const void* b,
                               const float* mean, const float* rstd, void* dx, float* t1p,
                               float* t2p, float* dgamma, float* dbeta, int n, int c, int s,
                               int groups, int k, int slice, int staged, int chunk,
                               int grid, int act, int dtype, void* stream) {
  const int es = dtype == 0 ? 4 : 2, vec = 16 / es;
  if (n < 1 || c < 1 || s < 1 || groups < 1 || c % groups || s % vec || (dtype != 0 && dtype != 1) ||
      (act != 0 && act != 1) || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dh) % 16 || reinterpret_cast<uintptr_t>(dx) % 16 ||
      (dgamma != nullptr && (t1p == nullptr || t2p == nullptr || dbeta == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const gnf::Plan p{n * groups, groups, c / groups, s / vec, k, slice, staged, chunk};
  if (!gnf::plan_ok(p, 2, grid) || grid / k > n * groups)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float cnt = (float)(c / groups) * (float)s;
  float* t1 = dgamma != nullptr ? t1p : nullptr;
  float* t2 = dgamma != nullptr ? t2p : nullptr;
  int rc;
  if (dtype == 0)
    rc = act ? launch_fast<float, true>(x, dh, w, b, mean, rstd, dx, t1, t2, p, grid, cnt, st)
             : launch_fast<float, false>(x, dh, w, b, mean, rstd, dx, t1, t2, p, grid, cnt, st);
  else
    rc = act ? launch_fast<__nv_bfloat16, true>(x, dh, w, b, mean, rstd, dx, t1, t2, p, grid, cnt,
                                                st)
             : launch_fast<__nv_bfloat16, false>(x, dh, w, b, mean, rstd, dx, t1, t2, p, grid,
                                                 cnt, st);
  if (rc == 0 && dgamma != nullptr)
    gn_bwd_wb_kernel<<<(c + 127) / 128, 128, 0, st>>>(t1, t2, mean, rstd, dgamma, dbeta, n, c,
                                                      groups, c / groups, k);
  const int last = static_cast<int>(cudaGetLastError());
  return rc != 0 ? rc : last;
}

// How many clusters of the fast backward the card holds at once for the
// plan's k and shared memory (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int lyc_gn_bwd_fast_clusters(int k, int smem, int act, int dtype, int* out) {
  const int grid_ok = k >= 1 && k <= gnf::kMaxCluster && smem >= 0 && smem <= gnf::kSmemMax;
  if (!grid_ok || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  static bool allowed[4] = {false, false, false, false};
  cudaError_t e;
  if (dtype == 0) {
    auto kern = act ? gn_bwd_fast_kernel<float, true> : gn_bwd_fast_kernel<float, false>;
    e = gnf::allow_smem(kern, allowed[act]);
    if (e == cudaSuccess) e = gnf::max_clusters(kern, k, smem, out);
  } else {
    auto kern = act ? gn_bwd_fast_kernel<__nv_bfloat16, true>
                    : gn_bwd_fast_kernel<__nv_bfloat16, false>;
    e = gnf::allow_smem(kern, allowed[2 + act]);
    if (e == cudaSuccess) e = gnf::max_clusters(kern, k, smem, out);
  }
  return static_cast<int>(e);
}
