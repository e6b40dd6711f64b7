// LoHa delta weight backward, the split form: the four factor gradients of
// dW = (w1u @ w1d) * (w2u @ w2d) * gamma in two kernels, each a full pass
// over the cotangent g (O, I):
//   t1 = g * gamma * (w2u @ w2d),  t2 = g * gamma * (w1u @ w1d)
//   u-kernel: g1u = t1 @ w1d^T,  g2u = t2 @ w2d^T      (O, R)
//   d-kernel: g1d = w1u^T @ t1,  g2d = w2u^T @ t2      (R, I)
// Both products and t1, t2 are formed tile by tile in shared memory and
// never written out; each kernel recomputes them.
//
// Replaces: lycoris_tpu/ops/hada.py `_hada_bwd_pallas` (the split form,
// `LYCORIS_TPU_HADA_BWD=split`) -> `_hada_bwd_u_kernel` and
// `_hada_bwd_d_kernel` (Pallas, TPU). The TPU kernels accumulate across the
// inner, sequential grid axis into an output block kept resident; here the
// inner axis becomes a loop inside the block: a u-kernel block owns a strip
// of 16 rows and walks every column tile, a d-kernel block owns a strip of 16
// columns and walks every row tile. Each gradient element is summed by one
// thread in a fixed order: no atomics and no partial sums across blocks, so
// the result is deterministic (the fused1 form in hada_bwd.cu writes
// per-block partials instead).
//
// Bound on the H100: g is read twice (once per kernel), twice the bytes of
// the fused form; each kernel does 4R multiply-adds per element of g (both
// products and two contractions) on the CUDA cores (no tensor-core work at
// depth R = 8). The grid is as wide as the form allows: O / 16 blocks for
// the u-kernel and I / 16 for the d-kernel, which at SD1.5's (10240, 1280)
// ff layer is 80 blocks on 132 SMs.
//
// Design: 256 threads; tiles of 16 x 64 (u) or 64 x 16 (d) elements of g,
// four per thread, read along g's rows. Shared memory holds 32 ranks at a
// time (about 34 KB whatever R is): the tile's rows of w1u/w2u and
// columns of w1d/w2d for a chunk of ranks, t1/t2 of the tile, and the
// block's gradient sums for one chunk, each owned by one thread. The
// products run over all R a chunk at a time; a block sums the gradients
// of one chunk of ranks per walk, so a rank above 32 walks the strip once
// per chunk (R <= 32, the path's ranks, is one walk, as before).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int NT = 256;
constexpr int STRIP = 16;  // rows (u) or columns (d) a block owns
constexpr int WALK = 64;   // columns (u) or rows (d) of one tile of the walk
constexpr int RC = 32;     // ranks staged at a time
constexpr int RU = RC + 1;

template <bool U>
struct Tile {
  static constexpr int TR = U ? STRIP : WALK;  // rows of a tile
  static constexpr int TC = U ? WALK : STRIP;  // columns of a tile
  static constexpr int LDC = TC + 1;
  static constexpr int EPT = TR * TC / NT;     // elements of a tile per thread
  static constexpr int N_ACC = U ? TR * RC : RC * TC;
};

template <typename T, bool U>
__global__ void __launch_bounds__(NT)
    hada_bwd_split_kernel(const T* __restrict__ g, const T* __restrict__ w1d,
                          const T* __restrict__ w1u, const T* __restrict__ w2d,
                          const T* __restrict__ w2u, float* __restrict__ out1,
                          float* __restrict__ out2, int O, int I, int R, float scale) {
  using Tl = Tile<U>;
  constexpr int TR = Tl::TR, TC = Tl::TC, LDC = Tl::LDC;
  __shared__ float s1u[TR * RU], s2u[TR * RU];      // the tile's rows of w1u/w2u, a rank chunk
  __shared__ float s1d[RC * LDC], s2d[RC * LDC];    // the tile's columns of w1d/w2d, likewise
  __shared__ float st1[TR * LDC], st2[TR * LDC];    // t1, t2 of the tile
  __shared__ float acc1[Tl::N_ACC], acc2[Tl::N_ACC];  // u: [TR][RC]; d: [RC][TC]

  const int tid = threadIdx.x;
  const int row0 = U ? blockIdx.x * STRIP : 0;
  const int col0 = U ? 0 : blockIdx.x * STRIP;

  // ranks [c0, c0 + RC) of the tile's rows of w1u/w2u and of its columns
  // of w1d/w2d (the ranks R has; the loops below read no others): the
  // strip's own slice (u: its rows; d: its columns), the same for every
  // tile of the walk, and the tile's other slice
  auto stage_u = [&](int o0, int c0) {
    const int cn = min(RC, R - c0);
    for (int idx = tid; idx < TR * cn; idx += NT) {
      const int m = idx / cn, r = idx - m * cn;
      const int o = o0 + m;
      const bool ok = o < O;
      s1u[m * RU + r] = ok ? to_f(w1u[(long long)o * R + c0 + r]) : 0.f;
      s2u[m * RU + r] = ok ? to_f(w2u[(long long)o * R + c0 + r]) : 0.f;
    }
  };
  auto stage_d = [&](int i0, int c0) {
    const int cn = min(RC, R - c0);
    for (int idx = tid; idx < cn * TC; idx += NT) {
      const int r = idx / TC, n = idx - r * TC;
      const int i = i0 + n;
      const bool ok = i < I;
      s1d[r * LDC + n] = ok ? to_f(w1d[(long long)(c0 + r) * I + i]) : 0.f;
      s2d[r * LDC + n] = ok ? to_f(w2d[(long long)(c0 + r) * I + i]) : 0.f;
    }
  };
  auto stage_own = [&](int c0) {
    if (U) stage_u(row0, c0); else stage_d(col0, c0);
  };
  auto stage_other = [&](int o0, int i0, int c0) {
    if (U) stage_d(i0, c0); else stage_u(o0, c0);
  };

  // at R <= RC (one chunk) the strip's own slice is staged once per walk
  const bool one = R <= RC;
  const int steps = U ? (I + TC - 1) / TC : (O + TR - 1) / TR;
  for (int r0 = 0; r0 < R; r0 += RC) {  // the ranks whose gradients this pass sums
    const int rc = min(RC, R - r0);
    for (int idx = tid; idx < Tl::N_ACC; idx += NT) acc1[idx] = acc2[idx] = 0.f;
    if (one) stage_own(0);
    for (int s = 0; s < steps; ++s) {
      const int o0 = U ? row0 : s * TR;
      const int i0 = U ? s * TC : col0;
      // both products over all R, a rank chunk at a time, EPT elements a thread
      float p1[Tl::EPT], p2[Tl::EPT];
#pragma unroll
      for (int k = 0; k < Tl::EPT; ++k) p1[k] = p2[k] = 0.f;
      for (int c0 = 0; c0 < R; c0 += RC) {
        __syncthreads();  // the previous readers of the staged chunk are done
        if (!one) stage_own(c0);
        stage_other(o0, i0, c0);
        __syncthreads();
        const int cn = min(RC, R - c0);
#pragma unroll
        for (int k = 0; k < Tl::EPT; ++k) {
          const int e = tid + k * NT, m = e / TC, n = e - m * TC;
          for (int r = 0; r < cn; ++r) {
            p1[k] = fmaf(s1u[m * RU + r], s1d[r * LDC + n], p1[k]);
            p2[k] = fmaf(s2u[m * RU + r], s2d[r * LDC + n], p2[k]);
          }
        }
      }
      if (!one) {  // the contraction below needs the pass's own chunk
        __syncthreads();
        stage_own(r0);
        stage_other(o0, i0, r0);
      }
      // t1 = g * gamma * p2, t2 = g * gamma * p1
#pragma unroll
      for (int k = 0; k < Tl::EPT; ++k) {
        const int e = tid + k * NT, m = e / TC, n = e - m * TC;
        const int o = o0 + m, i = i0 + n;
        const float gv = (o < O && i < I) ? to_f(g[(long long)o * I + i]) * scale : 0.f;
        st1[m * LDC + n] = gv * p2[k];
        st2[m * LDC + n] = gv * p1[k];
      }
      __syncthreads();

      if (U) {
        // g1u[m][r] += sum_n t1[m][n] w1d[r][n];  g2u with t2, w2d
        for (int idx = tid; idx < TR * rc; idx += NT) {
          const int m = idx / rc, r = idx - m * rc;
          float a1 = 0.f, a2 = 0.f;
#pragma unroll 8
          for (int n = 0; n < TC; ++n) {
            a1 = fmaf(st1[m * LDC + n], s1d[r * LDC + n], a1);
            a2 = fmaf(st2[m * LDC + n], s2d[r * LDC + n], a2);
          }
          acc1[m * RC + r] += a1;
          acc2[m * RC + r] += a2;
        }
      } else {
        // g1d[r][n] += sum_m w1u[m][r] t1[m][n];  g2d with w2u, t2
        for (int idx = tid; idx < rc * TC; idx += NT) {
          const int r = idx / TC, n = idx - r * TC;
          float a1 = 0.f, a2 = 0.f;
#pragma unroll 8
          for (int m = 0; m < TR; ++m) {
            a1 = fmaf(s1u[m * RU + r], st1[m * LDC + n], a1);
            a2 = fmaf(s2u[m * RU + r], st2[m * LDC + n], a2);
          }
          acc1[idx] += a1;
          acc2[idx] += a2;
        }
      }
    }

    // each sum is read back by the thread that owns it
    if (U) {
      for (int idx = tid; idx < TR * rc; idx += NT) {
        const int m = idx / rc, r = idx - m * rc;
        const int o = row0 + m;
        if (o < O) {
          out1[(long long)o * R + r0 + r] = acc1[m * RC + r];
          out2[(long long)o * R + r0 + r] = acc2[m * RC + r];
        }
      }
    } else {
      for (int idx = tid; idx < rc * TC; idx += NT) {
        const int r = idx / TC, n = idx - r * TC;
        const int i = col0 + n;
        if (i < I) {
          out1[(long long)(r0 + r) * I + i] = acc1[idx];
          out2[(long long)(r0 + r) * I + i] = acc2[idx];
        }
      }
    }
  }
}

template <typename T, bool U>
int launch(const void* g, const void* w1d, const void* w1u, const void* w2d, const void* w2u,
           float* out1, float* out2, int O, int I, int R, float scale, cudaStream_t st) {
  const int blocks = U ? (O + STRIP - 1) / STRIP : (I + STRIP - 1) / STRIP;
  hada_bwd_split_kernel<T, U><<<blocks, NT, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(w1d), static_cast<const T*>(w1u),
      static_cast<const T*>(w2d), static_cast<const T*>(w2u), out1, out2, O, I, R, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_both(const void* g, const void* w1d, const void* w1u, const void* w2d,
                const void* w2u, float* g1d, float* g1u, float* g2d, float* g2u, int O, int I,
                int R, float scale, cudaStream_t st) {
  const int rc = launch<T, true>(g, w1d, w1u, w2d, w2u, g1u, g2u, O, I, R, scale, st);
  if (rc != 0) return rc;
  return launch<T, false>(g, w1d, w1u, w2d, w2u, g1d, g2d, O, I, R, scale, st);
}

}  // namespace

// g: (O, I); w1d, w2d: (R, I); w1u, w2u: (O, R); all contiguous, one dtype
// (0 = float32, 1 = bfloat16). Out: g1d, g2d (R, I) and g1u, g2u (O, R)
// fp32. Launches the u-kernel, then the d-kernel, on ``stream``.
extern "C" int lyc_hada_bwd_split(const void* g, const void* w1d, const void* w1u,
                                  const void* w2d, const void* w2u, float* g1d, float* g1u,
                                  float* g2d, float* g2u, int O, int I, int R, float scale,
                                  int dtype, void* stream) {
  if (O < 1 || I < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_both<float>(g, w1d, w1u, w2d, w2u, g1d, g1u, g2d, g2u, O, I, R, scale, st);
  if (dtype == 1)
    return launch_both<__nv_bfloat16>(g, w1d, w1u, w2d, w2u, g1d, g1u, g2d, g2u, O, I, R,
                                      scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
