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
// four per thread, read along g's rows; the strip's own factor slice (u:
// the rows of w1u/w2u; d: the columns of w1d/w2d) is loaded once, the other
// slice per tile; the block's gradient sums stay in shared memory, each
// owned by one thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int NT = 256;
constexpr int STRIP = 16;  // rows (u) or columns (d) a block owns
constexpr int WALK = 64;   // columns (u) or rows (d) of one tile of the walk

template <bool U>
struct Tile {
  static constexpr int TR = U ? STRIP : WALK;  // rows of a tile
  static constexpr int TC = U ? WALK : STRIP;  // columns of a tile
  static constexpr int LDC = TC + 1;
  static size_t floats(int R) {
    const size_t n_acc = U ? (size_t)TR * R : (size_t)R * TC;
    return 2 * (size_t)TR * (R + 1) + 2 * (size_t)R * LDC + 2 * (size_t)TR * LDC + 2 * n_acc;
  }
};

template <typename T, bool U>
__global__ void __launch_bounds__(NT)
    hada_bwd_split_kernel(const T* __restrict__ g, const T* __restrict__ w1d,
                          const T* __restrict__ w1u, const T* __restrict__ w2d,
                          const T* __restrict__ w2u, float* __restrict__ out1,
                          float* __restrict__ out2, int O, int I, int R, float scale) {
  constexpr int TR = Tile<U>::TR, TC = Tile<U>::TC, LDC = Tile<U>::LDC;
  extern __shared__ float sm[];
  const int RU = R + 1;
  const int n_acc = U ? TR * R : R * TC;
  float* s1u = sm;                 // [TR][R + 1] the tile's rows of w1u
  float* s2u = s1u + TR * RU;      // [TR][R + 1]
  float* s1d = s2u + TR * RU;      // [R][LDC] the tile's columns of w1d
  float* s2d = s1d + R * LDC;      // [R][LDC]
  float* st1 = s2d + R * LDC;      // [TR][LDC] t1 of the tile
  float* st2 = st1 + TR * LDC;     // [TR][LDC]
  float* acc1 = st2 + TR * LDC;    // u: [TR][R] of g1u; d: [R][TC] of g1d
  float* acc2 = acc1 + n_acc;

  const int tid = threadIdx.x;
  const int row0 = U ? blockIdx.x * STRIP : 0;
  const int col0 = U ? 0 : blockIdx.x * STRIP;

  auto load_u = [&](int o0) {
    for (int idx = tid; idx < TR * R; idx += NT) {
      const int m = idx / R, r = idx - m * R;
      const int o = o0 + m;
      const bool ok = o < O;
      s1u[m * RU + r] = ok ? to_f(w1u[(long long)o * R + r]) : 0.f;
      s2u[m * RU + r] = ok ? to_f(w2u[(long long)o * R + r]) : 0.f;
    }
  };
  auto load_d = [&](int i0) {
    for (int idx = tid; idx < R * TC; idx += NT) {
      const int r = idx / TC, n = idx - r * TC;
      const int i = i0 + n;
      const bool ok = i < I;
      s1d[r * LDC + n] = ok ? to_f(w1d[(long long)r * I + i]) : 0.f;
      s2d[r * LDC + n] = ok ? to_f(w2d[(long long)r * I + i]) : 0.f;
    }
  };

  for (int idx = tid; idx < n_acc; idx += NT) acc1[idx] = acc2[idx] = 0.f;
  if (U) load_u(row0); else load_d(col0);

  const int steps = U ? (I + TC - 1) / TC : (O + TR - 1) / TR;
  for (int s = 0; s < steps; ++s) {
    const int o0 = U ? row0 : s * TR;
    const int i0 = U ? s * TC : col0;
    __syncthreads();  // the previous tile's readers are done
    if (U) load_d(i0); else load_u(o0);
    __syncthreads();

    // t1 = g * gamma * p2, t2 = g * gamma * p1, four elements per thread
    for (int e = tid; e < TR * TC; e += NT) {
      const int m = e / TC, n = e - m * TC;
      float p1 = 0.f, p2 = 0.f;
      for (int r = 0; r < R; ++r) {
        p1 = fmaf(s1u[m * RU + r], s1d[r * LDC + n], p1);
        p2 = fmaf(s2u[m * RU + r], s2d[r * LDC + n], p2);
      }
      const int o = o0 + m, i = i0 + n;
      const float gv = (o < O && i < I) ? to_f(g[(long long)o * I + i]) * scale : 0.f;
      st1[m * LDC + n] = gv * p2;
      st2[m * LDC + n] = gv * p1;
    }
    __syncthreads();

    if (U) {
      // g1u[m][r] += sum_n t1[m][n] w1d[r][n];  g2u with t2, w2d
      for (int idx = tid; idx < TR * R; idx += NT) {
        const int m = idx / R, r = idx - m * R;
        float a1 = 0.f, a2 = 0.f;
#pragma unroll 8
        for (int n = 0; n < TC; ++n) {
          a1 = fmaf(st1[m * LDC + n], s1d[r * LDC + n], a1);
          a2 = fmaf(st2[m * LDC + n], s2d[r * LDC + n], a2);
        }
        acc1[idx] += a1;
        acc2[idx] += a2;
      }
    } else {
      // g1d[r][n] += sum_m w1u[m][r] t1[m][n];  g2d with w2u, t2
      for (int idx = tid; idx < R * TC; idx += NT) {
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
    for (int idx = tid; idx < TR * R; idx += NT) {
      const int m = idx / R, r = idx - m * R;
      const int o = row0 + m;
      if (o < O) {
        out1[(long long)o * R + r] = acc1[idx];
        out2[(long long)o * R + r] = acc2[idx];
      }
    }
  } else {
    for (int idx = tid; idx < R * TC; idx += NT) {
      const int r = idx / TC, n = idx - r * TC;
      const int i = col0 + n;
      if (i < I) {
        out1[(long long)r * I + i] = acc1[idx];
        out2[(long long)r * I + i] = acc2[idx];
      }
    }
  }
}

template <typename T, bool U>
int launch(const void* g, const void* w1d, const void* w1u, const void* w2d, const void* w2u,
           float* out1, float* out2, int O, int I, int R, float scale, cudaStream_t st) {
  const size_t smem = Tile<U>::floats(R) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hada_bwd_split_kernel<T, U>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = U ? (O + STRIP - 1) / STRIP : (I + STRIP - 1) / STRIP;
  hada_bwd_split_kernel<T, U><<<blocks, NT, smem, st>>>(
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
