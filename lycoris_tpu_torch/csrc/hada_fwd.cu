// LoHa delta weight: dW = (w1u @ w1d) * (w2u @ w2d) * gamma, elementwise
// product of two rank-R products, written once.
//
// Replaces: lycoris_tpu/ops/hada.py `_hada_fwd_pallas` -> `_hada_fwd_kernel`
// (Pallas, TPU), which forms both products tile-local at fp32 HIGHEST
// precision and never writes either to device memory.
//
// Bound on the H100: the single O x I write. With R = 8 each output costs
// 2R multiply-adds against 4 bytes written (fp32), far below the card's
// compute-to-bandwidth balance, and there is nothing for the tensor cores
// to do at depth 8.
//
// Design: one 256-thread block per 32 x 64 output tile. The block stages
// the tile's rows of w1u/w2u and columns of w1d/w2d in shared memory in
// chunks of 16 along R, keeps both partial products in fp32 registers
// (8 outputs per thread), multiplies them, scales by gamma and stores each
// output once; consecutive threads write consecutive columns.

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

constexpr int TM = 32;   // output rows per block
constexpr int TN = 64;   // output cols per block
constexpr int RC = 16;   // rank chunk staged per pass
constexpr int BX = 32, BY = 8;

template <typename T>
__global__ void hada_fwd_kernel(const T* __restrict__ w1d, const T* __restrict__ w1u,
                                const T* __restrict__ w2d, const T* __restrict__ w2u,
                                T* __restrict__ out, int O, int I, int R, float scale) {
  __shared__ float s1u[TM][RC + 1];
  __shared__ float s2u[TM][RC + 1];
  __shared__ float s1d[RC][TN];
  __shared__ float s2d[RC][TN];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BX + tx;
  const int o0 = blockIdx.y * TM, i0 = blockIdx.x * TN;

  float p1[TM / BY][TN / BX];
  float p2[TM / BY][TN / BX];
#pragma unroll
  for (int a = 0; a < TM / BY; ++a)
#pragma unroll
    for (int c = 0; c < TN / BX; ++c) p1[a][c] = p2[a][c] = 0.f;

  for (int r0 = 0; r0 < R; r0 += RC) {
    for (int idx = tid; idx < TM * RC; idx += BX * BY) {
      const int rr = idx / RC, kk = idx % RC;
      const int o = o0 + rr, r = r0 + kk;
      const bool ok = o < O && r < R;
      s1u[rr][kk] = ok ? to_f(w1u[(long long)o * R + r]) : 0.f;
      s2u[rr][kk] = ok ? to_f(w2u[(long long)o * R + r]) : 0.f;
    }
    for (int idx = tid; idx < RC * TN; idx += BX * BY) {
      const int kk = idx / TN, cc = idx % TN;
      const int r = r0 + kk, i = i0 + cc;
      const bool ok = r < R && i < I;
      s1d[kk][cc] = ok ? to_f(w1d[(long long)r * I + i]) : 0.f;
      s2d[kk][cc] = ok ? to_f(w2d[(long long)r * I + i]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < RC; ++kk) {
      float b1[TN / BX], b2[TN / BX];
#pragma unroll
      for (int c = 0; c < TN / BX; ++c) {
        b1[c] = s1d[kk][tx + c * BX];
        b2[c] = s2d[kk][tx + c * BX];
      }
#pragma unroll
      for (int a = 0; a < TM / BY; ++a) {
        const float a1 = s1u[ty + a * BY][kk];
        const float a2 = s2u[ty + a * BY][kk];
#pragma unroll
        for (int c = 0; c < TN / BX; ++c) {
          p1[a][c] = fmaf(a1, b1[c], p1[a][c]);
          p2[a][c] = fmaf(a2, b2[c], p2[a][c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TM / BY; ++a) {
    const int o = o0 + ty + a * BY;
    if (o >= O) continue;
#pragma unroll
    for (int c = 0; c < TN / BX; ++c) {
      const int i = i0 + tx + c * BX;
      if (i < I) out[(long long)o * I + i] = from_f<T>(p1[a][c] * p2[a][c] * scale);
    }
  }
}

}  // namespace

// w1d, w2d: (R, I); w1u, w2u: (O, R); out: (O, I); all contiguous, one dtype.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int lyc_hada_fwd(const void* w1d, const void* w1u, const void* w2d,
                            const void* w2u, void* out, int O, int I, int R,
                            float scale, int dtype, void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid((I + TN - 1) / TN, (O + TM - 1) / TM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    hada_fwd_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(w1d), static_cast<const float*>(w1u),
        static_cast<const float*>(w2d), static_cast<const float*>(w2u),
        static_cast<float*>(out), O, I, R, scale);
  } else if (dtype == 1) {
    hada_fwd_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(w1d), static_cast<const __nv_bfloat16*>(w1u),
        static_cast<const __nv_bfloat16*>(w2d), static_cast<const __nv_bfloat16*>(w2u),
        static_cast<__nv_bfloat16*>(out), O, I, R, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
