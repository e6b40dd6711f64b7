// LayerNorm forward over the last dim, one warp per row.
//
// Replaces: lycoris_tpu/ops/layer_norm.py `_fwd_call` -> `_fwd_kernel`
// (Pallas, TPU). Same math: fp32 row mean, then var = mean((x - mean)^2)
// (two passes over the row, not E[x^2] - mean^2), y = xc * rstd * w + b
// written in x's dtype.
//
// Bound on the H100: memory. Each element is read once from device memory
// and written once (2 + 2 bytes in bf16), against a handful of FLOPs, so
// the kernel can at best run at the HBM rate.
//
// Design: one warp owns one row (C = 320, 640 and 1280 on the SD1.5 path),
// four rows per 128-thread block. The mean and the centred sum of squares
// are warp-shuffle reductions; the second and third passes re-read the row,
// which at these widths (<= 2.5 KB in bf16) hits L1, so device memory sees
// one read of x. No shared memory, no cross-block reduction.

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kRowsPerBlock = 4;

template <typename T>
__global__ void ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                              const T* __restrict__ b, T* __restrict__ y,
                              int rows, int cols, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= rows) return;  // whole warp leaves together
  const int lane = threadIdx.x;
  const T* xr = x + (long long)row * cols;
  T* yr = y + (long long)row * cols;

  float s = 0.f;
  for (int c = lane; c < cols; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / cols;

  float ss = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f(xr[c]) - mean;
    ss += d * d;
  }
  const float var = warp_sum(ss) / cols;
  const float rstd = rsqrtf(var + eps);

  for (int c = lane; c < cols; c += 32) {
    const float xc = to_f(xr[c]) - mean;
    yr[c] = from_f<T>(xc * rstd * to_f(w[c]) + to_f(b[c]));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, b and y share it).
extern "C" int lyc_ln_fwd(const void* x, const void* w, const void* b, void* y,
                          int rows, int cols, float eps, int dtype, void* stream) {
  const dim3 block(32, kRowsPerBlock);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ln_fwd_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y), rows, cols, eps);
  } else if (dtype == 1) {
    ln_fwd_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), rows,
        cols, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
