// LayerNorm backward over the last dim: dx, and optionally dw and db.
//
// Replaces: lycoris_tpu/ops/layer_norm.py `_vjp_bwd` -> `_bwd_kernel`
// (Pallas, TPU). Same math: the row statistics are recomputed from x in
// fp32 (two passes, as the forward), x^ = (x - mean) * rstd, and
//   dx = (w*dy - x^ * mean(w*dy*x^) - mean(w*dy)) * rstd,
//   dw = sum over rows of dy*x^,  db = sum over rows of dy.
//
// Bound on the H100: memory. Each element of x and dy is read once and dx
// written once (6 bytes in bf16) against ~10 FLOPs.
//
// Design: one warp owns one row; a block of 4 warps walks rows with a grid
// stride, so a few hundred blocks cover any row count. The TPU kernel sums
// dw/db in VMEM across its sequential row grid; Hopper's blocks run in no
// order, so each warp keeps its own fp32 column sums in shared memory (each
// lane owns columns lane, lane+32, ...: no atomics), the block adds its
// warps' sums in a fixed order into one partial row per block, and a second
// small kernel adds the partial rows column by column. The result does not
// depend on scheduling (deterministic), and the partial rows (<= 528 x C
// fp32) are small beside x and dy. When the caller needs no dw/db (frozen
// LayerNorm weights, as on the training path) both the shared sums and the
// second kernel are skipped.

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

constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const T* __restrict__ w, T* __restrict__ dx,
                  float* __restrict__ dw_part, float* __restrict__ db_part, int rows,
                  int cols, float eps) {
  extern __shared__ float sums[];  // [kWarps][2][cols] when dw/db are wanted
  const int warp = threadIdx.y, lane = threadIdx.x;
  const bool want_wb = dw_part != nullptr;
  float* sdw = sums + warp * 2 * cols;
  float* sdb = sdw + cols;
  if (want_wb)
    for (int c = lane; c < cols; c += 32) sdw[c] = sdb[c] = 0.f;

  const float inv_c = 1.f / cols;
  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const T* xr = x + (long long)row * cols;
    const T* dyr = dy + (long long)row * cols;
    T* dxr = dx + (long long)row * cols;

    float s = 0.f;
    for (int c = lane; c < cols; c += 32) s += to_f(xr[c]);
    const float mean = warp_sum(s) * inv_c;
    float ss = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float d = to_f(xr[c]) - mean;
      ss += d * d;
    }
    const float rstd = rsqrtf(warp_sum(ss) * inv_c + eps);

    float a1 = 0.f, a2 = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float xh = (to_f(xr[c]) - mean) * rstd;
      const float g = to_f(dyr[c]);
      const float wdy = g * to_f(w[c]);
      a1 += wdy * xh;
      a2 += wdy;
      if (want_wb) {
        sdw[c] += g * xh;
        sdb[c] += g;
      }
    }
    const float c1 = warp_sum(a1) * inv_c, c2 = warp_sum(a2) * inv_c;
    for (int c = lane; c < cols; c += 32) {
      const float xh = (to_f(xr[c]) - mean) * rstd;
      const float wdy = to_f(dyr[c]) * to_f(w[c]);
      dxr[c] = from_f<T>((wdy - xh * c1 - c2) * rstd);
    }
  }
  if (!want_wb) return;
  __syncthreads();
  for (int c = warp * 32 + lane; c < cols; c += 32 * kWarps) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      a += sums[k * 2 * cols + c];
      b += sums[k * 2 * cols + cols + c];
    }
    dw_part[(long long)blockIdx.x * cols + c] = a;
    db_part[(long long)blockIdx.x * cols + c] = b;
  }
}

// dw[c] = sum of dw_part[p][c] over the partial rows p (likewise db): a
// 32-column by 32-row block, each thread summing every 32nd partial row,
// then the 32 row sums of each column added in shared memory in order.
__global__ void __launch_bounds__(1024)
    ln_bwd_reduce_kernel(const float* __restrict__ dw_part, const float* __restrict__ db_part,
                         float* __restrict__ dw, float* __restrict__ db, int nparts,
                         int cols) {
  __shared__ float sw[32][33];
  __shared__ float sb[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, b = 0.f;
  if (c < cols) {
    for (int p = ty; p < nparts; p += 32) {
      a += dw_part[(long long)p * cols + c];
      b += db_part[(long long)p * cols + c];
    }
  }
  sw[ty][tx] = a;
  sb[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < cols) {
    float ta = 0.f, tb = 0.f;
    for (int k = 0; k < 32; ++k) {
      ta += sw[k][tx];
      tb += sb[k][tx];
    }
    dw[c] = ta;
    db[c] = tb;
  }
}

template <typename T>
int launch(const void* x, const void* dy, const void* w, void* dx, float* dw_part,
           float* db_part, int rows, int cols, int nparts, float eps, cudaStream_t st) {
  const size_t smem = dw_part ? (size_t)kWarps * 2 * cols * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ln_bwd_kernel<T><<<nparts, dim3(32, kWarps), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w),
      static_cast<T*>(dx), dw_part, db_part, rows, cols, eps);
  return 0;
}

}  // namespace

// x, dy, dx: (rows, cols) contiguous; w: (cols,); all one dtype
// (0 = float32, 1 = bfloat16). nparts: the number of blocks (1..). With
// dw == nullptr only dx is computed; otherwise dw_part/db_part are
// (nparts, cols) fp32 scratch and dw/db (cols,) fp32 outputs.
extern "C" int lyc_ln_bwd(const void* x, const void* dy, const void* w, void* dx,
                          float* dw_part, float* db_part, float* dw, float* db, int rows,
                          int cols, int nparts, float eps, int dtype, void* stream) {
  if (rows < 1 || cols < 1 || nparts < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool want_wb = dw != nullptr;
  float* wp = want_wb ? dw_part : nullptr;
  float* bp = want_wb ? db_part : nullptr;
  int rc;
  if (dtype == 0) {
    rc = launch<float>(x, dy, w, dx, wp, bp, rows, cols, nparts, eps, st);
  } else if (dtype == 1) {
    rc = launch<__nv_bfloat16>(x, dy, w, dx, wp, bp, rows, cols, nparts, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  if (want_wb) {
    ln_bwd_reduce_kernel<<<(cols + 31) / 32, dim3(32, 32), 0, st>>>(dw_part, db_part, dw, db,
                                                                     nparts, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
