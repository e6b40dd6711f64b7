// LayerNorm forward over the last dim.
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
// Two variants, chosen by the caller (ops/layer_norm.py `fwd_plan`, which
// also sizes the block and the grid):
//
// Vectorised (every LayerNorm width of the SD1.5 and SDXL paths): the
// backward's layout (ln.cuh). A group of L lanes of one warp owns a row,
// lane j holding the row's 16-byte vectors j, j + L, ..., j + 4L of x in
// registers (kVecs = 5: L = 8, 16, 32 at C = 320, 640, 1280 in bf16),
// loaded once with 16-byte loads, neighbouring lanes on neighbouring
// addresses. The mean, then the centred sum of squares, are xor-shuffle sums
// inside the group over values already in registers (each lane first adds
// its own values in a fixed order, one partial sum per vector element), and
// y goes out with 16-byte stores: device memory sees one read of x and one
// write of y. Each lane loads its slice of w and b once, before the rows it
// walks. Blocks have 8 warps, or fewer until the grid has 8 blocks an SM,
// as the backward's: SD1.5's (256, 1280) and (1024, 1280) run 256 and 1024
// one-warp blocks over all 132 SMs instead of 64 and 256 four-warp blocks
// (a warp of the generic variant had one 2-byte load a lane in flight;
// here it has 5 x 16 bytes). The grid covers every row once, so a warp
// walks one group of rows at the path's sizes: the grid-stride loop only
// serves grids the caller caps, and issuing the next row's loads early
// would only add registers (capped grids did not help on the card). Sums
// run in a fixed order, so a call repeats bit for bit, on any stream and
// under graph replay.
//
// Registers (ptxas -v, sm_90a): 104 a thread in bf16 and 80 in fp32, no
// spills (room for 19 and 25 warps an SM); the generic kernel 32.
//
// Generic (any other width, fp32 C = 1280, or a tensor not 16-byte
// aligned): one warp owns one row, four rows per 128-thread block. The mean
// and the centred sum of squares are warp-shuffle reductions; the second
// and third passes re-read the row, which at these widths (<= 2.5 KB in
// bf16) hits L1, so device memory sees one read of x.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ln.cuh"

namespace {

constexpr int kRowsPerBlock = 4;

// v, hidden from the optimiser: its unpacking cannot be hoisted out of the
// row loop, so w and b stay packed in registers (20 each) and are unpacked
// where used, not held as 80 floats (x, used in three passes, is left to the
// compiler: hiding it too saves registers but read slower on the card)
__device__ __forceinline__ uint4 opaque(uint4 v) {
  asm volatile("" : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w));
  return v;
}

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

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ln_fwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ b, T* __restrict__ y, int rows, int cols,
                      int lanes, float eps) {
  constexpr int E = 16 / sizeof(T), V = kVecs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int j = lane & (lanes - 1);  // this lane's place in its group
  const int groups = 32 / lanes;     // rows a warp walks at once
  const int group = lane / lanes;
  const int rows_per_block = warps * groups;
  const float inv_c = 1.f / cols;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* y4 = reinterpret_cast<uint4*>(y);

  uint4 wv[V], bv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    wv[v] = __ldg(reinterpret_cast<const uint4*>(w) + v * lanes + j);
    bv[v] = __ldg(reinterpret_cast<const uint4*>(b) + v * lanes + j);
  }

  // the loop bound is the same for every lane of a warp (the shuffles need
  // them all); a group past the last row computes on zeros and stores nothing
  for (int base = blockIdx.x * rows_per_block + warp * groups; base < rows;
       base += gridDim.x * rows_per_block) {
    const int row = base + group;
    const bool valid = row < rows;
    const long long off = (long long)(valid ? row : 0) * (cols / E);
    uint4 xv[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      xv[v] = valid ? __ldg(x4 + off + v * lanes + j) : make_uint4(0, 0, 0, 0);

    float sp[E];
#pragma unroll
    for (int e = 0; e < E; ++e) sp[e] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float xf[E];
      unpack(xv[v], xf);
#pragma unroll
      for (int e = 0; e < E; ++e) sp[e] += xf[e];
    }
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s += sp[e];
    const float mean = group_sum(s, lanes) * inv_c;

#pragma unroll
    for (int e = 0; e < E; ++e) sp[e] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float xf[E];
      unpack(xv[v], xf);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = xf[e] - mean;
        sp[e] += d * d;
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) ss += sp[e];
    const float rstd = rsqrtf(group_sum(ss, lanes) * inv_c + eps);
    if (!valid) continue;

#pragma unroll
    for (int v = 0; v < V; ++v) {
      float xf[E], wf[E], bf[E], out[E];
      unpack(xv[v], xf);
      unpack(opaque(wv[v]), wf);
      unpack(opaque(bv[v]), bf);
#pragma unroll
      for (int e = 0; e < E; ++e) out[e] = (xf[e] - mean) * rstd * wf[e] + bf[e];
      y4[off + v * lanes + j] = pack(out);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int rows, int cols,
           int lanes, int warps, int grid, float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  if (lanes == 0) {
    if (warps != kRowsPerBlock || (long long)grid * kRowsPerBlock < rows)
      return static_cast<int>(cudaErrorInvalidValue);
    ln_fwd_kernel<T><<<grid, dim3(32, kRowsPerBlock), 0, st>>>(xt, wt, bt, yt, rows, cols,
                                                                eps);
    return 0;
  }
  constexpr int E = 16 / sizeof(T);
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (!lanes_ok || cols != lanes * kVecs * E || warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long addr_bits =
      reinterpret_cast<unsigned long long>(x) | reinterpret_cast<unsigned long long>(w) |
      reinterpret_cast<unsigned long long>(b) | reinterpret_cast<unsigned long long>(y);
  if (addr_bits % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  ln_fwd_vec_kernel<T><<<grid, 32 * warps, 0, st>>>(xt, wt, bt, yt, rows, cols, lanes, eps);
  return 0;
}

}  // namespace

// x, y: (rows, cols) contiguous; w, b: (cols,); all one dtype (0 = float32,
// 1 = bfloat16). lanes: 0 for the generic variant (then warps = 4, a row
// each, and grid * 4 >= rows), else the lanes per row of the vectorised one
// (a power of two <= 32 with cols = lanes * kVecs 16-byte vectors; the four
// tensors 16-byte aligned), with warps <= kMaxWarps a block and any grid:
// its blocks walk the rows in turn.
extern "C" int lyc_ln_fwd(const void* x, const void* w, const void* b, void* y, int rows,
                          int cols, int lanes, int warps, int grid, float eps, int dtype,
                          void* stream) {
  if (rows < 1 || cols < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = launch<float>(x, w, b, y, rows, cols, lanes, warps, grid, eps, st);
  } else if (dtype == 1) {
    rc = launch<__nv_bfloat16>(x, w, b, y, rows, cols, lanes, warps, grid, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
