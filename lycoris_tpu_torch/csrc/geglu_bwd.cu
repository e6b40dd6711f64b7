// GEGLU backward: d_hfull = [dy * gelu(gate) | dy * h * gelu'(gate)] for
// o = h * gelu(gate), h, gate = split(h_full, 2, dim=-1), gelu the tanh
// approximation.
//
// Replaces: lycoris_tpu/ops/geglu.py `geglu_bwd_dt` -> `_bwd_kernel` (Pallas,
// TPU). Same math: gelu(x) = 0.5 x (1 + tanh(u)), u = k0 (x + 0.044715 x^3),
// and gelu'(x) = 0.5 (1 + tanh u) + 0.5 x (1 - tanh^2 u) k0 (1 + 3 * 0.044715
// x^2), the derivative `jax.jvp(jax.nn.gelu)` gives; both in fp32, each
// output rounded once.
//
// Bound on the H100: memory. h, gate and dy are read once and both halves of
// d_hfull written once: 5 F elements (10 F bytes in bf16) per token row,
// against ~30 fp32 operations per element of dy.
//
// Design. The TPU kernel works on a D-major (B, 2F, T) view so that the
// h/gate split is a sublane block split; PyTorch's (B, T, 2F) rows are
// contiguous, so each thread takes 16 bytes of h, of gate (F elements
// further along the same row) and of dy, and writes 16 bytes into each half of the row of
// d_hfull: one pass, no concat, no second buffer. F is a multiple of 8 at
// every UNet level, so a vector never straddles a row.

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

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    geglu_bwd_kernel(const T* __restrict__ hf, const T* __restrict__ dy, T* __restrict__ out,
                     long long nvec, int f) {
  constexpr float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  constexpr float k1 = 0.044715f;
  const int per_row = f / VEC;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * blockDim.x) {
    const long long row = v / per_row;
    const int col = (int)(v % per_row) * VEC;
    const long long base = row * 2 * f + col;
    float h[VEC], g[VEC], d[VEC];
    load_vec<T, VEC>(hf + base, h);
    load_vec<T, VEC>(hf + base + f, g);
    load_vec<T, VEC>(dy + row * f + col, d);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float x = g[k];
      const float t = tanhf(k0 * (x + k1 * x * x * x));
      const float gelu = 0.5f * x * (1.f + t);
      const float dgelu = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * k0 * (1.f + 3.f * k1 * x * x);
      g[k] = d[k] * h[k] * dgelu;
      h[k] = d[k] * gelu;
    }
    store_vec<T, VEC>(out + base, h);
    store_vec<T, VEC>(out + base + f, g);
  }
}

template <typename T, int VEC>
void launch(const void* hf, const void* dy, void* out, int rows, int f, cudaStream_t st) {
  const long long nvec = (long long)rows * f / VEC;
  const long long want = (nvec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  geglu_bwd_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(hf), static_cast<const T*>(dy), static_cast<T*>(out), nvec, f);
}

}  // namespace

// hf, out: (rows, 2F) contiguous; dy: (rows, F) contiguous; one dtype (0 =
// float32, 1 = bfloat16). vec: 1, or 16 / sizeof(element) when F is a
// multiple of it and the three pointers are 16-byte aligned.
extern "C" int lyc_geglu_bwd(const void* hf, const void* dy, void* out, int rows, int f,
                             int vec, int dtype, void* stream) {
  if (rows < 1 || f < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4 && f % 4 == 0) {
    launch<float, 4>(hf, dy, out, rows, f, st);
  } else if (dtype == 0 && vec == 1) {
    launch<float, 1>(hf, dy, out, rows, f, st);
  } else if (dtype == 1 && vec == 8 && f % 8 == 0) {
    launch<__nv_bfloat16, 8>(hf, dy, out, rows, f, st);
  } else if (dtype == 1 && vec == 1) {
    launch<__nv_bfloat16, 1>(hf, dy, out, rows, f, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
