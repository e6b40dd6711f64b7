// The pieces the LayerNorm kernels (ln_fwd.cu, ln_bwd.cu) share: element
// conversions, warp and lane-group sums, the 16-byte pack/unpack of the
// vectorised variants, and their block and grid planning constants.
//
// Vectorised layout (both directions): a group of L lanes of one warp owns a
// row, so a warp walks 32 / L rows at once, and lane j of the group holds the
// row's 16-byte vectors j, j + L, ..., j + (kVecs - 1) L in registers. L is
// chosen by the caller (ops/layer_norm.py `lanes`): C = L * kVecs * 16 /
// sizeof(T), a power of two up to 32.

#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

constexpr int kMaxWarps = 8;   // warps per block, fewer where the rows would not fill the SMs
constexpr int kBlocksPerSm = 8;  // blocks an SM that a grid of fewer warps a block aims for
constexpr int kVecs = 5;  // 16-byte vectors of x (and of dy) a lane holds: the path's count

// the E = 16 / sizeof(T) values of one 16-byte vector as floats
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// the sum of a over the `lanes` lanes of this lane's group (groups are
// aligned runs of `lanes` lanes; every lane of the warp takes part)
__device__ __forceinline__ float group_sum(float a, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// sums of a and of b over the `lanes` lanes of this lane's group, the two
// shuffle chains interleaved
__device__ __forceinline__ void group_sum2(float& a, float& b, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// SMs of the current device (the backward's grid planning)
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace
