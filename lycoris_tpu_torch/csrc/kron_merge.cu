// LoKr's merged weight in one pass:
//   W_eff[a*u + i, b*v + j] = bf16_rn(float(W[a*u + i, b*v + j]) + (w1[a, b] * c) * w2[i, j])
// with c = scalar * k, W and W_eff bf16 (p*u, q*v), w1 (p, q) and w2 (u, v)
// fp32, all row-major. W is read once and W_eff written once; W is never
// written, so the live route stays stateless.
//
// Replaces: no kernel of lycoris_tpu/ops/. The JAX package leaves W + dW to
// XLA, which fuses the Kronecker product, the scales, the add and the cast
// into one loop over W. PyTorch runs the same formula as a chain of
// elementwise kernels over the full-size weight (dW in fp32, two scales, the
// add, the cast): about 44 bytes an element of W where the function needs 4.
//
// Bound on the H100: bytes. Each element costs one multiply and one add
// against 2 bytes read and 2 written; w1 and w2 are 1/(u*v) and 1/(p*q) of
// W. The arithmetic order is that of the plain version (ops/kron.py
// `merge_plain`): c, then w1 * c, then that times w2, then the add, each
// rounded to fp32 (no contraction into an fma), then one round to nearest
// even into bf16, so the two agree bit for bit.
//
// Design: a thread owns 8 consecutive columns of one row of w2 (two 16-byte
// loads, kept in registers) and sweeps a run of the p*q blocks of W that
// they scale, one 16-byte load and one 16-byte store of 8 bf16 a block,
// UNROLL blocks' loads in flight before the first store. Grid: x over runs
// of blocks (`pairs_per_block` each), y over 256-vector tiles of w2; x
// varies fastest, so the blocks that share a w2 tile run together and read
// it from L2. Every pointer is 16-byte aligned and v a multiple of 8
// (ops/kron.py `supported`).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ float lo_bf16(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_bf16(unsigned x) { return __uint_as_float(x & 0xffff0000u); }

// (a, b) -> one 32-bit word of two bf16, a in the low half (the lower address)
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ unsigned merge2(unsigned w, float cw, float s0, float s1) {
  return pack_bf16(__fadd_rn(lo_bf16(w), __fmul_rn(cw, s0)),
                   __fadd_rn(hi_bf16(w), __fmul_rn(cw, s1)));
}

__global__ void __launch_bounds__(THREADS)
    lyc_kron_merge_kernel(const uint4* __restrict__ w, const float* __restrict__ w1,
                          const float4* __restrict__ w2, const float* __restrict__ scalar,
                          float k, uint4* __restrict__ out, int q, int u, int v8, int pairs,
                          int pairs_per_block) {
  const long long e = (long long)blockIdx.y * THREADS + threadIdx.x;  // 8-column vector of w2
  if (e >= (long long)u * v8) return;
  const int i = (int)(e / v8), j8 = (int)(e - (long long)i * v8);
  const float4 sa = __ldg(w2 + 2 * e), sb = __ldg(w2 + 2 * e + 1);
  const float s[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
  const float c = __fmul_rn(__ldg(scalar), k);
  const long long row = (long long)q * v8;  // 16-byte vectors in a row of W
  const int n0 = blockIdx.x * pairs_per_block;
  const int n1 = min(pairs, n0 + pairs_per_block);
  for (int n = n0; n < n1; n += UNROLL) {
    uint4 x[UNROLL];
    float cw[UNROLL];
    long long off[UNROLL];
#pragma unroll
    for (int t = 0; t < UNROLL; ++t) {
      const int m = n + t;
      if (m < n1) {
        const int a = m / q, b = m - a * q;
        off[t] = ((long long)a * u + i) * row + (long long)b * v8 + j8;
        x[t] = __ldcs(w + off[t]);  // read once: evict first
        cw[t] = __fmul_rn(__ldg(w1 + m), c);
      }
    }
#pragma unroll
    for (int t = 0; t < UNROLL; ++t) {
      if (n + t < n1) {
        uint4 y;
        y.x = merge2(x[t].x, cw[t], s[0], s[1]);
        y.y = merge2(x[t].y, cw[t], s[2], s[3]);
        y.z = merge2(x[t].z, cw[t], s[4], s[5]);
        y.w = merge2(x[t].w, cw[t], s[6], s[7]);
        out[off[t]] = y;
      }
    }
  }
}

}  // namespace

// W, out: bf16 (p*u, q*v); w1: fp32 (p, q); w2: fp32 (u, v); scalar: one
// fp32 on the device; c = scalar * k. All contiguous and 16-byte aligned, v
// a multiple of 8. Blocks of 256 threads over ceil(u*v/8 / 256) tiles of w2
// (grid y, at most 65535) and ceil(p*q / pairs_per_block) runs of W's
// blocks (grid x).
extern "C" int lyc_kron_merge(const void* w, const void* w1, const void* w2, const void* scalar,
                              float k, void* out, int p, int q, int u, int v,
                              int pairs_per_block, void* stream) {
  if (p < 1 || q < 1 || u < 1 || v < 8 || v % 8 != 0 || pairs_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vecs = (long long)u * (v / 8);
  const long long gy = (vecs + THREADS - 1) / THREADS;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = p * q;
  const dim3 grid((pairs + pairs_per_block - 1) / pairs_per_block, (unsigned)gy);
  lyc_kron_merge_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(w), static_cast<const float*>(w1),
      static_cast<const float4*>(w2), static_cast<const float*>(scalar), k,
      static_cast<uint4*>(out), q, u, v / 8, pairs, pairs_per_block);
  return static_cast<int>(cudaGetLastError());
}
