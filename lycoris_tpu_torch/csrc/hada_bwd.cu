// LoHa delta weight backward: the four factor gradients of
// dW = (w1u @ w1d) * (w2u @ w2d) * gamma in one pass over the cotangent g:
//   t1 = g * gamma * (w2u @ w2d),  t2 = g * gamma * (w1u @ w1d)
//   g1u = t1 @ w1d^T,  g1d = w1u^T @ t1,  g2u = t2 @ w2d^T,  g2d = w2u^T @ t2
// t1, t2 and both products are formed tile by tile and never written out.
//
// Replaces: lycoris_tpu/ops/hada.py `_hada_bwd_fused1` ->
// `_make_hada_bwd_fused1_kernel` (Pallas, TPU), which keeps the (O, R) and
// (R, I) gradient accumulators resident in VMEM for its whole sequential
// grid. Hopper's blocks run in parallel and in no order, so each block
// writes partial sums instead and a second small kernel adds them in a
// fixed order (deterministic, no atomics): a block owns a strip of 128
// columns and a run of rows, walks it in 16-row tiles, writes each tile's
// u-grad rows (complete over its 128 columns) as a partial for its column
// strip, and keeps its d-grad columns in shared memory across its rows. The
// caller picks the rows per block (16..256) so that a layer spreads over
// about two blocks per SM: a small layer in few long blocks would be
// latency-bound on the serial walk.
//
// Bound on the H100: at rank 8, the fp32 operations. Each element of g
// costs 6R multiply-adds (both products, the u- and the d-contractions), no
// work for the tensor cores at depth 8, against one 4-byte read of g; the
// partial sums add 2R(1/128 + 1/rows per block) of g's bytes, written and
// read once more (19% at 256 rows, rank 8).
//
// Design: 256 threads (32 x 8); a thread owns 2 rows x 4 columns of each
// 16 x 128 tile for the products and t1/t2, then the tile's u-grad
// (16 x R, each a 128-long dot) and d-grad (R x 128, each a 16-long dot)
// are split over the threads from shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int TM = 16;    // rows per tile
constexpr int TN = 128;   // columns per block
constexpr int BX = 32, BY = 8, NT = BX * BY;
constexpr int LDN = TN + 1;

size_t smem_floats(int R) {
  return 2 * (size_t)R * LDN + 2 * (size_t)R * TN + 2 * (size_t)TM * (R + 1) +
         2 * (size_t)TM * LDN;
}

template <typename T>
__global__ void __launch_bounds__(NT)
    hada_bwd_kernel(const T* __restrict__ g, const T* __restrict__ w1d,
                    const T* __restrict__ w1u, const T* __restrict__ w2d,
                    const T* __restrict__ w2u, float* __restrict__ pu1,
                    float* __restrict__ pu2, float* __restrict__ pd1,
                    float* __restrict__ pd2, int O, int I, int R, int rpb, float scale) {
  extern __shared__ float sm[];
  float* s1d = sm;                   // [R][LDN] this block's columns of w1d
  float* s2d = s1d + R * LDN;        // [R][LDN]
  float* sd1 = s2d + R * LDN;        // [R][TN] d-grad sums over the block's rows
  float* sd2 = sd1 + R * TN;         // [R][TN]
  float* s1u = sd2 + R * TN;         // [TM][R + 1] the tile's rows of w1u
  float* s2u = s1u + TM * (R + 1);   // [TM][R + 1]
  float* st1 = s2u + TM * (R + 1);   // [TM][LDN] t1 of the tile
  float* st2 = st1 + TM * LDN;       // [TM][LDN]

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  const int i0 = blockIdx.x * TN;
  const int ob = blockIdx.y * rpb;
  const int oe = min(O, ob + rpb);
  const int RU = R + 1;

  for (int idx = tid; idx < R * TN; idx += NT) {
    const int r = idx / TN, n = idx - r * TN;
    const int i = i0 + n;
    const bool ok = i < I;
    s1d[r * LDN + n] = ok ? to_f(w1d[(long long)r * I + i]) : 0.f;
    s2d[r * LDN + n] = ok ? to_f(w2d[(long long)r * I + i]) : 0.f;
    sd1[idx] = sd2[idx] = 0.f;
  }

  for (int o0 = ob; o0 < oe; o0 += TM) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < TM * R; idx += NT) {
      const int m = idx / R, r = idx - m * R;
      const int o = o0 + m;
      const bool ok = o < O;
      s1u[m * RU + r] = ok ? to_f(w1u[(long long)o * R + r]) : 0.f;
      s2u[m * RU + r] = ok ? to_f(w2u[(long long)o * R + r]) : 0.f;
    }
    __syncthreads();

    // products and t1 = g*gamma*p2, t2 = g*gamma*p1 for 2 rows x 4 columns
#pragma unroll
    for (int a = 0; a < TM / BY; ++a) {
      const int m = ty + a * BY;
      float p1[TN / BX], p2[TN / BX];
#pragma unroll
      for (int c = 0; c < TN / BX; ++c) p1[c] = p2[c] = 0.f;
      for (int r = 0; r < R; ++r) {
        const float u1 = s1u[m * RU + r], u2 = s2u[m * RU + r];
#pragma unroll
        for (int c = 0; c < TN / BX; ++c) {
          p1[c] = fmaf(u1, s1d[r * LDN + tx + c * BX], p1[c]);
          p2[c] = fmaf(u2, s2d[r * LDN + tx + c * BX], p2[c]);
        }
      }
      const int o = o0 + m;
#pragma unroll
      for (int c = 0; c < TN / BX; ++c) {
        const int n = tx + c * BX, i = i0 + n;
        const float gv = (o < O && i < I) ? to_f(g[(long long)o * I + i]) * scale : 0.f;
        st1[m * LDN + n] = gv * p2[c];
        st2[m * LDN + n] = gv * p1[c];
      }
    }
    __syncthreads();

    // u-grads of the tile's rows over this block's columns: one partial
    for (int idx = tid; idx < TM * R; idx += NT) {
      const int m = idx / R, r = idx - m * R;
      const int o = o0 + m;
      float u1 = 0.f, u2 = 0.f;
      for (int n = 0; n < TN; ++n) {
        u1 = fmaf(st1[m * LDN + n], s1d[r * LDN + n], u1);
        u2 = fmaf(st2[m * LDN + n], s2d[r * LDN + n], u2);
      }
      if (o < O) {
        const long long at = ((long long)blockIdx.x * O + o) * R + r;
        pu1[at] = u1;
        pu2[at] = u2;
      }
    }
    // d-grads: add the tile's rows into this block's column sums
    for (int idx = tid; idx < R * TN; idx += NT) {
      const int r = idx / TN, n = idx - r * TN;
      float d1 = 0.f, d2 = 0.f;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        d1 = fmaf(s1u[m * RU + r], st1[m * LDN + n], d1);
        d2 = fmaf(s2u[m * RU + r], st2[m * LDN + n], d2);
      }
      sd1[idx] += d1;
      sd2[idx] += d2;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * TN; idx += NT) {
    const int r = idx / TN, n = idx - r * TN;
    const int i = i0 + n;
    if (i < I) {
      const long long at = ((long long)blockIdx.y * R + r) * I + i;
      pd1[at] = sd1[idx];
      pd2[at] = sd2[idx];
    }
  }
}

// g1u/g2u (O*R each) = sums of pu1/pu2 over the nu column strips;
// g1d/g2d (R*I each) = sums of pd1/pd2 over the nd row strips.
__global__ void hada_bwd_reduce_kernel(const float* __restrict__ pu1,
                                       const float* __restrict__ pu2,
                                       const float* __restrict__ pd1,
                                       const float* __restrict__ pd2, float* __restrict__ g1u,
                                       float* __restrict__ g2u, float* __restrict__ g1d,
                                       float* __restrict__ g2d, long long n_u, long long n_d,
                                       int nu, int nd) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n_u) {
    float a = 0.f, b = 0.f;
    for (int p = 0; p < nu; ++p) {
      a += pu1[p * n_u + idx];
      b += pu2[p * n_u + idx];
    }
    g1u[idx] = a;
    g2u[idx] = b;
  } else if (idx < n_u + n_d) {
    const long long j = idx - n_u;
    float a = 0.f, b = 0.f;
    for (int p = 0; p < nd; ++p) {
      a += pd1[p * n_d + j];
      b += pd2[p * n_d + j];
    }
    g1d[j] = a;
    g2d[j] = b;
  }
}

template <typename T>
int launch(const void* g, const void* w1d, const void* w1u, const void* w2d, const void* w2u,
           float* pu1, float* pu2, float* pd1, float* pd2, int O, int I, int R, int rpb,
           float scale, cudaStream_t st) {
  const size_t smem = smem_floats(R) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hada_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((I + TN - 1) / TN, (O + rpb - 1) / rpb);
  hada_bwd_kernel<T><<<grid, dim3(BX, BY), smem, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(w1d), static_cast<const T*>(w1u),
      static_cast<const T*>(w2d), static_cast<const T*>(w2u), pu1, pu2, pd1, pd2, O, I, R,
      rpb, scale);
  return 0;
}

}  // namespace

// g: (O, I); w1d, w2d: (R, I); w1u, w2u: (O, R); all contiguous, one dtype
// (0 = float32, 1 = bfloat16). rpb: rows per block, a multiple of 16.
// Scratch: pu1, pu2 (ceil(I/128), O, R) and pd1, pd2 (ceil(O/rpb), R, I)
// fp32. Out: g1d, g2d (R, I) and g1u, g2u (O, R) fp32.
extern "C" int lyc_hada_bwd(const void* g, const void* w1d, const void* w1u, const void* w2d,
                            const void* w2u, float* pu1, float* pu2, float* pd1, float* pd2,
                            float* g1d, float* g1u, float* g2d, float* g2u, int O, int I,
                            int R, int rpb, float scale, int dtype, void* stream) {
  if (O < 1 || I < 1 || R < 1 || rpb < TM || rpb % TM != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = launch<float>(g, w1d, w1u, w2d, w2u, pu1, pu2, pd1, pd2, O, I, R, rpb, scale, st);
  } else if (dtype == 1) {
    rc = launch<__nv_bfloat16>(g, w1d, w1u, w2d, w2u, pu1, pu2, pd1, pd2, O, I, R, rpb, scale,
                               st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  const long long n_u = (long long)O * R, n_d = (long long)R * I;
  const int nu = (I + TN - 1) / TN, nd = (O + rpb - 1) / rpb;
  const long long total = n_u + n_d;
  hada_bwd_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      pu1, pu2, pd1, pd2, g1u, g2u, g1d, g2d, n_u, n_d, nu, nd);
  return static_cast<int>(cudaGetLastError());
}
