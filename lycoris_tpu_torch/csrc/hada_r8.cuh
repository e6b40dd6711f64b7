// The rank-8 LoHa backward pass shared by the fused form (hada_bwd.cu: one
// pass forms all four gradients) and the split form (hada_bwd_split.cu: a
// u-pass forms g1u/g2u, a d-pass g1d/g2d), with the adder of their partial
// sums. Of dW = (w1u @ w1d) * (w2u @ w2d) * gamma:
//   t1 = g * gamma * (w2u @ w2d),  t2 = g * gamma * (w1u @ w1d)
//   g1u = t1 @ w1d^T,  g2u = t2 @ w2d^T      (O, R): the u-grads
//   g1d = w1u^T @ t1,  g2d = w2u^T @ t2      (R, I): the d-grads
//
// One pass, R = 8 (I a multiple of 4, 16-byte aligned tensors): a block of
// 8 warps owns a strip of 128 columns (32 lanes x 4) and a run of rows; a
// thread owns 4 consecutive columns and walks every 8th row of the run,
// reading g with 16-byte loads (8 bytes in bf16), ``kAhead`` rows ahead,
// into a ring of registers whose indices are fixed at compile time (a
// register copy of a value still in flight would wait for its load). It
// keeps its columns of w1d and w2d (2R x 4) in registers across all its
// rows, and in a pass that forms the d-grads its d-grad sums (2R x 4) too.
// The block's rows of w1u/w2u are staged in shared memory first (16-byte
// loads), so a row's 2R u-values are four 16-byte broadcast loads; the row
// loop never syncs the block. In a pass that forms the u-grads, a row's 2R
// u-grad partials (one per lane, over its 4 columns) are summed over the
// warp's 128 columns by a reduce-scatter butterfly, 8 + 4 + 2 + 1 + 1
// shuffles for the 16 values in a fixed order, and written as the row's
// partial for the column strip: pu[strip][O][2R]. In a pass that forms the
// d-grads, the 8 warps' sums are added in warp order through shared memory
// into one partial per block: pd[run][2R][I]. A second kernel adds the
// partials in index order, 16 bytes a thread. No float atomics anywhere, so
// the gradients repeat bit for bit.

#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// 4 consecutive elements: one 16-byte load in fp32 (8 bytes in bf16);
// ``stream``: g is read once, so it is loaded evict-first
template <bool kStream>
__device__ __forceinline__ float4 load4(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return kStream ? __ldcs(q) : __ldg(q);
}
template <bool kStream>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
  const uint2 raw = kStream ? __ldcs(q) : __ldg(q);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

constexpr int FR = 8;           // the rank of the pass
constexpr int FU = 2 * FR;      // u-values (and u-grads) of one row: factor 1's R, factor 2's
constexpr int FW = 8;           // warps of a block, each over every 8th row
constexpr int FCOLS = 32 * 4;   // columns of a block: 32 lanes x 4
constexpr int FU4 = FU / 4;     // 16-byte vectors of a row's u-values
constexpr int MAX_RPB = 1024;   // rows of a block (their u-values in shared memory)
// shared memory: the block's u-values during the row loop, then the warps'
// d-grad sums (the two share it)
constexpr size_t FAST_SMEM = (size_t)FW * FU * FCOLS * sizeof(float);
static_assert((size_t)MAX_RPB * FU * sizeof(float) <= FAST_SMEM, "u-values exceed smem");

// the block's rows [ob, ob + n) of w1u and w2u into su4 as fp32, row m at
// su4[m * 4 .. m * 4 + 3] (w1u's R, then w2u's): 16-byte loads, four in
// flight a thread
__device__ __forceinline__ void stage_u(const float* w1u, const float* w2u, int ob, int n,
                                        float4* su4, int tid) {
  const float4* a = reinterpret_cast<const float4*>(w1u + (long long)ob * FR);
  const float4* b = reinterpret_cast<const float4*>(w2u + (long long)ob * FR);
#pragma unroll 4
  for (int idx = tid; idx < n * FU4; idx += 32 * FW) {
    const int m = idx >> 2, q = idx & 3;
    su4[idx] = __ldg((q < 2 ? a : b) + 2 * m + (q & 1));
  }
}
__device__ __forceinline__ void stage_u(const __nv_bfloat16* w1u, const __nv_bfloat16* w2u,
                                        int ob, int n, float4* su4, int tid) {
  const uint4* a = reinterpret_cast<const uint4*>(w1u + (long long)ob * FR);
  const uint4* b = reinterpret_cast<const uint4*>(w2u + (long long)ob * FR);
#pragma unroll 4
  for (int idx = tid; idx < n * 2; idx += 32 * FW) {
    const int m = idx >> 1, q = idx & 1;
    const uint4 v = __ldg((q ? b : a) + m);
    const unsigned x[4] = {v.x, v.y, v.z, v.w};
    float f[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[j]));
      f[2 * j] = h.x;
      f[2 * j + 1] = h.y;
    }
    su4[m * FU4 + 2 * q] = make_float4(f[0], f[1], f[2], f[3]);
    su4[m * FU4 + 2 * q + 1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// Programmatic dependent launch: a grid launched with the attribute may
// start once every block of the grid before it has called ``pdl_trigger``
// (or exited), and ``pdl_wait`` returns once that grid has completed and
// its writes are visible. Both are no-ops in a grid launched without it.
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// one level of the butterfly: lanes whose bit ``kOff`` is set keep the upper
// half of v[0..2H), the others the lower, each adding the partner's copy of
// the half it keeps. The halves are picked with bit masks, so each pair
// costs one shuffle.
template <int kH, int kOff>
__device__ __forceinline__ void fold(float (&v)[FU], int lane) {
  const unsigned hi = (lane & kOff) ? 0xffffffffu : 0u;
#pragma unroll
  for (int j = 0; j < kH; ++j) {
    const unsigned a = __float_as_uint(v[j]), b = __float_as_uint(v[j + kH]);
    const float send = __uint_as_float((a & hi) | (b & ~hi));
    const float keep = __uint_as_float((b & hi) | (a & ~hi));
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// sums of v[0..15] over the warp's 32 lanes, scattered: lane l ends with
// the sum for index l >> 1 (lanes l and l ^ 1 hold the same bits)
__device__ __forceinline__ float reduce_scatter16(float (&v)[FU], int lane) {
  fold<8, 16>(v, lane);
  fold<4, 8>(v, lane);
  fold<2, 4>(v, lane);
  fold<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// One pass over g: the u-grad partials when kU (pu: [gridDim.x][O][FU],
// each row's u-grads over one column strip), the d-grad partials when kD
// (pd: [gridDim.y][FU][I], each column's d-grads over one run of rows).
// kAhead: rows of g in flight a warp; kMinBlocks: blocks an SM must hold
// (the register budget).
template <typename T, bool kU, bool kD, int kAhead, int kMinBlocks>
__global__ void __launch_bounds__(32 * FW, kMinBlocks)
    hada_bwd_r8_kernel(const T* __restrict__ g, const T* __restrict__ w1d,
                       const T* __restrict__ w1u, const T* __restrict__ w2d,
                       const T* __restrict__ w2u, float* __restrict__ pu,
                       float* __restrict__ pd, int O, int I, int rpb, float scale) {
  static_assert(kU || kD, "a pass forms the u-grads, the d-grads or both");
  constexpr int NB = kAhead + 1;  // buffers of the ring
  extern __shared__ float4 sm4[];  // [rpb][FU4] u-values, then [FW][FU][FCOLS / 4] d-sums
  // the warp index broadcast from lane 0, so the compiler knows it is the
  // same across the warp: the row loop's trip count is then warp-uniform and
  // its shuffles compile as plain shuffles, not as collective emulation
  pdl_trigger();  // the next pass reads none of this one's output
  const int tid = threadIdx.x, lane = tid & 31;
  const int w = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int bx = blockIdx.x, by = blockIdx.y;
  const int ob = by * rpb;
  const int nrows = min(O - ob, rpb);
  const int col = bx * FCOLS + 4 * lane;
  const bool on = col < I;  // the ragged strip's idle lanes add zeros
  stage_u(w1u, w2u, ob, nrows, sm4, tid);
  float d1[FR][4], d2[FR][4], s1[FR][4], s2[FR][4];
#pragma unroll
  for (int r = 0; r < FR; ++r) {
    const float4 a = on ? load4<false>(w1d + (long long)r * I + col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b = on ? load4<false>(w2d + (long long)r * I + col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    d1[r][0] = a.x; d1[r][1] = a.y; d1[r][2] = a.z; d1[r][3] = a.w;
    d2[r][0] = b.x; d2[r][1] = b.y; d2[r][2] = b.z; d2[r][3] = b.w;
#pragma unroll
    for (int c = 0; c < 4; ++c) s1[r][c] = s2[r][c] = 0.f;
  }
  // g kAhead rows ahead (from HBM). The loop body (NB rows) has no branch,
  // so one row's butterfly can overlap the next row's products: a row past
  // the run reads g as zero and the last row's u-values, adds nothing and
  // stores nothing.
  const long long gstep = (long long)FW * I;
  const T* gnext = g + (long long)(ob + w + kAhead * FW) * I + col;  // kAhead steps on
  float* pu_row = pu + ((size_t)bx * O + ob + w) * FU + (lane >> 1);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto step = [&](int m, const float4& gc, float4& gn) {
    gn = (on && m + kAhead * FW < nrows) ? load4<true>(gnext) : zero;
    gnext += gstep;
    const float4* u_row = sm4 + min(m, nrows - 1) * FU4;
    float u[FU];
#pragma unroll
    for (int q = 0; q < FU4; ++q) {
      const float4 v = u_row[q];
      u[4 * q] = v.x; u[4 * q + 1] = v.y; u[4 * q + 2] = v.z; u[4 * q + 3] = v.w;
    }
    float p1[4], p2[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      p1[c] = u[0] * d1[0][c];
      p2[c] = u[FR] * d2[0][c];
    }
#pragma unroll
    for (int r = 1; r < FR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p1[c] = fmaf(u[r], d1[r][c], p1[c]);
        p2[c] = fmaf(u[FR + r], d2[r][c], p2[c]);
      }
    const float gs[4] = {gc.x * scale, gc.y * scale, gc.z * scale, gc.w * scale};
    float t1[4], t2[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      t1[c] = gs[c] * p2[c];
      t2[c] = gs[c] * p1[c];
    }
    float v[FU];
#pragma unroll
    for (int r = 0; r < FR; ++r) {
      if constexpr (kU) {
        float a = t1[0] * d1[r][0], b = t2[0] * d2[r][0];
#pragma unroll
        for (int c = 1; c < 4; ++c) {
          a = fmaf(t1[c], d1[r][c], a);
          b = fmaf(t2[c], d2[r][c], b);
        }
        v[r] = a;
        v[FR + r] = b;
      }
      if constexpr (kD) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s1[r][c] = fmaf(u[r], t1[c], s1[r][c]);
          s2[r][c] = fmaf(u[FR + r], t2[c], s2[r][c]);
        }
      }
    }
    if constexpr (kU) {
      const float ug = reduce_scatter16(v, lane);
      if (!(lane & 1) && m < nrows) *pu_row = ug;
      pu_row += FW * FU;
    }
  };
  float4 ring[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) ring[k] = zero;
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    if (on && w + k * FW < nrows) ring[k] = load4<true>(gnext - (kAhead - k) * gstep);
  __syncthreads();  // the u-values are staged
  for (int m = w; m < nrows; m += NB * FW) {
#pragma unroll
    for (int k = 0; k < NB; ++k) step(m + k * FW, ring[k], ring[(k + kAhead) % NB]);
  }
  if constexpr (kD) {
    // the warps' d-grad sums, added in warp order: one partial per block
    __syncthreads();  // every warp is done with the u-values
    float4* red = sm4 + (size_t)w * FU * (FCOLS / 4);
#pragma unroll
    for (int r = 0; r < FR; ++r) {
      red[r * (FCOLS / 4) + lane] = make_float4(s1[r][0], s1[r][1], s1[r][2], s1[r][3]);
      red[(FR + r) * (FCOLS / 4) + lane] = make_float4(s2[r][0], s2[r][1], s2[r][2], s2[r][3]);
    }
    __syncthreads();
    const float* sred = reinterpret_cast<const float*>(sm4);
#pragma unroll
    for (int j = 0; j < FU * FCOLS / (32 * FW); ++j) {
      const int idx = tid + j * 32 * FW;
      const int k = idx / FCOLS, n = idx - k * FCOLS;
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < FW; ++ww) s += sred[(ww * FU + k) * FCOLS + n];
      if (bx * FCOLS + n < I) pd[((size_t)by * FU + k) * I + bx * FCOLS + n] = s;
    }
  }
  // a pass that started early completes only after the pass before it, so
  // the adder, which waits for this grid, sees both passes' partials
  pdl_wait();
}

// the gradients from the partials, each summed in index order, 4 values
// (16 bytes) a thread: g1u/g2u (O, R) over the gx column strips, g1d/g2d
// (R, I) over the gy row runs; out = g1d, g2d, g1u, g2u one after another
__global__ void hada_bwd_r8_reduce_kernel(const float* __restrict__ pu,
                                          const float* __restrict__ pd, float* __restrict__ out,
                                          int O, int I, int gx, int gy) {
  pdl_wait();  // the passes' partials are written
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nu = (long long)O * (FU / 4), nd = (long long)FU * (I / 4);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float* dst;
  if (t < nu) {
    const float4* src = reinterpret_cast<const float4*>(pu) + t;
#pragma unroll 4
    for (int x = 0; x < gx; ++x) {
      const float4 v = __ldcg(src + (long long)x * nu);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const long long o = t / (FU / 4), q = t - o * (FU / 4);
    dst = out + (size_t)2 * FR * I + (q < 2 ? 0 : (size_t)O * FR) + o * FR + 4 * (q & 1);
  } else if (t < nu + nd) {
    const long long j = t - nu;
    const float4* src = reinterpret_cast<const float4*>(pd) + j;
#pragma unroll 4
    for (int y = 0; y < gy; ++y) {
      const float4 v = __ldcg(src + (long long)y * nd);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    dst = out + 4 * j;  // [FU][I]: g1d's R rows, then g2d's
  } else {
    return;
  }
  *reinterpret_cast<float4*>(dst) = s;
}

// one pass over g (grid: ceil(I / 128) column strips x ceil(O / rpb) runs
// of rows) on ``st``; a pass without the d-grads takes shared memory for
// its u-values only
// ``kernel`` on ``st``, with programmatic dependent launch if ``pdl``
template <typename... Exp, typename... Act>
cudaError_t launch_pdl(bool pdl, void (*kernel)(Exp...), dim3 grid, int threads, size_t smem,
                       cudaStream_t st, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, bool kU, bool kD, int kAhead, int kMinBlocks>
cudaError_t launch_r8_pass(const T* g, const T* w1d, const T* w1u, const T* w2d, const T* w2u,
                           float* pu, float* pd, int O, int I, int rpb, float scale,
                           cudaStream_t st, bool pdl = false) {
  auto kernel = hada_bwd_r8_kernel<T, kU, kD, kAhead, kMinBlocks>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FAST_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const size_t smem = kD ? FAST_SMEM : (size_t)rpb * FU * sizeof(float);
  const dim3 grid((I + FCOLS - 1) / FCOLS, (O + rpb - 1) / rpb);
  const cudaError_t e =
      launch_pdl(pdl, kernel, grid, 32 * FW, smem, st, g, w1d, w1u, w2d, w2u, pu, pd, O, I, rpb,
                 scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// out (g1d, g2d, g1u, g2u) from pu ([gx][O][FU]) and pd ([gy][FU][I]) on ``st``
inline cudaError_t launch_r8_reduce(const float* pu, const float* pd, float* out, int O, int I,
                                    int gy, cudaStream_t st, bool pdl = false) {
  const int gx = (I + FCOLS - 1) / FCOLS;
  const long long total = (long long)O * (FU / 4) + (long long)FU * (I / 4);
  const cudaError_t e =
      launch_pdl(pdl, hada_bwd_r8_reduce_kernel, dim3((unsigned)((total + 255) / 256)), 256, 0,
                 st, pu, pd, out, O, I, gx, gy);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace
