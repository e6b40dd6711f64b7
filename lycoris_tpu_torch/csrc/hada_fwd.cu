// LoHa delta weight: dW = (w1u @ w1d) * (w2u @ w2d) * gamma, elementwise
// product of two rank-R products, written once.
//
// Replaces: lycoris_tpu/ops/hada.py `_hada_fwd_pallas` -> `_hada_fwd_kernel`
// (Pallas, TPU), which forms both products tile-local at fp32 HIGHEST
// precision and never writes either to device memory.
//
// Bound on the H100: the single O x I write. With R = 8 each output costs
// 2R multiply-adds against 4 bytes written (fp32): 8 flops a byte, below
// the card's FFMA-to-HBM balance of 20, and there is nothing for the
// tensor cores to do at depth 8.
//
// Two variants, chosen by the caller (ops/hada.py `fast`):
//
// Fast (R = 8, the path's rank; I a multiple of 4 and 16-byte aligned
// tensors): a thread owns 4 consecutive columns and keeps their 2R x 4
// values of w1d and w2d in registers (64 fp32) for every row it walks, so
// the loop has no rank chunk and no sync. A block (32 lanes x 8 warps)
// first copies its run of rows of w1u and w2u into shared memory with
// 16-byte loads; then each warp walks every 8th row of the run: the row's
// 2R u-values are four 16-byte broadcast loads from shared memory, the 64
// multiply-adds run from registers, and the 4 outputs leave as one 16-byte
// store (8 bytes in bf16). The grid is sized to the card (two blocks an SM,
// each over a run of rows), not one block per output tile, so w1d and w2d
// are read from L2 once per block.
//
// Generic (any other rank or layout): one 256-thread block per 32 x 64
// output tile. The block stages the tile's rows of w1u/w2u and columns of
// w1d/w2d in shared memory in chunks of 16 along R, keeps both partial
// products in fp32 registers (8 outputs per thread), multiplies them,
// scales by gamma and stores each output once.

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

// 4 consecutive elements in fp32: one 16-byte access (8 bytes in bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// ---------------------------------------------------------------------------
// fast variant, R = 8
// ---------------------------------------------------------------------------

constexpr int FR = 8;             // the fast variant's rank
constexpr int FBX = 32, FBY = 8;  // lanes over 4-column groups, warps over rows
constexpr int FU = 2 * FR;        // u-values of one row: w1u's R, then w2u's
constexpr int FU4 = FU / 4;       // 16-byte vectors of them
constexpr int MAX_RPB = 512;      // rows of a block: 32 KB of u-values in shared memory

// the block's rows [ob, ob + n) of w1u and w2u into su4 as fp32, row m at
// su4[m * 4 .. m * 4 + 3] (w1u's R, then w2u's): 16-byte loads, four in
// flight a thread
__device__ __forceinline__ void stage_u(const float* w1u, const float* w2u, int ob, int n,
                                        float4* su4, int tid) {
  const float4* a = reinterpret_cast<const float4*>(w1u + (long long)ob * FR);
  const float4* b = reinterpret_cast<const float4*>(w2u + (long long)ob * FR);
#pragma unroll 4
  for (int idx = tid; idx < n * FU4; idx += FBX * FBY) {
    const int m = idx >> 2, q = idx & 3;
    su4[idx] = __ldg((q < 2 ? a : b) + 2 * m + (q & 1));
  }
}
__device__ __forceinline__ void stage_u(const __nv_bfloat16* w1u, const __nv_bfloat16* w2u,
                                        int ob, int n, float4* su4, int tid) {
  const uint4* a = reinterpret_cast<const uint4*>(w1u + (long long)ob * FR);
  const uint4* b = reinterpret_cast<const uint4*>(w2u + (long long)ob * FR);
#pragma unroll 4
  for (int idx = tid; idx < n * 2; idx += FBX * FBY) {
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

template <typename T>
__global__ void __launch_bounds__(FBX * FBY, 2)
    hada_fwd_r8_kernel(const T* __restrict__ w1d, const T* __restrict__ w1u,
                       const T* __restrict__ w2d, const T* __restrict__ w2u,
                       T* __restrict__ out, int O, int I, int rpb, float scale) {
  __shared__ float4 su4[MAX_RPB * FU4];  // the block's rows of w1u | w2u
  const int ob = blockIdx.y * rpb;
  const int nrows = min(O - ob, rpb);
  stage_u(w1u, w2u, ob, nrows, su4, threadIdx.y * FBX + threadIdx.x);
  const int col = 4 * (blockIdx.x * FBX + threadIdx.x);
  const bool on = col < I;
  float d1[FR][4], d2[FR][4];
#pragma unroll
  for (int r = 0; r < FR; ++r) {
    const float4 a = on ? load4(w1d + (long long)r * I + col) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b = on ? load4(w2d + (long long)r * I + col) : make_float4(0.f, 0.f, 0.f, 0.f);
    d1[r][0] = a.x; d1[r][1] = a.y; d1[r][2] = a.z; d1[r][3] = a.w;
    d2[r][0] = b.x; d2[r][1] = b.y; d2[r][2] = b.z; d2[r][3] = b.w;
  }
  __syncthreads();
  if (!on) return;
  const long long ostep = (long long)FBY * I;
  T* op = out + (long long)(ob + threadIdx.y) * I + col;
  for (int m = threadIdx.y; m < nrows; m += FBY, op += ostep) {
    float u[FU];
#pragma unroll
    for (int q = 0; q < FU4; ++q) {
      const float4 v = su4[m * FU4 + q];
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
    store4(op, make_float4(p1[0] * p2[0] * scale, p1[1] * p2[1] * scale,
                           p1[2] * p2[2] * scale, p1[3] * p2[3] * scale));
  }
}

// ---------------------------------------------------------------------------
// generic variant, any R
// ---------------------------------------------------------------------------

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

template <typename T>
int launch(const void* w1d, const void* w1u, const void* w2d, const void* w2u, void* out, int O,
           int I, int R, int rpb, float scale, int fast, cudaStream_t st) {
  const T* a = static_cast<const T*>(w1d);
  const T* b = static_cast<const T*>(w1u);
  const T* c = static_cast<const T*>(w2d);
  const T* d = static_cast<const T*>(w2u);
  T* y = static_cast<T*>(out);
  if (fast) {
    const dim3 grid((I / 4 + FBX - 1) / FBX, (O + rpb - 1) / rpb);
    hada_fwd_r8_kernel<T><<<grid, dim3(FBX, FBY), 0, st>>>(a, b, c, d, y, O, I, rpb, scale);
  } else {
    const dim3 grid((I + TN - 1) / TN, (O + TM - 1) / TM);
    hada_fwd_kernel<T><<<grid, dim3(BX, BY), 0, st>>>(a, b, c, d, y, O, I, R, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w1d, w2d: (R, I); w1u, w2u: (O, R); out: (O, I); all contiguous, one dtype
// (0 = float32, 1 = bfloat16). fast: 1 for the R = 8 variant (I % 4 == 0,
// every pointer 16-byte aligned), which runs blocks of ``rpb`` <= 512 rows
// each; 0 for the generic one (rpb unused).
extern "C" int lyc_hada_fwd(const void* w1d, const void* w1u, const void* w2d,
                            const void* w2u, void* out, int O, int I, int R, int rpb,
                            float scale, int dtype, int fast, void* stream) {
  if (O < 1 || I < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (fast && (R != FR || I % 4 != 0 || rpb < 1 || rpb > MAX_RPB))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(w1d, w1u, w2d, w2u, out, O, I, R, rpb, scale, fast, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(w1d, w1u, w2d, w2u, out, O, I, R, rpb, scale, fast, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
