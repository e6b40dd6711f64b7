// Flash attention forward, non-causal: O = softmax(Q K^T * s) V per
// (batch, head), plus the fp32 logsumexp lse = m + log(l) per query row.
//
// Replaces: lycoris_tpu/ops/flash.py `_fwd` -> `_fwd_kernel` and its
// D-major twin `_fwd_dt` -> `_fwd_dt_kernel` (Pallas, TPU). The TPU kernel
// keeps a whole row of logits (bq x T fp32, 4 MB at bq 256, T 4096) in
// VMEM so it can take the true row max in one exp pass. A Hopper SM has
// 227 KB of shared memory, so this is a re-design: K/V stream through
// shared memory in blocks of 64 keys and the softmax is online (running
// max m and sum l in fp32, the fp32 accumulator rescaled per block).
// The D-major layout was a TPU device; here one kernel takes arbitrary
// batch/head/token strides (head dim contiguous), so the head-split
// projections feed it without a copy and O is written straight into the
// (B, T, H, D) layout the output projection reads.
//
// Bound on the H100: at the SD1.5 shapes (T 4096 / D 40, T 1024 / D 80)
// the two matmuls are 4*T*T*D FLOPs per head against 8*T*D bytes, so the
// kernel is compute-bound; the tensor cores (mma.sync m16n8k16 bf16, fp32
// accumulate) carry both matmuls. D = 40 is not a multiple of the MMA
// depth 16, so the head dim is zero-padded to DP = 48 in shared memory
// (D = 80 already is); the scale stays 1/sqrt(D) with the true D, which
// the caller passes in.
//
// Layout: 4 warps per CTA, each owning 16 query rows (BQ = 64); Q stays
// in registers as MMA A-fragments for the whole key loop; S and P never
// leave registers (the S accumulator fragment is re-packed as the A
// fragment of P.V). A simple first version: no cp.async/TMA pipelining
// and no wgmma, which are later work.
//
// fp32 inputs take a plain FMA kernel with the same online softmax (one
// query row per 4 threads, each owning a quarter of the head dim), so
// float32 results are not rounded through bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

constexpr float kLn2 = 0.69314718055994530942f;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive head-dim elements of one row as an A-fragment register;
// zero outside [0, T) x [0, D).
__device__ __forceinline__ uint32_t load_pair(const bf16* base, long long st, int row,
                                              int col, int T, int D) {
  const bf16 z = __ushort_as_bfloat16(0);
  if (row >= T) return 0u;
  const bf16* p = base + row * st;
  const bf16 lo = col < D ? p[col] : z;
  const bf16 hi = col + 1 < D ? p[col + 1] : z;
  return pack_raw(lo, hi);
}

template <int DP>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int H, int T, int D, Strides st,
                          float scale_log2) {
  constexpr int BQ = 64, BK = 64, LD = DP + 8;
  constexpr int KC = DP / 16;  // MMA depth steps of Q.K^T
  constexpr int NS = BK / 8;   // 8-wide key tiles of S
  constexpr int NO = DP / 8;   // 8-wide head-dim tiles of O
  __shared__ __align__(16) bf16 sK[BK * LD];
  __shared__ __align__(16) bf16 sV[BK * LD];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;
  bf16* op = o + b * st.ob + h * st.oh;
  const int r0 = blockIdx.y * BQ + warp * 16 + g;
  const int r1 = r0 + 8;

  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c0 = kc * 16 + 2 * t4, c1 = c0 + 8;
    qa[kc][0] = load_pair(qp, st.qt, r0, c0, T, D);
    qa[kc][1] = load_pair(qp, st.qt, r1, c0, T, D);
    qa[kc][2] = load_pair(qp, st.qt, r0, c1, T, D);
    qa[kc][3] = load_pair(qp, st.qt, r1, c1, T, D);
  }

  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const bf16 zero = __ushort_as_bfloat16(0);
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * DP; idx += 128) {
      const int r = idx / DP, c = idx - r * DP;
      const int key = k0 + r;
      const bool ok = key < T && c < D;
      sK[r * LD + c] = ok ? kp[key * st.kt + c] : zero;
      sV[r * LD + c] = ok ? vp[key * st.vt + c] : zero;
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const bf16* kr = sK + (n * 8 + g) * LD + kc * 16 + 2 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16(s[n], qa[kc], b0, b1);
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + n * 8 + 2 * t4 + e < T;
        s[n][e] = ok ? s[n][e] * scale_log2 : -CUDART_INF_F;
        s[n][2 + e] = ok ? s[n][2 + e] * scale_log2 : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key k0 is always valid, so mx0/mx1 are finite and exp2(-inf) = 0
    // zeroes the empty state of the first block
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p00 = exp2f(s[n][0] - m0), p01 = exp2f(s[n][1] - m0);
      const float p10 = exp2f(s[n][2] - m1), p11 = exp2f(s[n][3] - m1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      const int half = (n & 1) * 2;
      pa[n >> 1][half] = pack_f32(p00, p01);
      pa[n >> 1][half + 1] = pack_f32(p10, p11);
    }

#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const bf16* vr = sV + (kc * 16 + 2 * t4) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* vc = vr + n * 8;
        const uint32_t b0 = pack_raw(vc[0], vc[LD]);
        const uint32_t b1 = pack_raw(vc[8 * LD], vc[9 * LD]);
        mma_bf16(acc[n], pa[kc], b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n * 8 + 2 * t4 + e;
      if (col < D) {
        if (r0 < T) op[r0 * st.ot + col] = __float2bfloat16(acc[n][e] * inv0);
        if (r1 < T) op[r1 * st.ot + col] = __float2bfloat16(acc[n][2 + e] * inv1);
      }
    }
  }
  if (t4 == 0) {
    if (r0 < T) lse[(long long)bh * T + r0] = m0 * kLn2 + logf(l0);
    if (r1 < T) lse[(long long)bh * T + r1] = m1 * kLn2 + logf(l1);
  }
}

template <int NPT>
__global__ void __launch_bounds__(128)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int H, int T, int D, Strides st,
                         float scale_log2) {
  constexpr int BQ = 32, BK = 32, DM = 4 * NPT;
  __shared__ float sK[BK][DM];
  __shared__ float sV[BK][DM];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, part = tid & 3;
  const int row = blockIdx.y * BQ + (tid >> 2);
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  float* op = o + b * st.ob + h * st.oh;

  float qr[NPT], acc[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int d = part + 4 * i;
    qr[i] = (row < T && d < D) ? qp[row * st.qt + d] : 0.f;
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * DM; idx += 128) {
      const int r = idx / DM, c = idx - r * DM;
      const int key = k0 + r;
      const bool ok = key < T && c < D;
      sK[r][c] = ok ? kp[key * st.kt + c] : 0.f;
      sV[r][c] = ok ? vp[key * st.vt + c] : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) p = fmaf(qr[i], sK[j][part + 4 * i], p);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      s[j] = k0 + j < T ? p * scale_log2 : -CUDART_INF_F;
      mx = fmaxf(mx, s[j]);
    }
    const float c = exp2f(m - mx);
    m = mx;
    l *= c;
#pragma unroll
    for (int i = 0; i < NPT; ++i) acc[i] *= c;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = exp2f(s[j] - m);
      l += p;
#pragma unroll
      for (int i = 0; i < NPT; ++i) acc[i] = fmaf(p, sV[j][part + 4 * i], acc[i]);
    }
  }

  if (row < T) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int d = part + 4 * i;
      if (d < D) op[row * st.ot + d] = acc[i] * inv;
    }
    if (part == 0) lse[(long long)bh * T + row] = m * kLn2 + logf(l);
  }
}

template <int DP>
void launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                 int BH, int H, int T, int D, const Strides& st, float sl2,
                 cudaStream_t stream) {
  const dim3 grid(BH, (T + 63) / 64);
  flash_fwd_bf16_kernel<DP><<<grid, 128, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, T, D, st, sl2);
}

template <int NPT>
void launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                int BH, int H, int T, int D, const Strides& st, float sl2,
                cudaStream_t stream) {
  const dim3 grid(BH, (T + 31) / 32);
  flash_fwd_f32_kernel<NPT><<<grid, 128, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, T, D, st, sl2);
}

}  // namespace

// q, k, v, o: (B, H, T, D) addressed through the 12 element strides
// (q: b, h, t; k: b, h, t; v: b, h, t; o: b, h, t), head dim contiguous.
// lse: (B*H, T) float32, contiguous. dtype: 0 = float32, 1 = bfloat16.
// 1 <= D <= 128.
extern "C" int lyc_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             float* lse, int B, int H, int T, int D,
                             const long long* strides, float sm_scale, int dtype,
                             void* stream) {
  if (D < 1 || D > 128 || T < 1 || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  st.qb = strides[0]; st.qh = strides[1]; st.qt = strides[2];
  st.kb = strides[3]; st.kh = strides[4]; st.kt = strides[5];
  st.vb = strides[6]; st.vh = strides[7]; st.vt = strides[8];
  st.ob = strides[9]; st.oh = strides[10]; st.ot = strides[11];
  const float sl2 = sm_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (dtype == 1) {
    switch ((D + 15) / 16) {
      case 1: launch_bf16<16>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
      case 2: launch_bf16<32>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
      case 3: launch_bf16<48>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
      case 4: launch_bf16<64>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
      case 5: launch_bf16<80>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
      case 6: launch_bf16<96>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
      case 7: launch_bf16<112>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
      default: launch_bf16<128>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
    }
  } else if (dtype == 0) {
    switch ((D + 31) / 32) {
      case 1: launch_f32<8>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
      case 2: launch_f32<16>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
      case 3: launch_f32<24>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
      default: launch_f32<32>(q, k, v, o, lse, BH, H, T, D, st, sl2, s); break;
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
