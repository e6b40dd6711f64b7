// Flash attention backward, non-causal: dQ, dK, dV from Q, K, V, dO, the
// forward's fp32 logsumexp lse and di = rowsum(dO * O) (computed outside,
// as in the JAX package):
//   P  = exp(S * s - lse),  S = Q K^T
//   dV = P^T dO             (P rounded to the input dtype)
//   dS = P * (dO V^T - di) * s
//   dK = dS^T Q,  dQ = dS K (dS rounded to the input dtype, fp32 sums)
//
// Replaces: lycoris_tpu/ops/flash.py `_bwd_call` -> `_bwd_kernel` and its
// D-major twin `_bwd_dt_call` -> `_bwd_dt_kernel` (Pallas, TPU). The TPU
// kernel walks the k-blocks as a sequential grid and carries dQ for the
// whole sequence in VMEM, adding each k-block's share. Hopper's blocks run
// in parallel and in no order, so this is two kernels: one over k-blocks
// that keeps dK/dV in registers and walks all q-blocks, and one over
// q-blocks that keeps dQ in registers and walks all k-blocks. S and P are
// recomputed in the second (two more of the seven matmuls), in exchange
// for no atomics and a deterministic result. The D-major layout is served
// by the same kernels: q, k, v and dO are read, and dq, dk, dv written,
// through their batch/head/token strides (head dim contiguous), so the
// head-split projections need no copies either way.
//
// Bound on the H100: compute. At the SD1.5 shapes the kernels do
// 4 (dK/dV) + 3 (dQ) matmuls of 2*T*T*D FLOPs per head against ~16*T*D
// bytes of traffic. The tensor cores (mma.sync m16n8k16 bf16, fp32
// accumulate) carry every matmul; D = 40 is zero-padded to DP = 48 in
// shared memory and registers, as in the forward.
//
// Layout (bf16): 4 warps per CTA, each owning 16 rows (keys in the dK/dV
// kernel, queries in the dQ kernel) whose K,V (resp. Q,dO) A-fragments
// stay in registers; the other side streams through shared memory in
// blocks of 64 rows and is consumed in chunks of 16, so each chunk's S and
// dP tiles (16 x 16) turn straight into the A fragments of the next MMA.
// No cp.async/TMA and no wgmma yet: a simple first version.
//
// fp32 inputs take plain FMA kernels of the same structure (one row per 4
// threads, each owning a quarter of the head dim), so float32 results are
// not rounded through bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;  // ob..ot: dO
  long long dqb, dqh, dqt, dkb, dkh, dkt, dvb, dvh, dvt;
};

constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ uint32_t load_pair(const bf16* base, long long st, int row,
                                              int col, int T, int D) {
  const bf16 z = __ushort_as_bfloat16(0);
  if (row >= T) return 0u;
  const bf16* p = base + row * st;
  const bf16 lo = col < D ? p[col] : z;
  const bf16 hi = col + 1 < D ? p[col + 1] : z;
  return pack_raw(lo, hi);
}

// A fragments (16 rows x DP) of one warp's rows r0 = row0 + g, r1 = r0 + 8.
template <int KC>
__device__ __forceinline__ void load_a(uint32_t (&a)[KC][4], const bf16* base, long long st,
                                       int r0, int t4, int T, int D) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c0 = kc * 16 + 2 * t4, c1 = c0 + 8;
    a[kc][0] = load_pair(base, st, r0, c0, T, D);
    a[kc][1] = load_pair(base, st, r0 + 8, c0, T, D);
    a[kc][2] = load_pair(base, st, r0, c1, T, D);
    a[kc][3] = load_pair(base, st, r0 + 8, c1, T, D);
  }
}

// rows [row0, row0 + 64) of a (T, D) strided operand into shared memory,
// zero-padded to DP columns and past T
template <int DP>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long st, int row0,
                                      int T, int D, int tid) {
  constexpr int LD = DP + 8;
  const bf16 zero = __ushort_as_bfloat16(0);
  for (int idx = tid; idx < 64 * DP; idx += 128) {
    const int r = idx / DP, c = idx - r * DP;
    const int row = row0 + r;
    dst[r * LD + c] = (row < T && c < D) ? src[row * st + c] : zero;
  }
}

// C[16 x 16] += A(regs) . B^T where B's 16 rows sit at smem rows [r0, r0+16)
// (two 8-wide n tiles), contracting the DP columns.
template <int KC, int LD>
__device__ __forceinline__ void mma_rows(float (&c)[2][4], const uint32_t (&a)[KC][4],
                                         const bf16* sb, int r0, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const bf16* br = sb + (r0 + nt * 8 + g) * LD + kc * 16 + 2 * t4;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 8);
      mma_bf16(c[nt], a[kc], b0, b1);
    }
  }
}

// acc[16 x DP] += A(16 x 16 chunk, regs) . B where B's 16 contraction rows
// sit at smem rows [r0, r0 + 16), DP columns.
template <int NO, int LD>
__device__ __forceinline__ void mma_cols(float (&acc)[NO][4], const uint32_t (&a)[4],
                                         const bf16* sb, int r0, int g, int t4) {
  const bf16* br = sb + (r0 + 2 * t4) * LD + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const bf16* bc = br + n * 8;
    const uint32_t b0 = pack_raw(bc[0], bc[LD]);
    const uint32_t b1 = pack_raw(bc[8 * LD], bc[9 * LD]);
    mma_bf16(acc[n], a, b0, b1);
  }
}

template <int NO>
__device__ __forceinline__ void store_rows(bf16* base, long long st, const float (&acc)[NO][4],
                                           int r0, int t4, int T, int D) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n * 8 + 2 * t4 + e;
      if (col < D) {
        if (r0 < T) base[r0 * st + col] = __float2bfloat16(acc[n][e]);
        if (r0 + 8 < T) base[(r0 + 8) * st + col] = __float2bfloat16(acc[n][2 + e]);
      }
    }
  }
}

// dK, dV: one CTA per (batch*head, 64 keys); walks every q-block.
template <int DP>
__global__ void __launch_bounds__(128)
    flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T, int D,
                        Strides st, float scale) {
  constexpr int LD = DP + 8, KC = DP / 16, NO = DP / 8;
  __shared__ __align__(16) bf16 sQ[64 * LD];
  __shared__ __align__(16) bf16 sO[64 * LD];
  __shared__ float sL[64];
  __shared__ float sD[64];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* op = dout + b * st.ob + h * st.oh;
  const int r0 = blockIdx.y * 64 + warp * 16 + g;  // this thread's first key row

  uint32_t ka[KC][4], va[KC][4];
  load_a<KC>(ka, k + b * st.kb + h * st.kh, st.kt, r0, t4, T, D);
  load_a<KC>(va, v + b * st.vb + h * st.vh, st.vt, r0, t4, T, D);
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const float sl2 = scale * kLog2e;
  for (int q0 = 0; q0 < T; q0 += 64) {
    __syncthreads();
    stage<DP>(sQ, qp, st.qt, q0, T, D, tid);
    stage<DP>(sO, op, st.ot, q0, T, D, tid);
    if (tid < 64) {
      const bool ok = q0 + tid < T;
      sL[tid] = ok ? lse[(long long)bh * T + q0 + tid] * kLog2e : 0.f;
      sD[tid] = ok ? di[(long long)bh * T + q0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s[2][4], dp[2][4];
      mma_rows<KC, LD>(s, ka, sQ, c * 16, g, t4);   // S^T = K Q^T
      mma_rows<KC, LD>(dp, va, sO, c * 16, g, t4);  // dP^T = V dO^T
      uint32_t pa[4], da[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = c * 16 + nt * 8 + 2 * t4 + (e & 1);
          p[e] = q0 + qq < T ? exp2f(s[nt][e] * sl2 - sL[qq]) : 0.f;
          ds[e] = p[e] * (dp[nt][e] - sD[qq]) * scale;
        }
        pa[nt * 2] = pack_f32(p[0], p[1]);
        pa[nt * 2 + 1] = pack_f32(p[2], p[3]);
        da[nt * 2] = pack_f32(ds[0], ds[1]);
        da[nt * 2 + 1] = pack_f32(ds[2], ds[3]);
      }
      mma_cols<NO, LD>(dva, pa, sO, c * 16, g, t4);  // dV += P^T dO
      mma_cols<NO, LD>(dka, da, sQ, c * 16, g, t4);  // dK += dS^T Q
    }
  }
  store_rows<NO>(dk + b * st.dkb + h * st.dkh, st.dkt, dka, r0, t4, T, D);
  store_rows<NO>(dv + b * st.dvb + h * st.dvh, st.dvt, dva, r0, t4, T, D);
}

// dQ: one CTA per (batch*head, 64 queries); walks every k-block.
template <int DP>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ di,
                      bf16* __restrict__ dq, int H, int T, int D, Strides st, float scale) {
  constexpr int LD = DP + 8, KC = DP / 16, NO = DP / 8;
  __shared__ __align__(16) bf16 sK[64 * LD];
  __shared__ __align__(16) bf16 sV[64 * LD];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;
  const int r0 = blockIdx.y * 64 + warp * 16 + g;  // this thread's first query row

  uint32_t qa[KC][4], oa[KC][4];
  load_a<KC>(qa, q + b * st.qb + h * st.qh, st.qt, r0, t4, T, D);
  load_a<KC>(oa, dout + b * st.ob + h * st.oh, st.ot, r0, t4, T, D);
  const long long lrow = (long long)bh * T;
  const float l0 = r0 < T ? lse[lrow + r0] * kLog2e : 0.f;
  const float l1 = r0 + 8 < T ? lse[lrow + r0 + 8] * kLog2e : 0.f;
  const float d0 = r0 < T ? di[lrow + r0] : 0.f;
  const float d1 = r0 + 8 < T ? di[lrow + r0 + 8] : 0.f;
  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  const float sl2 = scale * kLog2e;
  for (int k0 = 0; k0 < T; k0 += 64) {
    __syncthreads();
    stage<DP>(sK, kp, st.kt, k0, T, D, tid);
    stage<DP>(sV, vp, st.vt, k0, T, D, tid);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s[2][4], dp[2][4];
      mma_rows<KC, LD>(s, qa, sK, c * 16, g, t4);   // S = Q K^T
      mma_rows<KC, LD>(dp, oa, sV, c * 16, g, t4);  // dP = dO V^T
      uint32_t da[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k0 + c * 16 + nt * 8 + 2 * t4 + (e & 1) < T;
          const float lq = e < 2 ? l0 : l1, dq_ = e < 2 ? d0 : d1;
          const float p = ok ? exp2f(s[nt][e] * sl2 - lq) : 0.f;
          ds[e] = p * (dp[nt][e] - dq_) * scale;
        }
        da[nt * 2] = pack_f32(ds[0], ds[1]);
        da[nt * 2 + 1] = pack_f32(ds[2], ds[3]);
      }
      mma_cols<NO, LD>(dqa, da, sK, c * 16, g, t4);  // dQ += dS K
    }
  }
  store_rows<NO>(dq + b * st.dqb + h * st.dqh, st.dqt, dqa, r0, t4, T, D);
}

// fp32: one row per 4 threads (each a quarter of the head dim), 32 rows per
// CTA; the other side streams through shared memory 32 rows at a time.
template <int NPT>
__global__ void __launch_bounds__(128)
    flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       float* __restrict__ dk, float* __restrict__ dv, int H, int T, int D,
                       Strides st, float scale) {
  constexpr int BQ = 32, DM = 4 * NPT;
  __shared__ float sQ[BQ][DM];
  __shared__ float sO[BQ][DM];
  __shared__ float sL[BQ];
  __shared__ float sD[BQ];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, part = tid & 3;
  const int row = blockIdx.y * 32 + (tid >> 2);
  const float* qp = q + b * st.qb + h * st.qh;
  const float* op = dout + b * st.ob + h * st.oh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;

  float kr[NPT], vr[NPT], dka[NPT], dva[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int d = part + 4 * i;
    const bool ok = row < T && d < D;
    kr[i] = ok ? kp[row * st.kt + d] : 0.f;
    vr[i] = ok ? vp[row * st.vt + d] : 0.f;
    dka[i] = dva[i] = 0.f;
  }

  for (int q0 = 0; q0 < T; q0 += BQ) {
    __syncthreads();
    for (int idx = tid; idx < BQ * DM; idx += 128) {
      const int r = idx / DM, c = idx - r * DM;
      const bool ok = q0 + r < T && c < D;
      sQ[r][c] = ok ? qp[(q0 + r) * st.qt + c] : 0.f;
      sO[r][c] = ok ? op[(q0 + r) * st.ot + c] : 0.f;
    }
    if (tid < BQ) {
      const bool ok = q0 + tid < T;
      sL[tid] = ok ? lse[(long long)bh * T + q0 + tid] : 0.f;
      sD[tid] = ok ? di[(long long)bh * T + q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < BQ; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        s = fmaf(kr[i], sQ[j][part + 4 * i], s);
        dp = fmaf(vr[i], sO[j][part + 4 * i], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const float p = q0 + j < T ? expf(s * scale - sL[j]) : 0.f;
      const float ds = p * (dp - sD[j]) * scale;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        dva[i] = fmaf(p, sO[j][part + 4 * i], dva[i]);
        dka[i] = fmaf(ds, sQ[j][part + 4 * i], dka[i]);
      }
    }
  }
  if (row < T) {
    float* dkp = dk + b * st.dkb + h * st.dkh + row * st.dkt;
    float* dvp = dv + b * st.dvb + h * st.dvh + row * st.dvt;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int d = part + 4 * i;
      if (d < D) {
        dkp[d] = dka[i];
        dvp[d] = dva[i];
      }
    }
  }
}

template <int NPT>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     float* __restrict__ dq, int H, int T, int D, Strides st, float scale) {
  constexpr int BK = 32, DM = 4 * NPT;
  __shared__ float sK[BK][DM];
  __shared__ float sV[BK][DM];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, part = tid & 3;
  const int row = blockIdx.y * 32 + (tid >> 2);
  const float* qp = q + b * st.qb + h * st.qh;
  const float* op = dout + b * st.ob + h * st.oh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;

  float qr[NPT], orr[NPT], dqa[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int d = part + 4 * i;
    const bool ok = row < T && d < D;
    qr[i] = ok ? qp[row * st.qt + d] : 0.f;
    orr[i] = ok ? op[row * st.ot + d] : 0.f;
    dqa[i] = 0.f;
  }
  const float l = row < T ? lse[(long long)bh * T + row] : 0.f;
  const float dd = row < T ? di[(long long)bh * T + row] : 0.f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * DM; idx += 128) {
      const int r = idx / DM, c = idx - r * DM;
      const bool ok = k0 + r < T && c < D;
      sK[r][c] = ok ? kp[(k0 + r) * st.kt + c] : 0.f;
      sV[r][c] = ok ? vp[(k0 + r) * st.vt + c] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        s = fmaf(qr[i], sK[j][part + 4 * i], s);
        dp = fmaf(orr[i], sV[j][part + 4 * i], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const float p = k0 + j < T ? expf(s * scale - l) : 0.f;
      const float ds = p * (dp - dd) * scale;
#pragma unroll
      for (int i = 0; i < NPT; ++i) dqa[i] = fmaf(ds, sK[j][part + 4 * i], dqa[i]);
    }
  }
  if (row < T) {
    float* dqp = dq + b * st.dqb + h * st.dqh + row * st.dqt;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int d = part + 4 * i;
      if (d < D) dqp[d] = dqa[i];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *dq, *dk, *dv;
  int BH, H, T, D;
  Strides st;
  float scale;
  cudaStream_t stream;
};

template <int DP>
void launch_bf16(const Args& a) {
  const dim3 grid(a.BH, (a.T + 63) / 64);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* o = static_cast<const bf16*>(a.dout);
  flash_bwd_dkdv_bf16<DP><<<grid, 128, 0, a.stream>>>(
      q, k, v, o, a.lse, a.di, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.T,
      a.D, a.st, a.scale);
  flash_bwd_dq_bf16<DP><<<grid, 128, 0, a.stream>>>(
      q, k, v, o, a.lse, a.di, static_cast<bf16*>(a.dq), a.H, a.T, a.D, a.st, a.scale);
}

template <int NPT>
void launch_f32(const Args& a) {
  const dim3 grid(a.BH, (a.T + 31) / 32);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* o = static_cast<const float*>(a.dout);
  flash_bwd_dkdv_f32<NPT><<<grid, 128, 0, a.stream>>>(
      q, k, v, o, a.lse, a.di, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H,
      a.T, a.D, a.st, a.scale);
  flash_bwd_dq_f32<NPT><<<grid, 128, 0, a.stream>>>(
      q, k, v, o, a.lse, a.di, static_cast<float*>(a.dq), a.H, a.T, a.D, a.st, a.scale);
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (B, H, T, D) addressed through the 21 element
// strides (q, k, v, dout, dq, dk, dv: b, h, t each), head dim contiguous.
// lse, di: (B*H, T) float32, contiguous. dtype: 0 = float32, 1 = bfloat16.
// 1 <= D <= 128.
extern "C" int lyc_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* di, void* dq, void* dk, void* dv,
                             int B, int H, int T, int D, const long long* strides,
                             float sm_scale, int dtype, void* stream) {
  if (D < 1 || D > 128 || T < 1 || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.di = di;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.BH = B * H; a.H = H; a.T = T; a.D = D;
  long long* s = &a.st.qb;
  for (int i = 0; i < 21; ++i) s[i] = strides[i];
  a.scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch ((D + 15) / 16) {
      case 1: launch_bf16<16>(a); break;
      case 2: launch_bf16<32>(a); break;
      case 3: launch_bf16<48>(a); break;
      case 4: launch_bf16<64>(a); break;
      case 5: launch_bf16<80>(a); break;
      case 6: launch_bf16<96>(a); break;
      case 7: launch_bf16<112>(a); break;
      default: launch_bf16<128>(a); break;
    }
  } else if (dtype == 0) {
    switch ((D + 31) / 32) {
      case 1: launch_f32<8>(a); break;
      case 2: launch_f32<16>(a); break;
      case 3: launch_f32<24>(a); break;
      default: launch_f32<32>(a); break;
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
