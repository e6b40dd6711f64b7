// Flash attention forward, non-causal: O = softmax(Q K^T * s) V per
// (batch, head), plus the fp32 logsumexp lse = m + log(l) per query row.
//
// Replaces: lycoris_tpu/ops/flash.py `_fwd` -> `_fwd_kernel` and its
// D-major twin `_fwd_dt` -> `_fwd_dt_kernel` (Pallas, TPU). The TPU kernel
// keeps a whole row of logits (bq x T fp32) in VMEM to take the true row
// max in one pass; a Hopper SM has 227 KB of shared memory, so K and V
// stream through it and the softmax is online (running max m and sum l in
// fp32, the O accumulator rescaled per block). One kernel takes any
// batch/head/token strides, so the head-split projections feed it without
// a copy (the D-major layout was a TPU device), and O goes straight into
// the (B, T, H, D) buffer the output projection reads.
//
// Bound on the H100: at the path's shapes (T 4096 / 1024, D 40 / 64 / 80)
// the two products are 4*T*T*D FLOPs per head against 8*T*D bytes, so the
// tensor cores bound it, and next to them the exp2 of every logit (the
// SM's 16 MUFU lanes a clock match the bf16 tensor rate at D = 64).
//
// Design (bf16): one CTA per (batch*head, 128 queries), 288 threads: two
// consumer warpgroups of 64 query rows each and one producer warp.
// - The producer loads the CTA's Q tile once by TMA, then streams K and V
//   in blocks of BK keys (128 for D <= 64, else 64) through a 2-stage ring
//   of shared memory; each stage has a full mbarrier (TMA transaction
//   bytes) and an empty one (one arrival per consumer warp).
// - S = Q K^T is a wgmma with both operands in shared memory, K-major.
// - The online softmax runs on the wgmma accumulator's registers: exp2
//   with scale_log2 = s * log2(e), keys >= T masked to -inf.
// - P is cast to bf16 in registers and is the register A operand of the
//   P V wgmma; V in shared memory is MN-major (the transpose flag).
// - Tiles use the no-swizzle core-matrix layout of hopper.cuh: D = 40 is
//   padded to the MMA depth 48 by TMA's zero fill of the chunks past D, and
//   rows past T arrive as zeros, so no copy and no scalar staging.
// - O is normalised in registers and stored as bf16 pairs; lse in fp32.
// ptxas (-Xptxas -v, _build.build_log): see the note in PERF.md section 6.
//
// fp32 inputs take a plain FMA kernel with the same online softmax (one
// query row per 4 threads, each owning a quarter of the head dim), so
// float32 results are not rounded through bf16 or TF32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

constexpr float kLn2 = 0.69314718055994530942f;
constexpr int kThreads = 288;  // two consumer warpgroups and one producer warp

template <int DP>
struct FwdCfg {
  static constexpr int BQ = 128, BK = DP <= 64 ? 128 : 64, STAGES = 2;
  static constexpr int Q_BYTES = BQ * DP * 2, KV_BYTES = BK * DP * 2;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 128;  // + alignment slack
};

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128 - (hop::smem_addr(p) & 127)) & 127);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                          float* __restrict__ lse, int H, int T, int D, long long ob,
                          long long oh, long long ot, float sl2) {
  using C = FwdCfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align128(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  const int nqb = (T + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqb, q0 = (blockIdx.x - bh * nqb) * BQ;
  const int b = bh / H, h = bh - b * H;
  const int nkb = (T + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    hop::mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(full + s, 1);
      hop::mbar_init(empty + s, 8);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      hop::mbar_expect_tx(qbar, C::Q_BYTES);
      hop::tma_tile(sm, &mq, qbar, q0, h, b);
      for (int j = 0; j < nkb; ++j) {
        const int s = j % S;
        if (j >= S) hop::mbar_wait(empty + s, ((j / S) - 1) & 1);
        unsigned char* kv = sm + C::Q_BYTES + s * 2 * C::KV_BYTES;
        hop::mbar_expect_tx(full + s, 2 * C::KV_BYTES);
        hop::tma_tile(kv, &mk, full + s, j * BK, h, b);
        hop::tma_tile(kv + C::KV_BYTES, &mv, full + s, j * BK, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [wg*64, wg*64 + 64) of the tile
  const int wg = tid >> 7, quad = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // and r0 + 8
  const uint32_t aq = hop::smem_addr(sm);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  hop::mbar_wait(qbar, 0);
  for (int j = 0; j < nkb; ++j) {
    const int s = j % S;
    const uint32_t ak = aq + C::Q_BYTES + s * 2 * C::KV_BYTES, av = ak + C::KV_BYTES;
    hop::mbar_wait(full + s, (j / S) & 1);

    float sc[BK / 2];
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wg::Wgmma<BK>::template ss<0>(sc, hop::desc_k<BQ>(aq, wg * 64, kk),
                                    hop::desc_k<BK>(ak, 0, kk), kk);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(sc);

    const int k0 = j * BK;
    if (k0 + BK > T) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + i * 8 + 2 * quad + e >= T) sc[4 * i + e] = sc[4 * i + 2 + e] = -CUDART_INF_F;
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key k0 is always valid, so the new maxima are finite and exp2(-inf)
    // zeroes the empty state of the first block
    mx0 = fmaxf(m0, mx0 * sl2);
    mx1 = fmaxf(m1, mx1 * sl2);
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[4 * n] *= c0;
      acc[4 * n + 1] *= c0;
      acc[4 * n + 2] *= c1;
      acc[4 * n + 3] *= c1;
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float p00 = exp2f(fmaf(sc[4 * i], sl2, -m0));
      const float p01 = exp2f(fmaf(sc[4 * i + 1], sl2, -m0));
      const float p10 = exp2f(fmaf(sc[4 * i + 2], sl2, -m1));
      const float p11 = exp2f(fmaf(sc[4 * i + 3], sl2, -m1));
      l0 += p00 + p01;
      l1 += p10 + p11;
      pa[i >> 1][(i & 1) * 2] = hop::pack_bf16(p00, p01);
      pa[i >> 1][(i & 1) * 2 + 1] = hop::pack_bf16(p10, p11);
    }

    hop::fence_regs(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wg::Wgmma<DP>::template rs<1>(acc, pa[kk], hop::desc_mn<BK>(av, kk), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc);
    if (lane == 0) hop::mbar_arrive(empty + s);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int g0 = q0 + r0, g1 = g0 + 8;
  bf16* op = o + b * ob + h * oh;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * quad;
    if (col >= D) continue;
    const float v00 = acc[4 * n] * inv0, v01 = acc[4 * n + 1] * inv0;
    const float v10 = acc[4 * n + 2] * inv1, v11 = acc[4 * n + 3] * inv1;
    if ((D & 1) == 0) {  // col + 1 < D, and the pair is 4-byte aligned
      if (g0 < T) *reinterpret_cast<__nv_bfloat162*>(op + g0 * ot + col) = __floats2bfloat162_rn(v00, v01);
      if (g1 < T) *reinterpret_cast<__nv_bfloat162*>(op + g1 * ot + col) = __floats2bfloat162_rn(v10, v11);
    } else {
      if (g0 < T) {
        op[g0 * ot + col] = __float2bfloat16(v00);
        if (col + 1 < D) op[g0 * ot + col + 1] = __float2bfloat16(v01);
      }
      if (g1 < T) {
        op[g1 * ot + col] = __float2bfloat16(v10);
        if (col + 1 < D) op[g1 * ot + col + 1] = __float2bfloat16(v11);
      }
    }
  }
  if (quad == 0) {
    if (g0 < T) lse[(long long)bh * T + g0] = m0 * kLn2 + logf(l0);
    if (g1 < T) lse[(long long)bh * T + g1] = m1 * kLn2 + logf(l1);
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
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                int T, int D, const Strides& st, float sl2, cudaStream_t stream) {
  using C = FwdCfg<DP>;
  CUtensorMap mq, mk, mv;
  if (!hop::make_map(&mq, q, B, H, T, D, st.qb, st.qh, st.qt, C::BQ, DP) ||
      !hop::make_map(&mk, k, B, H, T, D, st.kb, st.kh, st.kt, C::BK, DP) ||
      !hop::make_map(&mv, v, B, H, T, D, st.vb, st.vh, st.vt, C::BK, DP))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const long long blocks = static_cast<long long>(B) * H * ((T + C::BQ - 1) / C::BQ);
  flash_fwd_bf16_kernel<DP><<<static_cast<unsigned>(blocks), kThreads, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, H, T, D, st.ob, st.oh, st.ot, sl2);
  return static_cast<int>(cudaGetLastError());
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
// 1 <= D <= 128. bf16 q, k and v are read by TMA: 16-byte aligned, strides
// multiples of 8 elements, and ceil(D/8)*8 readable columns, zero past D
// (the wrapper pads a head dim that is not a multiple of 8).
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
      case 1: return launch_bf16<16>(q, k, v, o, lse, B, H, T, D, st, sl2, s);
      case 2: return launch_bf16<32>(q, k, v, o, lse, B, H, T, D, st, sl2, s);
      case 3: return launch_bf16<48>(q, k, v, o, lse, B, H, T, D, st, sl2, s);
      case 4: return launch_bf16<64>(q, k, v, o, lse, B, H, T, D, st, sl2, s);
      case 5: return launch_bf16<80>(q, k, v, o, lse, B, H, T, D, st, sl2, s);
      case 6: return launch_bf16<96>(q, k, v, o, lse, B, H, T, D, st, sl2, s);
      case 7: return launch_bf16<112>(q, k, v, o, lse, B, H, T, D, st, sl2, s);
      default: return launch_bf16<128>(q, k, v, o, lse, B, H, T, D, st, sl2, s);
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
