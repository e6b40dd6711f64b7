// Flash attention backward, non-causal: dQ, dK, dV from Q, K, V, O, dO and
// the forward's fp32 logsumexp lse:
//   di = rowsum(dO * O)      (fp32, a small kernel of this file)
//   P  = exp(S * s - lse),  S = Q K^T
//   dV = P^T dO             (P rounded to the input dtype)
//   dS = P * (dO V^T - di) * s
//   dK = dS^T Q,  dQ = dS K (dS rounded to the input dtype, fp32 sums)
//
// Replaces: lycoris_tpu/ops/flash.py `_bwd_call` -> `_bwd_kernel` and its
// D-major twin `_bwd_dt_call` -> `_bwd_dt_kernel` (Pallas, TPU), and the
// di = rowsum(dO * O) that flash.py forms outside them. The TPU kernel
// walks the k-blocks as a sequential grid and carries dQ for the whole
// sequence in VMEM. Hopper's blocks run in parallel and in no order, so
// this is two kernels with no atomics and a deterministic result: one over
// key blocks that keeps dK and dV in registers and streams every query
// block, one over query blocks that keeps dQ in registers and streams
// every key block. S and dP are computed in both (7 products where the
// bound counts 5), the price of determinism. Every operand is read through
// its batch/head/token strides (head dim contiguous), so the head-split
// projections need no copies either way.
//
// Bound on the H100: the tensor cores (5 products of 2*T*T*D FLOPs per
// head against ~16*T*D bytes), and the exp2 of every logit in both kernels.
//
// Design (bf16), both kernels: two consumer warpgroups of 64 rows and one
// producer warp; TMA loads into a 2-stage shared-memory ring guarded by
// full/empty mbarriers; wgmma for every product.
// - dK/dV: one CTA per (batch*head, 128 keys). Its producer warp is the
//   working warp of a third warpgroup that drops to 24 registers
//   (setmaxnreg), so the consumers hold dK, dV, S^T and dP^T in up to 240.
//   K and V are loaded once;
//   the producer streams Q and dO in blocks of BQ queries (64 for D <= 96,
//   else 32, for registers) and writes the block's lse (log2 units) and di
//   into the stage. S^T = K Q^T and dP^T = V dO^T are wgmmas with both
//   operands in shared memory (K-major); P^T and dS^T are formed on the
//   accumulator registers and cast to bf16 as the register A operands of
//   dV += P^T dO and dK += dS^T Q, whose B (dO, Q) is MN-major.
// - dQ: one CTA per (batch*head, 128 queries). Q and dO are loaded once;
//   K and V stream in blocks of 64 keys: S = Q K^T, dP = dO V^T, then
//   dQ += dS K with dS as the register A operand and K MN-major.
// - Tiles use the no-swizzle core-matrix layout of hopper.cuh: D = 40 is
//   padded to the MMA depth 48 by TMA's zero fill, and rows past T arrive
//   as zeros. A zero row of Q or dO (queries past T) and a zero row of K
//   or V (keys past T) add nothing to dK, dV or dQ, so no mask is needed;
//   the lse and di of queries past T are set to 0, which keeps P finite.
// ptxas (-Xptxas -v, _build.build_log): see the note in PERF.md section 6.
//
// fp32 inputs take plain FMA kernels of the same structure (one row per 4
// threads, each owning a quarter of the head dim), so float32 results are
// not rounded through bf16 or TF32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;  // ob..ot: dO
  long long dqb, dqh, dqt, dkb, dkh, dkt, dvb, dvh, dvt;
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 288;  // dQ: two consumer warpgroups and one producer warp
// dK/dV: two consumer warpgroups and a producer warpgroup (one working warp)
// that gives its registers to the consumers (setmaxnreg): dK and dV stay in
// registers for the whole walk, which 168 registers a thread do not hold
constexpr int kThreadsKV = 384, kEntryRegs = 168, kProducerRegs = 24, kConsumerRegs = 240;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// di[bh, t] = sum_d dO[b, h, t, d] * O[b, h, t, d] in fp32; 8 threads a row.
template <typename E>
__global__ void __launch_bounds__(256)
    flash_di_kernel(const E* __restrict__ o, const E* __restrict__ dout, float* __restrict__ di,
                    long long rows, int H, int T, int D, long long ob, long long oh, long long ot,
                    long long db, long long dh, long long dt) {
  const long long row = static_cast<long long>(blockIdx.x) * 32 + (threadIdx.x >> 3);
  const int sub = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
    const long long bh = row / T;
    const int t = static_cast<int>(row - bh * T);
    const int b = static_cast<int>(bh / H), h = static_cast<int>(bh - static_cast<long long>(b) * H);
    const E* op = o + b * ob + h * oh + t * ot;
    const E* dp = dout + b * db + h * dh + t * dt;
    for (int c = sub; c < D; c += 8) acc = fmaf(to_f32(op[c]), to_f32(dp[c]), acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (sub == 0 && row < rows) di[row] = acc;
}

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128 - (hop::smem_addr(p) & 127)) & 127);
}

// rows g0 and g0 + 8 of a (T, D) bf16 output from an m64 accumulator
template <int DP>
__device__ __forceinline__ void store_acc(bf16* base, long long st, const float (&acc)[DP / 2],
                                          int g0, int quad, int T, int D) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = g0 + 8 * half, col = n * 8 + 2 * quad;
      if (row >= T || col >= D) continue;
      const float x0 = acc[4 * n + 2 * half], x1 = acc[4 * n + 2 * half + 1];
      bf16* p = base + row * st + col;
      if ((D & 1) == 0) {  // col + 1 < D, and the pair is 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
      } else {
        p[0] = __float2bfloat16(x0);
        if (col + 1 < D) p[1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DP>
struct BwdCfg {
  static constexpr int STAGES = 2;
  // dK/dV kernel: 128 keys per CTA, query blocks of BQ
  static constexpr int BKV = 128, BQ = DP <= 96 ? 64 : 32;
  static constexpr int KV_BYTES = BKV * DP * 2, QB_BYTES = BQ * DP * 2;
  static constexpr int KV_STAGE = 2 * QB_BYTES + 2 * BQ * 4;  // Q, dO, lse, di
  static constexpr int KV_BAR = 2 * KV_BYTES + STAGES * KV_STAGE;
  static constexpr int KV_SMEM = KV_BAR + 8 * (1 + 2 * STAGES) + 128;
  // dQ kernel: 128 queries per CTA, key blocks of BKD
  static constexpr int BQD = 128, BKD = 64;
  static constexpr int QD_BYTES = BQD * DP * 2, KB_BYTES = BKD * DP * 2;
  static constexpr int Q_BAR = 2 * QD_BYTES + STAGES * 2 * KB_BYTES;
  static constexpr int Q_SMEM = Q_BAR + 8 * (1 + 2 * STAGES) + 128;
};

// dK, dV: one CTA per (batch*head, 128 keys); walks every query block.
template <int DP>
__global__ void __launch_bounds__(kThreadsKV, 1)
    flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                        const float* __restrict__ di, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int H, int T, int D, Strides st, float scale) {
  using C = BwdCfg<DP>;
  constexpr int BKV = C::BKV, BQ = C::BQ, S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align128(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::KV_BAR);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  const int nkb = (T + BKV - 1) / BKV;
  const int bh = blockIdx.x / nkb, k0 = (blockIdx.x - bh * nkb) * BKV;
  const int b = bh / H, h = bh - b * H;
  const int nqb = (T + BQ - 1) / BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long lrow = static_cast<long long>(bh) * T;

  if (tid == 0) {
    hop::mbar_init(kvbar, 1);
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(full + s, 32);  // the producer warp's lanes (lane 0 with the bytes)
      hop::mbar_init(empty + s, 8);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: warp 8 works, 9-11 only give registers
    hop::reg_dealloc<kProducerRegs>();
    if (warp > 8) return;
    if (lane == 0) {
      hop::mbar_expect_tx(kvbar, 2 * C::KV_BYTES);
      hop::tma_tile(sm, &mk, kvbar, k0, h, b);
      hop::tma_tile(sm + C::KV_BYTES, &mv, kvbar, k0, h, b);
    }
    for (int j = 0; j < nqb; ++j) {
      const int s = j % S;
      if (j >= S) hop::mbar_wait(empty + s, ((j / S) - 1) & 1);
      unsigned char* stage = sm + 2 * C::KV_BYTES + s * C::KV_STAGE;
      float* sl = reinterpret_cast<float*>(stage + 2 * C::QB_BYTES);
      for (int i = lane; i < BQ; i += 32) {
        const int q = j * BQ + i;
        sl[i] = q < T ? lse[lrow + q] * kLog2e : 0.f;
        sl[BQ + i] = q < T ? di[lrow + q] : 0.f;
      }
      if (lane == 0) {
        hop::mbar_expect_tx(full + s, 2 * C::QB_BYTES);
        hop::tma_tile(stage, &mq, full + s, j * BQ, h, b);
        hop::tma_tile(stage + C::QB_BYTES, &mdo, full + s, j * BQ, h, b);
      } else {
        hop::mbar_arrive(full + s);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns key rows [wg*64, wg*64 + 64) of the tile
  hop::reg_alloc<kConsumerRegs>();
  const int wg = tid >> 7, quad = lane & 3;
  const uint32_t ak = hop::smem_addr(sm), av = ak + C::KV_BYTES;
  const float sl2 = scale * kLog2e;
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;

  hop::mbar_wait(kvbar, 0);
  for (int j = 0; j < nqb; ++j) {
    const int s = j % S;
    const uint32_t aqs = ak + 2 * C::KV_BYTES + s * C::KV_STAGE, ados = aqs + C::QB_BYTES;
    const float* sl = reinterpret_cast<const float*>(sm + 2 * C::KV_BYTES + s * C::KV_STAGE +
                                                     2 * C::QB_BYTES);
    hop::mbar_wait(full + s, (j / S) & 1);

    float pt[BQ / 2], dpt[BQ / 2];
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)  // S^T = K Q^T
      wg::Wgmma<BQ>::template ss<0>(pt, hop::desc_k<BKV>(ak, wg * 64, kk),
                                    hop::desc_k<BQ>(aqs, 0, kk), kk);
    hop::wg_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)  // dP^T = V dO^T
      wg::Wgmma<BQ>::template ss<0>(dpt, hop::desc_k<BKV>(av, wg * 64, kk),
                                    hop::desc_k<BQ>(ados, 0, kk), kk);
    hop::wg_commit();
    hop::wg_wait<1>();
    hop::fence_regs(pt);

    uint32_t pa[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lq = sl[i * 8 + 2 * quad + e];
        pt[4 * i + e] = exp2f(fmaf(pt[4 * i + e], sl2, -lq));
        pt[4 * i + 2 + e] = exp2f(fmaf(pt[4 * i + 2 + e], sl2, -lq));
      }
      pa[i >> 1][(i & 1) * 2] = hop::pack_bf16(pt[4 * i], pt[4 * i + 1]);
      pa[i >> 1][(i & 1) * 2 + 1] = hop::pack_bf16(pt[4 * i + 2], pt[4 * i + 3]);
    }
    hop::fence_regs(dva);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)  // dV += P^T dO
      wg::Wgmma<DP>::template rs<1>(dva, pa[kk], hop::desc_mn<BQ>(ados, kk), 1);
    hop::wg_commit();
    hop::wg_wait<1>();
    hop::fence_regs(dpt);

    uint32_t da[BQ / 16][4];  // dS^T; dV's product may still be reading P
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dd = sl[BQ + i * 8 + 2 * quad + e];
        ds[e] = pt[4 * i + e] * (dpt[4 * i + e] - dd) * scale;
        ds[2 + e] = pt[4 * i + 2 + e] * (dpt[4 * i + 2 + e] - dd) * scale;
      }
      da[i >> 1][(i & 1) * 2] = hop::pack_bf16(ds[0], ds[1]);
      da[i >> 1][(i & 1) * 2 + 1] = hop::pack_bf16(ds[2], ds[3]);
    }
    hop::fence_regs(dka);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)  // dK += dS^T Q
      wg::Wgmma<DP>::template rs<1>(dka, da[kk], hop::desc_mn<BQ>(aqs, kk), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(dka);
    hop::fence_regs(dva);
    if (lane == 0) hop::mbar_arrive(empty + s);
  }

  const int g0 = k0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  store_acc<DP>(dk + b * st.dkb + h * st.dkh, st.dkt, dka, g0, quad, T, D);
  store_acc<DP>(dv + b * st.dvb + h * st.dvh, st.dvt, dva, g0, quad, T, D);
}

// dQ: one CTA per (batch*head, 128 queries); walks every key block.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                      const float* __restrict__ di, bf16* __restrict__ dq, int H, int T, int D,
                      Strides st, float scale) {
  using C = BwdCfg<DP>;
  constexpr int BQD = C::BQD, BKD = C::BKD, S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align128(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::Q_BAR);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  const int nqb = (T + BQD - 1) / BQD;
  const int bh = blockIdx.x / nqb, q0 = (blockIdx.x - bh * nqb) * BQD;
  const int b = bh / H, h = bh - b * H;
  const int nkb = (T + BKD - 1) / BKD;
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
      hop::mbar_expect_tx(qbar, 2 * C::QD_BYTES);
      hop::tma_tile(sm, &mq, qbar, q0, h, b);
      hop::tma_tile(sm + C::QD_BYTES, &mdo, qbar, q0, h, b);
      for (int j = 0; j < nkb; ++j) {
        const int s = j % S;
        if (j >= S) hop::mbar_wait(empty + s, ((j / S) - 1) & 1);
        unsigned char* kv = sm + 2 * C::QD_BYTES + s * 2 * C::KB_BYTES;
        hop::mbar_expect_tx(full + s, 2 * C::KB_BYTES);
        hop::tma_tile(kv, &mk, full + s, j * BKD, h, b);
        hop::tma_tile(kv + C::KB_BYTES, &mv, full + s, j * BKD, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [wg*64, wg*64 + 64) of the tile
  const int wg = tid >> 7, quad = lane & 3;
  const int g0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2), g1 = g0 + 8;
  const long long lrow = static_cast<long long>(bh) * T;
  const float l0 = g0 < T ? lse[lrow + g0] * kLog2e : 0.f;
  const float l1 = g1 < T ? lse[lrow + g1] * kLog2e : 0.f;
  const float d0 = g0 < T ? di[lrow + g0] : 0.f;
  const float d1 = g1 < T ? di[lrow + g1] : 0.f;
  const uint32_t aq = hop::smem_addr(sm), ado = aq + C::QD_BYTES;
  const float sl2 = scale * kLog2e;
  float dqa[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;

  hop::mbar_wait(qbar, 0);
  for (int j = 0; j < nkb; ++j) {
    const int s = j % S;
    const uint32_t aks = aq + 2 * C::QD_BYTES + s * 2 * C::KB_BYTES, avs = aks + C::KB_BYTES;
    hop::mbar_wait(full + s, (j / S) & 1);

    float sc[BKD / 2], dp[BKD / 2];
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)  // S = Q K^T
      wg::Wgmma<BKD>::template ss<0>(sc, hop::desc_k<BQD>(aq, wg * 64, kk),
                                     hop::desc_k<BKD>(aks, 0, kk), kk);
    hop::wg_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)  // dP = dO V^T
      wg::Wgmma<BKD>::template ss<0>(dp, hop::desc_k<BQD>(ado, wg * 64, kk),
                                     hop::desc_k<BKD>(avs, 0, kk), kk);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(sc);
    hop::fence_regs(dp);

    uint32_t da[BKD / 16][4];
#pragma unroll
    for (int i = 0; i < BKD / 8; ++i) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ds[e] = exp2f(fmaf(sc[4 * i + e], sl2, -l0)) * (dp[4 * i + e] - d0) * scale;
        ds[2 + e] = exp2f(fmaf(sc[4 * i + 2 + e], sl2, -l1)) * (dp[4 * i + 2 + e] - d1) * scale;
      }
      da[i >> 1][(i & 1) * 2] = hop::pack_bf16(ds[0], ds[1]);
      da[i >> 1][(i & 1) * 2 + 1] = hop::pack_bf16(ds[2], ds[3]);
    }
    hop::fence_regs(dqa);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKD / 16; ++kk)  // dQ += dS K
      wg::Wgmma<DP>::template rs<1>(dqa, da[kk], hop::desc_mn<BKD>(aks, kk), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(dqa);
    if (lane == 0) hop::mbar_arrive(empty + s);
  }
  store_acc<DP>(dq + b * st.dqb + h * st.dqh, st.dqt, dqa, g0, quad, T, D);
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
  const void *q, *k, *v, *dout, *o;
  const float* lse;
  float* di;
  void *dq, *dk, *dv;
  int B, BH, H, T, D;
  Strides st;
  long long o_b, o_h, o_t;
  float scale;
  cudaStream_t stream;
};

template <typename E>
void launch_di(const Args& a) {
  const long long rows = static_cast<long long>(a.BH) * a.T;
  flash_di_kernel<E><<<static_cast<unsigned>((rows + 31) / 32), 256, 0, a.stream>>>(
      static_cast<const E*>(a.o), static_cast<const E*>(a.dout), a.di, rows, a.H, a.T, a.D,
      a.o_b, a.o_h, a.o_t, a.st.ob, a.st.oh, a.st.ot);
}

template <typename K>
int smem_attr(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

template <int DP>
int launch_bf16(const Args& a) {
  using C = BwdCfg<DP>;
  const Strides& s = a.st;
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;  // boxes of the dK/dV and the dQ kernel
  if (!hop::make_map(&kq, a.q, a.B, a.H, a.T, a.D, s.qb, s.qh, s.qt, C::BQ, DP) ||
      !hop::make_map(&kdo, a.dout, a.B, a.H, a.T, a.D, s.ob, s.oh, s.ot, C::BQ, DP) ||
      !hop::make_map(&kk, a.k, a.B, a.H, a.T, a.D, s.kb, s.kh, s.kt, C::BKV, DP) ||
      !hop::make_map(&kv, a.v, a.B, a.H, a.T, a.D, s.vb, s.vh, s.vt, C::BKV, DP) ||
      !hop::make_map(&qq, a.q, a.B, a.H, a.T, a.D, s.qb, s.qh, s.qt, C::BQD, DP) ||
      !hop::make_map(&qdo, a.dout, a.B, a.H, a.T, a.D, s.ob, s.oh, s.ot, C::BQD, DP) ||
      !hop::make_map(&qk, a.k, a.B, a.H, a.T, a.D, s.kb, s.kh, s.kt, C::BKD, DP) ||
      !hop::make_map(&qv, a.v, a.B, a.H, a.T, a.D, s.vb, s.vh, s.vt, C::BKD, DP))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_kv = false, attr_q = false;
  if (!attr_kv) {
    // setmaxnreg.inc waits for the registers the producer frees: that
    // balance holds only if the kernel starts at exactly kEntryRegs
    cudaFuncAttributes fa;
    const cudaError_t fe = cudaFuncGetAttributes(&fa, flash_bwd_dkdv_bf16<DP>);
    if (fe != cudaSuccess) return static_cast<int>(fe);
    if (fa.numRegs != kEntryRegs) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  int e = smem_attr(flash_bwd_dkdv_bf16<DP>, C::KV_SMEM, attr_kv);
  if (e == 0) e = smem_attr(flash_bwd_dq_bf16<DP>, C::Q_SMEM, attr_q);
  if (e != 0) return e;
  launch_di<bf16>(a);
  const long long bkv = static_cast<long long>(a.BH) * ((a.T + C::BKV - 1) / C::BKV);
  flash_bwd_dkdv_bf16<DP><<<static_cast<unsigned>(bkv), kThreadsKV, C::KV_SMEM, a.stream>>>(
      kq, kk, kv, kdo, a.lse, a.di, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H,
      a.T, a.D, s, a.scale);
  const long long bq = static_cast<long long>(a.BH) * ((a.T + C::BQD - 1) / C::BQD);
  flash_bwd_dq_bf16<DP><<<static_cast<unsigned>(bq), kThreads, C::Q_SMEM, a.stream>>>(
      qq, qk, qv, qdo, a.lse, a.di, static_cast<bf16*>(a.dq), a.H, a.T, a.D, s, a.scale);
  return static_cast<int>(cudaGetLastError());
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

// q, k, v, dout, dq, dk, dv, o: (B, H, T, D) addressed through the 24
// element strides (q, k, v, dout, dq, dk, dv, o: b, h, t each), head dim
// contiguous. lse: (B*H, T) float32, contiguous; di: a (B*H, T) float32
// buffer that this entry fills with rowsum(dO * O) before the gradient
// kernels read it. dtype: 0 = float32, 1 = bfloat16. 1 <= D <= 128. bf16
// q, k, v and dout are read by TMA: 16-byte aligned, strides multiples of
// 8 elements, and ceil(D/8)*8 readable columns, zero past D (the wrapper
// pads a head dim that is not a multiple of 8).
extern "C" int lyc_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* di, void* dq, void* dk,
                             void* dv, int B, int H, int T, int D, const long long* strides,
                             float sm_scale, int dtype, void* stream) {
  if (D < 1 || D > 128 || T < 1 || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.o = o; a.lse = lse; a.di = di;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.BH = B * H; a.H = H; a.T = T; a.D = D;
  long long* s = &a.st.qb;
  for (int i = 0; i < 21; ++i) s[i] = strides[i];
  a.o_b = strides[21]; a.o_h = strides[22]; a.o_t = strides[23];
  a.scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch ((D + 15) / 16) {
      case 1: return launch_bf16<16>(a);
      case 2: return launch_bf16<32>(a);
      case 3: return launch_bf16<48>(a);
      case 4: return launch_bf16<64>(a);
      case 5: return launch_bf16<80>(a);
      case 6: return launch_bf16<96>(a);
      case 7: return launch_bf16<112>(a);
      default: return launch_bf16<128>(a);
    }
  } else if (dtype == 0) {
    launch_di<float>(a);
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
