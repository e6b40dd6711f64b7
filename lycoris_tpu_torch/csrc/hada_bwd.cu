// LoHa delta weight backward: the four factor gradients of
// dW = (w1u @ w1d) * (w2u @ w2d) * gamma in one pass over the cotangent g:
//   t1 = g * gamma * (w2u @ w2d),  t2 = g * gamma * (w1u @ w1d)
//   g1u = t1 @ w1d^T,  g1d = w1u^T @ t1,  g2u = t2 @ w2d^T,  g2d = w2u^T @ t2
// t1, t2 and both products never leave the SM.
//
// Replaces: lycoris_tpu/ops/hada.py `_hada_bwd_fused1` ->
// `_make_hada_bwd_fused1_kernel` (Pallas, TPU), which keeps the (O, R) and
// (R, I) gradient accumulators resident in VMEM for its whole sequential
// grid. Hopper's blocks run in parallel and in no order, so each block
// writes partial sums and they are added in a fixed order: deterministic,
// no float atomics.
//
// Bound on the H100: at rank 8, the fp32 operations, just. Each element of
// g costs 6R multiply-adds (both products, the u- and the d-contractions),
// 24 flops a byte of fp32 g against the card's FFMA-to-HBM balance of 20;
// at depth 8 there is no work for the tensor cores that a single TF32 pass
// could do within the fp32 gate, so the design is FFMA.
//
// Two variants, chosen by the caller (ops/hada.py `fast`):
//
// Fast (R = 8, the path's rank; I a multiple of 4, 16-byte aligned
// tensors). One pass over g with 16-byte loads (8 bytes in bf16): a thread
// owns 4 consecutive columns and walks every 8th row of its block's run,
// with g prefetched two rows ahead into a ring of three buffers. It keeps
// its columns of w1d and w2d (2R x 4) and its d-grad sums (2R x 4) in
// registers across all its rows. The block's rows of w1u/w2u are copied
// into shared memory first (16-byte loads), so a row's 2R u-values are four
// 16-byte broadcast loads from shared memory; the row loop never syncs the
// block. A row's 2R u-grad partials (one per lane, over the lane's 4
// columns) are summed over the warp's 128 columns by a reduce-scatter
// butterfly, 8 + 4 + 2 + 1 + 1 shuffles for the 16 values, and written as
// the row's partial for the warp's column strip. At the end the 8 warps'
// d-grad sums are added in warp order through shared memory into one
// partial per block. The grid is one wave, a block an SM (about 240
// registers a thread). The caller gives each block enough rows that the
// partials (2R floats per row and column strip, 2R per column and block)
// stay within a quarter of fp32 g's bytes, written once and read once. A
// second kernel adds them in index order, 16 bytes a thread. (Letting the
// last block of each strip add them would save that launch, but it piles
// a strip's u-partials, one per column strip and row, onto one block: at
// I = 5120 that tail outweighs the launch.)
//
// What holds the fast variant back: the butterfly and the selects around
// it add about a third to the FMAs' issue slots, and with 8 warps an SM
// little of a row's latency hides; at the small layers the prologue, the
// epilogue and the second launch weigh as much as the row loop.
//
// Generic (any other rank or layout): a block owns a strip of 128 columns
// and a run of rows (the caller's rows per block), walks it in 16-row
// tiles with t1/t2 of the tile in shared memory, and forms the gradients
// of 32 ranks at a time: shared memory holds the chunk's columns of
// w1d/w2d and its d-grad sums, so any R fits (about 87 KB). The products
// read w1u/w1d over all R from L1/L2, once per chunk. Each tile's u-grad
// rows go out as a partial for the column strip, the d-grad sums as one
// partial per block, and a second kernel adds the partials in order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

// ---------------------------------------------------------------------------
// fast variant, R = 8
// ---------------------------------------------------------------------------

constexpr int FR = 8;           // the fast variant's rank
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

// pu: [gridDim.x][O][FU] each row's u-grads over one column strip;
// pd: [gridDim.y][FU][I] each column's d-grads over one run of rows
template <typename T>
__global__ void __launch_bounds__(32 * FW, 1)
    hada_bwd_r8_kernel(const T* __restrict__ g, const T* __restrict__ w1d,
                       const T* __restrict__ w1u, const T* __restrict__ w2d,
                       const T* __restrict__ w2u, float* __restrict__ pu,
                       float* __restrict__ pd, int O, int I, int rpb, float scale) {
  extern __shared__ float4 sm4[];  // [rpb][FU4] u-values, then [FW][FU][FCOLS / 4] d-sums
  // the warp index broadcast from lane 0, so the compiler knows it is the
  // same across the warp: the row loop's trip count is then warp-uniform and
  // its shuffles compile as plain shuffles, not as collective emulation
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
  // g two rows ahead (from HBM), in a ring of three buffers whose indices
  // are fixed at compile time: a register copy of a value still in flight
  // would wait for its load. The loop body (three rows) has no branch, so
  // one row's butterfly can overlap the next row's products: a row past the
  // run reads g as zero and the last row's u-values, adds nothing and
  // stores nothing.
  const long long gstep = (long long)FW * I;
  const T* gnext = g + (long long)(ob + w + 2 * FW) * I + col;  // the row two steps on
  float* pu_row = pu + ((size_t)bx * O + ob + w) * FU + (lane >> 1);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto step = [&](int m, const float4& gc, float4& gn) {
    gn = (on && m + 2 * FW < nrows) ? load4<true>(gnext) : zero;
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
      float a = t1[0] * d1[r][0], b = t2[0] * d2[r][0];
#pragma unroll
      for (int c = 1; c < 4; ++c) {
        a = fmaf(t1[c], d1[r][c], a);
        b = fmaf(t2[c], d2[r][c], b);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s1[r][c] = fmaf(u[r], t1[c], s1[r][c]);
        s2[r][c] = fmaf(u[FR + r], t2[c], s2[r][c]);
      }
      v[r] = a;
      v[FR + r] = b;
    }
    const float ug = reduce_scatter16(v, lane);
    if (!(lane & 1) && m < nrows) *pu_row = ug;
    pu_row += FW * FU;
  };
  float4 ga = zero, gb = zero, gc = zero;
  if (on && w < nrows) ga = load4<true>(gnext - 2 * gstep);
  if (on && w + FW < nrows) gb = load4<true>(gnext - gstep);
  __syncthreads();  // the u-values are staged
  for (int m = w; m < nrows; m += 3 * FW) {
    step(m, ga, gc);
    step(m + FW, gb, ga);
    step(m + 2 * FW, gc, gb);
  }

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

// the gradients from the partials, each summed in index order, 4 values
// (16 bytes) a thread: g1u/g2u (O, R) over the gx column strips, g1d/g2d
// (R, I) over the gy row runs; out = g1d, g2d, g1u, g2u one after another
__global__ void hada_bwd_r8_reduce_kernel(const float* __restrict__ pu,
                                          const float* __restrict__ pd, float* __restrict__ out,
                                          int O, int I, int gx, int gy) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nu = (long long)O * (FU / 4), nd = (long long)FU * (I / 4);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float* dst;
  if (t < nu) {
    const float4* src = reinterpret_cast<const float4*>(pu) + t;
#pragma unroll 4
    for (int x = 0; x < gx; ++x) {
      const float4 v = __ldg(src + (long long)x * nu);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const long long o = t / (FU / 4), q = t - o * (FU / 4);
    dst = out + (size_t)2 * FR * I + (q < 2 ? 0 : (size_t)O * FR) + o * FR + 4 * (q & 1);
  } else if (t < nu + nd) {
    const long long j = t - nu;
    const float4* src = reinterpret_cast<const float4*>(pd) + j;
#pragma unroll 4
    for (int y = 0; y < gy; ++y) {
      const float4 v = __ldg(src + (long long)y * nd);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    dst = out + 4 * j;  // [FU][I]: g1d's R rows, then g2d's
  } else {
    return;
  }
  *reinterpret_cast<float4*>(dst) = s;
}

// ---------------------------------------------------------------------------
// generic variant, any R
// ---------------------------------------------------------------------------

constexpr int TM = 16;    // rows per tile
constexpr int TN = 128;   // columns per block
constexpr int RC = 32;    // ranks whose gradients one pass forms
constexpr int BX = 32, BY = 8, NT = BX * BY;
constexpr int LDN = TN + 1;

constexpr size_t generic_smem_bytes() {
  return (2 * (size_t)RC * LDN + 2 * (size_t)RC * TN + 2 * (size_t)TM * (RC + 1) +
          2 * (size_t)TM * LDN) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    hada_bwd_kernel(const T* __restrict__ g, const T* __restrict__ w1d,
                    const T* __restrict__ w1u, const T* __restrict__ w2d,
                    const T* __restrict__ w2u, float* __restrict__ pu1,
                    float* __restrict__ pu2, float* __restrict__ pd1,
                    float* __restrict__ pd2, int O, int I, int R, int rpb, float scale) {
  extern __shared__ float sm[];
  float* s1d = sm;                   // [RC][LDN] the chunk's ranks of w1d, block's columns
  float* s2d = s1d + RC * LDN;       // [RC][LDN]
  float* sd1 = s2d + RC * LDN;       // [RC][TN] the chunk's d-grad sums over the block's rows
  float* sd2 = sd1 + RC * TN;        // [RC][TN]
  float* s1u = sd2 + RC * TN;        // [TM][RC + 1] the tile's rows of w1u, the chunk's ranks
  float* s2u = s1u + TM * (RC + 1);  // [TM][RC + 1]
  float* st1 = s2u + TM * (RC + 1);  // [TM][LDN] t1 of the tile
  float* st2 = st1 + TM * LDN;       // [TM][LDN]

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  const int i0 = blockIdx.x * TN;
  const int ob = blockIdx.y * rpb;
  const int oe = min(O, ob + rpb);
  constexpr int RU = RC + 1;

  for (int r0 = 0; r0 < R; r0 += RC) {
    const int rc = min(RC, R - r0);
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < rc * TN; idx += NT) {  // the loops below read no other rank
      const int r = idx / TN, n = idx - r * TN;
      const int i = i0 + n;
      const bool ok = i < I;
      s1d[r * LDN + n] = ok ? to_f(w1d[(long long)(r0 + r) * I + i]) : 0.f;
      s2d[r * LDN + n] = ok ? to_f(w2d[(long long)(r0 + r) * I + i]) : 0.f;
      sd1[idx] = sd2[idx] = 0.f;
    }

    for (int o0 = ob; o0 < oe; o0 += TM) {
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < TM * rc; idx += NT) {
        const int m = idx / rc, r = idx - m * rc;
        const int o = o0 + m;
        const bool ok = o < O;
        s1u[m * RU + r] = ok ? to_f(w1u[(long long)o * R + r0 + r]) : 0.f;
        s2u[m * RU + r] = ok ? to_f(w2u[(long long)o * R + r0 + r]) : 0.f;
      }

      // products over all R (from L1/L2) and t1 = g*gamma*p2, t2 = g*gamma*p1
      // for 2 rows x 4 columns
#pragma unroll
      for (int a = 0; a < TM / BY; ++a) {
        const int m = ty + a * BY;
        const int o = o0 + m;
        float p1[TN / BX], p2[TN / BX];
#pragma unroll
        for (int c = 0; c < TN / BX; ++c) p1[c] = p2[c] = 0.f;
        if (o < O) {
          for (int r = 0; r < R; ++r) {
            const float u1 = to_f(__ldg(w1u + (long long)o * R + r));
            const float u2 = to_f(__ldg(w2u + (long long)o * R + r));
#pragma unroll
            for (int c = 0; c < TN / BX; ++c) {
              const int i = i0 + tx + c * BX;
              if (i < I) {
                p1[c] = fmaf(u1, to_f(__ldg(w1d + (long long)r * I + i)), p1[c]);
                p2[c] = fmaf(u2, to_f(__ldg(w2d + (long long)r * I + i)), p2[c]);
              }
            }
          }
        }
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
      for (int idx = tid; idx < TM * rc; idx += NT) {
        const int m = idx / rc, r = idx - m * rc;
        const int o = o0 + m;
        float u1 = 0.f, u2 = 0.f;
        for (int n = 0; n < TN; ++n) {
          u1 = fmaf(st1[m * LDN + n], s1d[r * LDN + n], u1);
          u2 = fmaf(st2[m * LDN + n], s2d[r * LDN + n], u2);
        }
        if (o < O) {
          const long long at = ((long long)blockIdx.x * O + o) * R + r0 + r;
          pu1[at] = u1;
          pu2[at] = u2;
        }
      }
      // d-grads: add the tile's rows into this block's column sums
      for (int idx = tid; idx < rc * TN; idx += NT) {
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
    for (int idx = tid; idx < rc * TN; idx += NT) {
      const int r = idx / TN, n = idx - r * TN;
      const int i = i0 + n;
      if (i < I) {
        const long long at = ((long long)blockIdx.y * R + r0 + r) * I + i;
        pd1[at] = sd1[idx];
        pd2[at] = sd2[idx];
      }
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
int launch_fast(const T* g, const T* w1d, const T* w1u, const T* w2d, const T* w2u,
                float* part, float* out, int O, int I, int rpb, float scale, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        hada_bwd_r8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FAST_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int gx = (I + FCOLS - 1) / FCOLS, gy = (O + rpb - 1) / rpb;
  float* pu = part;
  float* pd = part + (size_t)gx * O * FU;
  hada_bwd_r8_kernel<T><<<dim3(gx, gy), 32 * FW, FAST_SMEM, st>>>(
      g, w1d, w1u, w2d, w2u, pu, pd, O, I, rpb, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = (long long)O * (FU / 4) + (long long)FU * (I / 4);
  hada_bwd_r8_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(pu, pd, out, O, I,
                                                                           gx, gy);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_generic(const T* g, const T* w1d, const T* w1u, const T* w2d, const T* w2u,
                   float* part, float* out, int O, int I, int R, int rpb, float scale,
                   cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        hada_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)generic_smem_bytes());
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int nu = (I + TN - 1) / TN, nd = (O + rpb - 1) / rpb;
  const long long n_u = (long long)O * R, n_d = (long long)R * I;
  float* pu1 = part;
  float* pu2 = pu1 + nu * n_u;
  float* pd1 = pu2 + nu * n_u;
  float* pd2 = pd1 + nd * n_d;
  float* g1d = out;
  float* g2d = g1d + n_d;
  float* g1u = g2d + n_d;
  float* g2u = g1u + n_u;
  hada_bwd_kernel<T><<<dim3(nu, nd), dim3(BX, BY), generic_smem_bytes(), st>>>(
      g, w1d, w1u, w2d, w2u, pu1, pu2, pd1, pd2, O, I, R, rpb, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = n_u + n_d;
  hada_bwd_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      pu1, pu2, pd1, pd2, g1u, g2u, g1d, g2d, n_u, n_d, nu, nd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* g, const void* w1d, const void* w1u, const void* w2d, const void* w2u,
           float* part, float* out, int O, int I, int R, int rpb, float scale, int fast,
           cudaStream_t st) {
  const T* a = static_cast<const T*>(g);
  const T* b = static_cast<const T*>(w1d);
  const T* c = static_cast<const T*>(w1u);
  const T* d = static_cast<const T*>(w2d);
  const T* e = static_cast<const T*>(w2u);
  if (fast) return launch_fast<T>(a, b, c, d, e, part, out, O, I, rpb, scale, st);
  return launch_generic<T>(a, b, c, d, e, part, out, O, I, R, rpb, scale, st);
}

}  // namespace

// g: (O, I); w1d, w2d: (R, I); w1u, w2u: (O, R); all contiguous, one dtype
// (0 = float32, 1 = bfloat16). out: g1d, g2d (R, I), then g1u, g2u (O, R),
// fp32, one after another. part: fp32 scratch for the partial sums. fast =
// 1 (R = 8, I % 4 == 0, 16-byte aligned pointers): blocks of rpb <= 1024 rows,
// part (ceil(I/128) * O + ceil(O/rpb) * I) * 16 floats. fast = 0: rows per
// block rpb (a multiple of 16), part 2 * (ceil(I/128) * O + ceil(O/rpb) * I)
// * R floats. Both launch their kernel, then the reduction, on ``stream``.
extern "C" int lyc_hada_bwd(const void* g, const void* w1d, const void* w1u, const void* w2d,
                            const void* w2u, float* part, float* out, int O, int I, int R,
                            int rpb, float scale, int dtype, int fast, void* stream) {
  if (O < 1 || I < 1 || R < 1 || rpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (fast ? (R != FR || I % 4 != 0 || rpb > MAX_RPB) : rpb % TM != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(g, w1d, w1u, w2d, w2u, part, out, O, I, R, rpb, scale, fast, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, w1d, w1u, w2d, w2u, part, out, O, I, R, rpb, scale, fast,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}
