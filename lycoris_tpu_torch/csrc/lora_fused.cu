// Fused LoRA matmul: the product with the effective weight
// W_eff = W + scale * up @ down, built tile by tile on chip and never
// written out:
//   nt:  y  (M, N) = x (M, K) . W_eff^T     (the forward)
//   nn:  dx (M, K) = g (M, N) . W_eff       (the input gradient)
// W is (N, K) in torch layout, in the model's dtype; down (R, K) and up
// (N, R) are fp32 (the adapter factors). Each W_eff tile is W in fp32 plus
// scale * sum_r up * down, rounded to the activation's dtype before the
// product, as the TPU kernel rounds it; the product accumulates in fp32 and
// the result is written in the activation's dtype.
//
// Replaces: lycoris_tpu/ops/lora_fused.py `_call_fused` -> `_fused_kernel_nt`
// and `_fused_kernel_nn` (Pallas, TPU). The TPU kernels carry the fp32
// accumulator across a sequential grid axis over the contraction; here a
// block walks the contraction in a loop, so nothing carries over between
// blocks. Ragged edges in every dimension (attn2 k/v have M = batch * 77)
// are masked; nothing is padded in memory.
//
// Bound on the H100: the product's 2MNK operations (bf16 tensor-core rate)
// against x, W and y read or written once; the narrow layers (K = 320) are
// bound by the output's bytes. Rebuilding W_eff costs R multiply-adds per W
// element per row tile, which on the CUDA cores (67 TFLOP/s fp32 against
// 989 bf16) costs as much as the product at R = 8 and 128-row tiles.
//
// Two variants, chosen by the wrapper (ops/lora_fused.py `variant`):
//
// Fast (bf16 x or g, bf16 W: every LoRA leg), namespace `fast`. The
// product is taken transposed, out^T (P, M) = W_eff' (P, C) . a^T, W_eff'
// = W_eff (nt) or W_eff^T (nn), so that both directions share one layout:
// W_eff' is wgmma's A operand and the activation tile its B operand, both
// K-major in shared memory with 128-byte swizzle.
// - A persistent grid (one block an SM) walks output tiles of BM (128 or
//   256, ops/lora_fused.py `fast_plan`) rows of m by 128 columns of p; 384
//   threads: two consumer warpgroups of 64 W_eff rows each and a warpgroup
//   of four W_eff warps, one lane of which issues the loads (setmaxnreg
//   gives their spare registers to the consumers' accumulators).
// - A ring of 4 stages (6 for BM 128) is kept full by TMA: per
//   stage the a tile (BM rows x 64) and the W tile (nt: 128 W rows x 64; nn:
//   64 W rows x 128, two boxes), 2-D tensor maps, ragged edges zero-filled
//   by TMA. A deep ring is what keeps the tensor cores fed: a stage is held
//   from its load through its build to the end of the next stage's wgmma,
//   and a 3-stage ring with a separate W_eff' tile left the consumers
//   waiting on the loads (2.5x the tensor time a stage).
// - The W_eff warps rewrite the stage's W tile in place as the W_eff' tile
//   (128 x 64) while the consumers run the stage before: W by ldmatrix (.trans for nn) into mma
//   fragments, + scale * the rank product on the tensor cores by mma.sync
//   (m16n8k8 for R <= 8; m16n8k16 chunks of 16 ranks for any other R, so
//   shared memory does not grow with R) with the factors rounded to bf16,
//   as the TPU kernel's DEFAULT-precision jnp.dot(up, down) rounds them,
//   then W + scale * dW in fp32, one bf16 rounding, and stmatrix into the
//   swizzled tile; fence.proxy.async and an mbarrier order those writes
//   before the consumers' wgmma read them. The rebuild costs R_pad / BM of
//   the product's tensor work (8 / 256 at the path's rank) and leaves the
//   CUDA cores and the consumers' issue slots alone.
// - The consumers issue the stage's four wgmma m64nBMk16 (A and B from
//   shared memory, the fp32 accumulators in registers) and keep one group
//   in flight; the wait for the group before frees its stage. A first
//   version built W_eff in the consumers' registers as a register A
//   operand: ptxas then serialized every wgmma (C7513: non-wgmma
//   instructions define a wgmma input inside the pipeline), and 128 x 128
//   tiles read from L2 more bytes per product than it delivers, which is
//   why the tile grew to 256 rows.
// - Epilogue: the accumulators (p rows, m columns) go to a per-warpgroup
//   staging box by stmatrix.trans (rows of m, swizzled), 128 rows at a
//   time, then a TMA store clips the ragged edges and drains while the
//   block moves on.
// - Small M (attn2 k/v, M <= 616): where the output tiles fill under the
//   card, the contraction is cut into slices (`fast_plan`); each slice
//   writes fp32 partial sums and a second kernel adds them in slice order,
//   so a repeated call is bit for bit equal.
//
// Generic (fp32 x or g, or an fp32 W; no LoRA leg runs these): 256 threads,
// one 128 x 128 output tile a block, a contraction tile of 32 a loop step;
// the x tile and the W_eff tile, in W's own layout, go to shared memory;
// each thread builds a 4 x 4 piece of W_eff in fp32 on the CUDA cores from
// RCH = 32 ranks of the factors at a time in shared memory. bf16 activations
// take nvcuda::wmma fragments; fp32 activations a plain FMA kernel, so fp32
// results are not rounded through bf16 or TF32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;  // output rows per block
constexpr int BP = 128;  // output columns per block
constexpr int BQ = 32;   // contraction depth per tile
constexpr int NT = 256;  // threads per block
constexpr int NWARP = NT / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout of one block, in bytes from the start of the dynamic
// shared memory: the x tile, the W_eff tile, RCH ranks of the rows of up and
// of the columns of down that the W_eff tile needs (fp32, padded to RCH + 1),
// and for the wmma path one 16 x 16 fp32 staging tile per warp for the
// guarded stores. A rank above RCH is taken RCH ranks at a time, so the
// shared memory does not grow with R.
constexpr int RCH = 32;

template <typename TX, bool NN>
struct Smem {
  static constexpr int PAD = sizeof(TX) == 2 ? 8 : 1;  // wmma needs ldm % 8 == 0 for bf16
  static constexpr int LDA = BQ + PAD;
  static constexpr int WROWS = NN ? BQ : BP;  // W_eff tile rows (W's row axis)
  static constexpr int WCOLS = NN ? BP : BQ;  // W_eff tile columns (W's k axis)
  static constexpr int LDB = WCOLS + PAD;
  static constexpr size_t b_off = align128(sizeof(TX) * BM * LDA);
  static constexpr size_t up_off = b_off + align128(sizeof(TX) * WROWS * LDB);
  static constexpr size_t dn_off = up_off + align128(sizeof(float) * WROWS * (RCH + 1));
  static constexpr size_t st_off = dn_off + align128(sizeof(float) * WCOLS * (RCH + 1));
  static constexpr size_t bytes = st_off + (sizeof(TX) == 2 ? sizeof(float) * NWARP * 256 : 0);
};

// nt (NN false): out (M, N), contraction over K, W_eff tile rows = output
//   columns p (fixed per block), tile columns = contraction q (moving);
// nn (NN true): out (M, K), contraction over N, W_eff tile rows =
//   contraction q (moving), tile columns = output columns p (fixed).
template <typename TX, typename TW, bool NN>
__global__ void __launch_bounds__(NT)
    lora_fused_kernel(const TX* __restrict__ a, const TW* __restrict__ w,
                      const float* __restrict__ down, const float* __restrict__ up,
                      TX* __restrict__ out, int M, int N, int K, int R, float scale) {
  using S = Smem<TX, NN>;
  constexpr int LDA = S::LDA, LDB = S::LDB, WROWS = S::WROWS, WCOLS = S::WCOLS;
  constexpr int RU = RCH + 1;
  extern __shared__ __align__(128) unsigned char smem[];
  TX* sA = reinterpret_cast<TX*>(smem);
  TX* sB = reinterpret_cast<TX*>(smem + S::b_off);
  float* sUp = reinterpret_cast<float*>(smem + S::up_off);  // [WROWS][RCH + 1]
  float* sDn = reinterpret_cast<float*>(smem + S::dn_off);  // [WCOLS][RCH + 1]

  const int P = NN ? K : N;  // output columns
  const int Q = NN ? N : K;  // contraction
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, p0 = blockIdx.x * BP;

  // ranks [rc, rc + rn) of the rows of up for W rows [r0, r0 + WROWS), and
  // of the columns of down for W columns [c0, c0 + WCOLS), stored
  // transposed; zeros beyond the edges
  auto load_up = [&](int r0, int rc, int rn) {
    for (int idx = tid; idx < WROWS * rn; idx += NT) {
      const int i = idx / rn, r = idx - i * rn;
      const int row = r0 + i;
      sUp[i * RU + r] = row < N ? up[(long long)row * R + rc + r] : 0.f;
    }
  };
  auto load_dn = [&](int c0, int rc, int rn) {
    for (int idx = tid; idx < rn * WCOLS; idx += NT) {
      const int r = idx / WCOLS, j = idx - r * WCOLS;
      const int col = c0 + j;
      sDn[j * RU + r] = col < K ? down[(long long)(rc + r) * K + col] : 0.f;
    }
  };
  // one chunk holds every rank: the factor that does not move with the
  // contraction is loaded once
  const bool one = R <= RCH;
  if (one) {
    if (NN) load_dn(p0, 0, R); else load_up(p0, 0, R);
  }

  // the thread's 4 x 4 piece of the W_eff tile (CT pieces along W's k axis)
  constexpr int CT = WCOLS / 4;
  const int tc = tid % CT, tr = tid / CT;

  // fp32 path: 8 x 8 outputs per thread, rows ty + 16 i, columns tx + 16 j
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
  // bf16 path: warp (wm, wn) owns rows wm * 64 .. +64, columns wn * 32 .. +32
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> cf[4][2];
  if constexpr (sizeof(TX) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(cf[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int q0 = 0; q0 < Q; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    if (one) {
      if (NN) load_up(q0, 0, R); else load_dn(q0, 0, R);
    }
    for (int idx = tid; idx < BM * BQ; idx += NT) {
      const int i = idx / BQ, q = idx - i * BQ;
      const int m = m0 + i, qq = q0 + q;
      sA[i * LDA + q] = (m < M && qq < Q) ? a[(long long)m * Q + qq] : from_f<TX>(0.f);
    }

    // W_eff tile: W rows wr0 + tr*4 + i, W columns wc0 + tc*4 + j
    {
      const int wr0 = NN ? q0 : p0, wc0 = NN ? p0 : q0;
      float lr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) lr[i][j] = 0.f;
      for (int rc = 0; rc < R; rc += RCH) {
        const int rn = min(RCH, R - rc);
        if (!one) {
          if (rc > 0) __syncthreads();  // the previous chunk's readers are done
          load_up(wr0, rc, rn);
          load_dn(wc0, rc, rn);
        }
        __syncthreads();
        for (int r = 0; r < rn; ++r) {
          float u[4], d[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) u[i] = sUp[(tr * 4 + i) * RU + r];
#pragma unroll
          for (int j = 0; j < 4; ++j) d[j] = sDn[(tc * 4 + j) * RU + r];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) lr[i][j] = fmaf(u[i], d[j], lr[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wr0 + tr * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wc0 + tc * 4 + j;
          const float wv = (row < N && col < K) ? to_f(w[(long long)row * K + col]) : 0.f;
          sB[(tr * 4 + i) * LDB + tc * 4 + j] = from_f<TX>(fmaf(scale, lr[i][j], wv));
        }
      }
    }
    __syncthreads();

    if constexpr (sizeof(TX) == 2) {
      using namespace nvcuda;
#pragma unroll
      for (int kk = 0; kk < BQ; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wmma::load_matrix_sync(af[i], sA + (wm * 64 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pc = wn * 32 + j * 16;
          if constexpr (NN) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, sB + kk * LDB + pc, LDB);
#pragma unroll
            for (int i = 0; i < 4; ++i) wmma::mma_sync(cf[i][j], af[i], bfr, cf[i][j]);
          } else {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
            wmma::load_matrix_sync(bfr, sB + pc * LDB + kk, LDB);
#pragma unroll
            for (int i = 0; i < 4; ++i) wmma::mma_sync(cf[i][j], af[i], bfr, cf[i][j]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int q = 0; q < BQ; ++q) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_f(sA[(ty + 16 * i) * LDA + q]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          bv[j] = to_f(NN ? sB[q * LDB + tx + 16 * j] : sB[(tx + 16 * j) * LDB + q]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  if constexpr (sizeof(TX) == 2) {
    float* stage = reinterpret_cast<float*>(smem + S::st_off) + warp * 256;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        nvcuda::wmma::store_matrix_sync(stage, cf[i][j], 16, nvcuda::wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int m = m0 + wm * 64 + i * 16 + e / 16;
          const int p = p0 + wn * 32 + j * 16 + e % 16;
          if (m < M && p < P) out[(long long)m * P + p] = from_f<TX>(stage[e]);
        }
        __syncwarp();
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + tx + 16 * j;
        if (p < P) out[(long long)m * P + p] = from_f<TX>(acc[i][j]);
      }
    }
  }
}

template <typename TX, typename TW, bool NN>
int launch(const void* a, const void* w, const float* down, const float* up, void* out, int M,
           int N, int K, int R, float scale, cudaStream_t st) {
  const size_t smem = Smem<TX, NN>::bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lora_fused_kernel<TX, TW, NN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int P = NN ? K : N;
  const dim3 grid((P + BP - 1) / BP, (M + BM - 1) / BM);
  lora_fused_kernel<TX, TW, NN><<<grid, NT, smem, st>>>(
      static_cast<const TX*>(a), static_cast<const TW*>(w), down, up, static_cast<TX*>(out), M,
      N, K, R, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool NN>
int dispatch(const void* a, const void* w, const float* down, const float* up, void* out, int M,
             int N, int K, int R, float scale, int adtype, int wdtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (adtype == 0 && wdtype == 0)
    return launch<float, float, NN>(a, w, down, up, out, M, N, K, R, scale, st);
  if (adtype == 0 && wdtype == 1)
    return launch<float, bf16, NN>(a, w, down, up, out, M, N, K, R, scale, st);
  if (adtype == 1 && wdtype == 0)
    return launch<bf16, float, NN>(a, w, down, up, out, M, N, K, R, scale, st);
  if (adtype == 1 && wdtype == 1)
    return launch<bf16, bf16, NN>(a, w, down, up, out, M, N, K, R, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ===========================================================================
// Fast variant: bf16 activations and bf16 W (the dtypes of every LoRA leg)
// ===========================================================================

namespace fast {

constexpr int BP = 128;   // output columns p of a tile: two consumer warpgroups of 64
constexpr int BC = 64;    // contraction per stage: one 128-byte swizzled row of bf16
constexpr int NTH = 384;  // consumers: warps 0-7; W_eff warps: 8-11 (lane 0 of 8 loads)
constexpr int W_BYTES = BP * BC * 2;  // W tile, rewritten in place as the W_eff' tile
constexpr int STG = 128 * 64 * 2;     // a consumer warpgroup's output box: [128 m][64 p]
// setmaxnreg: the W_eff warpgroup gives registers to the consumers. A
// block keeps the registers it launched with (384 x 168), so what the
// consumers gain is what that warpgroup gives up: 128 x 64 frees 256 x 32
// (a count above 200 would wait forever). A block of 13 or 16 warps
// launches at 128 registers a thread, and ptxas refused the m64n256 wgmma
// (154 needed) there: hence 384 threads, the loads issued by a W_eff warp.
constexpr int WEFF_REGS = 104, CONSUMER_REGS = 200;

// a stage: the a tile ([BM rows][64], swizzled) and the W tile (nt: [128 W
// rows][64 k]; nn: two [64 W rows][64 k] boxes), which the W_eff warps rewrite
// in place as the W_eff' tile ([128 p rows][64 c], swizzled)
template <int BM>
struct Cfg {
  static constexpr int ST = BM == 256 ? 4 : 6;  // ring stages
  static constexpr int A_BYTES = BM * BC * 2;
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int BAR_OFF = ST * STAGE + 2 * STG;
  static constexpr int SMEM = BAR_OFF + 24 * ST + 1024;  // + barriers and alignment slack
};

__device__ __forceinline__ uint32_t bf2(float lo, float hi) { return hop::pack_bf16(lo, hi); }
__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// d (16 x 8) += a (16 x 8) . b (8 x 8), and the same over a depth of 16:
// bf16 operands, fp32 accumulators, the mma.sync fragment layouts
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The adapter factors as the rank product reads them: f(p, r) follows the
// output columns (nt: up[p][r]; nn: down[r][p]), v(c, r) the contraction
// (nt: down[r][c]; nn: up[c][r]); zero outside P, C and R.
template <bool NN>
struct Factors {
  const float* __restrict__ down;
  const float* __restrict__ up;
  int P, C, R, K;
  __device__ __forceinline__ float f(int p, int r) const {
    if (p >= P || r >= R) return 0.f;
    return NN ? __ldg(down + (long long)r * K + p) : __ldg(up + (long long)p * R + r);
  }
  __device__ __forceinline__ float v(int c, int r) const {
    if (c >= C || r >= R) return 0.f;
    return NN ? __ldg(up + (long long)c * R + r) : __ldg(down + (long long)r * K + c);
  }
};

// Tile t of the persistent walk: p tile fastest, then m tile, then the
// slice of the contraction (stages [j0, j1)).
struct Tile {
  int p0, m0, sp, j0, j1;
  __device__ __forceinline__ Tile() : p0(0), m0(0), sp(0), j0(0), j1(0) {}
  __device__ __forceinline__ Tile(int t, int np, int nm, int bm, int steps, int cps) {
    const int pt = t % np, mt = (t / np) % nm;
    sp = t / (np * nm);
    p0 = pt * BP;
    m0 = mt * bm;
    j0 = sp * cps;
    j1 = min(steps, j0 + cps);
  }
};

// A W_eff warp's 16-row blocks bi and bi + 4 of the stage's
// W_eff' tile, rows [16 blk, 16 blk + 16): W by ldmatrix from the W tile
// (.trans for nn, whose W_eff' rows are W's columns) straight into mma
// fragments, + scale * the rank product by mma.sync (factors rounded to
// bf16; RK 8: one m16n8k8 for R <= 8, the output-column factor held for the
// tile in ``fa``; RK 16: chunks of 16 ranks from L1/L2), one bf16 rounding,
// then stmatrix over the W tile, in place. For nn a warp reads W rows that
// other warps overwrite, so every W_eff warp reads all its fragments first
// and the four meet at a barrier before any writes. (Loading nn's W tile as
// eight 16-column boxes, each in the bytes of its own W_eff' rows, needs
// no barrier but made the loads slower than the barrier costs.)
template <bool NN, int RK>
__device__ __forceinline__ void build_stage(uint32_t wt, const Factors<NN>& fac,
                                            const uint32_t (&fa)[2][2],
                                            const uint32_t (&fb)[4][2], int bi, int p0, int c0,
                                            int lane, float scale) {
  const int g = lane >> 2, t4 = lane & 3, li = lane >> 3, lr = lane & 7;
  uint32_t wf[2][4][4];
  if constexpr (NN) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pb = 16 * (bi + 4 * i);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int n = 16 * kk + (li >> 1) * 8 + lr;
        const int cp = (pb >> 3) + (li & 1);
        hop::ldsm_x4<true>(wf[i][kk],
                           wt + (cp >> 3) * (W_BYTES / 2) + n * 128 + (((cp & 7) ^ lr) << 4));
      }
    }
    hop::named_bar(3, 128);
  }
  // a block's eight rank products first, then its sums and stores: the
  // mma.sync of the four 16-column slices run back to back instead of
  // each waiting on the one before's stores
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pb = 16 * (bi + 4 * i);
    const int prow = pb + (li & 1) * 8 + lr;  // the row whose address the lane gives
    if constexpr (!NN) {  // nt reads and rewrites only its own rows: no barrier
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::ldsm_x4<false>(wf[i][kk], wt + prow * 128 + (((2 * kk + (li >> 1)) ^ lr) << 4));
    }
    float d[4][2][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[kk][h][e] = 0.f;
    if constexpr (RK == 8) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_k8(d[kk][0], fa[i][0], fa[i][1], fb[kk][0]);
        mma_k8(d[kk][1], fa[i][0], fa[i][1], fb[kk][1]);
      }
    } else {
      const int pr = p0 + pb + g;
      for (int rc = 0; rc < fac.R; rc += 16) {
        const int r0 = rc + 2 * t4;
        const uint32_t a[4] = {bf2(fac.f(pr, r0), fac.f(pr, r0 + 1)),
                               bf2(fac.f(pr + 8, r0), fac.f(pr + 8, r0 + 1)),
                               bf2(fac.f(pr, r0 + 8), fac.f(pr, r0 + 9)),
                               bf2(fac.f(pr + 8, r0 + 8), fac.f(pr + 8, r0 + 9))};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = c0 + 16 * kk + 8 * h + g;
            mma_k16(d[kk][h], a, bf2(fac.v(c, r0), fac.v(c, r0 + 1)),
                    bf2(fac.v(c, r0 + 8), fac.v(c, r0 + 9)));
          }
      }
    }
    uint32_t e[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t(&w)[4] = wf[i][kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float(&dq)[4] = d[kk][q >> 1];
        e[kk][q] = bf2(fmaf(scale, dq[(q & 1) * 2], lo_f(w[q])),
                       fmaf(scale, dq[(q & 1) * 2 + 1], hi_f(w[q])));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::stsm_x4<false>(wt + prow * 128 + (((2 * kk + (li >> 1)) ^ lr) << 4), e[kk][0],
                          e[kk][1], e[kk][2], e[kk][3]);
  }
}

// Tiles of BM x 128 outputs (and, with splits > 1, one of ``splits``
// slices of the contraction), walked by a persistent grid. The product is
// taken transposed: out^T (p, m) = W_eff' (p, c) . a^T, W_eff' = W_eff (nt)
// or W_eff^T (nn), both A operands from shared memory, K-major.
template <bool NN, int RK, int BM>
__global__ void __launch_bounds__(NTH, 1)
    lora_fast_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mw,
                     const __grid_constant__ CUtensorMap my, const float* __restrict__ down,
                     const float* __restrict__ up, float* __restrict__ ws, int M, int N, int K,
                     int R, float scale, int splits) {
  using CF = Cfg<BM>;
  constexpr int ST = CF::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (hop::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + CF::BAR_OFF);  // a and W tiles landed
  uint64_t* built = full + ST;                                      // W_eff tile written
  uint64_t* empty = built + ST;                                     // stage consumed
  const int P = NN ? K : N, C = NN ? N : K;
  const int np = (P + BP - 1) / BP, nm = (M + BM - 1) / BM;
  const int steps = (C + BC - 1) / BC, cps = (steps + splits - 1) / splits;
  const int tiles = np * nm * splits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Factors<NN> fac{down, up, P, C, R, K};

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hop::mbar_init(full + s, 1);
      hop::mbar_init(built + s, 128);  // every W_eff thread
      hop::mbar_init(empty + s, 8);    // lane 0 of each consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    hop::reg_dealloc<WEFF_REGS>();
    int it = 0;
    // the loads: lane 0 of warp 8 walks the block's stages ahead of the
    // W_eff warps, ST - 1 of them at the start, then one after each build,
    // into the slot of the stage the consumers run meanwhile (it waits for
    // them to hand it back)
    const bool loader = warp == 8 && lane == 0;
    int tp = blockIdx.x, jp = 0, itp = 0;
    Tile TP;
    if (tp < tiles) {
      TP = Tile(tp, np, nm, BM, steps, cps);
      jp = TP.j0;
    }
    auto load_next = [&]() {
      if (tp >= tiles) return;
      const int s = itp % ST;
      if (itp >= ST) hop::mbar_wait(empty + s, ((itp / ST) - 1) & 1);
      unsigned char* st = sm + s * CF::STAGE;
      hop::mbar_expect_tx(full + s, CF::A_BYTES + W_BYTES);
      hop::tma_2d(st, &ma, full + s, jp * BC, TP.m0);
      if (NN) {  // W rows = the stage's contraction, columns = the tile's outputs
        hop::tma_2d(st + CF::A_BYTES, &mw, full + s, TP.p0, jp * BC);
        hop::tma_2d(st + CF::A_BYTES + W_BYTES / 2, &mw, full + s, TP.p0 + 64, jp * BC);
      } else {
        hop::tma_2d(st + CF::A_BYTES, &mw, full + s, jp * BC, TP.p0);
      }
      ++itp;
      if (++jp >= TP.j1) {
        tp += gridDim.x;
        if (tp < tiles) {
          TP = Tile(tp, np, nm, BM, steps, cps);
          jp = TP.j0;
        }
      }
    };
    if (loader)
      for (int k = 0; k < ST - 1; ++k) load_next();
    __syncwarp();
    // W_eff warps: warp bi writes the 16-row blocks bi and bi + 4 of each
    // stage's W_eff' tile. RK 8: the factor fragments of the next
    // stage (and, at a tile's last stage, of the next tile) are loaded
    // while this one is built, so their L2 latency (shared memory leaves
    // little L1) is not on their path.
    const int bi = warp - 8, g = lane >> 2, t4 = lane & 3;
    uint32_t fa[2][2] = {}, fb[4][2] = {};
    float fa_n[2][2][2] = {}, fb_n[4][2][2] = {};  // the next fragments, as loaded
    auto load_fa = [&](int p0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pr = p0 + 16 * (bi + 4 * i) + 8 * e + g;
          fa_n[i][e][0] = fac.f(pr, 2 * t4);
          fa_n[i][e][1] = fac.f(pr, 2 * t4 + 1);
        }
    };
    auto load_fb = [&](int c0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + 16 * kk + 8 * h + g;
          fb_n[kk][h][0] = fac.v(c, 2 * t4);
          fb_n[kk][h][1] = fac.v(c, 2 * t4 + 1);
        }
    };
    if constexpr (RK == 8) {
      if (blockIdx.x < tiles) {
        const Tile T(blockIdx.x, np, nm, BM, steps, cps);
        load_fa(T.p0);
        load_fb(T.j0 * BC);
      }
    }
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile T(t, np, nm, BM, steps, cps);
      for (int j = T.j0; j < T.j1; ++j, ++it) {
        const int s = it % ST;
        if constexpr (RK == 8) {
          if (j == T.j0) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) fa[i][e] = bf2(fa_n[i][e][0], fa_n[i][e][1]);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int h = 0; h < 2; ++h) fb[kk][h] = bf2(fb_n[kk][h][0], fb_n[kk][h][1]);
          if (j + 1 < T.j1) {
            load_fb((j + 1) * BC);
          } else if (t + gridDim.x < tiles) {
            const Tile U(t + gridDim.x, np, nm, BM, steps, cps);
            load_fa(U.p0);
            load_fb(U.j0 * BC);
          }
        }
        hop::mbar_wait(full + s, (it / ST) & 1);
        build_stage<NN, RK>(hop::smem_addr(sm + s * CF::STAGE + CF::A_BYTES), fac, fa, fb, bi,
                            T.p0, j * BC, lane, scale);
        hop::fence_proxy_async();  // the W_eff' writes, before wgmma reads them
        hop::mbar_arrive(built + s);
        if (loader) load_next();
        __syncwarp();
      }
    }
    return;
  }

  // consumers: warpgroup wg owns W_eff rows [64 wg, 64 wg + 64) of the tile
  hop::reg_alloc<CONSUMER_REGS>();
  const int wg = warp >> 2, wq = warp & 3, wtid = tid & 127;
  const int li = lane >> 3, lr = lane & 7;
  unsigned char* stg = sm + ST * CF::STAGE + wg * STG;
  const uint32_t stg_a = hop::smem_addr(stg);
  float acc[BM / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile T(t, np, nm, BM, steps, cps);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int j = T.j0; j < T.j1; ++j, ++it) {
      const int s = it % ST;
      hop::mbar_wait(full + s, (it / ST) & 1);
      hop::mbar_wait(built + s, (it / ST) & 1);
      const uint32_t at = hop::smem_addr(sm + s * CF::STAGE);
      const uint32_t et = at + CF::A_BYTES + wg * (64 * 128);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::Wgmma<BM>::template ss<0>(acc, hop::desc_sw128(et + kk * 32),
                                      hop::desc_sw128(at + kk * 32), 1);
      hop::wg_commit();
      hop::wg_wait<1>();  // the stage before is read: hand it back
      if (prev >= 0 && lane == 0) hop::mbar_arrive(empty + prev);
      prev = s;
    }
    hop::wg_wait<0>();
    hop::fence_regs(acc);
    if (prev >= 0 && lane == 0) hop::mbar_arrive(empty + prev);

    if (splits == 1) {
      // bf16, 128 rows of m at a time: stmatrix.trans into the warpgroup's
      // staging box (rows of m, swizzled), then one TMA store, which clips
      // the ragged edges and drains while the next rows or tile run
#pragma unroll
      for (int h = 0; h < BM / 128; ++h) {
        if (wtid == 0) hop::bulk_wait_read();  // the last store has read the box
        hop::named_bar(1 + wg, 128);
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          const int q = 16 * h + j;  // the n8 slab of m in the accumulators
          const int m = 8 * j + (li >> 1) * 8 + lr;
          const int ch = 2 * wq + (li & 1);
          hop::stsm_x4<true>(stg_a + m * 128 + ((ch ^ lr) << 4), bf2(acc[4 * q], acc[4 * q + 1]),
                             bf2(acc[4 * q + 2], acc[4 * q + 3]),
                             bf2(acc[4 * q + 4], acc[4 * q + 5]),
                             bf2(acc[4 * q + 6], acc[4 * q + 7]));
        }
        hop::fence_proxy_async();
        hop::named_bar(1 + wg, 128);
        if (wtid == 0 && T.p0 + 64 * wg < P && T.m0 + 128 * h < M) {
          hop::tma_store_2d(&my, stg, T.p0 + 64 * wg, T.m0 + 128 * h);
          hop::bulk_commit();
        }
      }
    } else {
      // fp32 partial sums of the slice; lanes t4 of a row g write one
      // 32-byte sector
      float* wp = ws + (long long)T.sp * M * P;
      const int p = T.p0 + 64 * wg + 16 * wq + (lane >> 2), t4 = lane & 3;
#pragma unroll
      for (int q = 0; q < BM / 8; ++q) {
        const int m = T.m0 + 8 * q + 2 * t4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (m + e >= M) continue;
          float* row = wp + (long long)(m + e) * P;
          if (p < P) row[p] = acc[4 * q + e];
          if (p + 8 < P) row[p + 8] = acc[4 * q + 2 + e];
        }
      }
    }
  }
  if (wtid == 0) hop::bulk_wait_read();
}

// y = the slices' fp32 partial sums added in slice order, rounded to bf16
__global__ void __launch_bounds__(256)
    lora_fast_reduce(const float4* __restrict__ ws, uint2* __restrict__ y, long long n4,
                     int splits) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  float4 a = ws[i];
  for (int s = 1; s < splits; ++s) {
    const float4 b = ws[s * n4 + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  y[i] = make_uint2(bf2(a.x, a.y), bf2(a.z, a.w));
}

template <bool NN, int RK, int BM>
int launch(const void* a, const void* w, const float* down, const float* up, void* out,
           float* ws, int M, int N, int K, int R, float scale, int splits, int grid,
           cudaStream_t st) {
  const int P = NN ? K : N, C = NN ? N : K;
  CUtensorMap ma, mw, my;
  if (!hop::make_map_2d(&ma, a, M, C, BM) || !hop::make_map_2d(&mw, w, N, K, NN ? 64 : BP) ||
      !hop::make_map_2d(&my, out, M, P, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        lora_fast_kernel<NN, RK, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BM>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  lora_fast_kernel<NN, RK, BM><<<grid, NTH, Cfg<BM>::SMEM, st>>>(ma, mw, my, down, up, ws, M, N, K,
                                                                 R, scale, splits);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long n4 = static_cast<long long>(M) * P / 4;
    lora_fast_reduce<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, st>>>(
        reinterpret_cast<const float4*>(ws), static_cast<uint2*>(out), n4, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool NN, int BM>
int launch_rank(const void* a, const void* w, const float* down, const float* up, void* out,
                float* ws, int M, int N, int K, int R, float scale, int splits, int grid,
                cudaStream_t st) {
  return R <= 8 ? launch<NN, 8, BM>(a, w, down, up, out, ws, M, N, K, R, scale, splits, grid, st)
                : launch<NN, 16, BM>(a, w, down, up, out, ws, M, N, K, R, scale, splits, grid, st);
}

}  // namespace fast

}  // namespace

// x: (M, K) in adtype; w: (N, K) in wdtype; down: (R, K) and up: (N, R) fp32;
// y: (M, N) in adtype. All contiguous. dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int lyc_lora_fused_nt(const void* x, const void* w, const float* down,
                                 const float* up, void* y, int M, int N, int K, int R,
                                 float scale, int adtype, int wdtype, void* stream) {
  return dispatch<false>(x, w, down, up, y, M, N, K, R, scale, adtype, wdtype, stream);
}

// g: (M, N) in adtype; w, down, up as above; dx: (M, K) in adtype.
extern "C" int lyc_lora_fused_nn(const void* g, const void* w, const float* down,
                                 const float* up, void* dx, int M, int N, int K, int R,
                                 float scale, int adtype, int wdtype, void* stream) {
  return dispatch<true>(g, w, down, up, dx, M, N, K, R, scale, adtype, wdtype, stream);
}

// The fast variant (bf16 a and w; N % 8 == 0, K % 8 == 0, a, w and out
// 16-byte aligned): nn = 0 computes y = a . W_eff^T (a = x), nn = 1 dx =
// a . W_eff (a = g), in tiles of ``bm`` (128 or 256) rows by 128 columns.
// ``grid`` persistent blocks; with ``splits`` > 1 the contraction is cut
// into that many slices whose fp32 partials go to ``ws`` (splits x M x the
// output width) and are added in order by a second kernel.
extern "C" int lyc_lora_fused_fast(const void* a, const void* w, const float* down,
                                   const float* up, void* out, float* ws, int M, int N, int K,
                                   int R, float scale, int nn, int bm, int splits, int grid,
                                   void* stream) {
  if (M < 1 || N < 1 || K < 1 || R < 1 || splits < 1 || grid < 1 || N % 8 || K % 8 ||
      (bm != 128 && bm != 256) || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nn)
    return bm == 256 ? fast::launch_rank<true, 256>(a, w, down, up, out, ws, M, N, K, R, scale,
                                                    splits, grid, st)
                     : fast::launch_rank<true, 128>(a, w, down, up, out, ws, M, N, K, R, scale,
                                                    splits, grid, st);
  return bm == 256 ? fast::launch_rank<false, 256>(a, w, down, up, out, ws, M, N, K, R, scale,
                                                   splits, grid, st)
                   : fast::launch_rank<false, 128>(a, w, down, up, out, ws, M, N, K, R, scale,
                                                   splits, grid, st);
}
