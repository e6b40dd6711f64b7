// Fused LoRA matmul: the product with the effective weight
// W_eff = W + scale * up @ down, built tile by tile and never written out:
//   nt:  y  (M, N) = x (M, K) . W_eff^T     (the forward)
//   nn:  dx (M, K) = g (M, N) . W_eff       (the input gradient)
// W is (N, K) in torch layout, in the model's dtype; down (R, K) and up
// (N, R) are fp32 (the adapter factors). Each W_eff tile is W in fp32 plus
// scale * sum_r up * down in fp32, rounded to the activation's dtype before
// the product, as the TPU kernel rounds it; the product accumulates in fp32
// and the result is written in the activation's dtype.
//
// Replaces: lycoris_tpu/ops/lora_fused.py `_call_fused` -> `_fused_kernel_nt`
// and `_fused_kernel_nn` (Pallas, TPU). The TPU kernels carry the fp32
// accumulator across a sequential grid axis over the contraction; here one
// block owns one 128 x 128 output tile and walks the contraction in a loop
// inside the block, so nothing carries over between blocks. The factor that
// does not depend on the contraction tile (nt: the block's rows of up; nn:
// the block's columns of down) is loaded once per block; the other one once
// per contraction tile. Ragged edges in every dimension (attn2 k/v have M =
// batch * 77) are masked: out-of-range loads read zeros, stores are guarded,
// and nothing is padded in memory.
//
// Bound on the H100: the product's 2MNK operations against x, W and y read
// or written once. At the SD1.5 and SDXL attn-mlp shapes that is the bf16
// tensor-core rate for the wide layers and the memory for the narrow ones.
// Rebuilding W_eff costs R multiply-adds per W element per M-tile, on the
// CUDA cores, beside the tensor cores' 128 (BM) per W element.
//
// Design: 256 threads. Per contraction tile of 32: the x tile (128 x 32) and
// the W_eff tile, kept in W's own layout (nt: 128 rows x 32 k; nn: 32 rows x
// 128 k), go to shared memory; each thread builds a 4 x 4 piece of W_eff
// (16 fp32 sums of R products) from loads along W's k axis, so W is read
// coalesced in both directions. bf16 activations take nvcuda::wmma bf16
// 16x16x16 fragments with fp32 accumulators (8 warps, 64 x 32 each; W_eff
// read as a col-major B for nt and a row-major B for nn); fp32 activations
// take a plain FMA kernel (8 x 8 outputs per thread), so fp32 results are
// not rounded through bf16 or TF32. A simple first version: no cp.async or
// TMA pipelining and no wgmma, which are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

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
// shared memory: the x tile, the W_eff tile, the rows of up and the columns
// of down that the W_eff tile needs (fp32, padded to R + 1), and for the
// wmma path one 16 x 16 fp32 staging tile per warp for the guarded stores.
template <typename TX, bool NN>
struct Smem {
  static constexpr int PAD = sizeof(TX) == 2 ? 8 : 1;  // wmma needs ldm % 8 == 0 for bf16
  static constexpr int LDA = BQ + PAD;
  static constexpr int WROWS = NN ? BQ : BP;  // W_eff tile rows (W's row axis)
  static constexpr int WCOLS = NN ? BP : BQ;  // W_eff tile columns (W's k axis)
  static constexpr int LDB = WCOLS + PAD;
  __host__ __device__ static constexpr size_t b_off() { return align128(sizeof(TX) * BM * LDA); }
  __host__ __device__ static constexpr size_t up_off() {
    return b_off() + align128(sizeof(TX) * WROWS * LDB);
  }
  __host__ __device__ static size_t dn_off(int R) {
    return up_off() + align128(sizeof(float) * WROWS * (R + 1));
  }
  __host__ __device__ static size_t st_off(int R) {
    return dn_off(R) + align128(sizeof(float) * WCOLS * (R + 1));
  }
  __host__ __device__ static size_t bytes(int R) {
    return st_off(R) + (sizeof(TX) == 2 ? sizeof(float) * NWARP * 256 : 0);
  }
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
  extern __shared__ __align__(128) unsigned char smem[];
  TX* sA = reinterpret_cast<TX*>(smem);
  TX* sB = reinterpret_cast<TX*>(smem + S::b_off());
  float* sUp = reinterpret_cast<float*>(smem + S::up_off());  // [WROWS][R + 1]
  float* sDn = reinterpret_cast<float*>(smem + S::dn_off(R));  // [WCOLS][R + 1]

  const int P = NN ? K : N;  // output columns
  const int Q = NN ? N : K;  // contraction
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, p0 = blockIdx.x * BP;
  const int RU = R + 1;

  // rows of up for W rows [r0, r0 + WROWS); columns of down for W columns
  // [c0, c0 + WCOLS), stored transposed; zeros beyond the edges
  auto load_up = [&](int r0) {
    for (int idx = tid; idx < WROWS * R; idx += NT) {
      const int i = idx / R, r = idx - i * R;
      const int row = r0 + i;
      sUp[i * RU + r] = row < N ? up[(long long)row * R + r] : 0.f;
    }
  };
  auto load_dn = [&](int c0) {
    for (int idx = tid; idx < R * WCOLS; idx += NT) {
      const int r = idx / WCOLS, j = idx - r * WCOLS;
      const int col = c0 + j;
      sDn[j * RU + r] = col < K ? down[(long long)r * K + col] : 0.f;
    }
  };
  if (NN) load_dn(p0); else load_up(p0);

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
    if (NN) load_up(q0); else load_dn(q0);
    for (int idx = tid; idx < BM * BQ; idx += NT) {
      const int i = idx / BQ, q = idx - i * BQ;
      const int m = m0 + i, qq = q0 + q;
      sA[i * LDA + q] = (m < M && qq < Q) ? a[(long long)m * Q + qq] : from_f<TX>(0.f);
    }
    __syncthreads();

    // W_eff tile: W rows wr0 + tr*4 + i, W columns wc0 + tc*4 + j
    {
      const int wr0 = NN ? q0 : p0, wc0 = NN ? p0 : q0;
      float lr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) lr[i][j] = 0.f;
      for (int r = 0; r < R; ++r) {
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
    float* stage = reinterpret_cast<float*>(smem + S::st_off(R)) + warp * 256;
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
  const size_t smem = Smem<TX, NN>::bytes(R);
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
