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
// tensors): the pass of hada_r8.cuh forming both the u- and the d-grads,
// g two rows ahead in a ring of three registers, then its adder. A thread
// keeps its columns of w1d/w2d and its d-grad sums in registers, a warp
// sums each row's u-grads by a butterfly of shuffles. The grid is one
// wave, a block an SM (about 240 registers a thread). The caller gives each
// block enough rows that the partials (2R floats per row and column strip,
// 2R per column and block) stay within a quarter of fp32 g's bytes,
// written once and read once. (Letting the last block of each strip add
// them would save the adder's launch, but it piles a strip's u-partials,
// one per column strip and row, onto one block: at I = 5120 that tail
// outweighs the launch.)
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

#include "hada_r8.cuh"  // the fast variant's pass and the adder of its partials

namespace {

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
  const int gx = (I + FCOLS - 1) / FCOLS, gy = (O + rpb - 1) / rpb;
  float* pu = part;
  float* pd = part + (size_t)gx * O * FU;
  cudaError_t e = launch_r8_pass<T, true, true, 2, 1>(g, w1d, w1u, w2d, w2u, pu, pd, O, I, rpb,
                                                      scale, st);
  if (e == cudaSuccess) e = launch_r8_reduce(pu, pd, out, O, I, gy, st);
  return static_cast<int>(e);
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
