// LoHa delta weight backward, the split form: the four factor gradients of
// dW = (w1u @ w1d) * (w2u @ w2d) * gamma in two kernels, each a full pass
// over the cotangent g (O, I):
//   t1 = g * gamma * (w2u @ w2d),  t2 = g * gamma * (w1u @ w1d)
//   u-pass: g1u = t1 @ w1d^T,  g2u = t2 @ w2d^T      (O, R)
//   d-pass: g1d = w1u^T @ t1,  g2d = w2u^T @ t2      (R, I)
// Each pass forms both products and t1, t2 on chip and never writes them
// out.
//
// Replaces: lycoris_tpu/ops/hada.py `_hada_bwd_pallas` (the split form,
// `LYCORIS_TPU_HADA_BWD=split`) -> `_hada_bwd_u_kernel` and
// `_hada_bwd_d_kernel` (Pallas, TPU), which accumulate across the inner,
// sequential grid axis into an output block kept resident. Hopper's blocks
// run in parallel and in no order, so the reduction axis is split over
// blocks too and their partial sums are added in a fixed order.
//
// Bound on the H100: the function's own cost is that of the fused form
// (hada_bwd.cu): g read once, 6R multiply-adds an element, at rank 8 the
// fp32 operations. The split form reads g twice and forms both products
// in each pass, 8R multiply-adds an element: its extra work, not the
// function's.
//
// Two variants, chosen by the caller (ops/hada.py `fast`, `split_grid`):
//
// Fast (R = 8, the path's rank; I a multiple of 4, 16-byte aligned
// tensors): each pass is the rank-8 pass of hada_r8.cuh, the fused form's
// own, built to form one side of the gradients: a thread owns 4
// consecutive columns (16-byte loads of g, kAhead rows in flight a warp in
// a register ring), keeps its columns of w1d/w2d (and in the d-pass its
// d-grad sums) in registers, and reads a row's 2R u-values as broadcast
// loads from shared memory; the row loop never syncs the block.
// - u-pass: the reduction over I is split into strips of 128 columns and
//   the rows into runs, two blocks an SM (at most 128 registers a
//   thread), g 3 rows ahead a warp. A row's u-grads over its strip are
//   summed by the warp's reduce-scatter butterfly and written as a
//   partial: 2R floats per row and strip, an eighth of fp32 g's bytes.
// - d-pass: the columns are split into the same strips and the reduction
//   over O into runs of rows, one wave of one block an SM (the d-grad sums
//   take 64 more registers a thread), g 6 rows ahead a warp. The 8 warps'
//   sums are added in warp order into one partial per block.
// - The fused form's adder then adds both passes' partials in index order:
//   three launches, no float atomics, the same bits on every call.
// - The d-pass and the adder go out as programmatic dependent launches:
//   the d-pass starts on the SMs the u-pass's blocks leave (it reads none
//   of the u-pass's output, but does not exit before the u-pass is done),
//   and the adder's blocks are in place when the d-pass ends. On an H100
//   80GB HBM3 at 700 W that took the fp32 split over a SDXL b4 step's
//   LoHa layers from 16.44-16.54 ms to 15.35 (7%), and a (320, 320) call
//   from 0.0105 to 0.0084 ms (PERF.md, section 6).
// The partials go through HBM and a second launch (they mostly stay in
// L2) rather than through a thread block cluster's distributed shared
// memory: measured by torch.profiler, the adder took 2.4-3.2 us of a call
// (13% of the fast variant's device time over a SDXL step's shapes, 5.6 us
// at (1280, 5120)) before the dependent launch hid most of it; a cluster
// would hold at most 8 of the 10-40 column strips a row's u-grads are
// summed over at the path's widths, and keep a run's u-partials in shared
// memory until its last block is done.
//
// Generic (any other rank or layout; the split's first design): a u-kernel block owns a strip of 16 rows and walks every column
// tile, a d-kernel block owns a strip of 16 columns and walks every row
// tile; each gradient element is summed by one thread in a fixed order.
// 256 threads; tiles of 16 x 64 (u) or 64 x 16 (d) elements of g, four per
// thread. Shared memory holds 32 ranks at a time (about 34 KB whatever R
// is): the tile's rows of w1u/w2u and columns of w1d/w2d for a chunk of
// ranks, t1/t2 of the tile, and the block's gradient sums for one chunk,
// each owned by one thread. The products run over all R a chunk at a
// time; a rank above 32 walks the strip once per chunk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hada_r8.cuh"  // the fast variant's pass and the adder of its partials

namespace {

// ---------------------------------------------------------------------------
// generic variant, any R
// ---------------------------------------------------------------------------

constexpr int NT = 256;
constexpr int STRIP = 16;  // rows (u) or columns (d) a block owns
constexpr int WALK = 64;   // columns (u) or rows (d) of one tile of the walk
constexpr int RC = 32;     // ranks staged at a time
constexpr int RU = RC + 1;

template <bool U>
struct Tile {
  static constexpr int TR = U ? STRIP : WALK;  // rows of a tile
  static constexpr int TC = U ? WALK : STRIP;  // columns of a tile
  static constexpr int LDC = TC + 1;
  static constexpr int EPT = TR * TC / NT;     // elements of a tile per thread
  static constexpr int N_ACC = U ? TR * RC : RC * TC;
};

template <typename T, bool U>
__global__ void __launch_bounds__(NT)
    hada_bwd_split_kernel(const T* __restrict__ g, const T* __restrict__ w1d,
                          const T* __restrict__ w1u, const T* __restrict__ w2d,
                          const T* __restrict__ w2u, float* __restrict__ out1,
                          float* __restrict__ out2, int O, int I, int R, float scale) {
  using Tl = Tile<U>;
  constexpr int TR = Tl::TR, TC = Tl::TC, LDC = Tl::LDC;
  __shared__ float s1u[TR * RU], s2u[TR * RU];      // the tile's rows of w1u/w2u, a rank chunk
  __shared__ float s1d[RC * LDC], s2d[RC * LDC];    // the tile's columns of w1d/w2d, likewise
  __shared__ float st1[TR * LDC], st2[TR * LDC];    // t1, t2 of the tile
  __shared__ float acc1[Tl::N_ACC], acc2[Tl::N_ACC];  // u: [TR][RC]; d: [RC][TC]

  const int tid = threadIdx.x;
  const int row0 = U ? blockIdx.x * STRIP : 0;
  const int col0 = U ? 0 : blockIdx.x * STRIP;

  // ranks [c0, c0 + RC) of the tile's rows of w1u/w2u and of its columns
  // of w1d/w2d (the ranks R has; the loops below read no others): the
  // strip's own slice (u: its rows; d: its columns), the same for every
  // tile of the walk, and the tile's other slice
  auto stage_u = [&](int o0, int c0) {
    const int cn = min(RC, R - c0);
    for (int idx = tid; idx < TR * cn; idx += NT) {
      const int m = idx / cn, r = idx - m * cn;
      const int o = o0 + m;
      const bool ok = o < O;
      s1u[m * RU + r] = ok ? to_f(w1u[(long long)o * R + c0 + r]) : 0.f;
      s2u[m * RU + r] = ok ? to_f(w2u[(long long)o * R + c0 + r]) : 0.f;
    }
  };
  auto stage_d = [&](int i0, int c0) {
    const int cn = min(RC, R - c0);
    for (int idx = tid; idx < cn * TC; idx += NT) {
      const int r = idx / TC, n = idx - r * TC;
      const int i = i0 + n;
      const bool ok = i < I;
      s1d[r * LDC + n] = ok ? to_f(w1d[(long long)(c0 + r) * I + i]) : 0.f;
      s2d[r * LDC + n] = ok ? to_f(w2d[(long long)(c0 + r) * I + i]) : 0.f;
    }
  };
  auto stage_own = [&](int c0) {
    if (U) stage_u(row0, c0); else stage_d(col0, c0);
  };
  auto stage_other = [&](int o0, int i0, int c0) {
    if (U) stage_d(i0, c0); else stage_u(o0, c0);
  };

  // at R <= RC (one chunk) the strip's own slice is staged once per walk
  const bool one = R <= RC;
  const int steps = U ? (I + TC - 1) / TC : (O + TR - 1) / TR;
  for (int r0 = 0; r0 < R; r0 += RC) {  // the ranks whose gradients this pass sums
    const int rc = min(RC, R - r0);
    for (int idx = tid; idx < Tl::N_ACC; idx += NT) acc1[idx] = acc2[idx] = 0.f;
    if (one) stage_own(0);
    for (int s = 0; s < steps; ++s) {
      const int o0 = U ? row0 : s * TR;
      const int i0 = U ? s * TC : col0;
      // both products over all R, a rank chunk at a time, EPT elements a thread
      float p1[Tl::EPT], p2[Tl::EPT];
#pragma unroll
      for (int k = 0; k < Tl::EPT; ++k) p1[k] = p2[k] = 0.f;
      for (int c0 = 0; c0 < R; c0 += RC) {
        __syncthreads();  // the previous readers of the staged chunk are done
        if (!one) stage_own(c0);
        stage_other(o0, i0, c0);
        __syncthreads();
        const int cn = min(RC, R - c0);
#pragma unroll
        for (int k = 0; k < Tl::EPT; ++k) {
          const int e = tid + k * NT, m = e / TC, n = e - m * TC;
          for (int r = 0; r < cn; ++r) {
            p1[k] = fmaf(s1u[m * RU + r], s1d[r * LDC + n], p1[k]);
            p2[k] = fmaf(s2u[m * RU + r], s2d[r * LDC + n], p2[k]);
          }
        }
      }
      if (!one) {  // the contraction below needs the pass's own chunk
        __syncthreads();
        stage_own(r0);
        stage_other(o0, i0, r0);
      }
      // t1 = g * gamma * p2, t2 = g * gamma * p1
#pragma unroll
      for (int k = 0; k < Tl::EPT; ++k) {
        const int e = tid + k * NT, m = e / TC, n = e - m * TC;
        const int o = o0 + m, i = i0 + n;
        const float gv = (o < O && i < I) ? to_f(g[(long long)o * I + i]) * scale : 0.f;
        st1[m * LDC + n] = gv * p2[k];
        st2[m * LDC + n] = gv * p1[k];
      }
      __syncthreads();

      if (U) {
        // g1u[m][r] += sum_n t1[m][n] w1d[r][n];  g2u with t2, w2d
        for (int idx = tid; idx < TR * rc; idx += NT) {
          const int m = idx / rc, r = idx - m * rc;
          float a1 = 0.f, a2 = 0.f;
#pragma unroll 8
          for (int n = 0; n < TC; ++n) {
            a1 = fmaf(st1[m * LDC + n], s1d[r * LDC + n], a1);
            a2 = fmaf(st2[m * LDC + n], s2d[r * LDC + n], a2);
          }
          acc1[m * RC + r] += a1;
          acc2[m * RC + r] += a2;
        }
      } else {
        // g1d[r][n] += sum_m w1u[m][r] t1[m][n];  g2d with w2u, t2
        for (int idx = tid; idx < rc * TC; idx += NT) {
          const int r = idx / TC, n = idx - r * TC;
          float a1 = 0.f, a2 = 0.f;
#pragma unroll 8
          for (int m = 0; m < TR; ++m) {
            a1 = fmaf(s1u[m * RU + r], st1[m * LDC + n], a1);
            a2 = fmaf(s2u[m * RU + r], st2[m * LDC + n], a2);
          }
          acc1[idx] += a1;
          acc2[idx] += a2;
        }
      }
    }

    // each sum is read back by the thread that owns it
    if (U) {
      for (int idx = tid; idx < TR * rc; idx += NT) {
        const int m = idx / rc, r = idx - m * rc;
        const int o = row0 + m;
        if (o < O) {
          out1[(long long)o * R + r0 + r] = acc1[m * RC + r];
          out2[(long long)o * R + r0 + r] = acc2[m * RC + r];
        }
      }
    } else {
      for (int idx = tid; idx < rc * TC; idx += NT) {
        const int r = idx / TC, n = idx - r * TC;
        const int i = col0 + n;
        if (i < I) {
          out1[(long long)(r0 + r) * I + i] = acc1[idx];
          out2[(long long)(r0 + r) * I + i] = acc2[idx];
        }
      }
    }
  }
}

template <typename T, bool U>
int launch(const void* g, const void* w1d, const void* w1u, const void* w2d, const void* w2u,
           float* out1, float* out2, int O, int I, int R, float scale, cudaStream_t st) {
  const int blocks = U ? (O + STRIP - 1) / STRIP : (I + STRIP - 1) / STRIP;
  hada_bwd_split_kernel<T, U><<<blocks, NT, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(w1d), static_cast<const T*>(w1u),
      static_cast<const T*>(w2d), static_cast<const T*>(w2u), out1, out2, O, I, R, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_generic(const void* g, const void* w1d, const void* w1u, const void* w2d,
                   const void* w2u, float* out, int O, int I, int R, float scale,
                   cudaStream_t st) {
  float* g1d = out;
  float* g2d = g1d + (size_t)R * I;
  float* g1u = g2d + (size_t)R * I;
  float* g2u = g1u + (size_t)O * R;
  const int rc = launch<T, true>(g, w1d, w1u, w2d, w2u, g1u, g2u, O, I, R, scale, st);
  if (rc != 0) return rc;
  return launch<T, false>(g, w1d, w1u, w2d, w2u, g1d, g2d, O, I, R, scale, st);
}

constexpr int U_AHEAD = 3, U_BLOCKS = 2;  // u-pass: rows of g in flight a warp, blocks an SM
constexpr int D_AHEAD = 6, D_BLOCKS = 1;  // d-pass: likewise

template <typename T>
int launch_fast(const void* gv, const void* w1dv, const void* w1uv, const void* w2dv,
                const void* w2uv, float* part, float* out, int O, int I, int rpb_u, int rpb_d,
                float scale, cudaStream_t st) {
  const T* g = static_cast<const T*>(gv);
  const T* w1d = static_cast<const T*>(w1dv);
  const T* w1u = static_cast<const T*>(w1uv);
  const T* w2d = static_cast<const T*>(w2dv);
  const T* w2u = static_cast<const T*>(w2uv);
  const int gx = (I + FCOLS - 1) / FCOLS, gy = (O + rpb_d - 1) / rpb_d;
  float* pu = part;
  float* pd = part + (size_t)gx * O * FU;
  cudaError_t e = launch_r8_pass<T, true, false, U_AHEAD, U_BLOCKS>(g, w1d, w1u, w2d, w2u, pu, pd,
                                                                  O, I, rpb_u, scale, st);
  if (e == cudaSuccess)
    e = launch_r8_pass<T, false, true, D_AHEAD, D_BLOCKS>(g, w1d, w1u, w2d, w2u, pu, pd, O, I,
                                                          rpb_d, scale, st, true);
  if (e == cudaSuccess) e = launch_r8_reduce(pu, pd, out, O, I, gy, st, true);
  return static_cast<int>(e);
}

template <typename T>
int launch_any(const void* g, const void* w1d, const void* w1u, const void* w2d, const void* w2u,
               float* part, float* out, int O, int I, int R, int rpb_u, int rpb_d, float scale,
               int fast, cudaStream_t st) {
  if (fast)
    return launch_fast<T>(g, w1d, w1u, w2d, w2u, part, out, O, I, rpb_u, rpb_d, scale, st);
  return launch_generic<T>(g, w1d, w1u, w2d, w2u, out, O, I, R, scale, st);
}

}  // namespace

// g: (O, I); w1d, w2d: (R, I); w1u, w2u: (O, R); all contiguous, one dtype
// (0 = float32, 1 = bfloat16). out: g1d, g2d (R, I), then g1u, g2u (O, R),
// fp32, one after another. fast = 1 (R = 8, I % 4 == 0, 16-byte aligned
// pointers): the u-pass over runs of rpb_u rows, the d-pass over runs of
// rpb_d rows (each <= 1024), then the adder; part: fp32 scratch of
// (ceil(I/128) * O + ceil(O/rpb_d) * I) * 16 floats. fast = 0: the u- and
// d-kernels of the generic variant, part unused. All on ``stream``.
extern "C" int lyc_hada_bwd_split(const void* g, const void* w1d, const void* w1u,
                                  const void* w2d, const void* w2u, float* part, float* out,
                                  int O, int I, int R, int rpb_u, int rpb_d, float scale,
                                  int dtype, int fast, void* stream) {
  if (O < 1 || I < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (fast && (R != FR || I % 4 != 0 || rpb_u < 1 || rpb_u > MAX_RPB || rpb_d < 1 ||
               rpb_d > MAX_RPB))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_any<float>(g, w1d, w1u, w2d, w2u, part, out, O, I, R, rpb_u, rpb_d, scale,
                             fast, st);
  if (dtype == 1)
    return launch_any<__nv_bfloat16>(g, w1d, w1u, w2d, w2u, part, out, O, I, R, rpb_u, rpb_d,
                                     scale, fast, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
