// LayerNorm backward over the last dim: dx, and optionally dw and db.
//
// Replaces: lycoris_tpu/ops/layer_norm.py `_vjp_bwd` -> `_bwd_kernel`
// (Pallas, TPU). Same math: the row statistics are recomputed from x in
// fp32 (two passes, as the forward), x^ = (x - mean) * rstd, and
//   dx = (w*dy - x^ * mean(w*dy*x^) - mean(w*dy)) * rstd,
//   dw = sum over rows of dy*x^,  db = sum over rows of dy.
//
// Bound on the H100: memory. Each element of x and dy is read once and dx
// written once (6 bytes in bf16) against ~12 FLOPs.
//
// Two variants, chosen by the caller (ops/layer_norm.py `bwd_lanes`):
//
// Vectorised (every LayerNorm width of the SD1.5 and SDXL paths): a group
// of L lanes of one warp owns a row, so a warp walks 32 / L rows at once.
// Lane j holds the row's 16-byte vectors j, j + L, j + 2L, ... of x and dy
// in registers, kVecs = 5 of them (5 * L * 8 = C in bf16: L = C / 40 at
// C = 320, 640 and 1280; the caller picks L), loaded once with 16-byte
// loads, neighbouring lanes on neighbouring addresses. The mean and
// mean(w*dy), then the centred variance and mean(w*dy*x^), are two rounds
// of xor-shuffle reductions inside the group, all from the registers, and
// dx is written with 16-byte stores: device memory sees one read of x and
// dy and one write of dx. Each lane loads its slice of w once for all the
// rows it walks. A block has 8 warps, or fewer until the grid has 8 blocks
// an SM. A lane's columns are the same in every row, so with dw/db it
// keeps their sums in registers; at the end the groups of a warp are added
// by a fixed xor butterfly, the warps of a block in warp order through
// shared memory into one partial row per block, and a second kernel adds
// the partial rows in order: no atomics, so the result does not depend on
// scheduling.
//
// Generic (any other width, or a tensor not 16-byte aligned; no path shape
// in bf16 takes it): one warp owns a row and re-reads it from L1 with
// scalar loads; its dw/db sums live per warp in shared memory, one partial
// row per block.
//
// When the caller needs no dw/db (frozen LayerNorm weights, as on the
// training path) the sums and the second kernel are skipped.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ln.cuh"

namespace {

constexpr int kWarps = 4;  // warps per block of the generic variant

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
    ln_bwd_generic_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const T* __restrict__ w, T* __restrict__ dx,
                          float* __restrict__ dw_part, float* __restrict__ db_part, int rows,
                          int cols, float eps) {
  extern __shared__ float sums[];  // [kWarps][2][cols] when dw/db are wanted
  const int warp = threadIdx.y, lane = threadIdx.x;
  const bool want_wb = dw_part != nullptr;
  float* sdw = sums + warp * 2 * cols;
  float* sdb = sdw + cols;
  if (want_wb)
    for (int c = lane; c < cols; c += 32) sdw[c] = sdb[c] = 0.f;

  const float inv_c = 1.f / cols;
  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const T* xr = x + (long long)row * cols;
    const T* dyr = dy + (long long)row * cols;
    T* dxr = dx + (long long)row * cols;

    float s = 0.f;
    for (int c = lane; c < cols; c += 32) s += to_f(xr[c]);
    const float mean = warp_sum(s) * inv_c;
    float ss = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float d = to_f(xr[c]) - mean;
      ss += d * d;
    }
    const float rstd = rsqrtf(warp_sum(ss) * inv_c + eps);

    float a1 = 0.f, a2 = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float xh = (to_f(xr[c]) - mean) * rstd;
      const float g = to_f(dyr[c]);
      const float wdy = g * to_f(w[c]);
      a1 += wdy * xh;
      a2 += wdy;
      if (want_wb) {
        sdw[c] += g * xh;
        sdb[c] += g;
      }
    }
    const float c1 = warp_sum(a1) * inv_c, c2 = warp_sum(a2) * inv_c;
    for (int c = lane; c < cols; c += 32) {
      const float xh = (to_f(xr[c]) - mean) * rstd;
      const float wdy = to_f(dyr[c]) * to_f(w[c]);
      dxr[c] = from_f<T>((wdy - xh * c1 - c2) * rstd);
    }
  }
  if (!want_wb) return;
  __syncthreads();
  for (int c = warp * 32 + lane; c < cols; c += 32 * kWarps) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      a += sums[k * 2 * cols + c];
      b += sums[k * 2 * cols + cols + c];
    }
    dw_part[(long long)blockIdx.x * cols + c] = a;
    db_part[(long long)blockIdx.x * cols + c] = b;
  }
}

// dw[c] = sum of dw_part[p][c] over the partial rows p (likewise db): a
// 32-column by 32-row block, each thread summing every 32nd partial row,
// then the 32 row sums of each column added in shared memory in order.
__global__ void __launch_bounds__(1024)
    ln_bwd_reduce_kernel(const float* __restrict__ dw_part, const float* __restrict__ db_part,
                         float* __restrict__ dw, float* __restrict__ db, int nparts,
                         int cols) {
  __shared__ float sw[32][33];
  __shared__ float sb[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, b = 0.f;
  if (c < cols) {
    for (int p = ty; p < nparts; p += 32) {
      a += dw_part[(long long)p * cols + c];
      b += db_part[(long long)p * cols + c];
    }
  }
  sw[ty][tx] = a;
  sb[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < cols) {
    float ta = 0.f, tb = 0.f;
    for (int k = 0; k < 32; ++k) {
      ta += sw[k][tx];
      tb += sb[k][tx];
    }
    dw[c] = ta;
    db[c] = tb;
  }
}

template <typename T>
int launch_generic(const void* x, const void* dy, const void* w, void* dx, float* dw_part,
                   float* db_part, int rows, int cols, int nparts, float eps, cudaStream_t st) {
  const size_t smem = dw_part ? (size_t)kWarps * 2 * cols * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_generic_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ln_bwd_generic_kernel<T><<<nparts, dim3(32, kWarps), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w),
      static_cast<T*>(dx), dw_part, db_part, rows, cols, eps);
  return 0;
}

// ---------------------------------------------------------------------------
// vectorised variant
// ---------------------------------------------------------------------------

template <typename T, bool WB>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ln_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const T* __restrict__ w, T* __restrict__ dx, float* __restrict__ dw_part,
                      float* __restrict__ db_part, int rows, int cols, int lanes, float eps) {
  constexpr int E = 16 / sizeof(T), V = kVecs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int j = lane & (lanes - 1);          // this lane's place in its group
  const int groups = 32 / lanes;             // rows a warp walks at once
  const int group = lane / lanes;
  const int rows_per_block = warps * groups;
  const float inv_c = 1.f / cols;

  uint4 wv[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    wv[v] = __ldg(reinterpret_cast<const uint4*>(w) + v * lanes + j);
  float dws[WB ? V * E : 1], dbs[WB ? V * E : 1];
  if constexpr (WB) {
#pragma unroll
    for (int i = 0; i < V * E; ++i) dws[i] = dbs[i] = 0.f;
  }

  // the loop bound is the same for every lane of a warp (the shuffles need
  // them all); a group past the last row computes on zeros and stores nothing
  for (int base = blockIdx.x * rows_per_block + warp * groups; base < rows;
       base += gridDim.x * rows_per_block) {
    const int row = base + group;
    const bool valid = row < rows;
    const long long off = (long long)(valid ? row : 0) * cols / E;
    uint4 xv[V], gv[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xv[v] = valid ? __ldg(reinterpret_cast<const uint4*>(x) + off + v * lanes + j)
                    : make_uint4(0, 0, 0, 0);
      gv[v] = valid ? __ldg(reinterpret_cast<const uint4*>(dy) + off + v * lanes + j)
                    : make_uint4(0, 0, 0, 0);
    }
    // two rounds of group sums: (sum x, sum w*dy), then, from the mean,
    // (sum (x - mean)^2, sum w*dy*(x - mean)); each lane keeps one partial
    // sum per vector element so that its adds do not form one long chain
    float sp[E], ap[E];
#pragma unroll
    for (int e = 0; e < E; ++e) sp[e] = ap[e] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float xf[E], gf[E], wf[E];
      unpack(xv[v], xf);
      unpack(gv[v], gf);
      unpack(wv[v], wf);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sp[e] += xf[e];
        ap[e] += gf[e] * wf[e];
      }
    }
    float s = 0.f, a2 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      s += sp[e];
      a2 += ap[e];
    }
    group_sum2(s, a2, lanes);
    const float mean = s * inv_c, c2 = a2 * inv_c;
#pragma unroll
    for (int e = 0; e < E; ++e) sp[e] = ap[e] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float xf[E], gf[E], wf[E];
      unpack(xv[v], xf);
      unpack(gv[v], gf);
      unpack(wv[v], wf);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = xf[e] - mean;
        sp[e] += d * d;
        ap[e] += gf[e] * wf[e] * d;
      }
    }
    float ss = 0.f, a1 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ss += sp[e];
      a1 += ap[e];
    }
    group_sum2(ss, a1, lanes);
    const float rstd = rsqrtf(ss * inv_c + eps);
    const float c1 = a1 * rstd * inv_c;  // mean(w*dy*x^)
    if (!valid) continue;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float xf[E], gf[E], wf[E], out[E];
      unpack(xv[v], xf);
      unpack(gv[v], gf);
      unpack(wv[v], wf);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = (xf[e] - mean) * rstd;
        out[e] = (gf[e] * wf[e] - xh * c1 - c2) * rstd;
        if constexpr (WB) {
          dws[v * E + e] += gf[e] * xh;
          dbs[v * E + e] += gf[e];
        }
      }
      reinterpret_cast<uint4*>(dx)[off + v * lanes + j] = pack(out);
    }
  }
  if constexpr (WB) {
    // the groups of the warp hold the same columns: a fixed butterfly adds
    // them, leaving every lane with the warp's sums for its columns
    for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < V * E; ++i) {
        dws[i] += __shfl_xor_sync(0xffffffffu, dws[i], o);
        dbs[i] += __shfl_xor_sync(0xffffffffu, dbs[i], o);
      }
    }
    // the warps of the block, added in warp order by the first group of each
    extern __shared__ float sums[];  // [2][cols]
    float* sdw = sums;
    float* sdb = sums + cols;
    for (int k = 0; k < warps; ++k) {
      if (warp == k && lane < lanes) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int c = (v * lanes + j) * E + e;
            sdw[c] = (k ? sdw[c] : 0.f) + dws[v * E + e];
            sdb[c] = (k ? sdb[c] : 0.f) + dbs[v * E + e];
          }
        }
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      dw_part[(long long)blockIdx.x * cols + c] = sdw[c];
      db_part[(long long)blockIdx.x * cols + c] = sdb[c];
    }
  }
}

template <typename T>
int launch_vec(const void* x, const void* dy, const void* w, void* dx, float* dw_part,
               float* db_part, int rows, int cols, int lanes, int* nparts, float eps,
               cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (!lanes_ok || cols != lanes * kVecs * E) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long addr_bits =
      reinterpret_cast<unsigned long long>(x) | reinterpret_cast<unsigned long long>(dy) |
      reinterpret_cast<unsigned long long>(w) | reinterpret_cast<unsigned long long>(dx);
  if (addr_bits % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  // fewer warps a block until the grid has 8 blocks an SM: smaller blocks
  // fill the SMs more evenly at the path's sizes (the most rows, 32768 at
  // C = 320, keep 4 warps), and the fewest rows, SD1.5's (512, 1280),
  // still reach every SM
  const int groups = 32 / lanes;
  int warps = kMaxWarps;
  while (warps > 1 && (rows + warps * groups - 1) / (warps * groups) < kBlocksPerSm * sm_count())
    warps >>= 1;
  long long grid = (rows + warps * groups - 1) / (warps * groups);
  const dim3 block(32 * warps);
  if (dw_part == nullptr) {
    ln_bwd_vec_kernel<T, false><<<(unsigned)grid, block, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w),
        static_cast<T*>(dx), nullptr, nullptr, rows, cols, lanes, eps);
    return 0;
  }
  // with dw/db: at most nparts blocks (the partial rows the caller gave),
  // and no more than the card holds at once, so each block walks many rows
  const size_t smem = 2 * (size_t)cols * sizeof(float);
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ln_bwd_vec_kernel<T, true>, (int)block.x, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  if (grid > resident) grid = resident;
  if (grid > *nparts) grid = *nparts;
  *nparts = (int)grid;
  ln_bwd_vec_kernel<T, true><<<(unsigned)grid, block, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w),
      static_cast<T*>(dx), dw_part, db_part, rows, cols, lanes, eps);
  return 0;
}

}  // namespace

// x, dy, dx: (rows, cols) contiguous; w: (cols,); all one dtype
// (0 = float32, 1 = bfloat16). lanes: 0 for the generic variant, else the
// lanes per row of the vectorised one (a power of two <= 32 with cols =
// lanes * kVecs 16-byte vectors; the four tensors 16-byte aligned).
// nparts: the generic variant's block count and the partial rows of
// dw_part/db_part. With dw == nullptr only dx is
// computed; otherwise dw_part/db_part are (nparts, cols) fp32 scratch and
// dw/db (cols,) fp32 outputs.
extern "C" int lyc_ln_bwd(const void* x, const void* dy, const void* w, void* dx,
                          float* dw_part, float* db_part, float* dw, float* db, int rows,
                          int cols, int nparts, int lanes, float eps, int dtype, void* stream) {
  if (rows < 1 || cols < 1 || nparts < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool want_wb = dw != nullptr;
  float* wp = want_wb ? dw_part : nullptr;
  float* bp = want_wb ? db_part : nullptr;
  int rc;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) {
    rc = dtype == 0 ? launch_generic<float>(x, dy, w, dx, wp, bp, rows, cols, nparts, eps, st)
                    : launch_generic<__nv_bfloat16>(x, dy, w, dx, wp, bp, rows, cols, nparts,
                                                    eps, st);
  } else {
    rc = dtype == 0
             ? launch_vec<float>(x, dy, w, dx, wp, bp, rows, cols, lanes, &nparts, eps, st)
             : launch_vec<__nv_bfloat16>(x, dy, w, dx, wp, bp, rows, cols, lanes, &nparts,
                                         eps, st);
  }
  if (rc != 0) return rc;
  if (want_wb) {
    ln_bwd_reduce_kernel<<<(cols + 31) / 32, dim3(32, 32), 0, st>>>(dw_part, db_part, dw, db,
                                                                     nparts, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
