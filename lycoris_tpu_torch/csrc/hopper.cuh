// Hopper building blocks shared by the flash, fused LoRA and GroupNorm
// kernels: mbarriers, TMA tile loads and stores, 1-D bulk copies, thread
// block clusters and their distributed shared memory, ldmatrix/stmatrix,
// wgmma shared-memory descriptors and fences, and the host-side encoding of
// the tensor maps.
//
// Tile layout. Every bf16 tile a flash kernel stages is R rows (tokens) by
// DP head-dim columns, loaded by one TMA box of a 5-D tensor map
// (8 columns, T rows, D/8 column chunks, H heads, B batches) whose box is
// (8, R, DP/8, 1, 1). TMA writes the box with its first dimension fastest,
// so shared memory holds [DP/8 chunks][R rows][8 columns]: every 8 rows x
// 16 bytes are one contiguous 128-byte core matrix, the no-swizzle layout
// wgmma reads directly. Chunks past ceil(D/8) and rows past T are out of
// the tensor's bounds and TMA fills them with zeros: that pads D = 40 to
// the MMA depth 48 and masks ragged T without a copy.

#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA -----------------------------------------------------------------

// The tile of rows [row0, row0 + R) of head (b, h) (one box of the 5-D
// tensor map, see the note above) into shared memory; completion is
// reported to ``bar`` as transaction bytes.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0), "r"(row0), "r"(0),
      "r"(h), "r"(b)
      : "memory");
}

// A box of a 2-D tensor map (see make_map_2d) at element column ``col``,
// row ``row`` into shared memory; completion reported to ``bar``.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                       int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

// A box from shared memory to the tensor at (col, row); the part outside
// the tensor is not written. Tracked by the issuing thread's bulk groups.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int col,
                                             int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until the issuing thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Order this thread's ordinary shared-memory writes before later reads by
// the async proxy (TMA, wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ``bytes`` (a multiple of 16) from global ``src`` to shared ``dst``, both
// 16-byte aligned, by one 1-D bulk copy (no tensor map); completion is
// reported to ``bar`` as transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// --- thread block clusters -----------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives (releasing its earlier
// writes to shared memory), then waits for all (acquiring theirs). The two
// halves may be split, so that work runs between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at ``p``'s offset in the shared memory of the cluster's CTA
// ``rank`` (distributed shared memory).
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Barrier ``id`` (1..15) over ``count`` threads, a multiple of 32.
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Four 8x8 bf16 matrices from shared memory, each lane giving one row
// address (lanes 8i..8i+7 the rows of matrix i), in the mma fragment
// layout; ``trans`` delivers each matrix transposed.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// The inverse of ldsm_x4: four 8x8 fragments to shared memory, the lanes
// giving the row addresses as there; ``trans`` stores each transposed.
template <bool TRANS>
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  if constexpr (TRANS)
    asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     addr),
                 "r"(r0), "r"(r1), "r"(r2), "r"(r3)
                 : "memory");
  else
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                 "r"(r0), "r"(r1), "r"(r2), "r"(r3)
                 : "memory");
}

// --- wgmma ---------------------------------------------------------------

// Descriptor of a K-major operand tile loaded with 128-byte swizzle (rows of
// 64 bf16, 1024-byte aligned, 8-row groups 1024 bytes apart); a step of 16
// along K adds 32 bytes to ``addr``.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Descriptor of a no-swizzle operand: start address, LBO (the stride
// between core matrices along the contraction) and SBO (along M or N), in
// bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// A [chunks][R][8] tile contracted over its head dim (K-major), rows
// [r0, ...) of it, depth step kk (16 columns = two chunks).
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return desc(tile + kk * 2 * R * 16 + r0 * 16, R * 16, 128);
}

// A [chunks][R][8] tile contracted over its rows (MN-major: the head dim is
// the N of the product), depth step kk (16 rows).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 16, 128, R * 16);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Hand registers from the producer warpgroup to the consumers (setmaxnreg):
// with 384 threads launched at 168 registers each, a producer at 24 frees
// exactly the 2 x 128 x 72 registers the consumers take to reach 240.
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// --- host: tensor maps ---------------------------------------------------

inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The tensor map of a bf16 (B, H, T, D) operand with head dim contiguous and
// element strides st_b, st_h, st_t, read in boxes of ``rows`` rows by ``dp``
// columns (a multiple of 16). The caller guarantees ceil(D/8)*8 readable
// columns (zeros past D), a 16-byte aligned base and strides that are
// multiples of 8 elements. Returns false if the driver refuses the map.
inline bool make_map(CUtensorMap* map, const void* base, int B, int H, int T, int D,
                     long long st_b, long long st_h, long long st_t, int rows, int dp) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(T), static_cast<cuuint64_t>((D + 7) / 8),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  // a dimension of extent 1 is only ever read at index 0: any legal stride
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(T > 1 ? st_t * 2 : 16), 16,
                                 static_cast<cuuint64_t>(H > 1 ? st_h * 2 : 16),
                                 static_cast<cuuint64_t>(B > 1 ? st_b * 2 : 16)};
  const cuuint32_t box[5] = {8, static_cast<cuuint32_t>(rows), static_cast<cuuint32_t>(dp / 8), 1,
                             1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a row-major bf16 (rows, cols) matrix read or written in
// boxes of ``box_rows`` rows by 64 columns (128 bytes) with 128-byte swizzle:
// shared memory holds the box as rows of 128 bytes whose 16-byte chunks are
// XOR-ed with the row index mod 8, the layout wgmma's swizzled descriptors
// and conflict-free ldmatrix/stmatrix read and write. The caller guarantees
// a 16-byte aligned base and cols % 8 == 0. Elements past the edges load as
// zeros and are not stored.
inline bool make_map_2d(CUtensorMap* map, const void* base, long long rows, long long cols,
                        int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * 2)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hop
