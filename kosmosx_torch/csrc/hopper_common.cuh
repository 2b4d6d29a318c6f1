// Hopper (sm_90a) building blocks shared by the kernels that are fed by the
// Tensor Memory Accelerator (TMA) and multiply with warpgroup MMA (wgmma):
// mbarriers, 3-D TMA tile loads and 1-D bulk copies (the decode kernel's
// cache chunks), shared-memory matrix descriptors for tiles
// stored with the 128-byte swizzle, the bf16 m64n64k16 wgmma in its SS
// (both operands from shared memory) and RS (A from registers) forms, the
// ring of a warp-specialised block (two consumer warpgroups, one TMA
// producer warp), and the host-side encoding of 2-D and 3-D TMA tensor
// maps.
//
// Tile layout: a tile of R rows x 64 bf16 (one 128-byte row each) written
// by TMA with CU_TENSOR_MAP_SWIZZLE_128B, at a 1024-byte aligned address.
// Every 8 rows form a 1024-byte swizzle atom whose 16-byte chunks are
// permuted by chunk ^ (row % 8). The same tile serves as
// - a K-major operand (the contraction runs along the 64 columns): rows are
//   M or N, 8-row groups 1024 bytes apart, and the k-th 16-column step
//   starts 32 bytes further into the row;
// - an MN-major operand (the contraction runs along the rows, B only, with
//   wgmma's transpose bit): the 64 columns are N, 8-row groups of K 1024
//   bytes apart, and the k-th 16-row step starts 2048 bytes further.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"

namespace kx_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA); follow with
// __syncthreads().
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
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

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first,
// into shared memory; completion is counted on `bar` in bytes. Elements
// outside the tensor are filled with zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 2-D tensor map at (c0, c1), innermost first.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes from global to shared memory by Hopper's bulk
// copy (no tensor map); completion is counted on `bar` in bytes. Both
// addresses 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Makes this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma reading them as an operand); a barrier among the writers and
// the readers follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (bits
// 62-63). The k-th step of a K-major operand adds 2 * k, of an MN-major one
// 128 * k (both in 16-byte units of the start address).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo_bytes) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) { return desc_sw128(tile, 16); }
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile) { return desc_sw128(tile, 0); }
// An MN-major operand 128 wide: two (64, 64) tiles, the second 8 KB after
// the first (the leading byte offset steps from one to the other).
__device__ __forceinline__ uint64_t desc_mn_major_n128(const void* tile) {
  return desc_sw128(tile, 64 * 64 * 2);
}
constexpr uint64_t K_STEP = 2;     // 32 bytes
constexpr uint64_t MN_STEP = 128;  // 2048 bytes

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders the compiler's use of registers that an asynchronous wgmma reads
// or writes against the fence / wait instructions around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define KX_WGMMA_D32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define KX_WGMMA_D32_OUT(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),          \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),    \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31])

// d (64 x 64, fp32) = A (64 x 16) B (16 x 64) (+ d when accumulate): A
// K-major from shared memory, B K-major (TransB 0) or MN-major (TransB 1).
// Accumulator layout: warp w of the warpgroup, lane (g = lane / 4, t =
// lane % 4) holds d[4n + e] at row 16 w + g + 8 (e / 2), column
// 8 n + 2 t + e % 2 -- the mma.sync m16n8 layout, per warp.
template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KX_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : KX_WGMMA_D32_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TransB));
}

// The same with A (64 x 16, bf16) from registers in the mma.sync m16n8k16
// A-fragment layout per warp: a[0] = (row g, columns 2t, 2t + 1), a[1] =
// row g + 8, a[2] and a[3] the same at columns 2t + 8, 2t + 9.
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KX_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : KX_WGMMA_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TransB));
}

#define KX_WGMMA_D64                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, fp32) = A (64 x 16) B (16 x 128) (+ d): A K-major from shared
// memory, B MN-major from two (64, 64) tiles 8 KB apart (desc_mn_major_n128).
// Accumulator layout as wgmma_ss, with n up to 15: d[4n + e] at row
// 16 w + g + 8 (e / 2), column 8 n + 2 t + e % 2. Against two m64n64
// products it reads A from shared memory once, not twice.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KX_WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : KX_WGMMA_D32_OUT(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef KX_WGMMA_D64
#undef KX_WGMMA_D32
#undef KX_WGMMA_D32_OUT

// A fragments for a k = 64 product from an fp32 accumulator of the layout
// above (the accumulator's columns become the contraction), rounded to
// bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = kx_flash::pack_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
}

// 2^x on the special-function unit, denormal results flushed to zero (they
// lie below 2^-126, far under any bar these kernels are held to).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// ---------------------------------------------------------------------------
// Warp-specialised blocks: two consumer warpgroups of 64 own rows each and
// one producer warp that streams (64, 64) bf16 tiles through a ring
// ---------------------------------------------------------------------------

constexpr int HOP_ROWS = 128;                // own rows per block
constexpr int HOP_STAGES = 4;                // ring of streamed tiles
constexpr int HOP_THREADS = 2 * 128 + 32;    // two consumer warpgroups, one producer warp
constexpr int PRODUCER_WARP = 8;
constexpr uint32_t TILE_BYTES = 64 * 64 * sizeof(__nv_bfloat16);  // one (64, 64) tile

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// Barrier counts: full[s] completes when the producer warp's 32 lanes have
// arrived (after writing the stage's small arrays) and the stage's TMA
// bytes have landed; empty[s] when the 8 consumer warps are done with it;
// bars[2 * HOP_STAGES] when the block's own tiles have landed.
__device__ __forceinline__ void init_ring(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < HOP_STAGES; ++s) {
      mbar_init(&bars[s], 32);
      mbar_init(&bars[HOP_STAGES + s], 8);
    }
    mbar_init(&bars[2 * HOP_STAGES], 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// A consumer warp waits for the stage of streamed tile `it` to fill, and
// later gives it back to the producer.
__device__ __forceinline__ void acquire(uint64_t* full, int it) {
  mbar_wait(&full[it % HOP_STAGES], (it / HOP_STAGES) & 1);
  __syncwarp();
}
__device__ __forceinline__ void release(uint64_t* empty, int it, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[it % HOP_STAGES]);
}

// ---------------------------------------------------------------------------
// Host: TMA tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime so the
// library needs no link against libcuda.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// A (B*H, L, D) bf16 tensor as a 3-D map (D, L, B*H), innermost first,
// with (64, 64, 1) boxes and the 128-byte swizzle: a row of D = 128 loads
// as two boxes, at c0 = 0 and 64. Rows past L inside a head read as zeros.
// Returns cudaSuccess, or an error when the map is refused.
inline cudaError_t tensor_map_rows(CUtensorMap* map, const void* ptr, int D, int L, int BH) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(__nv_bfloat16),
                                 (cuuint64_t)L * D * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A row-major (rows, cols) matrix of `elem_bytes`-byte elements (bf16 or
// int8) whose rows start `pitch` elements apart (pitch >= cols) as a 2-D
// map (cols, rows), innermost first, with (box_cols, box_rows) boxes and
// the 128-byte swizzle (box_cols * elem_bytes must be 128 at most).
// Elements past either dimension read as zeros, also those between cols
// and the pitch. The pitch must be a multiple of 16 bytes and the base
// 16-byte aligned.
inline cudaError_t tensor_map_2d(CUtensorMap* map, const void* ptr, int elem_bytes,
                                 long long rows, long long cols, long long pitch, int box_rows,
                                 int box_cols) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type =
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace kx_hopper
