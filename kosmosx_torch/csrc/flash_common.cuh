// Pieces shared by the flash-attention forward (flash_fwd.cu) and backward
// (flash_bwd.cu) kernels: tile sizes, the mask value, the xPos rotation
// with the plain version's rounding, tile loads into shared memory, the
// bf16 mma.sync / ldmatrix wrappers (also the tile-rate kernel's), and the
// test for a tile that needs no mask.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace kx_flash {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // kv rows per tile
constexpr int NTHREADS = 128;  // 4 warps x 16 rows
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

using bf16 = __nv_bfloat16;

constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

// xPos on a pair (x0, x1): x*cos + rotate_every_two(x)*sin with
// rotate_every_two = [-x1, x0]. Each product and the sum round separately
// (no fused multiply-add), as the plain version and _apply_rot compute it,
// so the rotated rows round to the same bf16 values.
__device__ __forceinline__ float rotate_even(float x0, float x1, float sn, float cs) {
  return __fsub_rn(__fmul_rn(x0, cs), __fmul_rn(x1, sn));
}
__device__ __forceinline__ float rotate_odd(float x0, float x1, float sn, float cs) {
  return __fadd_rn(__fmul_rn(x1, cs), __fmul_rn(x0, sn));
}

// The transpose of that rotation, mapping a gradient (g0, g1) with respect
// to the rotated pair back to the un-rotated one: g*cos - rotate_every_two(
// g*sin), i.e. (g0*c0 + g1*s1, g1*c1 - g0*s0) (_apply_rot_transpose,
// kosmosx_tpu/ops/flash_attention.py:150-153), rounded as the plain version.
__device__ __forceinline__ float rotate_t_even(float g0, float g1, const float* sn,
                                               const float* cs) {
  return __fadd_rn(__fmul_rn(g0, cs[0]), __fmul_rn(g1, sn[1]));
}
__device__ __forceinline__ float rotate_t_odd(float g0, float g1, const float* sn,
                                              const float* cs) {
  return __fsub_rn(__fmul_rn(g1, cs[1]), __fmul_rn(g0, sn[0]));
}

// Segment ids of rows [row0, row0 + n) into shared memory; padding id `pad`.
__device__ __forceinline__ void load_seg(int* dst, const int* src, int row0,
                                         int n, int L, int pad) {
  for (int i = threadIdx.x; i < n; i += NTHREADS)
    dst[i] = (src != nullptr && row0 + i < L) ? src[row0 + i] : pad;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const bf16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a (L, D) bf16 slab into shared memory, 16 bytes
// per thread and step; rows past L are zero.
template <int D, int LD>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, int row0,
                                               int L) {
  for (int i = threadIdx.x; i < 64 * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int row = row0 + r;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (row < L) out = *reinterpret_cast<const uint4*>(src + (size_t)row * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = out;
  }
}

// Rows [row0, row0 + 64) of a (L, D) fp32 slab, rotated by xPos when tables
// are given; rows past L are zero.
template <int D, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row0,
                                              int L, const float* sin_t,
                                              const float* cos_t) {
  for (int i = threadIdx.x; i < 64 * (D / 2); i += NTHREADS) {
    const int r = i / (D / 2);
    const int c = (i % (D / 2)) * 2;
    const int row = row0 + r;
    float x0 = 0.f, x1 = 0.f;
    if (row < L) {
      const size_t at = (size_t)row * D + c;
      x0 = src[at];
      x1 = src[at + 1];
      if (sin_t != nullptr) {
        const float y0 = rotate_even(x0, x1, sin_t[at], cos_t[at]);
        x1 = rotate_odd(x0, x1, sin_t[at + 1], cos_t[at + 1]);
        x0 = y0;
      }
    }
    dst[r * LD + c] = x0;
    dst[r * LD + c + 1] = x1;
  }
}

// Sets the dynamic shared memory a kernel needs and launches it on `grid`.
template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, size_t bytes, dim3 grid, const Params& p,
                   cudaStream_t stream, int threads = NTHREADS) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tiles that need no mask
// ---------------------------------------------------------------------------

// The segment id that values a and b of every lane of the warp share (one
// is set when they all hold one value). Every lane of the warp calls it.
struct WarpIds {
  int id;
  bool one;
};
__device__ __forceinline__ WarpIds warp_ids(int a, int b) {
  const int id = __shfl_sync(0xffffffffu, a, 0);
  return {id, __all_sync(0xffffffffu, (a == id) & (b == id)) != 0};
}

// Whether every entry of a tile is visible to a warp's rows, so that the
// tile takes no mask: `inside` says that the tile lies wholly inside both
// lengths and, under causal masking, wholly at or below the diagonal for
// every row of the warp; with segment ids (`segs`), the warp's rows and the
// tile's columns must also hold one and the same id. A training batch
// without padding has one id everywhere, so its tiles take no mask.
// ops/flash_attention.py::whole_tiles is the plain version.
__device__ __forceinline__ bool tile_whole(bool inside, bool segs, WarpIds rows,
                                           WarpIds cols) {
  return inside & (!segs | (rows.one & cols.one & (rows.id == cols.id)));
}

}  // namespace kx_flash
