// The tile-rate study's attention skeleton for Hopper (sm_90a): S = Q K^T,
// then O = S V, with no softmax.
//
// Replaces the Pallas TPU kernel benchmarks/tile_rate_study.py::make_fn.kernel
// (pallas_call at :41). It computes the same function: for each program
// i < G on (G, L, d) bf16 q, k and v, s = q[i] k[i]^T accumulated in fp32
// and rounded to bf16, then o = s v[i] accumulated in fp32 and stored as
// bf16. No softmax, no mask, no scale.
//
// What bounds it on this card: 4 G L^2 d flops against 8 G L d bytes (q, k
// and v read once, o written once), L / 2 = 512 flops per byte at the
// study's L = 1024, above the H100's 295 (bf16 tensor-core peak over HBM
// rate): the tensor cores, not device memory.
//
// Design (first version; no wgmma, TMA or pipeline yet):
// - the Pallas kernel holds the whole (L, L) score matrix in VMEM (4 MB at
//   L = 1024), which no block's shared memory can; here it is the flash
//   forward's skeleton (csrc/flash_fwd.cu) without the softmax: one block of
//   4 warps per (64-row q tile, program), each warp owning 16 q rows, and a
//   loop over 64-row key tiles staged in shared memory, so S only ever
//   exists as one 16 x 64 register tile per warp;
// - S = Q K^T and O += S V are mma.sync m16n8k16 with fp32 accumulation;
//   the S fragments are rounded to bf16 in registers and reused directly as
//   the A operand of S V; V's B fragments come from ldmatrix.trans;
// - O stays in fp32 registers across all key tiles and is rounded once;
// - templated on the head dim d in {64, 128}, the two the study compares;
//   L must be a multiple of the 64-row tiles (the wrapper checks), so
//   nothing is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace kx_flash;

struct TileParams {
  const bf16* q;  // (G, L, D)
  const bf16* k;
  const bf16* v;
  bf16* o;        // (G, L, D)
  int L;
};

// Row pitch D + 8 elements, as in the flash forward: 16-byte rows for
// ldmatrix, and the 32-bit fragment loads fall on 32 different banks.
template <int D>
struct TileSmem {
  static constexpr int LD = D + 8;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + round128(sizeof(bf16) * BQ * LD);
  static constexpr size_t v = k + round128(sizeof(bf16) * BK * LD);
  static constexpr size_t bytes = v + round128(sizeof(bf16) * BK * LD);
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) tile_rate_kernel(TileParams p) {
  using S = TileSmem<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + S::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + S::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + S::v);

  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * p.L * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  load_tile_bf16<D, LD>(sQ, p.q + base, q0, p.L);
  __syncthreads();

  // this thread's rows: local ra (fragment elements 0, 1) and ra + 8 (2, 3)
  const int ra = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = ld32(sQ + ra * LD + kk * 16 + 2 * t);
    qf[kk][1] = ld32(sQ + (ra + 8) * LD + kk * 16 + 2 * t);
    qf[kk][2] = ld32(sQ + ra * LD + kk * 16 + 8 + 2 * t);
    qf[kk][3] = ld32(sQ + (ra + 8) * LD + kk * 16 + 8 + 2 * t);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < p.L; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, LD>(sK, p.k + base, k0, p.L);
    load_tile_bf16<D, LD>(sV, p.v + base, k0, p.L);
    __syncthreads();

    // S = Q K^T: 8 fragments of 16 rows x 8 keys, fp32
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* krow = sK + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[n], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    // O += S V: the score fragments, rounded to bf16, are the A operand
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int mat = lane >> 3;
      const bf16* vrow = sV + (j * 16 + (mat & 1) * 8 + (lane & 7)) * LD +
                         (mat >> 1) * 8;
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + nd * 16);
        mma_bf16(o[2 * nd], a, vb[0], vb[1]);
        mma_bf16(o[2 * nd + 1], a, vb[2], vb[3]);
      }
    }
  }

  bf16* O = p.o + base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ra + 8 * i;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(O + (size_t)row * D + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * i], o[n][2 * i + 1]);
    }
  }
}

}  // namespace

// q, k, v, o: (G, L, head_dim) bf16, contiguous. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a head dim other than 64 or
// 128, an L that is not a positive multiple of 64, or G outside the grid.
extern "C" int kx_tile_rate(const void* q, const void* k, const void* v, void* o,
                            int G, int L, int head_dim, void* stream) {
  if (G <= 0 || G > 65535 || L <= 0 || L % BQ != 0 || L % BK != 0)
    return cudaErrorInvalidValue;
  TileParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.L = L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(L / BQ, G);
  if (head_dim == 64)
    return launch(tile_rate_kernel<64>, TileSmem<64>::bytes, grid, p, s);
  if (head_dim == 128)
    return launch(tile_rate_kernel<128>, TileSmem<128>::bytes, grid, p, s);
  return cudaErrorInvalidValue;
}
