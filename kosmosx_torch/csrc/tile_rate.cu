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
// Design: the flash forward's Hopper skeleton (csrc/flash_fwd.cu) without
// the softmax, the mask or the segment ids.
// - The Pallas kernel holds the whole (L, L) score matrix in VMEM (4 MB at
//   L = 1024), which no block's shared memory can; S only ever exists as
//   one 64 x 64 fp32 accumulator per warpgroup and key tile.
// - One block per (128 q rows, program): two consumer warpgroups of 64 rows
//   each and one producer warp. The producer loads the block's Q once and
//   streams the K and V tiles (64 rows, 128-byte swizzle) through the
//   HOP_STAGES ring of full/empty mbarriers. Every tile is whole (L is a
//   multiple of 64): no tile takes a mask.
// - S = Q K^T is wgmma with both operands in shared memory, d / 16 k-steps;
//   S goes to A fragments with acc_to_a, which rounds to bf16 as the plain
//   version does; O += S V is wgmma with S from registers and V read
//   MN-major. A tile's two products retire within its iteration: kept in
//   flight across the loop's back edge, ptxas serializes every wgmma.
// - d = 128: a 256-byte row does not fit one 128-byte swizzle box, so every
//   row loads as two boxes (c0 = 0 and 64; hopper_common.cuh::
//   tensor_map_rows). S's k-steps 0-3 run on the first box of Q and K,
//   steps 4-7 on the second; O is two m64n64 accumulators, one per half of
//   V. A consumer then holds 64 (O) + 32 (S) + 16 (A) registers of values,
//   past the 112-register cap of two blocks per SM, and Q plus the ring take
//   160 KB of shared memory: one block per SM. d = 64 fits two blocks per SM
//   (80 KB, at most 112 registers), whose four consumer warpgroups fill the
//   tensor cores for each other, as in the flash forward. Q held in
//   registers as the A operand of S (wgmma from registers) was tried: at
//   d = 64 it needs more than 112 registers (ptxas serialized the products
//   and spilled), at d = 128 it gained nothing.
// - L shorter than a block's 128 rows (L = 64): TMA reads the missing q
//   rows as zeros; a warpgroup whose rows all lie past L only gives the
//   ring's stages back, and rows past L are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace kx_flash;
using namespace kx_hopper;

struct TileTma {
  CUtensorMap q, k, v;  // (D, L, G) maps, (64, 64, 1) boxes
  bf16* o;              // (G, L, D)
  int L;
};

// Offsets into the 1024-byte aligned dynamic shared memory: the block's Q
// (per warpgroup, H tiles of 64 columns), the ring (per stage: K's H tiles,
// then V's), the barriers full[stage], empty[stage] and one for Q.
template <int D>
struct TileSmem {
  static constexpr int H = D / 64;                                    // 64-column halves
  static constexpr size_t q = 0;                                      // 2 x H tiles
  static constexpr size_t ring = 2 * H * TILE_BYTES;                  // per stage: K, V
  static constexpr size_t stage = 2 * H * TILE_BYTES;
  static constexpr size_t bars = ring + HOP_STAGES * stage;
  static constexpr size_t bytes = bars + (2 * HOP_STAGES + 1) * 8 + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(HOP_THREADS, D == 64 ? 2 : 1)
    tile_rate_hopper_kernel(const __grid_constant__ TileTma P) {
  using S = TileSmem<D>;
  constexpr int H = S::H;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::bars);
  uint64_t* empty = full + HOP_STAGES;
  uint64_t* own = full + 2 * HOP_STAGES;

  const int n_qt = (P.L + HOP_ROWS - 1) / HOP_ROWS;
  const int prog = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * HOP_ROWS;
  const int n_tiles = P.L / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  init_ring(full);

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      mbar_arrive_expect_tx(own, 2 * H * TILE_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int h = 0; h < H; ++h)
          tma_load_3d(smem + S::q + (w * H + h) * TILE_BYTES, &P.q, own, 64 * h, q0 + 64 * w,
                      prog);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % HOP_STAGES;
      mbar_wait(&empty[s], ((it / HOP_STAGES) & 1) ^ 1);
      unsigned char* tile = smem + S::ring + s * S::stage;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * H * TILE_BYTES);
        for (int h = 0; h < H; ++h) {
          tma_load_3d(tile + h * TILE_BYTES, &P.k, &full[s], 64 * h, it * BK, prog);
          tma_load_3d(tile + (H + h) * TILE_BYTES, &P.v, &full[s], 64 * h, it * BK, prog);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [qw0, qw0 + 64); this thread rows
  // qw0 + 16 wi + g and that + 8 of the accumulators
  const int wg = warp / 4;
  const int wi = warp % 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qw0 = q0 + 64 * wg;
  const int it_end = qw0 < P.L ? n_tiles : 0;

  float o[H][32], sc[32];
  uint32_t pa[4][4];
#pragma unroll
  for (int h = 0; h < H; ++h) zero(o[h]);

  auto stage = [&](int it) { return smem + S::ring + (it % HOP_STAGES) * S::stage; };
  // S = Q K^T (64 q rows x 64 keys) of tile it, one group: k-steps 4h..4h+3
  // on box h of Q and K
  auto issue_s = [&](int it) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const uint64_t desc_q = desc_k_major(smem + S::q + (wg * H + h) * TILE_BYTES);
      const uint64_t desc_k = desc_k_major(stage(it) + h * TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(sc, desc_q + kk * K_STEP, desc_k + kk * K_STEP, (h | kk) > 0);
    }
    wgmma_commit();
  };
  // O += S V of tile it, one group: A from registers, B (half h of the V
  // tile) MN-major
  auto issue_sv = [&](int it) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        wgmma_rs<1>(o[h], pa[kk], desc_mn_major(stage(it) + (H + h) * TILE_BYTES) + kk * MN_STEP,
                    1);
    wgmma_commit();
  };

  mbar_wait(own, 0);
  for (int it = 0; it < it_end; ++it) {
    acquire(full, it);
    wgmma_fence();
    issue_s(it);
    wgmma_wait<0>();
    fence_regs(sc);
    acc_to_a(pa, sc);
    fence_regs(pa);
#pragma unroll
    for (int h = 0; h < H; ++h) fence_regs(o[h]);
    wgmma_fence();
    issue_sv(it);
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < H; ++h) fence_regs(o[h]);
    fence_regs(pa);
    release(empty, it, lane);
  }
  for (int it = it_end; it < n_tiles; ++it) {
    acquire(full, it);
    release(empty, it, lane);
  }

  bf16* O = P.o + (size_t)prog * P.L * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw0 + 16 * wi + g + 8 * i;
    if (row >= P.L) continue;
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(O + (size_t)row * D + 64 * h + n * 8 + 2 * t) =
            __floats2bfloat162_rn(o[h][4 * n + 2 * i], o[h][4 * n + 2 * i + 1]);
  }
}

template <int D>
cudaError_t launch_tile(const void* q, const void* k, const void* v, void* o, int G, int L,
                        cudaStream_t stream) {
  TileTma P;
  P.o = static_cast<bf16*>(o);
  P.L = L;
  cudaError_t err;
  if ((err = tensor_map_rows(&P.q, q, D, L, G)) != cudaSuccess) return err;
  if ((err = tensor_map_rows(&P.k, k, D, L, G)) != cudaSuccess) return err;
  if ((err = tensor_map_rows(&P.v, v, D, L, G)) != cudaSuccess) return err;
  const dim3 grid(((L + HOP_ROWS - 1) / HOP_ROWS) * G);
  return launch(tile_rate_hopper_kernel<D>, TileSmem<D>::bytes, grid, P, stream, HOP_THREADS);
}

}  // namespace

// q, k, v, o: (G, L, head_dim) bf16, contiguous, 16-byte aligned. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dim other than 64 or 128, an L that is not a positive multiple of 64, G
// outside [1, 65535] or a tensor that cannot be mapped for TMA.
extern "C" int kx_tile_rate(const void* q, const void* k, const void* v, void* o,
                            int G, int L, int head_dim, void* stream) {
  if (G <= 0 || G > 65535 || L <= 0 || L % BK != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_tile<64>(q, k, v, o, G, L, s);
  if (head_dim == 128) return launch_tile<128>(q, k, v, o, G, L, s);
  return cudaErrorInvalidValue;
}
