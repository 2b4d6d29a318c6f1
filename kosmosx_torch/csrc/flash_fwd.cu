// Flash-attention forward for Hopper (sm_90a), with optional xPos.
//
// Replaces the Pallas TPU kernel kosmosx_tpu/ops/flash_attention.py::_fwd_kernel
// (driven by _fwd, pallas_call at :303). It computes the same function:
// o = softmax(q k^T * sm_scale) v per (batch, head), online softmax in the
// log2 domain (exp2, c = sm_scale*log2(e) folded into the scores or, with
// xPos, into the q-side tables), fp32 statistics and accumulator, causal
// masking aligned at the top left, segment-id masking, and per-row
// statistics l (sum of exp2) and m (running max, log2 units) as (B, H, Lq).
// Masked scores take the value -0.7 * FLT_MAX for the max, and contribute
// nothing to l or o: a row with no visible key gives o = 0 and l = 0.
//
// What bounds it on this card: at the flagship's shapes (L = 2048, hd = 64)
// attention does 4*L*L*hd flops per head against 4*L*hd bytes of q/k/v
// traffic, so it is bound by the tensor cores and by the softmax's exp2 work
// between the two products, not by device memory.
//
// Design.
// - bf16 (Hopper): xPos leaves the kernel. The wrapper first runs the
//   backward's pre-pass as flash_fwd_prep_kernel (csrc/flash_bwd.cu) with
//   the forward's tables: q' = rot(q) with c folded into the q tables and
//   k' = rot(k), each rounded to bf16 once, as _apply_rot rounds them. Every
//   K tile is then rotated once, not once per q tile that reads it, and the
//   kernel scales nothing (c = 1); without xPos it reads q and k as they
//   are and scales the scores by c.
// - One block per (128 q rows, head, batch), blocks of the longest causal
//   rows first over every head: two consumer warpgroups of 64 q rows each
//   and one producer warp. The producer loads the block's Q' once (two TMA
//   boxes) and streams the K' and V tiles (64 rows, 128-byte swizzle) of the
//   kv tiles on or below the block's diagonal (all of them without causal)
//   through a ring of 4 stages of full/empty mbarriers, with each tile's kv
//   segment ids beside it. Tiles above the diagonal are never loaded.
// - Each consumer warpgroup runs S = Q' K'^T as wgmma with both operands in
//   shared memory, the online softmax on the accumulator (ex2 on the
//   special-function unit), and O += P V as wgmma with P from registers,
//   rounded to bf16 as JAX's p.astype(v.dtype), and V read MN-major. A
//   tile's two products retire within its iteration: kept in flight across
//   the loop's back edge, ptxas serializes every wgmma.
// - The kernel is bound by latency, not by a unit's rate: each warpgroup
//   waits on its products, its exp2 and its shuffles in turn. Two blocks
//   share an SM (96 registers a thread under __launch_bounds__(288, 2), 84
//   KB of shared memory each), so four consumer warpgroups fill the tensor
//   cores and the special-function units for each other: 1.33x against
//   one block per SM. Overlapping one warpgroup's softmax with its own
//   next product (tile j + 1's S issued with tile j's P V) needs some 128
//   registers: at one block per SM it gained nothing, at two it spills.
//   The loop's tile addresses are computed where they are used (the
//   lambdas below): the same loop with them held across its body spilled
//   88 bytes at 96 registers.
// - A tile takes no mask where every entry is visible to the warp
//   (flash_common.cuh::tile_whole: inside Lk, at or below the diagonal for
//   every row of the warp, and one segment id shared by the warp's rows and
//   the tile's); elsewhere the mask is a select, without branches.
// - fp32 (used to check the kernel at a tight bar): CUDA cores, K and V
//   staged in shared memory and rotated by xPos from the fp32 tables as
//   they are loaded, scores and output rows staged in shared memory.
// - rows past Lq and columns past Lk are bounded in the kernels (TMA reads
//   them as zeros), so the wrapper pads nothing.
// - Grouped-query attention: k and v hold Hkv heads, Hkv dividing H, and
//   query head h reads key/value head h / (H / Hkv) of its batch row; K and
//   V are never repeated in memory. The blocks of the H / Hkv query heads
//   that share a key/value head run next to each other, so their K and V
//   tiles come from L2. With Hkv = H the kernels read and compute exactly
//   as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace kx_flash;
using namespace kx_hopper;

struct FlashParams {
  const void* q;        // bf16: q' when xPos is on
  const void* k;        // bf16: k' when xPos is on
  const void* v;
  const int* qseg;      // (B, Lq) or null
  const int* kseg;      // (B, Lk) or null
  const float* qsin;    // fp32 only, (Lq, D) or null: xPos, c folded in
  const float* qcos;
  const float* ksin;    // (Lk, D)
  const float* kcos;
  void* o;              // (B, H, Lq, D), input type
  float* l;             // (B, H, Lq)
  float* m;             // (B, H, Lq)
  int B, H, Hkv, Lq, Lk, causal;  // Hkv divides H
  float scale_log2;     // applied to the scores: c, or 1 where q carries it
};

// The (batch, key/value head) row of k and v that the (batch, query head)
// row bh of q reads.
__device__ __forceinline__ int kv_row(const FlashParams& p, int bh) {
  return (bh / p.H) * p.Hkv + (bh % p.H) / (p.H / p.Hkv);
}

// The visibility rule shared by both kernels; every term is evaluated, so
// it compiles to selects and no branch.
__device__ __forceinline__ bool visible(const FlashParams& p, int row, int col,
                                        int qseg, int kseg) {
  return (col < p.Lk) & (!p.causal | (col <= row)) & ((p.qseg == nullptr) | (qseg == kseg));
}

// ---------------------------------------------------------------------------
// bf16 kernel for Hopper: TMA ring, warp-specialised, wgmma
// ---------------------------------------------------------------------------

struct FwdTma {
  CUtensorMap q, k, v;  // (64, L, B*H) map of q', (64, L, B*Hkv) of k' and v
  FlashParams p;
};

// Offsets into the 1024-byte aligned dynamic shared memory: the block's Q',
// the ring (K' and V per stage), each stage's kv segment ids, the barriers
// full[stage], empty[stage] and one for Q'.
struct FwdSmem {
  static constexpr size_t q = 0;                                     // own Q', 2 tiles
  static constexpr size_t ring = 2 * TILE_BYTES;                     // per stage: K', V
  static constexpr size_t seg = ring + HOP_STAGES * 2 * TILE_BYTES;  // per stage: kv ids
  static constexpr size_t bars = seg + HOP_STAGES * 64 * 4;
  static constexpr size_t bytes = bars + (2 * HOP_STAGES + 1) * 8 + 1024;  // + alignment
};

// One tile's online-softmax step on the S accumulator (this thread: rows
// row[0] for elements e = 0, 1 and row[1] for e = 2, 3 of s[4n + e], column
// 8n + 2t + e % 2 of the tile), in place: s becomes P, l_run is rescaled to
// the new running max and alpha is the factor that rescales O to it.
// Masked: the visibility select, with masked scores at MASK_VALUE and P = 0
// there; else no mask, and the scale c goes into the max and the exponent
// (max(s c) = c max(s) for c > 0).
template <bool Masked>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&alpha)[2],
                                             float (&m_run)[2], float (&l_run)[2], float c,
                                             const FlashParams& p, const int (&row)[2],
                                             const int (&qseg)[2], int k0, const int* sKseg,
                                             int t) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e];
      if (Masked) {
        const int col = n * 8 + 2 * t + (e & 1);
        x = visible(p, row[e >> 1], k0 + col, qseg[e >> 1], sKseg[col]) ? x * c : MASK_VALUE;
        s[4 * n + e] = x;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], Masked ? mx[i] : mx[i] * c);
    alpha[i] = ex2_ftz(m_run[i] - m_new);
    m_run[i] = m_new;
    l_run[i] *= alpha[i];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float x = s[4 * n + e];
      // a masked score adds nothing even when every score of the row so
      // far is masked
      const float pr = Masked ? (x == MASK_VALUE ? 0.f : ex2_ftz(x - m_run[i]))
                              : ex2_ftz(fmaf(x, c, -m_run[i]));
      s[4 * n + e] = pr;
      l_run[i] += pr;
    }
  }
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    o[4 * n] *= alpha[0];
    o[4 * n + 1] *= alpha[0];
    o[4 * n + 2] *= alpha[1];
    o[4 * n + 3] *= alpha[1];
  }
}

__global__ void __launch_bounds__(HOP_THREADS, 2)
    flash_fwd_hopper_kernel(const __grid_constant__ FwdTma P) {
  using S = FwdSmem;
  const FlashParams& p = P.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::bars);
  uint64_t* empty = full + HOP_STAGES;
  uint64_t* own = full + 2 * HOP_STAGES;

  // the block index runs over (batch, head) fastest, so the blocks of the
  // longest causal rows of every head come first
  const int n_bh = p.B * p.H;
  const int n_qt = (p.Lq + HOP_ROWS - 1) / HOP_ROWS;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_bh)) * HOP_ROWS;
  const int bh = blockIdx.x % n_bh;
  const int b = bh / p.H;
  int n_tiles = (p.Lk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + HOP_ROWS, p.Lq) - 1) / BK + 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  init_ring(full);

  if (warp == PRODUCER_WARP) {
    const int bkv = kv_row(p, bh);
    if (lane == 0) {
      mbar_arrive_expect_tx(own, 2 * TILE_BYTES);
      for (int h = 0; h < 2; ++h)
        tma_load_3d(smem + S::q + h * TILE_BYTES, &P.q, own, 0, q0 + 64 * h, bh);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % HOP_STAGES;
      mbar_wait(&empty[s], ((it / HOP_STAGES) & 1) ^ 1);
      const int k0 = it * BK;
      if (p.kseg != nullptr) {
        int* seg = reinterpret_cast<int*>(smem + S::seg + s * 64 * 4);
        for (int i = lane; i < 64; i += 32)
          seg[i] = k0 + i < p.Lk ? p.kseg[(size_t)b * p.Lk + k0 + i] : -2;
      }
      unsigned char* tile = smem + S::ring + s * 2 * TILE_BYTES;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        tma_load_3d(tile, &P.k, &full[s], 0, k0, bkv);
        tma_load_3d(tile + TILE_BYTES, &P.v, &full[s], 0, k0, bkv);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [qw0, qw0 + 64); this thread rows
  // row[0] and row[1] of the accumulators
  const int wg = warp / 4;
  const int wi = warp % 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qw0 = q0 + 64 * wg;
  const int row[2] = {qw0 + 16 * wi + g, qw0 + 16 * wi + g + 8};
  const bool segs = p.qseg != nullptr;
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qseg[i] = (segs && row[i] < p.Lq) ? p.qseg[(size_t)b * p.Lq + row[i]] : -1;
  const WarpIds q_ids = warp_ids(qseg[0], qseg[1]);
  // the warpgroup's kv tiles are [0, it_end): under causal masking the
  // last may lie wholly after its q rows, and past Lq it has none; it only
  // gives those stages back
  int it_end = qw0 < p.Lq ? n_tiles : 0;
  while (p.causal && it_end > 0 && (it_end - 1) * BK > qw0 + 63) --it_end;

  const float c = p.scale_log2;
  const uint64_t desc_q = desc_k_major(smem + S::q + wg * TILE_BYTES);
  float o[32], sc[32], alpha[2];
  uint32_t pa[4][4];
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};  // this thread's part of the row sums
  zero(o);

  auto stage = [&](int it) { return smem + S::ring + (it % HOP_STAGES) * 2 * TILE_BYTES; };
  // S = Q' K'^T (64 q rows x 64 kv columns) of tile it, one group
  auto issue_s = [&](int it) {
    const uint64_t desc_k = desc_k_major(stage(it));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0>(sc, desc_q + kk * K_STEP, desc_k + kk * K_STEP, kk > 0);
    wgmma_commit();
  };
  // O += P V of tile it, one group: A from registers, B (the V tile)
  // MN-major
  auto issue_pv = [&](int it) {
    const uint64_t desc_vt = desc_mn_major(stage(it) + TILE_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o, pa[kk], desc_vt + kk * MN_STEP, 1);
    wgmma_commit();
  };
  // S of tile it becomes P, with or without the mask
  auto softmax = [&](int it) {
    const int k0 = it * BK;
    const int* sKseg =
        reinterpret_cast<const int*>(smem + S::seg + (it % HOP_STAGES) * 64 * 4);
    const WarpIds kv_ids = segs ? warp_ids(sKseg[lane], sKseg[lane + 32]) : WarpIds{0, true};
    if (tile_whole(k0 + BK <= p.Lk && (!p.causal || k0 + BK - 1 <= qw0 + 16 * wi), segs,
                   q_ids, kv_ids))
      softmax_tile<false>(sc, alpha, m_run, l_run, c, p, row, qseg, k0, sKseg, t);
    else
      softmax_tile<true>(sc, alpha, m_run, l_run, c, p, row, qseg, k0, sKseg, t);
  };

  mbar_wait(own, 0);
  for (int it = 0; it < it_end; ++it) {
    acquire(full, it);
    wgmma_fence();
    issue_s(it);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(it);
    rescale(o, alpha);
    acc_to_a(pa, sc);
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
    issue_pv(it);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(empty, it, lane);
  }
  for (int it = it_end; it < n_tiles; ++it) {
    acquire(full, it);
    release(empty, it, lane);
  }

  bf16* O = static_cast<bf16*>(p.o) + (size_t)bh * p.Lq * 64;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row[i] >= p.Lq) continue;
    const float inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(O + (size_t)row[i] * 64 + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
    }
    if (t == 0) {
      p.l[(size_t)bh * p.Lq + row[i]] = l;
      p.m[(size_t)bh * p.Lq + row[i]] = m_run[i];
    }
  }
}

// The three tensor maps of a bf16 launch and the launch itself.
cudaError_t launch_hopper(const FlashParams& p, cudaStream_t stream) {
  FwdTma P;
  P.p = p;
  const int bh = p.B * p.H;
  cudaError_t err;
  if ((err = tensor_map_rows(&P.q, p.q, 64, p.Lq, bh)) != cudaSuccess) return err;
  const int bkv = p.B * p.Hkv;
  if ((err = tensor_map_rows(&P.k, p.k, 64, p.Lk, bkv)) != cudaSuccess) return err;
  if ((err = tensor_map_rows(&P.v, p.v, 64, p.Lk, bkv)) != cudaSuccess) return err;
  const dim3 grid(((p.Lq + HOP_ROWS - 1) / HOP_ROWS) * bh);
  return launch(flash_fwd_hopper_kernel, FwdSmem::bytes, grid, P, stream, HOP_THREADS);
}

// ---------------------------------------------------------------------------
// fp32 kernel: CUDA cores, scores and output rows staged in shared memory
// ---------------------------------------------------------------------------

// Row pitches padded by one element: column walks hit 32 different banks.
template <int D>
struct SmemF32 {
  static constexpr int LDT = D + 1;   // sQ, sK, sV
  static constexpr int LDS = BK + 1;  // sS (scores, then probabilities)
  static constexpr int LDO = D + 1;   // sO (output accumulator)
  static constexpr size_t q = 0;
  static constexpr size_t k = q + round128(sizeof(float) * BQ * LDT);
  static constexpr size_t v = k + round128(sizeof(float) * BK * LDT);
  static constexpr size_t s = v + round128(sizeof(float) * BK * LDT);
  static constexpr size_t o = s + round128(sizeof(float) * BQ * LDS);
  static constexpr size_t m = o + round128(sizeof(float) * BQ * LDO);
  static constexpr size_t l = m + round128(sizeof(float) * BQ);
  static constexpr size_t alpha = l + round128(sizeof(float) * BQ);
  static constexpr size_t qseg = alpha + round128(sizeof(float) * BQ);
  static constexpr size_t kseg = qseg + round128(sizeof(int) * BQ);
  static constexpr size_t bytes = kseg + round128(sizeof(int) * BK);
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_f32_kernel(FlashParams p) {
  using L = SmemF32<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);
  float* sAlpha = reinterpret_cast<float*>(smem + L::alpha);
  int* sQseg = reinterpret_cast<int*>(smem + L::qseg);
  int* sKseg = reinterpret_cast<int*>(smem + L::kseg);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + blockIdx.y;
  const size_t bkv = kv_row(p, (int)bh);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* Q = static_cast<const float*>(p.q) + bh * p.Lq * D;
  const float* K = static_cast<const float*>(p.k) + bkv * p.Lk * D;
  const float* V = static_cast<const float*>(p.v) + bkv * p.Lk * D;

  load_tile_f32<D, L::LDT>(sQ, Q, q0, p.Lq, p.qsin, p.qcos);
  load_seg(sQseg, p.qseg ? p.qseg + (size_t)b * p.Lq : nullptr, q0, BQ, p.Lq, -1);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS)
    sO[(i / D) * L::LDO + i % D] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    sM[r] = -CUDART_INF_F;
    sL[r] = 0.f;
  }

  int n_tiles = (p.Lk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  // the softmax of row r is split over lanes 2i and 2i+1, 32 columns each
  const int r = warp * 16 + lane / 2;
  const int row = q0 + r;
  const int cbase = (lane & 1) * (BK / 2);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    load_tile_f32<D, L::LDT>(sK, K, k0, p.Lk, p.ksin, p.kcos);
    load_tile_f32<D, L::LDT>(sV, V, k0, p.Lk, nullptr, nullptr);
    load_seg(sKseg, p.kseg ? p.kseg + (size_t)b * p.Lk : nullptr, k0, BK, p.Lk, -2);
    __syncthreads();

    // S for the warp's 16 rows
    for (int i = lane; i < 16 * BK; i += 32) {
      const int rr = warp * 16 + i / BK;
      const int c = i % BK;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc += sQ[rr * L::LDT + d] * sK[c * L::LDT + d];
      sS[rr * L::LDS + c] = acc;
    }
    __syncwarp();

    float* srow = sS + r * L::LDS;
    float mx = -CUDART_INF_F;
    for (int j = 0; j < BK / 2; ++j) {
      const int c = cbase + j;
      float x = srow[c] * p.scale_log2;
      if (!visible(p, row, k0 + c, sQseg[r], sKseg[c])) x = MASK_VALUE;
      srow[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = sM[r];
    const float m_new = fmaxf(m_prev, mx);
    const float alpha = exp2f(m_prev - m_new);
    float lsum = 0.f;
    for (int j = 0; j < BK / 2; ++j) {
      const int c = cbase + j;
      const float pr = srow[c] == MASK_VALUE ? 0.f : exp2f(srow[c] - m_new);
      srow[c] = pr;
      lsum += pr;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    __syncwarp();  // both lanes of a row have read sM[r]
    if ((lane & 1) == 0) {
      sM[r] = m_new;
      sL[r] = alpha * sL[r] + lsum;
      sAlpha[r] = alpha;
    }
    __syncwarp();

    // O = O * alpha + P V for the warp's 16 rows
    for (int i = lane; i < 16 * D; i += 32) {
      const int rr = warp * 16 + i / D;
      const int c = i % D;
      float acc = 0.f;
#pragma unroll 16
      for (int j = 0; j < BK; ++j) acc += sS[rr * L::LDS + j] * sV[j * L::LDT + c];
      sO[rr * L::LDO + c] = sO[rr * L::LDO + c] * sAlpha[rr] + acc;
    }
    __syncwarp();
  }

  float* O = static_cast<float*>(p.o) + bh * p.Lq * D;
  for (int i = lane; i < 16 * D; i += 32) {
    const int rr = warp * 16 + i / D;
    if (q0 + rr < p.Lq) {
      const float l = sL[rr];
      const float inv = l == 0.f ? 1.f : 1.f / l;
      O[(size_t)(q0 + rr) * D + i % D] = sO[rr * L::LDO + i % D] * inv;
    }
  }
  if (lane < 16) {
    const int rr = warp * 16 + lane;
    if (q0 + rr < p.Lq) {
      p.l[bh * p.Lq + q0 + rr] = sL[rr];
      p.m[bh * p.Lq + q0 + rr] = sM[rr];
    }
  }
}

}  // namespace

extern "C" const char* kx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// k and v hold Hkv heads (Hkv divides H; Hkv = H: one a query head).
// dtype: 0 = float32, 1 = bfloat16. bf16: q and k are q' and k' when xPos is
// on (kx_flash_fwd_prep), and no tables are given; fp32: raw q and k, and
// the tables rotate them in the kernel. scale_log2 multiplies the scores: c
// without xPos, 1 with it. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dim or type it does not take (or a tensor
// that cannot be mapped for TMA).
extern "C" int kx_flash_fwd(const void* q, const void* k, const void* v,
                            const void* qseg, const void* kseg,
                            const void* qsin, const void* qcos,
                            const void* ksin, const void* kcos,
                            void* o, void* l, void* m,
                            int B, int H, int Hkv, int Lq, int Lk, int head_dim,
                            int dtype, int causal, float scale_log2,
                            void* stream) {
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.qsin = static_cast<const float*>(qsin);
  p.qcos = static_cast<const float*>(qcos);
  p.ksin = static_cast<const float*>(ksin);
  p.kcos = static_cast<const float*>(kcos);
  p.o = o;
  p.l = static_cast<float*>(l);
  p.m = static_cast<float*>(m);
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.scale_log2 = scale_log2;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // head dim 64 only: the flagship decoder's
  if (dtype == 1 && head_dim == 64 && qsin == nullptr) return launch_hopper(p, s);
  if (dtype == 0 && head_dim == 64)
    return launch(flash_fwd_f32_kernel<64>, SmemF32<64>::bytes,
                  dim3((Lq + BQ - 1) / BQ, H, B), p, s);
  return cudaErrorInvalidValue;
}
