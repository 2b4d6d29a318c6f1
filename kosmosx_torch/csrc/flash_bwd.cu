// Flash-attention backward for Hopper (sm_90a): a pre-pass, the dK/dV
// kernel and the dQ kernel, with optional fused xPos.
//
// Replaces the Pallas TPU kernels of kosmosx_tpu/ops/flash_attention.py::_bwd:
// _bwd_dkv_kernel (:348-408, pallas_call at :515) and _bwd_dq_kernel
// (:411-464, pallas_call at :590), and the di = rowsum(o * dO) that _bwd
// computes outside them (:476). They compute the same functions from the
// forward's residuals (o, l, m):
//
//   s  = (q' k'^T) * c,  c = sm_scale * log2(e)            (_recompute_p)
//   p  = exp2(s - m) / l on visible entries, 0 elsewhere   (1/l = 1 at l = 0)
//   dV = p^T dO,  dP = dO V^T,  dS = p * (dP - di) * sm_scale
//   dK' = dS^T q',  dQ' = dS k'
//
// xPos rule (decided once, the plain version follows it too): q' and k' are
// the rows rotated with the RAW tables, q tables carrying the decay and k
// tables its inverse, with no c folded in, each rounded to the input type
// before the product (_apply_rot, :142-147); the scores are scaled by c
// after the product, as _recompute_p does (:339). The forward folds c into
// its q tables instead, so in bf16 a recomputed score may differ from the
// forward's by the rounding of q'. dQ' and dK' are mapped back through the
// transpose of the rotation with the same raw q and k tables
// (_apply_rot_transpose, :150-153) before the store. Without xPos, q' = q
// and k' = k.
//
// Visibility: a (q row, kv row) entry is visible when both lie inside Lq and
// Lk, the kv row is at or before the q row under causal masking (top left
// aligned), and the segment ids are equal when given. Masked entries have
// p = 0 and dS = 0, so a padding kv row gets dK = dV = 0 and a q row with
// no visible key gets dQ = 0.
//
// What bounds it on this card: at the flagship's shapes (L = 2048, hd = 64)
// the backward does 2.5x the forward's tensor-core work (five products per
// tile against two) over the same bytes, so dK/dV and dQ are bound by the
// tensor cores and the exp2 recompute, not by device memory; the pre-pass
// is bound by its bytes.
//
// Design. The FlashAttention-2 split of the JAX package is kept: dK/dV and
// dQ are two kernels, so no block adds into another's output, dQ needs no
// atomics, and two runs give bit-identical gradients.
// - Pre-pass (one block per 64-row tile, a few heads and batch): di =
//   rowsum(o dO) in fp32 and, with xPos, q' and k' rotated once and stored
//   in the input type, rounded exactly as the plain version rounds them.
//   Every tile the two kernels stream is then already rotated: the rotation
//   (and the tables, four times the tile's bytes) leaves their inner loops.
//   The bf16 forward runs the same pass for its own q' and k' (forward
//   tables, no di) as flash_fwd_prep_kernel (entry kx_flash_fwd_prep).
// - bf16 dK/dV (Hopper): one block per (128 kv rows, head, batch): two
//   consumer warpgroups of 64 kv rows each and one producer warp. The
//   producer loads the block's K' and V once and then streams the Q' and dO
//   tiles (64 rows) of the q tiles on or below the diagonal (all of them
//   without causal) into a ring of 4 stages with TMA, the 128-byte swizzle
//   and mbarrier completion, with each row's m + log2(l), di and q segment
//   id beside them. Each consumer runs S^T = K' Q'^T and dP^T = V dO^T as
//   wgmma with both operands in shared memory, turns them into P^T and dS^T
//   in registers (masks and exp2 as the plain version), and accumulates
//   dV += P^T dO and dK' += dS^T Q' as wgmma with A from registers (rounded
//   to bf16) and B the same tiles read MN-major. Blocks run from the first
//   kv rows (most q tiles) to the last.
// - bf16 dQ (Hopper): one block per (128 q rows, head, batch), the same
//   roles: Q' and dO of the block loaded once, K' and V tiles (with the kv
//   segment ids) streamed through the ring; S = Q' K'^T and dP = dO V^T
//   from shared memory, dQ' += dS K' with dS from registers. Blocks run
//   from the last (longest) q rows to the first.
// - The mask is skipped on a tile every entry of which is visible for the
//   warp (flash_common.cuh::tile_whole: inside both lengths, at or below the
//   diagonal, and one segment id shared by the warp's rows and the tile's),
//   and evaluated without branches elsewhere. A tile's products are
//   not overlapped with the next tile's in one warpgroup: with products in
//   flight across the loop's back edge, ptxas serializes every wgmma. The
//   other warpgroup's products fill the tensor cores meanwhile.
// - P and dS are rounded to bf16 as operands (the usual FlashAttention-2
//   choice, which sets the bf16 bar); accumulation, the recompute, the masks
//   and the statistics stay fp32.
// - fp32 (the path that holds the kernels at a tight bar): CUDA cores with
//   TF32 off, P^T/dS^T or dS staged in shared memory, q and k rotated in
//   the kernel from raw inputs; di from the pre-pass.
// - rows past Lq and Lk are bounded in the kernels (TMA reads them as
//   zeros); the wrapper pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace kx_flash;
using namespace kx_hopper;

struct BwdParams {
  const void* q;        // (B, H, Lq, D); bf16: q' from the pre-pass
  const void* k;        // (B, H, Lk, D); bf16: k' from the pre-pass
  const void* v;
  const void* dout;     // (B, H, Lq, D)
  const float* l;       // (B, H, Lq), forward statistics, log2 units
  const float* m;
  const float* di;      // (B, H, Lq), rowsum(o * dO)
  const int* qseg;      // (B, Lq) or null
  const int* kseg;      // (B, Lk) or null
  const float* qsin;    // (Lq, D) or null: raw xPos tables, no c folded in
  const float* qcos;
  const float* ksin;    // (Lk, D)
  const float* kcos;
  void* dq;             // (B, H, Lq, D), input type
  void* dk;             // (B, H, Lk, D)
  void* dv;
  int B, H, Lq, Lk, causal;
  float scale_log2;     // c = sm_scale * log2(e), applied to q' k'^T
  float sm_scale;       // applied to dS
};

// Every term is evaluated (no branches), so the lanes of a warp stay
// together between the warpgroup products around the masks.
__device__ __forceinline__ bool visible(const BwdParams& p, int row, int col,
                                        int qseg, int kseg) {
  return (row < p.Lq) & (col < p.Lk) & (!p.causal | (col <= row)) &
         ((p.qseg == nullptr) | (qseg == kseg));
}

// m, 1/l and di of q rows [q0, q0 + 64) into shared memory; rows past Lq
// get values that keep the (masked) arithmetic finite.
__device__ __forceinline__ void load_row_stats(const BwdParams& p, size_t bh, int q0,
                                               float* sM, float* sInvL, float* sDi) {
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    const int r = q0 + i;
    const bool in = r < p.Lq;
    const size_t at = bh * p.Lq + r;
    const float l = in ? p.l[at] : 0.f;
    sM[i] = in ? p.m[at] : 0.f;
    sInvL[i] = l == 0.f ? 1.f : 1.f / l;
    sDi[i] = in ? p.di[at] : 0.f;
  }
}

// The rotation's transpose on a gradient pair at (row, c), c even.
__device__ __forceinline__ float2 unrotate(float g0, float g1, const float* sin_t,
                                           const float* cos_t, int row, int c, int D) {
  if (sin_t == nullptr) return make_float2(g0, g1);
  const float* sn = sin_t + (size_t)row * D + c;
  const float* cs = cos_t + (size_t)row * D + c;
  return make_float2(rotate_t_even(g0, g1, sn, cs), rotate_t_odd(g0, g1, sn, cs));
}

// ---------------------------------------------------------------------------
// Pre-pass: di = rowsum(o * dO), q' and k'
// ---------------------------------------------------------------------------

struct PrepParams {
  const void* q;      // (B, H, Lq, D)
  const void* k;      // (B, H, Lk, D)
  const void* o;      // (B, H, Lq, D), with dout; null: no di
  const void* dout;
  const float* qsin;  // raw xPos tables (L, D)
  const float* qcos;
  const float* ksin;
  const float* kcos;
  void* q_r;          // q' (B, H, Lq, D) or null: no q rotation
  void* k_r;          // k' (B, H, Lk, D) or null: no k rotation
  float* di;          // (B, H, Lq) or null
  int B, H, Lq, Lk;
};

// 8 consecutive elements as loaded: 16 bytes of bf16, 32 of fp32.
template <typename T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
};
template <typename T>
__device__ __forceinline__ Raw8<T> load8(const T* src) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) r.u[i] = reinterpret_cast<const uint4*>(src)[i];
  return r;
}
__device__ __forceinline__ void to_float(const Raw8<bf16>& r, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void to_float(const Raw8<float>& r, float (&x)[8]) {
  *reinterpret_cast<uint4*>(x) = r.u[0];
  *reinterpret_cast<uint4*>(x + 4) = r.u[1];
}
__device__ __forceinline__ void store8(bf16* dst, const float (&x)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}
__device__ __forceinline__ void store8(float* dst, const float (&x)[8]) {
  reinterpret_cast<float4*>(dst)[0] = *reinterpret_cast<const float4*>(x);
  reinterpret_cast<float4*>(dst)[1] = *reinterpret_cast<const float4*>(x + 4);
}

// 8 columns of a row rotated with the row's table entries and rounded to T
// once, as the plain version rounds them.
template <typename T>
__device__ __forceinline__ void rotate8(T* dst, const Raw8<T>& src, const float (&sn)[8],
                                        const float (&cs)[8]) {
  float x[8], y[8];
  to_float(src, x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    y[2 * j] = rotate_even(x[2 * j], x[2 * j + 1], sn[2 * j], cs[2 * j]);
    y[2 * j + 1] = rotate_odd(x[2 * j], x[2 * j + 1], sn[2 * j + 1], cs[2 * j + 1]);
  }
  store8(dst, y);
}

constexpr int PREP_THREADS = 512;  // 64 rows x 8 threads of 8 columns

// Heads per block: each thread holds 4 loads of 8 elements per head in
// registers (64 registers at 4 bf16 or 2 fp32 heads).
template <typename T>
__host__ __device__ constexpr int prep_heads() {
  return 8 / (int)sizeof(T);
}

// One block per (64-row tile, prep_heads<T>() heads, batch) over max(Lq, Lk)
// rows. A thread loads its row's table entries once for all of the block's
// heads, and issues every head's loads before it uses the first, so they
// are in flight together.
template <typename T, int D>
__device__ __forceinline__ void prep_rows(const PrepParams& p) {
  static_assert(D == 64, "8 threads x 8 columns per row");
  constexpr int HEADS = prep_heads<T>();
  const int row = blockIdx.x * 64 + threadIdx.x / 8;
  const int c = (threadIdx.x % 8) * 8;
  const bool di_row = p.di != nullptr && row < p.Lq;
  const bool rot_q = p.q_r != nullptr && row < p.Lq;
  const bool rot_k = p.k_r != nullptr && row < p.Lk;
  float qs[8], qc[8], ks[8], kc[8];
  if (rot_q) {
    to_float(load8(p.qsin + (size_t)row * D + c), qs);
    to_float(load8(p.qcos + (size_t)row * D + c), qc);
  }
  if (rot_k) {
    to_float(load8(p.ksin + (size_t)row * D + c), ks);
    to_float(load8(p.kcos + (size_t)row * D + c), kc);
  }
  const int h0 = blockIdx.y * HEADS;
  Raw8<T> o[HEADS], g[HEADS], xq[HEADS], xk[HEADS];
#pragma unroll
  for (int j = 0; j < HEADS; ++j) {
    if (h0 + j >= p.H) break;
    const size_t bh = (size_t)blockIdx.z * p.H + h0 + j;
    const size_t at_q = (bh * p.Lq + row) * D + c;
    if (di_row) {
      o[j] = load8(static_cast<const T*>(p.o) + at_q);
      g[j] = load8(static_cast<const T*>(p.dout) + at_q);
    }
    if (rot_q) xq[j] = load8(static_cast<const T*>(p.q) + at_q);
    if (rot_k) xk[j] = load8(static_cast<const T*>(p.k) + (bh * p.Lk + row) * D + c);
  }
#pragma unroll
  for (int j = 0; j < HEADS; ++j) {
    if (h0 + j >= p.H) break;
    const size_t bh = (size_t)blockIdx.z * p.H + h0 + j;
    const size_t at_q = (bh * p.Lq + row) * D + c;
    if (p.di != nullptr) {  // uniform: every lane reaches the shuffles
      float acc = 0.f;
      if (di_row) {
        float x[8], y[8];
        to_float(o[j], x);
        to_float(g[j], y);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += x[e] * y[e];
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (c == 0 && di_row) p.di[bh * p.Lq + row] = acc;
    }
    if (rot_q) rotate8(static_cast<T*>(p.q_r) + at_q, xq[j], qs, qc);
    if (rot_k) rotate8(static_cast<T*>(p.k_r) + (bh * p.Lk + row) * D + c, xk[j], ks, kc);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(PREP_THREADS) flash_bwd_prep_kernel(PrepParams p) {
  prep_rows<T, D>(p);
}

// The same pass for the forward: q' and k' only, from the forward's tables
// (sm_scale * log2(e) folded into the q side). A kernel of its own name, so
// that a profile tells the forward's rotation from the backward's pre-pass.
template <typename T, int D>
__global__ void __launch_bounds__(PREP_THREADS) flash_fwd_prep_kernel(PrepParams p) {
  prep_rows<T, D>(p);
}

template <typename T>
dim3 prep_grid(const PrepParams& p) {
  constexpr int heads = prep_heads<T>();
  return dim3((max(p.Lq, p.Lk) + 63) / 64, (p.H + heads - 1) / heads, p.B);
}

// ---------------------------------------------------------------------------
// bf16 kernels for Hopper: TMA ring, warp-specialised, wgmma
// ---------------------------------------------------------------------------

struct BwdTma {
  CUtensorMap q, k, v, dout;  // (64, L, B*H) maps of q', k', v and dO
  BwdParams p;
};

// Offsets into the 1024-byte aligned dynamic shared memory. Tiles first
// (each 1024-byte aligned for the swizzle), then the small arrays and the
// barriers: full[stage], empty[stage], and one for the block's own rows.
struct DkvSmem {
  static constexpr size_t k = 0;                      // own K', 2 tiles
  static constexpr size_t v = 2 * TILE_BYTES;         // own V, 2 tiles
  static constexpr size_t ring = 4 * TILE_BYTES;      // per stage: Q', dO
  static constexpr size_t stats = ring + HOP_STAGES * 2 * TILE_BYTES;  // per stage:
  static constexpr size_t stats_bytes = 3 * 64 * 4;   // lse, di, q segment ids
  static constexpr size_t bars = stats + HOP_STAGES * stats_bytes;
  static constexpr size_t bytes = bars + (2 * HOP_STAGES + 1) * 8 + 1024;  // + alignment
};

struct DqSmem {
  static constexpr size_t q = 0;                      // own Q', 2 tiles
  static constexpr size_t dout = 2 * TILE_BYTES;      // own dO, 2 tiles
  static constexpr size_t ring = 4 * TILE_BYTES;      // per stage: K', V
  static constexpr size_t seg = ring + HOP_STAGES * 2 * TILE_BYTES;  // per stage: kv ids
  static constexpr size_t bars = seg + HOP_STAGES * 64 * 4;
  static constexpr size_t bytes = bars + (2 * HOP_STAGES + 1) * 8 + 1024;
};

// The row's log-sum-exp in log2 units, m + log2(l): p = 2^(s c - lse)
// equals 2^(s c - m) / l. A row with l = 0 has no visible entry and keeps
// m (any finite value would do).
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + log2f(l) : m;
}

__global__ void __launch_bounds__(HOP_THREADS, 1)
    flash_bwd_dkv_hopper_kernel(const __grid_constant__ BwdTma P) {
  using S = DkvSmem;
  const BwdParams& p = P.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::bars);
  uint64_t* empty = full + HOP_STAGES;
  uint64_t* own = full + 2 * HOP_STAGES;

  const int k0 = blockIdx.x * HOP_ROWS;  // kv block 0 has the most q tiles: first
  const int bh = blockIdx.z * p.H + blockIdx.y;
  const int n_qt = (p.Lq + BQ - 1) / BQ;
  const int qt0 = p.causal ? k0 / BQ : 0;
  const int n_iter = max(n_qt - qt0, 0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  init_ring(full);

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      mbar_arrive_expect_tx(own, 4 * TILE_BYTES);
      for (int h = 0; h < 2; ++h) {
        tma_load_3d(smem + S::k + h * TILE_BYTES, &P.k, own, 0, k0 + 64 * h, bh);
        tma_load_3d(smem + S::v + h * TILE_BYTES, &P.v, own, 0, k0 + 64 * h, bh);
      }
    }
    // rows lane and lane + 32 of the next q tile, loaded a tile ahead so
    // their latency passes while the producer waits for a free stage
    float m_n[2], l_n[2], di_n[2];
    int seg_n[2];
    auto fetch = [&](int it) {
      for (int j = 0; j < 2; ++j) {
        const int r = (qt0 + it) * BQ + lane + 32 * j;
        const bool in = r < p.Lq;
        const size_t at = (size_t)bh * p.Lq + r;
        m_n[j] = in ? p.m[at] : 0.f;
        l_n[j] = in ? p.l[at] : 0.f;
        di_n[j] = in ? p.di[at] : 0.f;
        seg_n[j] = (p.qseg != nullptr && in) ? p.qseg[(size_t)blockIdx.z * p.Lq + r] : -1;
      }
    };
    if (n_iter > 0) fetch(0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % HOP_STAGES;
      mbar_wait(&empty[s], ((it / HOP_STAGES) & 1) ^ 1);
      const int q0 = (qt0 + it) * BQ;
      float* st = reinterpret_cast<float*>(smem + S::stats + s * S::stats_bytes);
      int* seg = reinterpret_cast<int*>(st + 128);
      for (int j = 0; j < 2; ++j) {
        st[lane + 32 * j] = row_lse(m_n[j], l_n[j]);
        st[64 + lane + 32 * j] = di_n[j];
        seg[lane + 32 * j] = seg_n[j];
      }
      unsigned char* tile = smem + S::ring + s * 2 * TILE_BYTES;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        tma_load_3d(tile, &P.q, &full[s], 0, q0, bh);
        tma_load_3d(tile + TILE_BYTES, &P.dout, &full[s], 0, q0, bh);
      } else {
        mbar_arrive(&full[s]);
      }
      if (it + 1 < n_iter) fetch(it + 1);
    }
    return;
  }

  // consumers: warpgroup wg owns kv rows [kw0, kw0 + 64); this thread rows
  // col[0] and col[1] of the accumulators
  const int wg = warp / 4;
  const int wi = warp % 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kw0 = k0 + 64 * wg;
  const int warp_first_col = kw0 + 16 * wi;
  const int col[2] = {warp_first_col + g, warp_first_col + g + 8};
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kseg[i] = (p.kseg != nullptr && col[i] < p.Lk)
                  ? p.kseg[(size_t)blockIdx.z * p.Lk + col[i]] : -2;
  const bool segs = p.qseg != nullptr;
  // the warpgroup's q tiles are [it_begin, n_iter): under causal masking
  // the first may lie wholly above its kv rows, and past Lk it has none; it
  // only gives those stages back
  int it_begin = kw0 < p.Lk ? 0 : n_iter;
  while (p.causal && it_begin < n_iter && (qt0 + it_begin) * BQ + BQ - 1 < kw0) ++it_begin;
  for (int it = 0; it < it_begin; ++it) {
    acquire(full, it);
    release(empty, it, lane);
  }

  const uint64_t desc_k = desc_k_major(smem + S::k + wg * TILE_BYTES);
  const uint64_t desc_v = desc_k_major(smem + S::v + wg * TILE_BYTES);
  float dk[32], dv[32], sc[32], dp[32];
  uint32_t pa[4][4], da[4][4];
  zero(dk);
  zero(dv);
  mbar_wait(own, 0);

  for (int it = it_begin; it < n_iter; ++it) {
    const int s = it % HOP_STAGES;
    const int q0 = (qt0 + it) * BQ;
    const unsigned char* tile = smem + S::ring + s * 2 * TILE_BYTES;
    const float* sLse = reinterpret_cast<const float*>(smem + S::stats + s * S::stats_bytes);
    const float* sDi = sLse + 64;
    const int* sQseg = reinterpret_cast<const int*>(sLse + 128);
    acquire(full, it);

    // S^T = K' Q'^T and dP^T = V dO^T (64 kv rows x 64 q columns), one
    // group each: P^T is computed while dP^T is still in the tensor cores
    const uint64_t desc_q = desc_k_major(tile);
    const uint64_t desc_o = desc_k_major(tile + TILE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0>(sc, desc_k + kk * K_STEP, desc_q + kk * K_STEP, kk > 0);
    wgmma_commit();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0>(dp, desc_v + kk * K_STEP, desc_o + kk * K_STEP, kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P^T in place; no mask on a tile every entry of which is visible. The
    // kv side's ids are voted on per tile too: kept across the loop, they
    // would cost registers the kernel does not have (165 of 168)
    const WarpIds q_ids = segs ? warp_ids(sQseg[lane], sQseg[lane + 32]) : WarpIds{0, true};
    const WarpIds kv_ids = segs ? warp_ids(kseg[0], kseg[1]) : WarpIds{0, true};
    const bool whole = tile_whole(q0 + BQ <= p.Lq && kw0 + 64 <= p.Lk &&
                                      (!p.causal || q0 >= warp_first_col + 15),
                                  segs, kv_ids, q_ids);
    if (whole) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * n + e] = ex2_ftz(fmaf(sc[4 * n + e], p.scale_log2, -sLse[n * 8 + 2 * t + (e & 1)]));
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          const int i = e >> 1;
          const float pr = ex2_ftz(fmaf(sc[4 * n + e], p.scale_log2, -sLse[c]));
          sc[4 * n + e] = visible(p, q0 + c, col[i], sQseg[c], kseg[i]) ? pr : 0.f;
        }
      }
    }

    // dS^T in place of dP^T (sm_scale is applied to dK' once, at the
    // store), then dV += P^T dO and dK' += dS^T Q' as one group, A from
    // registers and B the same tiles read MN-major. dS^T comes first so
    // that P^T, dP^T and both A operands are never live together: with the
    // producer warp, 168 registers a thread is the most (nine warps on four
    // sub-partitions), and past that ptxas serializes every wgmma.
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * n + e] = sc[4 * n + e] * (dp[4 * n + e] - sDi[n * 8 + 2 * t + (e & 1)]);
    acc_to_a(pa, sc);
    acc_to_a(da, dp);
    fence_regs(pa);
    fence_regs(da);
    const uint64_t desc_qt = desc_mn_major(tile);
    const uint64_t desc_ot = desc_mn_major(tile + TILE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dv, pa[kk], desc_ot + kk * MN_STEP, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dk, da[kk], desc_qt + kk * MN_STEP, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    release(empty, it, lane);
  }

  bf16* dK = static_cast<bf16*>(p.dk) + (size_t)bh * p.Lk * 64;
  bf16* dV = static_cast<bf16*>(p.dv) + (size_t)bh * p.Lk * 64;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (col[i] >= p.Lk) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 g2 = unrotate(dk[4 * n + 2 * i] * p.sm_scale,
                                 dk[4 * n + 2 * i + 1] * p.sm_scale, p.ksin, p.kcos, col[i],
                                 c, 64);
      *reinterpret_cast<__nv_bfloat162*>(dK + (size_t)col[i] * 64 + c) =
          __floats2bfloat162_rn(g2.x, g2.y);
      *reinterpret_cast<__nv_bfloat162*>(dV + (size_t)col[i] * 64 + c) =
          __floats2bfloat162_rn(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
    }
  }
}

__global__ void __launch_bounds__(HOP_THREADS, 1)
    flash_bwd_dq_hopper_kernel(const __grid_constant__ BwdTma P) {
  using S = DqSmem;
  const BwdParams& p = P.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::bars);
  uint64_t* empty = full + HOP_STAGES;
  uint64_t* own = full + 2 * HOP_STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * HOP_ROWS;  // longest causal rows first
  const int bh = blockIdx.z * p.H + blockIdx.y;
  int n_tiles = (p.Lk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + HOP_ROWS, p.Lq) - 1) / BK + 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  init_ring(full);

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      mbar_arrive_expect_tx(own, 4 * TILE_BYTES);
      for (int h = 0; h < 2; ++h) {
        tma_load_3d(smem + S::q + h * TILE_BYTES, &P.q, own, 0, q0 + 64 * h, bh);
        tma_load_3d(smem + S::dout + h * TILE_BYTES, &P.dout, own, 0, q0 + 64 * h, bh);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % HOP_STAGES;
      mbar_wait(&empty[s], ((it / HOP_STAGES) & 1) ^ 1);
      const int k0 = it * BK;
      int* seg = reinterpret_cast<int*>(smem + S::seg + s * 64 * 4);
      for (int i = lane; i < 64; i += 32)
        seg[i] = (p.kseg != nullptr && k0 + i < p.Lk)
                     ? p.kseg[(size_t)blockIdx.z * p.Lk + k0 + i] : -2;
      unsigned char* tile = smem + S::ring + s * 2 * TILE_BYTES;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        tma_load_3d(tile, &P.k, &full[s], 0, k0, bh);
        tma_load_3d(tile + TILE_BYTES, &P.v, &full[s], 0, k0, bh);
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
  float lse[2], di[2];
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < p.Lq;
    const size_t at = (size_t)bh * p.Lq + row[i];
    lse[i] = in ? row_lse(p.m[at], p.l[at]) : 0.f;
    di[i] = in ? p.di[at] : 0.f;
    qseg[i] = (p.qseg != nullptr && in) ? p.qseg[(size_t)blockIdx.z * p.Lq + row[i]] : -1;
  }
  const bool segs = p.qseg != nullptr;
  const WarpIds q_ids = warp_ids(qseg[0], qseg[1]);
  // the warpgroup's kv tiles are [0, it_end): under causal masking the
  // last may lie wholly after its q rows, and past Lq it has none; it only
  // gives those stages back
  int it_end = qw0 < p.Lq ? n_tiles : 0;
  while (p.causal && it_end > 0 && (it_end - 1) * BK > qw0 + 63) --it_end;

  const uint64_t desc_q = desc_k_major(smem + S::q + wg * TILE_BYTES);
  const uint64_t desc_o = desc_k_major(smem + S::dout + wg * TILE_BYTES);
  float dq[32], sc[32], dp[32];
  uint32_t da[4][4];
  zero(dq);
  mbar_wait(own, 0);

  for (int it = 0; it < it_end; ++it) {
    const int s = it % HOP_STAGES;
    const int k0 = it * BK;
    const unsigned char* tile = smem + S::ring + s * 2 * TILE_BYTES;
    const int* sKseg = reinterpret_cast<const int*>(smem + S::seg + s * 64 * 4);
    acquire(full, it);

    // S = Q' K'^T and dP = dO V^T (64 q rows x 64 kv columns), one group
    // each: P is computed while dP is still in the tensor cores
    const uint64_t desc_k = desc_k_major(tile);
    const uint64_t desc_v = desc_k_major(tile + TILE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0>(sc, desc_q + kk * K_STEP, desc_k + kk * K_STEP, kk > 0);
    wgmma_commit();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0>(dp, desc_o + kk * K_STEP, desc_v + kk * K_STEP, kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    const WarpIds kv_ids = segs ? warp_ids(sKseg[lane], sKseg[lane + 32]) : WarpIds{0, true};
    const bool whole = tile_whole(qw0 + 64 <= p.Lq && k0 + BK <= p.Lk &&
                                      (!p.causal || k0 + BK - 1 <= qw0 + 16 * wi),
                                  segs, q_ids, kv_ids);
    if (whole) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * n + e] = ex2_ftz(fmaf(sc[4 * n + e], p.scale_log2, -lse[e >> 1]));
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          const int i = e >> 1;
          const float pr = ex2_ftz(fmaf(sc[4 * n + e], p.scale_log2, -lse[i]));
          sc[4 * n + e] = visible(p, row[i], k0 + c, qseg[i], sKseg[c]) ? pr : 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * n + e] = sc[4 * n + e] * (dp[4 * n + e] - di[e >> 1]);

    // dQ' += dS K': A from registers, B (the K' tile) MN-major
    acc_to_a(da, dp);
    fence_regs(da);
    fence_regs(dq);
    const uint64_t desc_kt = desc_mn_major(tile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dq, da[kk], desc_kt + kk * MN_STEP, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    release(empty, it, lane);
  }
  for (int it = it_end; it < n_tiles; ++it) {
    acquire(full, it);
    release(empty, it, lane);
  }

  bf16* dQ = static_cast<bf16*>(p.dq) + (size_t)bh * p.Lq * 64;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.Lq) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 g2 = unrotate(dq[4 * n + 2 * i] * p.sm_scale,
                                 dq[4 * n + 2 * i + 1] * p.sm_scale, p.qsin, p.qcos, row[i],
                                 c, 64);
      *reinterpret_cast<__nv_bfloat162*>(dQ + (size_t)row[i] * 64 + c) =
          __floats2bfloat162_rn(g2.x, g2.y);
    }
  }
}

// The four tensor maps of a bf16 launch and the launch itself.
template <typename Kernel>
cudaError_t launch_hopper(Kernel kernel, size_t bytes, dim3 grid, const BwdParams& p,
                          cudaStream_t stream) {
  BwdTma P;
  P.p = p;
  const int bh = p.B * p.H;
  cudaError_t err;
  if ((err = tensor_map_rows(&P.q, p.q, 64, p.Lq, bh)) != cudaSuccess) return err;
  if ((err = tensor_map_rows(&P.k, p.k, 64, p.Lk, bh)) != cudaSuccess) return err;
  if ((err = tensor_map_rows(&P.v, p.v, 64, p.Lk, bh)) != cudaSuccess) return err;
  if ((err = tensor_map_rows(&P.dout, p.dout, 64, p.Lq, bh)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, HOP_THREADS, bytes, stream>>>(P);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 kernels: CUDA cores, tiles staged in shared memory
// ---------------------------------------------------------------------------

// Row pitches padded by one element: column walks hit 32 different banks.
template <int D>
struct BwdSmemF32 {
  static constexpr int LDT = D + 1;   // row tiles (q, dO, k, v)
  static constexpr int LDS = 64 + 1;  // P^T / dS^T (dkv) or dS (dq)
  static constexpr size_t tile = round128(sizeof(float) * 64 * LDT);
  static constexpr size_t sq = round128(sizeof(float) * 64 * LDS);
  static constexpr size_t a = 0;                // dkv: Q'     dq: K'
  static constexpr size_t b = tile;             // dkv: dO     dq: V
  static constexpr size_t c = 2 * tile;         // dkv: own K' dq: own Q'
  static constexpr size_t d = 3 * tile;         // dkv: own V  dq: own dO
  static constexpr size_t p = 4 * tile;         // dkv: P^T    dq: dS
  static constexpr size_t ds = p + sq;          // dkv: dS^T
  static constexpr size_t stats = ds + sq;      // m, 1/l, di of the q tile
  static constexpr size_t seg = stats + round128(sizeof(float) * 3 * 64);
  static constexpr size_t bytes = seg + round128(sizeof(int) * 64);
};

// Thread layout of both fp32 kernels: row r = tid / 2 of the block's own
// 64 rows, and half h = tid & 1 of the 64 columns (streamed rows, or head
// dims) it works on.
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_f32_kernel(BwdParams p) {
  using S = BwdSmemF32<D>;
  constexpr int LDT = S::LDT;
  constexpr int LDS = S::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + S::a);
  float* sdO = reinterpret_cast<float*>(smem + S::b);
  float* sK = reinterpret_cast<float*>(smem + S::c);
  float* sV = reinterpret_cast<float*>(smem + S::d);
  float* sP = reinterpret_cast<float*>(smem + S::p);    // [kv j][q i]
  float* sdS = reinterpret_cast<float*>(smem + S::ds);  // [kv j][q i]
  float* sM = reinterpret_cast<float*>(smem + S::stats);
  float* sInvL = sM + 64;
  float* sDi = sM + 128;
  int* sQseg = reinterpret_cast<int*>(smem + S::seg);

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + blockIdx.y;
  const float* Q = static_cast<const float*>(p.q) + bh * p.Lq * D;
  const float* dO = static_cast<const float*>(p.dout) + bh * p.Lq * D;
  const float* K = static_cast<const float*>(p.k) + bh * p.Lk * D;
  const float* V = static_cast<const float*>(p.v) + bh * p.Lk * D;

  load_tile_f32<D, LDT>(sK, K, k0, p.Lk, p.ksin, p.kcos);
  load_tile_f32<D, LDT>(sV, V, k0, p.Lk, nullptr, nullptr);
  const int j = threadIdx.x / 2;  // this thread's kv row
  const int h = threadIdx.x & 1;
  const int col = k0 + j;
  const int kseg = (p.kseg != nullptr && col < p.Lk) ? p.kseg[(size_t)b * p.Lk + col] : -2;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int d = 0; d < D / 2; ++d) dk[d] = dv[d] = 0.f;

  const int n_qt = (p.Lq + BQ - 1) / BQ;
  for (int qt = p.causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile_f32<D, LDT>(sQ, Q, q0, p.Lq, p.qsin, p.qcos);
    load_tile_f32<D, LDT>(sdO, dO, q0, p.Lq, nullptr, nullptr);
    load_row_stats(p, bh, q0, sM, sInvL, sDi);
    load_seg(sQseg, p.qseg ? p.qseg + (size_t)b * p.Lq : nullptr, q0, BQ, p.Lq, -1);
    __syncthreads();

    // P^T and dS^T for kv row j against q columns [32h, 32h + 32)
    for (int ii = 0; ii < 32; ++ii) {
      const int i = h * 32 + ii;
      float pr = 0.f, ds = 0.f;
      if (visible(p, q0 + i, col, sQseg[i], kseg)) {
        float s = 0.f, dpv = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s += sK[j * LDT + d] * sQ[i * LDT + d];
          dpv += sV[j * LDT + d] * sdO[i * LDT + d];
        }
        pr = exp2f(s * p.scale_log2 - sM[i]) * sInvL[i];
        ds = pr * (dpv - sDi[i]) * p.sm_scale;
      }
      sP[j * LDS + i] = pr;
      sdS[j * LDS + i] = ds;
    }
    __syncthreads();

    // dV[j] += P^T[j] dO and dK'[j] += dS^T[j] Q' over head dims [32h, 32h + 32)
    for (int i = 0; i < BQ; ++i) {
      const float pr = sP[j * LDS + i];
      const float ds = sdS[j * LDS + i];
#pragma unroll
      for (int d = 0; d < D / 2; ++d) {
        dv[d] += pr * sdO[i * LDT + h * (D / 2) + d];
        dk[d] += ds * sQ[i * LDT + h * (D / 2) + d];
      }
    }
  }

  if (col < p.Lk) {
    float* dK = static_cast<float*>(p.dk) + bh * p.Lk * D + (size_t)col * D;
    float* dV = static_cast<float*>(p.dv) + bh * p.Lk * D + (size_t)col * D;
#pragma unroll
    for (int d = 0; d < D / 2; d += 2) {
      const int c = h * (D / 2) + d;
      const float2 g2 = unrotate(dk[d], dk[d + 1], p.ksin, p.kcos, col, c, D);
      dK[c] = g2.x;
      dK[c + 1] = g2.y;
      dV[c] = dv[d];
      dV[c + 1] = dv[d + 1];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_f32_kernel(BwdParams p) {
  using S = BwdSmemF32<D>;
  constexpr int LDT = S::LDT;
  constexpr int LDS = S::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem + S::a);
  float* sV = reinterpret_cast<float*>(smem + S::b);
  float* sQ = reinterpret_cast<float*>(smem + S::c);
  float* sdO = reinterpret_cast<float*>(smem + S::d);
  float* sdS = reinterpret_cast<float*>(smem + S::p);  // [q i][kv j]
  int* sKseg = reinterpret_cast<int*>(smem + S::seg);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + blockIdx.y;
  const float* Q = static_cast<const float*>(p.q) + bh * p.Lq * D;
  const float* dO = static_cast<const float*>(p.dout) + bh * p.Lq * D;
  const float* K = static_cast<const float*>(p.k) + bh * p.Lk * D;
  const float* V = static_cast<const float*>(p.v) + bh * p.Lk * D;

  load_tile_f32<D, LDT>(sQ, Q, q0, p.Lq, p.qsin, p.qcos);
  load_tile_f32<D, LDT>(sdO, dO, q0, p.Lq, nullptr, nullptr);
  const int i = threadIdx.x / 2;  // this thread's q row
  const int h = threadIdx.x & 1;
  const int row = q0 + i;
  const bool in = row < p.Lq;
  const size_t at = bh * p.Lq + row;
  const float l = in ? p.l[at] : 0.f;
  const float m_r = in ? p.m[at] : 0.f;
  const float invl = l == 0.f ? 1.f : 1.f / l;
  const float di = in ? p.di[at] : 0.f;
  const int qseg = (p.qseg != nullptr && in) ? p.qseg[(size_t)b * p.Lq + row] : -1;
  float dq[D / 2];
#pragma unroll
  for (int d = 0; d < D / 2; ++d) dq[d] = 0.f;

  int n_tiles = (p.Lk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    load_tile_f32<D, LDT>(sK, K, k0, p.Lk, p.ksin, p.kcos);
    load_tile_f32<D, LDT>(sV, V, k0, p.Lk, nullptr, nullptr);
    load_seg(sKseg, p.kseg ? p.kseg + (size_t)b * p.Lk : nullptr, k0, BK, p.Lk, -2);
    __syncthreads();

    // dS for q row i against kv columns [32h, 32h + 32)
    for (int jj = 0; jj < 32; ++jj) {
      const int j = h * 32 + jj;
      float ds = 0.f;
      if (visible(p, row, k0 + j, qseg, sKseg[j])) {
        float s = 0.f, dpv = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s += sQ[i * LDT + d] * sK[j * LDT + d];
          dpv += sdO[i * LDT + d] * sV[j * LDT + d];
        }
        const float pr = exp2f(s * p.scale_log2 - m_r) * invl;
        ds = pr * (dpv - di) * p.sm_scale;
      }
      sdS[i * LDS + j] = ds;
    }
    __syncthreads();

    // dQ'[i] += dS[i] K' over head dims [32h, 32h + 32)
    for (int j = 0; j < BK; ++j) {
      const float ds = sdS[i * LDS + j];
#pragma unroll
      for (int d = 0; d < D / 2; ++d) dq[d] += ds * sK[j * LDT + h * (D / 2) + d];
    }
  }

  if (in) {
    float* dQ = static_cast<float*>(p.dq) + bh * p.Lq * D + (size_t)row * D;
#pragma unroll
    for (int d = 0; d < D / 2; d += 2) {
      const int c = h * (D / 2) + d;
      const float2 g2 = unrotate(dq[d], dq[d + 1], p.qsin, p.qcos, row, c, D);
      dQ[c] = g2.x;
      dQ[c + 1] = g2.y;
    }
  }
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const void* l, const void* m, const void* di,
                      const void* qseg, const void* kseg, const void* qsin,
                      const void* qcos, const void* ksin, const void* kcos,
                      int B, int H, int Lq, int Lk, int causal, float scale_log2,
                      float sm_scale) {
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.l = static_cast<const float*>(l);
  p.m = static_cast<const float*>(m);
  p.di = static_cast<const float*>(di);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.qsin = static_cast<const float*>(qsin);
  p.qcos = static_cast<const float*>(qcos);
  p.ksin = static_cast<const float*>(ksin);
  p.kcos = static_cast<const float*>(kcos);
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.scale_log2 = scale_log2;
  p.sm_scale = sm_scale;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head dim 64 only (the flagship
// decoder's). Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a head dim or type it does not take (or a
// tensor that cannot be mapped for TMA).

// The pre-pass: di = rowsum(o * dout) when o is given, q' = rot(q) when q_r
// is given and k' = rot(k) when k_r is given (raw tables).
extern "C" int kx_flash_bwd_prep(const void* q, const void* k, const void* o,
                                 const void* dout, const void* qsin, const void* qcos,
                                 const void* ksin, const void* kcos, void* q_r,
                                 void* k_r, void* di, int B, int H, int Lq, int Lk,
                                 int head_dim, int dtype, void* stream) {
  PrepParams p = {};
  p.q = q;
  p.k = k;
  p.o = o;
  p.dout = dout;
  p.qsin = static_cast<const float*>(qsin);
  p.qcos = static_cast<const float*>(qcos);
  p.ksin = static_cast<const float*>(ksin);
  p.kcos = static_cast<const float*>(kcos);
  p.q_r = q_r;
  p.k_r = k_r;
  p.di = o != nullptr ? static_cast<float*>(di) : nullptr;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && head_dim == 64) {
    flash_bwd_prep_kernel<bf16, 64><<<prep_grid<bf16>(p), PREP_THREADS, 0, s>>>(p);
  } else if (dtype == 0 && head_dim == 64) {
    flash_bwd_prep_kernel<float, 64><<<prep_grid<float>(p), PREP_THREADS, 0, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The forward's rotation (bf16 only: the fp32 forward kernel rotates its
// tiles itself): q' = rot(q) with the q tables, which carry sm_scale *
// log2(e), and k' = rot(k), each rounded to bf16 once.
extern "C" int kx_flash_fwd_prep(const void* q, const void* k, const void* qsin,
                                 const void* qcos, const void* ksin, const void* kcos,
                                 void* q_r, void* k_r, int B, int H, int Lq, int Lk,
                                 int head_dim, void* stream) {
  PrepParams p = {};
  p.q = q;
  p.k = k;
  p.qsin = static_cast<const float*>(qsin);
  p.qcos = static_cast<const float*>(qcos);
  p.ksin = static_cast<const float*>(ksin);
  p.kcos = static_cast<const float*>(kcos);
  p.q_r = q_r;
  p.k_r = k_r;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  if (head_dim != 64) return cudaErrorInvalidValue;
  flash_fwd_prep_kernel<bf16, 64><<<prep_grid<bf16>(p), PREP_THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// bf16: q and k are the pre-pass's q' and k' (the tables only map dK' back);
// fp32: raw q and k, rotated in the kernel.
extern "C" int kx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* l, const void* m,
                                const void* di, const void* qseg, const void* kseg,
                                const void* qsin, const void* qcos,
                                const void* ksin, const void* kcos,
                                void* dk, void* dv,
                                int B, int H, int Lq, int Lk, int head_dim,
                                int dtype, int causal, float scale_log2,
                                float sm_scale, void* stream) {
  BwdParams p = make_params(q, k, v, dout, l, m, di, qseg, kseg, qsin, qcos, ksin,
                            kcos, B, H, Lq, Lk, causal, scale_log2, sm_scale);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && head_dim == 64)
    return launch_hopper(flash_bwd_dkv_hopper_kernel, DkvSmem::bytes,
                         dim3((Lk + HOP_ROWS - 1) / HOP_ROWS, H, B), p, s);
  if (dtype == 0 && head_dim == 64)
    return launch(flash_bwd_dkv_f32_kernel<64>, BwdSmemF32<64>::bytes,
                  dim3((Lk + BK - 1) / BK, H, B), p, s);
  return cudaErrorInvalidValue;
}

// q and k as for kx_flash_bwd_dkv; the q tables map dQ' back.
extern "C" int kx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* l, const void* m,
                               const void* di, const void* qseg, const void* kseg,
                               const void* qsin, const void* qcos,
                               const void* ksin, const void* kcos, void* dq,
                               int B, int H, int Lq, int Lk, int head_dim,
                               int dtype, int causal, float scale_log2,
                               float sm_scale, void* stream) {
  BwdParams p = make_params(q, k, v, dout, l, m, di, qseg, kseg, qsin, qcos, ksin,
                            kcos, B, H, Lq, Lk, causal, scale_log2, sm_scale);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && head_dim == 64)
    return launch_hopper(flash_bwd_dq_hopper_kernel, DqSmem::bytes,
                         dim3((Lq + HOP_ROWS - 1) / HOP_ROWS, H, B), p, s);
  if (dtype == 0 && head_dim == 64)
    return launch(flash_bwd_dq_f32_kernel<64>, BwdSmemF32<64>::bytes,
                  dim3((Lq + BQ - 1) / BQ, H, B), p, s);
  return cudaErrorInvalidValue;
}
