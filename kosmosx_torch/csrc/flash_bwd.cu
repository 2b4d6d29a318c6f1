// Flash-attention backward for Hopper (sm_90a): the dK/dV kernel and the dQ
// kernel, with optional fused xPos.
//
// Replaces the Pallas TPU kernels of kosmosx_tpu/ops/flash_attention.py::_bwd:
// _bwd_dkv_kernel (:348-408, pallas_call at :515) and _bwd_dq_kernel
// (:411-464, pallas_call at :590). They compute the same functions from the
// forward's residuals (o, l, m) and di = rowsum(o * dO), which the wrapper
// computes outside the kernels as _bwd does (:476):
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
// tile against two) over the same bytes, so it is bound by the tensor cores
// and the exp2 recompute, not by device memory.
//
// Design (first version; wgmma, TMA and pipelining are later work). The
// FlashAttention-2 split of the JAX package is kept: dK/dV and dQ are two
// kernels, so no block adds into another's output, dQ needs no atomics, and
// two runs give bit-identical gradients.
// - dK/dV: one block of 4 warps per (64-row kv tile, head, batch), each warp
//   owning 16 kv rows whose K' and V fragments stay in registers; a loop
//   over the q tiles on or below the diagonal (all of them without causal)
//   replaces the TPU's sequential q grid axis. Per q tile, Q' and dO are
//   staged in shared memory with m, 1/l, di and the q segment ids; S^T and
//   dP^T are computed per warp as 16 x 64 register tiles, turned into P^T
//   and dS^T in place, and reused as the A operand of dV += P^T dO and
//   dK += dS^T Q' (B fragments from ldmatrix.trans).
// - dQ: one block per (64-row q tile, head, batch), each warp owning 16 q
//   rows with Q', dO, m, 1/l and di in registers; a loop over the kv tiles
//   on or below the diagonal; dQ += dS K' with K' from ldmatrix.trans.
//   Blocks run from the last (longest) q tile to the first.
// - bf16: mma.sync m16n8k16 with fp32 accumulation; P and dS are rounded to
//   bf16 as operands (the usual FlashAttention-2 choice, which sets the bf16
//   bar); the recompute, the masks and the statistics stay fp32.
// - fp32 (the path that holds the kernels at a tight bar): the same loops on
//   the CUDA cores with TF32 off, P^T/dS^T or dS staged in shared memory.
// - rows past Lq and Lk are bounded in the kernels; the wrapper pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace kx_flash;

struct BwdParams {
  const void* q;        // (B, H, Lq, D)
  const void* k;        // (B, H, Lk, D)
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

__device__ __forceinline__ bool visible(const BwdParams& p, int row, int col,
                                        int qseg, int kseg) {
  return row < p.Lq && col < p.Lk && (!p.causal || col <= row) &&
         (p.qseg == nullptr || qseg == kseg);
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
// bf16 kernels: register-level mma.sync
// ---------------------------------------------------------------------------

// Row pitch D + 8 elements, as in the forward: 16-byte rows for ldmatrix,
// and the 32-bit fragment loads of 8 rows x 4 lanes on 32 different banks.
template <int D>
struct BwdSmemBf16 {
  static constexpr int LD = D + 8;
  static constexpr size_t tile = round128(sizeof(bf16) * 64 * LD);
  static constexpr size_t a = 0;          // dkv: Q' tile    dq: K' tile
  static constexpr size_t b = tile;       // dkv: dO tile    dq: V tile
  static constexpr size_t c = 2 * tile;   // dkv: own K'     dq: own Q'
  static constexpr size_t d = 3 * tile;   // dkv: own V      dq: own dO
  static constexpr size_t stats = 4 * tile;                   // m, 1/l, di
  static constexpr size_t seg = stats + round128(sizeof(float) * 3 * 64);
  static constexpr size_t bytes = seg + round128(sizeof(int) * 64);
};

// A fragments (16 rows x D) of rows [r0, r0 + 16) of a staged tile.
template <int D, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const bf16* s,
                                             int ra, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = ld32(s + ra * LD + kk * 16 + 2 * t);
    f[kk][1] = ld32(s + (ra + 8) * LD + kk * 16 + 2 * t);
    f[kk][2] = ld32(s + ra * LD + kk * 16 + 8 + 2 * t);
    f[kk][3] = ld32(s + (ra + 8) * LD + kk * 16 + 8 + 2 * t);
  }
}

// acc[n] (16 x 8 blocks, n < 8) = A (16 x D, fragments) times the transpose
// of rows [0, 64) of a staged (64 x D) tile.
template <int D, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* s, int g, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const bf16* row = s + (n * 8 + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_bf16(acc[n], a[kk], ld32(row + kk * 16), ld32(row + kk * 16 + 8));
  }
}

// acc (16 x D) += X (16 x 64, from the fp32 fragments x, rounded to bf16)
// times a staged (64 x D) tile, whose B fragments come from ldmatrix.trans.
template <int D, int LD>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const float (&x)[8][4],
                                       const bf16* s, int lane) {
  const int mat = lane >> 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                           pack_bf16(x[2 * j][2], x[2 * j][3]),
                           pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
    const bf16* row = s + (j * 16 + (mat & 1) * 8 + (lane & 7)) * LD + (mat >> 1) * 8;
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, row + nd * 16);
      mma_bf16(acc[2 * nd], a, bfr[0], bfr[1]);
      mma_bf16(acc[2 * nd + 1], a, bfr[2], bfr[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_bf16_kernel(BwdParams p) {
  using S = BwdSmemBf16<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + S::a);
  bf16* sdO = reinterpret_cast<bf16*>(smem + S::b);
  bf16* sK = reinterpret_cast<bf16*>(smem + S::c);
  bf16* sV = reinterpret_cast<bf16*>(smem + S::d);
  float* sM = reinterpret_cast<float*>(smem + S::stats);
  float* sInvL = sM + 64;
  float* sDi = sM + 128;
  int* sQseg = reinterpret_cast<int*>(smem + S::seg);

  const int k0 = blockIdx.x * BK;  // kv tile 0 has the most q tiles: first
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* Q = static_cast<const bf16*>(p.q) + bh * p.Lq * D;
  const bf16* dO = static_cast<const bf16*>(p.dout) + bh * p.Lq * D;
  const bf16* K = static_cast<const bf16*>(p.k) + bh * p.Lk * D;
  const bf16* V = static_cast<const bf16*>(p.v) + bh * p.Lk * D;

  // this warp's 16 kv rows: K' (rotated once, here) and V as A fragments
  load_tile_bf16<D, LD>(sK, K, k0, p.Lk, p.ksin, p.kcos);
  load_tile_bf16<D, LD>(sV, V, k0, p.Lk, nullptr, nullptr);
  __syncthreads();
  const int ra = warp * 16 + g;
  const int col[2] = {k0 + ra, k0 + ra + 8};
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kseg[i] = (p.kseg != nullptr && col[i] < p.Lk) ? p.kseg[(size_t)b * p.Lk + col[i]] : -2;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D, LD>(kf, sK, ra, t);
  load_a_frags<D, LD>(vf, sV, ra, t);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_qt = (p.Lq + BQ - 1) / BQ;
  const int warp_first_col = k0 + warp * 16;
  for (int qt = p.causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous Q'/dO tile
    load_tile_bf16<D, LD>(sQ, Q, q0, p.Lq, p.qsin, p.qcos);
    load_tile_bf16<D, LD>(sdO, dO, q0, p.Lq, nullptr, nullptr);
    load_row_stats(p, bh, q0, sM, sInvL, sDi);
    load_seg(sQseg, p.qseg ? p.qseg + (size_t)b * p.Lq : nullptr, q0, BQ, p.Lq, -1);
    __syncthreads();
    // every q row of the tile lies before this warp's kv rows: nothing to add
    if (p.causal && q0 + BQ - 1 < warp_first_col) continue;

    // S^T = K' Q'^T and dP^T = V dO^T: 16 kv rows x 64 q columns
    float s[8][4], dp[8][4];
    mma_abt<D, LD>(s, kf, sQ, g, t);
    mma_abt<D, LD>(dp, vf, sdO, g, t);

    // P^T and dS^T in place; no mask on a tile every entry of which is visible
    const bool whole = p.qseg == nullptr && q0 + BQ <= p.Lq && k0 + BK <= p.Lk &&
                       (!p.causal || q0 >= warp_first_col + 15);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const int i = e >> 1;
        float pr = 0.f;
        if (whole || visible(p, q0 + c, col[i], sQseg[c], kseg[i]))
          pr = exp2f(s[n][e] * p.scale_log2 - sM[c]) * sInvL[c];
        s[n][e] = pr;
        dp[n][e] = pr * (dp[n][e] - sDi[c]) * p.sm_scale;
      }
    }
    mma_ab<D, LD>(dv, s, sdO, lane);   // dV += P^T dO
    mma_ab<D, LD>(dk, dp, sQ, lane);   // dK' += dS^T Q'
  }

  bf16* dK = static_cast<bf16*>(p.dk) + bh * p.Lk * D;
  bf16* dV = static_cast<bf16*>(p.dv) + bh * p.Lk * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (col[i] >= p.Lk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 g2 = unrotate(dk[n][2 * i], dk[n][2 * i + 1], p.ksin, p.kcos,
                                 col[i], c, D);
      *reinterpret_cast<__nv_bfloat162*>(dK + (size_t)col[i] * D + c) =
          __floats2bfloat162_rn(g2.x, g2.y);
      *reinterpret_cast<__nv_bfloat162*>(dV + (size_t)col[i] * D + c) =
          __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_bf16_kernel(BwdParams p) {
  using S = BwdSmemBf16<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + S::a);
  bf16* sV = reinterpret_cast<bf16*>(smem + S::b);
  bf16* sQ = reinterpret_cast<bf16*>(smem + S::c);
  bf16* sdO = reinterpret_cast<bf16*>(smem + S::d);
  int* sKseg = reinterpret_cast<int*>(smem + S::seg);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* Q = static_cast<const bf16*>(p.q) + bh * p.Lq * D;
  const bf16* dO = static_cast<const bf16*>(p.dout) + bh * p.Lq * D;
  const bf16* K = static_cast<const bf16*>(p.k) + bh * p.Lk * D;
  const bf16* V = static_cast<const bf16*>(p.v) + bh * p.Lk * D;

  load_tile_bf16<D, LD>(sQ, Q, q0, p.Lq, p.qsin, p.qcos);
  load_tile_bf16<D, LD>(sdO, dO, q0, p.Lq, nullptr, nullptr);
  __syncthreads();
  const int ra = warp * 16 + g;
  const int row[2] = {q0 + ra, q0 + ra + 8};
  float m_r[2], invl[2], di[2];
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < p.Lq;
    const size_t at = bh * p.Lq + row[i];
    const float l = in ? p.l[at] : 0.f;
    m_r[i] = in ? p.m[at] : 0.f;
    invl[i] = l == 0.f ? 1.f : 1.f / l;
    di[i] = in ? p.di[at] : 0.f;
    qseg[i] = (p.qseg != nullptr && in) ? p.qseg[(size_t)b * p.Lq + row[i]] : -1;
  }
  uint32_t qf[D / 16][4], of[D / 16][4];
  load_a_frags<D, LD>(qf, sQ, ra, t);
  load_a_frags<D, LD>(of, sdO, ra, t);

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int n_tiles = (p.Lk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  const int warp_last_row = q0 + warp * 16 + 15;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous K'/V tile
    load_tile_bf16<D, LD>(sK, K, k0, p.Lk, p.ksin, p.kcos);
    load_tile_bf16<D, LD>(sV, V, k0, p.Lk, nullptr, nullptr);
    load_seg(sKseg, p.kseg ? p.kseg + (size_t)b * p.Lk : nullptr, k0, BK, p.Lk, -2);
    __syncthreads();
    if (p.causal && k0 > warp_last_row) continue;

    // S = Q' K'^T and dP = dO V^T: 16 q rows x 64 kv columns
    float s[8][4], dp[8][4];
    mma_abt<D, LD>(s, qf, sK, g, t);
    mma_abt<D, LD>(dp, of, sV, g, t);

    const bool whole = p.qseg == nullptr && q0 + BQ <= p.Lq && k0 + BK <= p.Lk &&
                       (!p.causal || k0 + BK - 1 <= q0 + warp * 16);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const int i = e >> 1;
        float pr = 0.f;
        if (whole || visible(p, row[i], k0 + c, qseg[i], sKseg[c]))
          pr = exp2f(s[n][e] * p.scale_log2 - m_r[i]) * invl[i];
        dp[n][e] = pr * (dp[n][e] - di[i]) * p.sm_scale;
      }
    }
    mma_ab<D, LD>(dq, dp, sK, lane);  // dQ' += dS K'
  }

  bf16* dQ = static_cast<bf16*>(p.dq) + bh * p.Lq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.Lq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 g2 = unrotate(dq[n][2 * i], dq[n][2 * i + 1], p.qsin, p.qcos,
                                 row[i], c, D);
      *reinterpret_cast<__nv_bfloat162*>(dQ + (size_t)row[i] * D + c) =
          __floats2bfloat162_rn(g2.x, g2.y);
    }
  }
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
// cudaErrorInvalidValue for a head dim or type it does not take.
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
  const dim3 grid((Lk + BK - 1) / BK, H, B);
  if (dtype == 1 && head_dim == 64)
    return launch(flash_bwd_dkv_bf16_kernel<64>, BwdSmemBf16<64>::bytes, grid, p, s);
  if (dtype == 0 && head_dim == 64)
    return launch(flash_bwd_dkv_f32_kernel<64>, BwdSmemF32<64>::bytes, grid, p, s);
  return cudaErrorInvalidValue;
}

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
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  if (dtype == 1 && head_dim == 64)
    return launch(flash_bwd_dq_bf16_kernel<64>, BwdSmemBf16<64>::bytes, grid, p, s);
  if (dtype == 0 && head_dim == 64)
    return launch(flash_bwd_dq_f32_kernel<64>, BwdSmemF32<64>::bytes, grid, p, s);
  return cudaErrorInvalidValue;
}
