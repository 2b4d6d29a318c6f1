// Flash-attention forward for Hopper (sm_90a), with optional fused xPos.
//
// Replaces the Pallas TPU kernel kosmosx_tpu/ops/flash_attention.py::_fwd_kernel
// (driven by _fwd, pallas_call at :303). It computes the same function:
// o = softmax(q k^T * sm_scale) v per (batch, head), online softmax in the
// log2 domain (exp2, sm_scale*log2(e) folded into the scores or, with fused
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
// Design (first version; wgmma, TMA and warp specialisation are later work):
// - one block of 4 warps per (64-row q tile, head, batch), each warp owning
//   16 q rows; a loop over 64-row kv tiles replaces the TPU's sequential kv
//   grid axis; under causal masking the tiles above the diagonal are never
//   loaded, and q tiles run from the last (longest) to the first;
// - K and V tiles are staged in shared memory, rotated by xPos from the fp32
//   sin/cos tables as they are loaded and rounded to the input type, as
//   _apply_rot does (:142-147); the TPU's rotation matrix is gone;
// - bf16: FlashAttention-2 style. q k^T and p v are mma.sync m16n8k16 with
//   fp32 accumulation; the scores, the softmax state and the output stay in
//   registers, and the score fragments are reused directly as the A operand
//   of p v; V's B fragments come from ldmatrix.trans;
// - fp32 (used to check the kernel at a tight bar): the same loop on the CUDA
//   cores, with scores and output rows staged in shared memory;
// - rows past Lq and columns past Lk are bounded in the kernel, so the
//   wrapper pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace kx_flash;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const int* qseg;      // (B, Lq) or null
  const int* kseg;      // (B, Lk) or null
  const float* qsin;    // (Lq, D) or null: fused xPos, scale*log2e folded in
  const float* qcos;
  const float* ksin;    // (Lk, D)
  const float* kcos;
  void* o;              // (B, H, Lq, D), input type
  float* l;             // (B, H, Lq)
  float* m;             // (B, H, Lq)
  int B, H, Lq, Lk, causal;
  float scale_log2;     // sm_scale * log2(e), applied to the scores when no xPos
};

// The visibility rule shared by both kernels.
__device__ __forceinline__ bool visible(const FlashParams& p, int row, int col,
                                        int qseg, int kseg) {
  return col < p.Lk && (!p.causal || col <= row) &&
         (p.qseg == nullptr || qseg == kseg);
}

// ---------------------------------------------------------------------------
// bf16 kernel: register-level mma.sync
// ---------------------------------------------------------------------------

// Row pitch D + 8 elements: 16-byte rows for ldmatrix, and the 32-bit
// fragment loads of 8 rows x 4 lanes fall on 32 different banks.
template <int D>
struct SmemBf16 {
  static constexpr int LD = D + 8;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + round128(sizeof(bf16) * BQ * LD);
  static constexpr size_t v = k + round128(sizeof(bf16) * BK * LD);
  static constexpr size_t qseg = v + round128(sizeof(bf16) * BK * LD);
  static constexpr size_t kseg = qseg + round128(sizeof(int) * BQ);
  static constexpr size_t bytes = kseg + round128(sizeof(int) * BK);
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_bf16_kernel(FlashParams p) {
  using L = SmemBf16<D>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  int* sQseg = reinterpret_cast<int*>(smem + L::qseg);
  int* sKseg = reinterpret_cast<int*>(smem + L::kseg);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const bf16* Q = static_cast<const bf16*>(p.q) + bh * p.Lq * D;
  const bf16* K = static_cast<const bf16*>(p.k) + bh * p.Lk * D;
  const bf16* V = static_cast<const bf16*>(p.v) + bh * p.Lk * D;
  const bool xpos = p.qsin != nullptr;

  load_tile_bf16<D, LD>(sQ, Q, q0, p.Lq, p.qsin, p.qcos);
  load_seg(sQseg, p.qseg ? p.qseg + (size_t)b * p.Lq : nullptr, q0, BQ, p.Lq, -1);
  __syncthreads();

  // this thread's rows: local ra (fragment elements 0, 1) and ra + 8 (2, 3)
  const int ra = warp * 16 + g;
  const int row[2] = {q0 + ra, q0 + ra + 8};
  const int qseg[2] = {sQseg[ra], sQseg[ra + 8]};
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
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};  // this thread's part of the row sums

  int n_tiles = (p.Lk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  const int warp_last_row = q0 + warp * 16 + 15;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, LD>(sK, K, k0, p.Lk, p.ksin, p.kcos);
    load_tile_bf16<D, LD>(sV, V, k0, p.Lk, nullptr, nullptr);
    load_seg(sKseg, p.kseg ? p.kseg + (size_t)b * p.Lk : nullptr, k0, BK, p.Lk, -2);
    __syncthreads();
    // a tile wholly above this warp's rows adds nothing (tile 0 never is)
    if (p.causal && k0 > warp_last_row) continue;

    // S = Q K^T: 8 fragments of 16 rows x 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* krow = sK + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[n], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    // scale and mask; the mask is skipped on tiles every row sees whole
    const bool whole = p.qseg == nullptr && k0 + BK <= p.Lk &&
                       (!p.causal || k0 + BK - 1 <= q0 + warp * 16);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = xpos ? s[n][e] : s[n][e] * p.scale_log2;
        if (!whole) {
          const int c = n * 8 + 2 * t + (e & 1);
          if (!visible(p, row[e >> 1], k0 + c, qseg[e >> 1], sKseg[c])) x = MASK_VALUE;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
    // p = exp2(s - m); a masked score adds nothing even when every score
    // of the row so far is masked
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float pr = x == MASK_VALUE ? 0.f : exp2f(x - m_run[e >> 1]);
        s[n][e] = pr;
        l_run[e >> 1] += pr;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: the score fragments are the A operand, rounded to bf16
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

  bf16* O = static_cast<bf16*>(p.o) + bh * p.Lq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row[i] >= p.Lq) continue;
    const float inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(O + (size_t)row[i] * D + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
    if (t == 0) {
      p.l[bh * p.Lq + row[i]] = l;
      p.m[bh * p.Lq + row[i]] = m_run[i];
    }
  }
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

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* Q = static_cast<const float*>(p.q) + bh * p.Lq * D;
  const float* K = static_cast<const float*>(p.k) + bh * p.Lk * D;
  const float* V = static_cast<const float*>(p.v) + bh * p.Lk * D;
  const bool xpos = p.qsin != nullptr;

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
      float x = xpos ? srow[c] : srow[c] * p.scale_log2;
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

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a head dim or type it does not take.
extern "C" int kx_flash_fwd(const void* q, const void* k, const void* v,
                            const void* qseg, const void* kseg,
                            const void* qsin, const void* qcos,
                            const void* ksin, const void* kcos,
                            void* o, void* l, void* m,
                            int B, int H, int Lq, int Lk, int head_dim,
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
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  // head dim 64 only: the flagship decoder's
  if (dtype == 1 && head_dim == 64)
    return launch(flash_fwd_bf16_kernel<64>, SmemBf16<64>::bytes, grid, p, s);
  if (dtype == 0 && head_dim == 64)
    return launch(flash_fwd_f32_kernel<64>, SmemF32<64>::bytes, grid, p, s);
  return cudaErrorInvalidValue;
}
