// Weight-only int8 (W8) matmul for Hopper (sm_90a): y = (x @ q) * scale.
//
// Replaces the Pallas TPU kernels kosmosx_tpu/ops/quant_matmul.py::_kernel
// (driven by _w8_matmul_2d, pallas_call at :89) and ::_stacked_kernel
// (driven by _w8_matmul_stacked_2d, pallas_call at :199). x is (M, K) bf16
// or fp32; q holds the int8 codes of one (K, N) weight, or of L stacked
// (L, K, N) weights of which layer `layer` is used; scale is the fp32
// per-output-channel scale, (L, N). The rows of codes start `ldq` codes
// apart (ldq >= N): a (K, N) view of a (K, round_up(N, 16)) buffer, as
// utils/quantize.py makes the codes of a weight whose N is not a multiple of
// 16, gives TMA a row pitch it can map. As in the Pallas kernels the codes are
// dequantised on the tile (exact: |q| <= 127 fits bf16), the products
// accumulate in fp32, and the scale is applied once per output in fp32
// before the one rounding to x's type (:70-72).
//
// What bounds it on this card: at decode (M = 4..8) every code serves M rows
// only, about 2M flops per byte, far below the ~295 where the H100 turns
// compute-bound, so the kernel is a stream over the int8 codes: half the
// bytes of the bf16 weight, and about a fifth of what the plain version moves
// (it reads the codes, writes a bf16 copy and reads that again). At prefill
// (M in the thousands) the tensor cores bound the function.
//
// Three kernels, chosen on the host by shape (ops/quant_matmul.py::_w8_plan):
// - w8_bf16_hopper_kernel, bf16 x with K % 8 == 0, a code row pitch that is
//   a multiple of 16, N even and x and q 16-byte aligned (every decoder and
//   ViT projection, the resampler, the vocab head on padded codes): TMA
//   and wgmma. One block per (BM rows, 128 columns, K split): two consumer
//   warpgroups and one producer warp, two of whose lanes stream, per 64
//   K-columns, x's (BM, 64) box (2-D map over (K, M), 128-byte swizzle:
//   the K-major A operand as it is; rows past M read as zeros) and the
//   codes' (64, 128) int8 box (2-D map over the whole (L K, N) array at
//   the codes' pitch, so the last column tile reads zeros past N; the
//   stacked layer is a row offset of layer * K read on the device, so no
//   slice is copied and the host never syncs), each through a ring of its
//   own: a code stage goes back as soon as it is converted, an x stage when
//   the products that read it retire.
//   The consumers convert each code box once for the block, each
//   warpgroup half of it, into two (64, 64) bf16 tiles in the 128-byte
//   swizzle layout (the MN-major B operand of wgmma), with the exact bit
//   trick of codes_to_bf16; the conversion of tile j + 1 runs while tile
//   j's products are in flight, two converted slots alternate, and
//   mbarriers say when a slot is converted (both halves, after
//   fence.proxy.async) and when both warpgroups' products on it retired.
//   The consumers, not a producer warpgroup, convert: eight warps share the
//   work, which overlaps their own asynchronous products, and the register
//   budget stays that of the attention kernels. A tile's products retire
//   within its iteration.
//   Small blocks (decode, and projections with few output tiles; see
//   ops/quant_matmul.py::_hopper_block): 64 x 128, the warpgroups split the
//   columns, two blocks per SM. Large blocks (prefill): 256 x 128, each
//   warpgroup 128 rows by 128 columns in two m64n128 products a k-step (one
//   m64n128 product reads its A tile from shared memory once where two
//   m64n64 products read it twice), one block per SM, a code tile
//   converted once per 256 rows. There shared memory is the likeliest
//   bound: per K tile the products read 96 KB of it and TMA and the
//   conversion move 64 KB more, at 128 bytes a cycle some 1,250 cycles
//   against the tensor cores' 1,024 (halving x's load traffic from L2
//   changed nothing).
//   Where the output tiles cannot fill the card, K is split over blocks
//   (gridDim.z), each split writes its fp32 partial sums, and the last
//   split to finish an output tile (an atomic ticket per tile, reset by
//   that block) adds the partials in split order, scales and rounds once:
//   one launch, and two launches give the same bits. That block's threads
//   each take up to four pairs of columns with the loads of four splits in
//   flight; the host keeps rows x splits within 128.
// - w8_bf16_kernel, the other bf16 shapes (CLIP's patch embedding, K = 588;
//   codes whose rows are not 16-byte aligned, such as a dense (2048, 32002)):
//   mma.sync m16n8k16 on 64 x 128 tiles, the next tile's x rows and codes
//   loaded into registers while the current one multiplies, the codes
//   converted by the same bit trick on their way into shared memory;
//   ragged M, K and N bounded in the kernel (code rows whose pitch is not a
//   multiple of 16 loaded 2 bytes at a time where it is even and byte by
//   byte otherwise, x
//   rows with K % 8 != 0 element by element). Split K is deterministic
//   there too: each split writes its partial sums and w8_reduce_kernel adds
//   them in a fixed order, scales and rounds once.
// - w8_f32_kernel, fp32 x: CUDA-core fmaf, a 64 x 64 tile, 4 x 4 outputs a
//   thread. TF32 is never used.
// Every kernel reads the stacked layer index from device memory, the
// counterpart of the Pallas scalar prefetch; an index outside [0, L) gives
// NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using kx_flash::ld32;
using kx_flash::ldmatrix_x4_trans;
using kx_flash::mma_bf16;
using namespace kx_hopper;

// bf16 kernel tiles
constexpr int BM = 64, BN = 128, BK = 64;
constexpr int NTHREADS = 128;  // 4 warps, 2 x 2, each 32 rows x 64 columns
constexpr int LDA = BK + 8;    // shared row pitches: conflict-free fragment loads
constexpr int LDB = BN + 8;
constexpr int CHUNKS = BM * BK / 8 / NTHREADS;  // 16-byte chunks a thread loads

// fp32 kernel tiles
constexpr int FM = 64, FN = 64, FK = 16;
constexpr int FTHREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct W8Params {
  const void* x;       // (M, K), row-major
  const int8_t* q;     // (L, K, N) codes
  const float* scale;  // (L, N)
  const int* layer;    // device scalar, or null for layer 0
  void* out;           // (M, N), x's type
  float* partial;      // (splits, M, N) fp32 when gridDim.z > 1
  int L, M, K, N;
  int ldq;             // codes between the starts of two code rows (>= N)
  int k_chunk;         // K elements per split
  bool vec_x, vec_q;   // 16-byte loads of x rows / code rows are aligned
  bool even_q;         // 2-byte loads of code rows are aligned
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int layer_of(const W8Params& p) {
  return p.layer != nullptr ? *p.layer : 0;
}

__device__ __forceinline__ bool bad_layer(const W8Params& p, int layer) {
  return layer < 0 || layer >= p.L;
}

// Four int8 codes (one 32-bit word) to four bf16, exactly: the biased byte
// c + 128 goes into the mantissa of 2^23, subtracting 2^23 + 128 leaves c as
// an fp32 whose low 16 bits are zero, so its top half is c in bf16.
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// 8 bf16 of x row `row` from column `col`; zero past M or k_end.
__device__ __forceinline__ uint4 load_x8(const W8Params& p, const bf16* X, int row,
                                         int col, int k_end) {
  if (row >= p.M) return make_uint4(0u, 0u, 0u, 0u);
  const bf16* src = X + (size_t)row * p.K + col;
  if (p.vec_x && col + 8 <= k_end) return *reinterpret_cast<const uint4*>(src);
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (col + j < k_end) w[j >> 1] |= (uint32_t)s16[j] << ((j & 1) * 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 codes of q row `k` from column `col`; zero past k_end or N.
__device__ __forceinline__ uint4 load_q16(const W8Params& p, const int8_t* Q, int k,
                                          int col, int k_end) {
  if (k >= k_end) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* src = Q + (size_t)k * p.ldq + col;
  if (p.vec_q && col + 16 <= p.N) return *reinterpret_cast<const uint4*>(src);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (p.even_q && col + 16 <= p.N) {  // 2-byte aligned rows
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j >> 1] |= (uint32_t)s16[j] << ((j & 1) * 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  const uint8_t* s8 = reinterpret_cast<const uint8_t*>(src);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (col + j < p.N) w[j >> 2] |= (uint32_t)s8[j] << ((j & 3) * 8);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One output of the tile: the final value, or the split's partial sum.
template <typename T>
__device__ __forceinline__ void store_out(const W8Params& p, int layer, bool bad,
                                          int r, int c, float v) {
  if (r >= p.M || c >= p.N) return;
  if (gridDim.z > 1) {
    p.partial[((size_t)blockIdx.z * p.M + r) * p.N + c] = v;
  } else {
    const float y = bad ? CUDART_NAN_F : v * p.scale[(size_t)layer * p.N + c];
    static_cast<T*>(p.out)[(size_t)r * p.N + c] = from_f<T>(y);
  }
}

__global__ void __launch_bounds__(NTHREADS) w8_bf16_kernel(W8Params p) {
  __shared__ __align__(16) bf16 sA[BM * LDA];
  __shared__ __align__(16) bf16 sB[BK * LDB];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int layer = layer_of(p);
  const bool bad = bad_layer(p, layer);
  const bf16* X = static_cast<const bf16*>(p.x);
  const int8_t* Q = p.q + (bad ? 0 : (size_t)layer * p.K * p.ldq);
  const int k_begin = blockIdx.z * p.k_chunk;
  const int k_end = bad ? k_begin : min(k_begin + p.k_chunk, p.K);

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;

  // chunk i of a thread: x row (c >> 3), column 8 (c & 7); codes row (c >> 3),
  // column 16 (c & 7), with c = tid + i * NTHREADS
  uint4 ra[CHUNKS], rb[CHUNKS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * NTHREADS;
      ra[i] = load_x8(p, X, m0 + (c >> 3), k0 + (c & 7) * 8, k_end);
      rb[i] = load_q16(p, Q, k0 + (c >> 3), n0 + (c & 7) * 16, k_end);
    }
  };

  if (k_begin < k_end) load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * NTHREADS;
      *reinterpret_cast<uint4*>(sA + (c >> 3) * LDA + (c & 7) * 8) = ra[i];
      uint4 lo, hi;
      codes_to_bf16(rb[i].x, lo.x, lo.y);
      codes_to_bf16(rb[i].y, lo.z, lo.w);
      codes_to_bf16(rb[i].z, hi.x, hi.y);
      codes_to_bf16(rb[i].w, hi.z, hi.w);
      bf16* dst = sB + (c >> 3) * LDB + (c & 7) * 16;
      *reinterpret_cast<uint4*>(dst) = lo;
      *reinterpret_cast<uint4*>(dst + 8) = hi;
    }
    __syncthreads();
    if (k0 + BK < k_end) load(k0 + BK);  // in flight while this tile multiplies

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* arow = sA + (wm * 32 + mi * 16 + g) * LDA + kk * 16 + 2 * t;
        a[mi][0] = ld32(arow);
        a[mi][1] = ld32(arow + 8 * LDA);
        a[mi][2] = ld32(arow + 8);
        a[mi][3] = ld32(arow + 8 * LDA + 8);
      }
      const int mat = lane >> 3;
      const bf16* brow = sB + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * LDB +
                         (mat >> 1) * 8 + wn * 64;
#pragma unroll
      for (int nd = 0; nd < 4; ++nd) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, brow + nd * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nd], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nd + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = m0 + wm * 32 + mi * 16 + g;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n0 + wn * 64 + n * 8 + 2 * t;
      store_out<bf16>(p, layer, bad, r, c, acc[mi][n][0]);
      store_out<bf16>(p, layer, bad, r, c + 1, acc[mi][n][1]);
      store_out<bf16>(p, layer, bad, r + 8, c, acc[mi][n][2]);
      store_out<bf16>(p, layer, bad, r + 8, c + 1, acc[mi][n][3]);
    }
  }
}

__global__ void __launch_bounds__(FTHREADS) w8_f32_kernel(W8Params p) {
  __shared__ float sA[FK][FM + 4];  // x transposed: sA[k][m]
  __shared__ float sB[FK][FN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  const int layer = layer_of(p);
  const bool bad = bad_layer(p, layer);
  const float* X = static_cast<const float*>(p.x);
  const int8_t* Q = p.q + (bad ? 0 : (size_t)layer * p.K * p.ldq);
  const int k_begin = blockIdx.z * p.k_chunk;
  const int k_end = bad ? k_begin : min(k_begin + p.k_chunk, p.K);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += FK) {
#pragma unroll
    for (int j = 0; j < FM * FK / FTHREADS; ++j) {
      const int i = tid + j * FTHREADS;
      const int r = i >> 4, c = i & 15;
      const int gr = m0 + r, gk = k0 + c;
      sA[c][r] = (gr < p.M && gk < k_end) ? X[(size_t)gr * p.K + gk] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < FK * FN / FTHREADS; ++j) {
      const int i = tid + j * FTHREADS;
      const int r = i >> 6, c = i & 63;
      const int gk = k0 + r, gc = n0 + c;
      sB[r][c] = (gk < k_end && gc < p.N) ? (float)Q[(size_t)gk * p.ldq + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sA[kk][ty + 16 * i];
        b[i] = sB[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_out<float>(p, layer, bad, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

// out = (sum of the splits' partials, in split order) * scale, rounded once.
template <typename T>
__global__ void w8_reduce_kernel(W8Params p, int splits) {
  const int layer = layer_of(p);
  const bool bad = bad_layer(p, layer);
  const size_t mn = (size_t)p.M * p.N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += p.partial[z * mn + i];
    const float y = bad ? CUDART_NAN_F : s * p.scale[(size_t)layer * p.N + i % p.N];
    static_cast<T*>(p.out)[i] = from_f<T>(y);
  }
}

// ---------------------------------------------------------------------------
// bf16 kernel for Hopper: TMA rings, codes converted once per block, wgmma
// ---------------------------------------------------------------------------

constexpr int HW_BN = 128;                      // output columns per block: one code box
constexpr int HW_BK = 64;                       // K per stage
constexpr uint32_t CODE_BYTES = HW_BK * HW_BN;  // one int8 code box
constexpr uint32_t B_BYTES = 2 * TILE_BYTES;    // the box as two (64, 64) bf16 tiles
constexpr int CONSUMERS = 256;                  // threads of the two consumer warpgroups
constexpr int CONSUMER_WARPS = CONSUMERS / 32;

struct W8Tma {
  CUtensorMap x;        // (K, M) bf16, (64, BM) boxes
  CUtensorMap q;        // (N, L * K) int8, (128, 64) boxes
  const float* scale;   // (L, N)
  const int* layer;     // device scalar, or null for layer 0
  bf16* out;            // (M, N)
  float* partial;       // (splits, M, N) fp32 when gridDim.z > 1
  int* tickets;         // one per output tile, 0 between launches
  int L, M, K, N;
  int kt_per_split;     // 64-deep K tiles per split
};

// MT: m64 row blocks per warpgroup. SPLIT_N (decode): the two warpgroups
// share the block's 64 rows and take 64 columns each; else each takes its
// own 64 MT rows and all 128 columns. XS, CS: stages of the x ring and of
// the code ring. A code stage is given back once it is converted, an x
// stage only once the products that read it retire, a tile later: the
// code ring runs further ahead.
template <int MT, bool SPLIT_N, int XS, int CS>
struct W8Hop {
  static constexpr int NT = SPLIT_N ? 1 : 2;  // n64 tiles per warpgroup
  static constexpr int BM = SPLIT_N ? 64 * MT : 128 * MT;
  static constexpr uint32_t X_BYTES = BM * HW_BK * sizeof(bf16);
  static constexpr size_t x = 0;                          // XS x boxes
  static constexpr size_t codes = x + XS * X_BYTES;       // CS code boxes
  static constexpr size_t b = codes + CS * CODE_BYTES;    // 2 converted slots
  static constexpr size_t flag = b + 2 * B_BYTES;         // last split's flag
  static constexpr size_t bars = flag + 16;
  static constexpr int N_BARS = 2 * XS + 2 * CS + 4;
  static constexpr size_t bytes = bars + N_BARS * 8 + 1024;  // + alignment
};

// Code box `src` (64 K rows of 128 codes, 128-byte swizzle) into the two
// bf16 tiles at `dst` (columns 0-63, then 64-127, 128-byte swizzle): this
// consumer thread's units of 8 codes, u = ctid + 256 j, row u / 16, codes
// 8 (u % 16) .. + 7. A half-warp reads one 128-byte row and a quarter-warp
// writes the eight 16-byte chunks of one tile row: no bank conflict.
__device__ __forceinline__ void convert_codes(const unsigned char* src, unsigned char* dst,
                                              int ctid) {
#pragma unroll
  for (int j = 0; j < HW_BK * HW_BN / 8 / CONSUMERS; ++j) {
    const int u = ctid + CONSUMERS * j;
    const int k = u >> 4, n8 = u & 15, sw = k & 7;
    const uint2 w = *reinterpret_cast<const uint2*>(src + k * 128 + (((n8 >> 1) ^ sw) << 4) +
                                                    ((n8 & 1) << 3));
    uint4 v;
    codes_to_bf16(w.x, v.x, v.y);
    codes_to_bf16(w.y, v.z, v.w);
    *reinterpret_cast<uint4*>(dst + (n8 >> 3) * TILE_BYTES + k * 128 + (((n8 & 7) ^ sw) << 4)) =
        v;
  }
  fence_proxy_async();
}

template <int MT, bool SPLIT_N, int XS, int CS>
__global__ void __launch_bounds__(HOP_THREADS, SPLIT_N ? 2 : 1)
    w8_bf16_hopper_kernel(const __grid_constant__ W8Tma P) {
  using S = W8Hop<MT, SPLIT_N, XS, CS>;
  constexpr int NT = S::NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  // x_full / x_empty per x stage, c_full / c_empty per code stage,
  // converted[b] (slot b holds a tile's bf16 codes) and freed[b] (both
  // warpgroups' products on slot b retired)
  uint64_t* x_full = reinterpret_cast<uint64_t*>(smem + S::bars);
  uint64_t* x_empty = x_full + XS;
  uint64_t* c_full = x_empty + XS;
  uint64_t* c_empty = c_full + CS;
  uint64_t* converted = c_empty + CS;
  uint64_t* freed = converted + 2;
  int* last_flag = reinterpret_cast<int*>(smem + S::flag);

  const int layer = P.layer != nullptr ? *P.layer : 0;
  const bool bad = layer < 0 || layer >= P.L;
  const int n0 = blockIdx.x * HW_BN;
  const int m0 = blockIdx.y * S::BM;
  const int nk = (P.K + HW_BK - 1) / HW_BK;
  const int kt0 = blockIdx.z * P.kt_per_split;
  const int n_tiles = min(nk, kt0 + P.kt_per_split) - kt0;  // >= 1 (host)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < XS; ++s) {
      mbar_init(&x_full[s], 1);
      mbar_init(&x_empty[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < CS; ++s) {
      mbar_init(&c_full[s], 1);
      mbar_init(&c_empty[s], CONSUMER_WARPS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&converted[b], CONSUMER_WARPS);
      mbar_init(&freed[b], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // producer warp: lane 0 streams the code boxes, lane 1 the x boxes, each
  // through its own ring
  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      const int row0 = (bad ? 0 : layer) * P.K + kt0 * HW_BK;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % CS;
        mbar_wait(&c_empty[s], ((it / CS) & 1) ^ 1);
        mbar_arrive_expect_tx(&c_full[s], CODE_BYTES);
        tma_load_2d(smem + S::codes + s * CODE_BYTES, &P.q, &c_full[s], n0, row0 + it * HW_BK);
      }
    } else if (lane == 1) {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % XS;
        mbar_wait(&x_empty[s], ((it / XS) & 1) ^ 1);
        mbar_arrive_expect_tx(&x_full[s], S::X_BYTES);
        tma_load_2d(smem + S::x + s * S::X_BYTES, &P.x, &x_full[s], (kt0 + it) * HW_BK, m0);
      }
    }
    return;
  }

  const int ctid = threadIdx.x;  // 0..255
  const int wg = warp / 4;
  const int wi = warp % 4;
  const int g = lane >> 2;
  const int t = lane & 3;

  // accumulator (mt, nt) is acc[mt][32 nt .. 32 nt + 31]; at prefill one
  // m64n128 product per row block writes both column tiles and reads the
  // x box from shared memory once, not twice
  float acc[MT][NT * 32];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < NT * 32; ++e) acc[mt][e] = 0.f;

  auto x_stage = [&](int it) { return smem + S::x + (it % XS) * S::X_BYTES; };
  auto slot = [&](int it) { return smem + S::b + (it & 1) * B_BYTES; };
  // the products of K tile it, one group: A is m64 block mb of the x box
  // (K-major), B the converted slot (MN-major): its n64 tile nb, or both
  auto issue = [&](int it) {
    const uint64_t da = desc_k_major(x_stage(it));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint64_t a = da + (SPLIT_N ? mt : wg * MT + mt) * (TILE_BYTES >> 4) + kk * K_STEP;
        if constexpr (SPLIT_N) {
          wgmma_ss<1>(acc[mt], a, desc_mn_major(slot(it)) + wg * (TILE_BYTES >> 4) + kk * MN_STEP,
                      1);
        } else {
          wgmma_ss_n128(acc[mt], a, desc_mn_major_n128(slot(it)) + kk * MN_STEP, 1);
        }
      }
    wgmma_commit();
  };
  // tile j's codes into slot j & 1 (its (j >> 1)-th use), once the
  // products on the slot's previous tile retired; the code stage goes back
  auto convert = [&](int j) {
    mbar_wait(&c_full[j % CS], (j / CS) & 1);
    mbar_wait(&freed[j & 1], ((j >> 1) & 1) ^ 1);
    convert_codes(smem + S::codes + (j % CS) * CODE_BYTES, slot(j), ctid);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&c_empty[j % CS]);
      mbar_arrive(&converted[j & 1]);
    }
  };

  convert(0);
  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(&x_full[it % XS], (it / XS) & 1);
    mbar_wait(&converted[it & 1], (it >> 1) & 1);
    wgmma_fence();
    issue(it);
    if (it + 1 < n_tiles) convert(it + 1);
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&freed[it & 1]);
      mbar_arrive(&x_empty[it % XS]);
    }
  }

  // this thread's outputs: accumulator (mt, nt), element 4n + 2i + e at row
  // row(mt, i), column col(nt, n) + e
  auto row = [&](int mt, int i) {
    return m0 + 64 * (SPLIT_N ? mt : wg * MT + mt) + 16 * wi + g + 8 * i;
  };
  auto col = [&](int nt, int n) { return n0 + 64 * (SPLIT_N ? wg : nt) + 8 * n + 2 * t; };
  const float* scale = P.scale + (size_t)(bad ? 0 : layer) * P.N;
  auto store = [&](int r, int c, float v0, float v1) {
    const float y0 = bad ? CUDART_NAN_F : v0 * scale[c];
    const float y1 = bad ? CUDART_NAN_F : v1 * scale[c + 1];
    *reinterpret_cast<__nv_bfloat162*>(P.out + (size_t)r * P.N + c) =
        __floats2bfloat162_rn(y0, y1);
  };
  // every output pair of this thread's accumulators inside (M, N)
  auto for_outputs = [&](auto&& fn) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row(mt, i);
        if (r >= P.M) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int c = col(nt, n);
            if (c < P.N) fn(r, c, acc[mt][32 * nt + 4 * n + 2 * i], acc[mt][32 * nt + 4 * n + 2 * i + 1]);
          }
      }
  };

  if (gridDim.z == 1) {
    for_outputs(store);
    return;
  }

  // split K: this split's partial sums, then a ticket; the last split of
  // the output tile adds every split's partials in split order, each thread
  // a pair of columns of the tile at a time, its loads of all splits in
  // flight together
  const size_t mn = (size_t)P.M * P.N;
  float* part = P.partial + blockIdx.z * mn;
  for_outputs([&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(part + (size_t)r * P.N + c) = make_float2(v0, v1);
  });
  __threadfence();
  named_barrier(1, CONSUMERS);
  if (ctid == 0) {
    int* ticket = P.tickets + blockIdx.y * gridDim.x + blockIdx.x;
    const int last = atomicAdd(ticket, 1) == (int)gridDim.z - 1;
    if (last) atomicExch(ticket, 0);
    *last_flag = last;
  }
  named_barrier(1, CONSUMERS);
  if (!*last_flag) return;
  __threadfence();
  // each thread takes up to four column pairs of the tile at a time and
  // has the loads of four splits of each in flight, adding in split order
  const int pairs = min(S::BM, P.M - m0) * (HW_BN / 2);
  const int cols = min(HW_BN, P.N - n0) / 2;
  for (int p0 = ctid; p0 < pairs; p0 += 4 * CONSUMERS) {
    size_t at[4];
    bool ok[4];
    float2 sum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + i * CONSUMERS, cp = p % (HW_BN / 2);
      ok[i] = p < pairs && cp < cols;
      at[i] = (size_t)(m0 + p / (HW_BN / 2)) * P.N + n0 + 2 * cp;
      sum[i] = make_float2(0.f, 0.f);
    }
#pragma unroll 4
    for (int z = 0; z < (int)gridDim.z; ++z) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!ok[i]) continue;
        const float2 v = __ldcg(reinterpret_cast<const float2*>(P.partial + z * mn + at[i]));
        sum[i].x += v.x;
        sum[i].y += v.y;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!ok[i]) continue;
      const int p = p0 + i * CONSUMERS;
      store(m0 + p / (HW_BN / 2), n0 + 2 * (p % (HW_BN / 2)), sum[i].x, sum[i].y);
    }
  }
}

template <int MT, bool SPLIT_N, int XS, int CS>
cudaError_t launch_w8_hopper(W8Tma& P, const void* x, const void* q, int ldq, int splits,
                             cudaStream_t stream) {
  using S = W8Hop<MT, SPLIT_N, XS, CS>;
  cudaError_t err;
  if ((err = tensor_map_2d(&P.x, x, 2, P.M, P.K, P.K, S::BM, HW_BK)) != cudaSuccess) return err;
  if ((err = tensor_map_2d(&P.q, q, 1, (long long)P.L * P.K, P.N, ldq, HW_BK, HW_BN)) !=
      cudaSuccess)
    return err;
  const dim3 grid((P.N + HW_BN - 1) / HW_BN, (P.M + S::BM - 1) / S::BM, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  return kx_flash::launch(w8_bf16_hopper_kernel<MT, SPLIT_N, XS, CS>, S::bytes, grid, P, stream,
                          HOP_THREADS);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// x_dtype: 0 = float32, 1 = bfloat16.
cudaError_t run(W8Params p, int x_dtype, cudaStream_t s) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.L <= 0 || p.k_chunk <= 0 || p.ldq < p.N)
    return cudaErrorInvalidValue;
  const int splits = cdiv(p.K, p.k_chunk);
  if (splits > 1 && p.partial == nullptr) return cudaErrorInvalidValue;
  p.vec_x = p.K % 8 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  p.vec_q = p.ldq % 16 == 0 && reinterpret_cast<uintptr_t>(p.q) % 16 == 0;
  p.even_q = p.ldq % 2 == 0 && reinterpret_cast<uintptr_t>(p.q) % 2 == 0;
  if (x_dtype == 1) {
    w8_bf16_kernel<<<dim3(cdiv(p.N, BN), cdiv(p.M, BM), splits), NTHREADS, 0, s>>>(p);
  } else if (x_dtype == 0) {
    w8_f32_kernel<<<dim3(cdiv(p.N, FN), cdiv(p.M, FM), splits), FTHREADS, 0, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)p.M * p.N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  if (x_dtype == 1)
    w8_reduce_kernel<bf16><<<blocks, 256, 0, s>>>(p, splits);
  else
    w8_reduce_kernel<float><<<blocks, 256, 0, s>>>(p, splits);
  return cudaGetLastError();
}

}  // namespace

// (M, K) x times the (K, N) codes q, rows `ldq` codes apart, times the fp32
// scale (N): out (M, N) in x's type. `partial` is fp32 scratch of
// (ceil(K / k_chunk), M, N), unused (may be null) when k_chunk >= K. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for an
// argument it does not take.
extern "C" int kx_w8_matmul(const void* x, const void* q, const void* scale, void* out,
                            void* partial, int M, int K, int N, int ldq, int k_chunk,
                            int x_dtype, void* stream) {
  W8Params p;
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.layer = nullptr;
  p.out = out;
  p.partial = static_cast<float*>(partial);
  p.L = 1;
  p.M = M;
  p.K = K;
  p.N = N;
  p.ldq = ldq;
  p.k_chunk = k_chunk;
  return run(p, x_dtype, static_cast<cudaStream_t>(stream));
}

// The same with layer *layer (a device int32) of stacked (L, K, N) codes
// (layers K * ldq codes apart) and (L, N) scales.
extern "C" int kx_w8_matmul_stacked(const void* x, const void* q, const void* scale,
                                    const void* layer, void* out, void* partial, int L,
                                    int M, int K, int N, int ldq, int k_chunk, int x_dtype,
                                    void* stream) {
  W8Params p;
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.layer = static_cast<const int*>(layer);
  p.out = out;
  p.partial = static_cast<float*>(partial);
  p.L = L;
  p.M = M;
  p.K = K;
  p.N = N;
  p.ldq = ldq;
  p.k_chunk = k_chunk;
  return run(p, x_dtype, static_cast<cudaStream_t>(stream));
}

// The Hopper path: (M, K) bf16 x times layer *layer (a device int32, or
// layer 0 when null) of the (L, K, N) codes q, rows `ldq` codes apart, times
// its fp32 scale row of (L, N): out (M, N) bf16. block_m (64 or 256) picks
// the block shape, splits the K split (ops/quant_matmul.py::_w8_plan); with
// splits > 1, `partial` is fp32 scratch of (splits, M, N) and `tickets`
// holds one int32 per output tile, all 0 (each launch leaves them 0).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape outside the path's rule (K % 8 == 0 for x's TMA rows, ldq % 16 == 0
// for the codes', N even for the column pairs the epilogue and the split
// reduction store, x and q 16-byte aligned) or a split count that leaves a
// split without K.
extern "C" int kx_w8_matmul_hopper(const void* x, const void* q, const void* scale,
                                   const void* layer, void* out, void* partial, void* tickets,
                                   int L, int M, int K, int N, int ldq, int block_m,
                                   int splits, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || L <= 0 || K % 8 != 0 || ldq % 16 != 0 || ldq < N ||
      N % 2 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return cudaErrorInvalidValue;
  const int nk = cdiv(K, HW_BK);
  if (splits < 1 || splits > nk) return cudaErrorInvalidValue;
  const int kt = cdiv(nk, splits);
  if (cdiv(nk, kt) != splits) return cudaErrorInvalidValue;
  if (splits > 1 && (partial == nullptr || tickets == nullptr)) return cudaErrorInvalidValue;
  W8Tma P;
  P.scale = static_cast<const float*>(scale);
  P.layer = static_cast<const int*>(layer);
  P.out = static_cast<bf16*>(out);
  P.partial = static_cast<float*>(partial);
  P.tickets = static_cast<int*>(tickets);
  P.L = L;
  P.M = M;
  P.K = K;
  P.N = N;
  P.kt_per_split = kt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_m == 64) return launch_w8_hopper<1, true, 3, 6>(P, x, q, ldq, splits, s);
  if (block_m == 256) return launch_w8_hopper<2, false, 4, 8>(P, x, q, ldq, splits, s);
  return cudaErrorInvalidValue;
}
