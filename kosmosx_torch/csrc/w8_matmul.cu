// Weight-only int8 (W8) matmul for Hopper (sm_90a): y = (x @ q) * scale.
//
// Replaces the Pallas TPU kernels kosmosx_tpu/ops/quant_matmul.py::_kernel
// (driven by _w8_matmul_2d, pallas_call at :89) and ::_stacked_kernel
// (driven by _w8_matmul_stacked_2d, pallas_call at :199). x is (M, K) bf16
// or fp32; q holds the int8 codes of one (K, N) weight, or of L stacked
// (L, K, N) weights of which layer `layer` is used; scale is the fp32
// per-output-channel scale, (L, N). As in the Pallas kernels the codes are
// dequantised on the tile (exact: |q| <= 127 fits bf16), the products
// accumulate in fp32, and the scale is applied once per output in fp32
// before the one rounding to x's type (:70-72).
//
// What bounds it on this card: at decode (M = 4..8) every code serves M rows
// only, about 2M flops per byte, far below the ~295 where the H100 turns
// compute-bound, so the kernel is a stream over the int8 codes: half the
// bytes of the bf16 weight, and about a fifth of what the plain version moves
// (it reads the codes, writes a bf16 copy and reads that again). At prefill
// (M in the thousands) the tensor cores bound it; this first version uses
// mma.sync, not wgmma, so it trails cuBLAS there.
//
// Design (first, simple version):
// - bf16 x: a block of 4 warps computes a 64 x 128 output tile, each warp
//   32 x 64 with mma.sync m16n8k16 (bf16 in, fp32 accumulate), looping over K
//   in tiles of 64. The next tile's x rows and codes are loaded into
//   registers while the current tile is multiplied from shared memory. The
//   codes become bf16 on their way into shared memory through an exact bit
//   trick (byte into the mantissa of 2^23, one fp32 subtract, the top half
//   is the bf16), with no int-to-float conversion instruction.
// - fp32 x: CUDA-core fmaf, a 64 x 64 tile, 4 x 4 outputs a thread. TF32 is
//   never used.
// - Ragged M, K and N are bounded in the kernel: x and codes outside the
//   matrix load as zero, outputs outside it are not written, so nothing is
//   padded or copied. Rows of q that are not 16-byte aligned (N % 16 != 0)
//   are loaded 2 bytes at a time where N is even (the vocab head's
//   N = 32002) and byte by byte otherwise; x rows with K % 8 != 0 (CLIP's
//   patch embedding, K = 588) element by element.
// - When the output tiles are too few to fill the card (decode), K is split
//   over blocks (gridDim.z, `k_chunk` elements each): each split writes its
//   fp32 partial sums, and a second kernel adds them in a fixed order, scales
//   and rounds once. The results are deterministic.
// - The stacked entry reads the layer index from device memory, the
//   counterpart of the Pallas scalar prefetch, and offsets into the whole
//   (L, K, N) array: no slice is copied. An index outside [0, L) gives NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ uint32_t ld32(const bf16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
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
  const int8_t* src = Q + (size_t)k * p.N + col;
  if (p.vec_q && col + 16 <= p.N) return *reinterpret_cast<const uint4*>(src);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (p.even_q && col + 16 <= p.N) {  // 2-byte aligned rows (N = 32002)
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
  const int8_t* Q = p.q + (bad ? 0 : (size_t)layer * p.K * p.N);
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
  const int8_t* Q = p.q + (bad ? 0 : (size_t)layer * p.K * p.N);
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
      sB[r][c] = (gk < k_end && gc < p.N) ? (float)Q[(size_t)gk * p.N + gc] : 0.f;
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

int cdiv(int a, int b) { return (a + b - 1) / b; }

// x_dtype: 0 = float32, 1 = bfloat16.
cudaError_t run(W8Params p, int x_dtype, cudaStream_t s) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.L <= 0 || p.k_chunk <= 0)
    return cudaErrorInvalidValue;
  const int splits = cdiv(p.K, p.k_chunk);
  if (splits > 1 && p.partial == nullptr) return cudaErrorInvalidValue;
  p.vec_x = p.K % 8 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  p.vec_q = p.N % 16 == 0 && reinterpret_cast<uintptr_t>(p.q) % 16 == 0;
  p.even_q = p.N % 2 == 0 && reinterpret_cast<uintptr_t>(p.q) % 2 == 0;
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

// (M, K) x times the (K, N) codes q, times the fp32 scale (N): out (M, N) in
// x's type. `partial` is fp32 scratch of (ceil(K / k_chunk), M, N), unused
// (may be null) when k_chunk >= K. Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for an argument it does not take.
extern "C" int kx_w8_matmul(const void* x, const void* q, const void* scale, void* out,
                            void* partial, int M, int K, int N, int k_chunk,
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
  p.k_chunk = k_chunk;
  return run(p, x_dtype, static_cast<cudaStream_t>(stream));
}

// The same with layer *layer (a device int32) of stacked (L, K, N) codes and
// (L, N) scales.
extern "C" int kx_w8_matmul_stacked(const void* x, const void* q, const void* scale,
                                    const void* layer, void* out, void* partial, int L,
                                    int M, int K, int N, int k_chunk, int x_dtype,
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
  p.k_chunk = k_chunk;
  return run(p, x_dtype, static_cast<cudaStream_t>(stream));
}
