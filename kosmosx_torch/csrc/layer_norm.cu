// LayerNorm forward and backward over the last dim, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's LayerNorm is jnp code
// (kosmosx_tpu/nn/layers.py:145-154) that XLA fuses on the TPU. Its op-for-op
// port in PyTorch runs as a chain of about eleven launches on a bf16 input
// (an upcast, two means, the centring twice, a square, rsqrt, the three
// broadcast products and sums, a downcast), moving some 68 bytes a value
// forward and 110 back under autograd: the largest block of elementwise time
// in training and scoring. This source computes the same function in one
// launch each way: fp32 math whatever the storage type, a two-pass mean and
// variance, y = (x - mean) * rsqrt(var + eps) * scale (+ bias) written in
// x's type, the scale and bias read in their own type (x's or fp32).
//
// What bounds it on this card: a few flops a value against 2-4 bytes, far
// below the ~295 flops a byte where the H100 turns compute-bound, so only
// the bytes count: x read and y written once forward (4 bytes a bf16
// value), x and dy read and dx written once backward (6 bytes), the fp32
// mean and rstd of a row beside them.
//
// Design:
// - A row lives in registers, packed as loaded. A group of TPR threads
//   (blockDim.x) takes a row, each thread NV chunks of 16 bytes (8 bf16 or 4
//   fp32 values) with chunk c at thread c % TPR, so a warp's loads are 512
//   contiguous bytes. TPR and NV follow the width (plan() below). Forward,
//   up to 4 chunks a thread and 512 threads a row: one warp a row at 1,024
//   bf16, 64 threads at 2,048, 256 at 8,192. Backward, which holds x, dy and
//   two sums a value, one chunk a thread and up to 1,024 threads: 256 at
//   2,048 bf16, 1,024 at 8,192. Groups share a block up to 256 threads
//   (blockDim.y rows a block), so a narrow row still launches full blocks,
//   and 8,184-12,276 rows give thousands of blocks over 132 SMs. Registers
//   bound the rows resident on an SM, and with them the bytes in flight:
//   the scale and bias are read chunk by chunk from L1 where they are used
//   (chunk_fence), not hoisted into registers all at once.
// - Both passes of the statistics read those registers: the sum, then the
//   sum of squared deviations, each reduced by warp shuffles and, across
//   the warps of a group, through shared memory in warp order.
// - Widths that are not a multiple of the chunk, rows whose start is not 16
//   bytes aligned (a strided view) and unaligned parameters take scalar
//   loads and stores (vec false), with the same arithmetic.
// - Backward, per row, from x and the saved fp32 mean and rstd:
//   xhat = (x - mean) rstd, g = dy scale,
//   dx = rstd (g - mean(g) - xhat mean(g xhat)): one reduction of two sums,
//   xhat and g recomputed from the packed x and dy where dx is written, each
//   rounded as the plain version rounds it (__fmul_rn: no product folded
//   into the next subtraction, so at width 1, where xhat is 0 and g equals
//   its mean, dx is exactly 0 as there).
//   dscale = sum over rows of dy xhat and dbias = sum of dy accumulate in
//   fp32 registers while a block walks its rows (grid-stride). The groups of
//   a block add theirs in order through shared memory, each block writes
//   one partial row, and kx_layer_norm_bwd_sum_kernel adds the partial rows
//   in a fixed order: no atomics, so two runs give the same bits. The
//   caller sets the block count from the shape and the card: with
//   parameter gradients as many as the card holds at once (an SM holds
//   1,024 of this kernel's threads, the 64 registers a thread that its
//   launch bounds allow), so the partial rows stay few; without them (a
//   frozen scale) one a block's rows, and nothing is accumulated.
// - RMSNorm forward (kx_rms_norm_fwd_kernel, the LFM2 decoder's norm):
//   y = x * rsqrt(mean(x^2) + eps) * scale in fp32, written in y's own
//   type (an fp32 residual stream normalised into bf16), no mean and no
//   bias; the forward's layout, with rows narrower than a warp packed
//   several to a warp (a 64-wide bf16 row is 8 threads of one chunk each,
//   32 rows a block), their sums reduced over the row's lanes alone. Its
//   own kernel and launcher: the LayerNorm kernels' code is as it was.
// Every kernel's name starts with kx_layer_norm or kx_rms_norm and holds
// none of the words the profile readers group PyTorch's own kernels by.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdRowThreads = 512;  // threads of one row's group at most
constexpr int kBwdRowThreads = 1024; // backward: one chunk a thread
constexpr int kBlockThreads = 256;   // narrow rows share a block up to this
constexpr int kCombineFloats = 2048; // a block's column span when y > 1
constexpr int kSumCols = 32;         // columns of a partial-sum block
constexpr int kSumSlices = 8;        // its slices of the partial rows

template <typename S>
__device__ __forceinline__ float to_f(S v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename S>
__device__ __forceinline__ S from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// N values of p from column col as floats: 16-byte loads where vec, else
// scalar loads, with 0 past width.
template <typename S, int N>
__device__ __forceinline__ void load_n(const S* p, int col, int width, bool vec,
                                       float (&out)[N]) {
  static_assert((N * sizeof(S)) % 16 == 0, "a chunk is whole 16-byte words");
  if (vec && col + N <= width) {
    constexpr int kWords = N * sizeof(S) / 16;
    uint4 raw[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) raw[u] = reinterpret_cast<const uint4*>(p + col)[u];
    const S* e = reinterpret_cast<const S*>(raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = col + j < width ? to_f(p[col + j]) : 0.f;
  }
}

template <typename S, int N>
__device__ __forceinline__ void store_n(S* p, int col, int width, bool vec,
                                        const float (&v)[N]) {
  static_assert((N * sizeof(S)) % 16 == 0, "a chunk is whole 16-byte words");
  if (vec && col + N <= width) {
    constexpr int kWords = N * sizeof(S) / 16;
    uint4 raw[kWords];
    S* e = reinterpret_cast<S*>(raw);
#pragma unroll
    for (int j = 0; j < N; ++j) e[j] = from_f<S>(v[j]);
#pragma unroll
    for (int u = 0; u < kWords; ++u) reinterpret_cast<uint4*>(p + col)[u] = raw[u];
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (col + j < width) p[col + j] = from_f<S>(v[j]);
  }
}

// One chunk of x's type (16 bytes, VEC values) kept packed in registers:
// 16-byte loads where vec, else scalar loads, with 0 past width.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int col, int width, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw;
  if (vec && col + VEC <= width) return *reinterpret_cast<const uint4*>(p + col);
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) e[j] = col + j < width ? p[col + j] : from_f<T>(0.f);
  return raw;
}

template <typename T>
__device__ __forceinline__ float chunk_at(const uint4& raw, int j) {
  return to_f(reinterpret_cast<const T*>(&raw)[j]);
}

// Keeps the compiler from hoisting the next chunk's parameter loads above
// this point: hoisted, every chunk's scale and bias would sit in registers
// at once.
__device__ __forceinline__ void chunk_fence() { asm volatile("" ::: "memory"); }

// Sum each of s over the row's group (blockDim.x threads of one
// threadIdx.y): shuffles within a warp, then the group's warps in order
// through shared memory. Every thread of the block calls it, and every
// thread of the group gets the sums.
template <int N>
__device__ __forceinline__ void group_sum(float (&s)[N], float* smem) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return;
  float* mine = smem + threadIdx.y * warps * N;
  __syncthreads();  // the previous call's readers are done
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) mine[(threadIdx.x >> 5) * N + i] = s[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += mine[w * N + i];
    s[i] = t;
  }
}

template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kFwdRowThreads, 2)
kx_layer_norm_fwd_kernel(const T* __restrict__ x, long long x_stride,
                         const W* __restrict__ scale, const W* __restrict__ bias,
                         T* __restrict__ y, float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, int rows, int width,
                         float eps, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float smem[kFwdRowThreads / 32];
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool valid = row < rows;  // every thread reaches the group's syncs
  const T* xr = x + (valid ? row * x_stride : 0);
  uint4 v[NV];
  float s[1] = {0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (threadIdx.x + i * blockDim.x) * VEC;
    v[i] = valid && col < width ? load_chunk<T>(xr, col, width, vec) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[0] += chunk_at<T>(v[i], j);
  }
  group_sum<1>(s, smem);
  const float mean = s[0] / width;
  float q[1] = {0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (threadIdx.x + i * blockDim.x) * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = chunk_at<T>(v[i], j) - mean;
      if (col + j < width) q[0] += d * d;
    }
  }
  group_sum<1>(q, smem);
  const float rstd = rsqrtf(q[0] / width + eps);
  if (!valid) return;
  T* yr = y + row * width;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (threadIdx.x + i * blockDim.x) * VEC;
    if (col < width) {
      float sc[VEC], b[VEC], out[VEC];
      load_n<W, VEC>(scale, col, width, vec, sc);
      if (bias != nullptr) {
        load_n<W, VEC>(bias, col, width, vec, b);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) b[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = (chunk_at<T>(v[i], j) - mean) * rstd * sc[j] + b[j];
      store_n<T, VEC>(yr, col, width, vec, out);
    }
    chunk_fence();
  }
  if (mean_out != nullptr && threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Sum s over a row's group (blockDim.x threads of one threadIdx.y, a power
// of two): shuffles over the group's lanes (a group narrower than a warp is
// that many neighbouring lanes), then the group's warps in order through
// shared memory. Every thread of the block calls it; every thread of the
// group gets the sum.
__device__ __forceinline__ float rms_group_sum(float s, float* smem) {
  const int lanes = blockDim.x < 32 ? blockDim.x : 32;
  for (int off = lanes >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const int warps = blockDim.x >> 5;
  if (warps <= 1) return s;
  float* mine = smem + threadIdx.y * warps;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) mine[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < warps; ++w) t += mine[w];
  return t;
}

// N values of p from column col as floats: the widest loads the bytes
// allow (16 or 8 bytes) where vec, else scalar loads, with 0 past width.
template <typename S, int N>
__device__ __forceinline__ void load_vals(const S* p, int col, int width, bool vec,
                                          float (&out)[N]) {
  constexpr int kBytes = N * sizeof(S);
  if constexpr (kBytes % 16 == 0) {
    load_n<S, N>(p, col, width, vec, out);
  } else {
    static_assert(kBytes % 8 == 0, "a chunk is whole 8-byte words");
    if (vec && col + N <= width) {
      uint2 raw[kBytes / 8];
#pragma unroll
      for (int u = 0; u < kBytes / 8; ++u) raw[u] = reinterpret_cast<const uint2*>(p + col)[u];
      const S* e = reinterpret_cast<const S*>(raw);
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = col + j < width ? to_f(p[col + j]) : 0.f;
    }
  }
}

// N values at column col as S: the widest stores the bytes allow where
// vec, else scalar stores, none past width.
template <typename S, int N>
__device__ __forceinline__ void store_vals(S* p, int col, int width, bool vec,
                                           const float (&v)[N]) {
  constexpr int kBytes = N * sizeof(S);
  if (vec && col + N <= width) {
    if constexpr (kBytes % 16 == 0) {
      uint4 raw[kBytes / 16];
      S* e = reinterpret_cast<S*>(raw);
#pragma unroll
      for (int j = 0; j < N; ++j) e[j] = from_f<S>(v[j]);
#pragma unroll
      for (int u = 0; u < kBytes / 16; ++u) reinterpret_cast<uint4*>(p + col)[u] = raw[u];
    } else {
      static_assert(kBytes % 8 == 0, "a chunk is whole 8-byte words");
      uint2 raw[kBytes / 8];
      S* e = reinterpret_cast<S*>(raw);
#pragma unroll
      for (int j = 0; j < N; ++j) e[j] = from_f<S>(v[j]);
#pragma unroll
      for (int u = 0; u < kBytes / 8; ++u) reinterpret_cast<uint2*>(p + col)[u] = raw[u];
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (col + j < width) p[col + j] = from_f<S>(v[j]);
  }
}

template <typename T, typename W, typename O, int NV>
__global__ void __launch_bounds__(kFwdRowThreads, 2)
kx_rms_norm_fwd_kernel(const T* __restrict__ x, long long x_stride,
                       const W* __restrict__ scale, O* __restrict__ y, int rows, int width,
                       float eps, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float smem[kFwdRowThreads / 32];
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool valid = row < rows;  // every thread reaches the group's sums
  const T* xr = x + (valid ? row * x_stride : 0);
  uint4 v[NV];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (threadIdx.x + i * blockDim.x) * VEC;
    v[i] = valid && col < width ? load_chunk<T>(xr, col, width, vec) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float e = chunk_at<T>(v[i], j);
      s += e * e;
    }
  }
  s = rms_group_sum(s, smem);
  const float rstd = rsqrtf(s / width + eps);
  if (!valid) return;
  O* yr = y + row * width;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (threadIdx.x + i * blockDim.x) * VEC;
    if (col < width) {
      float sc[VEC], out[VEC];
      load_vals<W, VEC>(scale, col, width, vec, sc);
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = chunk_at<T>(v[i], j) * rstd * sc[j];
      store_vals<O, VEC>(yr, col, width, vec, out);
    }
    chunk_fence();
  }
}

template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kBwdRowThreads)
kx_layer_norm_bwd_kernel(const T* __restrict__ x, long long x_stride,
                         const T* __restrict__ dy, long long dy_stride,
                         const W* __restrict__ scale, const float* __restrict__ mean,
                         const float* __restrict__ rstd, T* __restrict__ dx,
                         float* __restrict__ ds_part, float* __restrict__ db_part,
                         int rows, int width, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float smem[kBwdRowThreads / 32 * 2];
  __shared__ float combine[kCombineFloats];
  const bool params = ds_part != nullptr;
  float acc_s[NV][VEC], acc_b[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc_s[i][j] = acc_b[i][j] = 0.f;
  const long long step = (long long)gridDim.x * blockDim.y;
  const long long first = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  // the same count of turns for every thread of the block: the group sums
  // hold block-wide barriers
  const long long turns = (rows + step - 1) / step;
  for (long long t = 0; t < turns; ++t) {
    const long long row = first + t * step;
    const bool valid = row < rows;
    const float m = valid ? mean[row] : 0.f;
    const float r = valid ? rstd[row] : 0.f;
    const T* xr = x + (valid ? row * x_stride : 0);
    const T* dyr = dy + (valid ? row * dy_stride : 0);
    // x and dy stay packed; xhat and g are recomputed where dx is written
    uint4 xv[NV], dv[NV];
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (threadIdx.x + i * blockDim.x) * VEC;
      const bool in_row = valid && col < width;
      xv[i] = in_row ? load_chunk<T>(xr, col, width, vec) : make_uint4(0, 0, 0, 0);
      dv[i] = in_row ? load_chunk<T>(dyr, col, width, vec) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (threadIdx.x + i * blockDim.x) * VEC;
      if (valid && col < width) {
        float sc[VEC];
        load_n<W, VEC>(scale, col, width, vec, sc);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = chunk_at<T>(dv[i], j);
          const float xh = col + j < width ? __fmul_rn(chunk_at<T>(xv[i], j) - m, r) : 0.f;
          const float g = __fmul_rn(d, sc[j]);
          if (params) {
            acc_s[i][j] += d * xh;
            acc_b[i][j] += d;
          }
          s[0] += g * xh;
          s[1] += g;
        }
      }
      chunk_fence();
    }
    group_sum<2>(s, smem);
    const float c1 = s[0] / width, c2 = s[1] / width;
    if (!valid) continue;
    T* dxr = dx + row * width;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (threadIdx.x + i * blockDim.x) * VEC;
      if (col < width) {
        float sc[VEC], out[VEC];
        load_n<W, VEC>(scale, col, width, vec, sc);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = __fmul_rn(chunk_at<T>(xv[i], j) - m, r);
          const float g = __fmul_rn(chunk_at<T>(dv[i], j), sc[j]);
          out[j] = r * (g - c2 - xh * c1);
        }
        store_n<T, VEC>(dxr, col, width, vec, out);
      }
      chunk_fence();
    }
  }
  if (!params) return;
  // the groups of the block add into group 0's registers, in order
  for (int y = 1; y < blockDim.y; ++y) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      __syncthreads();
      if (threadIdx.y == y)
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const int at = (threadIdx.x + i * blockDim.x) * VEC + j;
            if (at < kCombineFloats) combine[at] = which ? acc_b[i][j] : acc_s[i][j];
          }
      __syncthreads();
      if (threadIdx.y == 0)
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const int at = (threadIdx.x + i * blockDim.x) * VEC + j;
            if (at < kCombineFloats) (which ? acc_b : acc_s)[i][j] += combine[at];
          }
    }
  }
  if (threadIdx.y != 0) return;
  float* ds_row = ds_part + (long long)blockIdx.x * width;
  float* db_row = db_part == nullptr ? nullptr : db_part + (long long)blockIdx.x * width;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int col = (threadIdx.x + i * blockDim.x) * VEC + j;
      if (col < width) {
        ds_row[col] = acc_s[i][j];
        if (db_row != nullptr) db_row[col] = acc_b[i][j];
      }
    }
}

// dscale (and dbias) from the backward's partial rows: column by column,
// kSumSlices slices of the rows each summed in order, then the slices in
// order, so the bits do not depend on the launch.
template <typename W>
__global__ void __launch_bounds__(kSumCols * kSumSlices)
kx_layer_norm_bwd_sum_kernel(const float* __restrict__ ds_part,
                             const float* __restrict__ db_part, W* __restrict__ dscale,
                             W* __restrict__ dbias, int parts, int width) {
  __shared__ float sh[2][kSumSlices][kSumCols + 1];
  const int col = blockIdx.x * kSumCols + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (col < width) {
    for (int p = threadIdx.y; p < parts; p += kSumSlices) {
      a += ds_part[(long long)p * width + col];
      if (db_part != nullptr) b += db_part[(long long)p * width + col];
    }
  }
  sh[0][threadIdx.y][threadIdx.x] = a;
  sh[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y != 0 || col >= width) return;
  a = b = 0.f;
  for (int y = 0; y < kSumSlices; ++y) {
    a += sh[0][y][threadIdx.x];
    b += sh[1][y][threadIdx.x];
  }
  dscale[col] = from_f<W>(a);
  if (dbias != nullptr) dbias[col] = from_f<W>(b);
}

struct Plan {
  int tpr;  // threads a row
  int nv;   // 16-byte chunks a thread
  int rpb;  // rows a block
};

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Threads and chunks for a row of `chunks` 16-byte chunks: at most nv_pref
// chunks a thread (fewer where one warp covers the row), more only where
// max_threads would not cover it; a power of two of threads, 32 to
// max_threads. _bwd_blocks in ops/layer_norm.py repeats the backward's
// threads and rows a block to size its grid: change both together.
Plan plan(int chunks, int nv_pref, int max_threads) {
  Plan p;
  p.nv = nv_pref;
  const int warp_nv = pow2_at_least((chunks + 31) / 32);
  if (warp_nv < p.nv) p.nv = warp_nv;
  while (p.nv * max_threads < chunks) p.nv <<= 1;
  p.tpr = pow2_at_least((chunks + p.nv - 1) / p.nv);
  if (p.tpr < 32) p.tpr = 32;
  p.rpb = p.tpr >= kBlockThreads ? 1 : kBlockThreads / p.tpr;
  return p;
}

constexpr int kFwdChunks = 4;  // chunks a thread forward
constexpr int kBwdChunks = 1;  // backward: x, dy and two sums a value in registers

template <typename T, typename W, int NV>
int fwd_nv(const void* x, long long x_stride, const void* scale, const void* bias,
           void* y, void* mean, void* rstd, int rows, int width, float eps, bool vec,
           const Plan& p, cudaStream_t stream) {
  dim3 block(p.tpr, p.rpb);
  dim3 grid((rows + p.rpb - 1) / p.rpb);
  kx_layer_norm_fwd_kernel<T, W, NV><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), x_stride, static_cast<const W*>(scale),
      static_cast<const W*>(bias), static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), rows, width, eps, vec);
  return cudaGetLastError();
}

template <typename T, typename W>
int fwd(const void* x, long long x_stride, const void* scale, const void* bias,
        void* y, void* mean, void* rstd, int rows, int width, float eps, bool vec,
        cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const Plan p = plan((width + VEC - 1) / VEC, kFwdChunks, kFwdRowThreads);
  switch (p.nv) {
    case 1: return fwd_nv<T, W, 1>(x, x_stride, scale, bias, y, mean, rstd, rows, width, eps, vec, p, stream);
    case 2: return fwd_nv<T, W, 2>(x, x_stride, scale, bias, y, mean, rstd, rows, width, eps, vec, p, stream);
    case 4: return fwd_nv<T, W, 4>(x, x_stride, scale, bias, y, mean, rstd, rows, width, eps, vec, p, stream);
  }
  // 8 chunks a thread only for fp32 rows of more than 8,192 (the build
  // leaves out what no width reaches)
  if constexpr (VEC == 4) {
    if (p.nv == 8) return fwd_nv<T, W, 8>(x, x_stride, scale, bias, y, mean, rstd, rows, width, eps, vec, p, stream);
  }
  return cudaErrorInvalidValue;
}

// RMSNorm's plan: the forward's, except that a row of fewer chunks than a
// warp takes as many threads as it has chunks (a power of two), so narrow
// rows share warps: 256 threads a block always.
Plan rms_plan(int chunks) {
  Plan p = plan(chunks, kFwdChunks, kFwdRowThreads);
  if (chunks < 32 && p.nv == 1) {
    p.tpr = pow2_at_least(chunks);
    p.rpb = kBlockThreads / p.tpr;
  }
  return p;
}

template <typename T, typename W, typename O, int NV>
int rms_nv(const void* x, long long x_stride, const void* scale, void* y, int rows,
           int width, float eps, bool vec, const Plan& p, cudaStream_t stream) {
  dim3 block(p.tpr, p.rpb);
  dim3 grid((rows + p.rpb - 1) / p.rpb);
  kx_rms_norm_fwd_kernel<T, W, O, NV><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), x_stride, static_cast<const W*>(scale), static_cast<O*>(y),
      rows, width, eps, vec);
  return cudaGetLastError();
}

template <typename T, typename W, typename O>
int rms(const void* x, long long x_stride, const void* scale, void* y, int rows, int width,
        float eps, bool vec, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const Plan p = rms_plan((width + VEC - 1) / VEC);
  switch (p.nv) {
    case 1: return rms_nv<T, W, O, 1>(x, x_stride, scale, y, rows, width, eps, vec, p, stream);
    case 2: return rms_nv<T, W, O, 2>(x, x_stride, scale, y, rows, width, eps, vec, p, stream);
    case 4: return rms_nv<T, W, O, 4>(x, x_stride, scale, y, rows, width, eps, vec, p, stream);
  }
  if constexpr (VEC == 4) {
    if (p.nv == 8)
      return rms_nv<T, W, O, 8>(x, x_stride, scale, y, rows, width, eps, vec, p, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename W, int NV>
int bwd_nv(const void* x, long long x_stride, const void* dy, long long dy_stride,
           const void* scale, const void* mean, const void* rstd, void* dx,
           void* ds_part, void* db_part, int parts, int rows, int width, bool vec,
           const Plan& p, cudaStream_t stream) {
  dim3 block(p.tpr, p.rpb);
  kx_layer_norm_bwd_kernel<T, W, NV><<<parts, block, 0, stream>>>(
      static_cast<const T*>(x), x_stride, static_cast<const T*>(dy), dy_stride,
      static_cast<const W*>(scale), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(dx),
      static_cast<float*>(ds_part), static_cast<float*>(db_part), rows, width, vec);
  return cudaGetLastError();
}

template <typename T, typename W>
int bwd(const void* x, long long x_stride, const void* dy, long long dy_stride,
        const void* scale, const void* mean, const void* rstd, void* dx,
        void* ds_part, void* db_part, void* dscale, void* dbias, int parts,
        int rows, int width, bool vec, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const Plan p = plan((width + VEC - 1) / VEC, kBwdChunks, kBwdRowThreads);
  if (p.rpb > 1 && p.tpr * p.nv * VEC > kCombineFloats) return cudaErrorInvalidValue;
  int err = cudaErrorInvalidValue;
  switch (p.nv) {
    case 1: err = bwd_nv<T, W, 1>(x, x_stride, dy, dy_stride, scale, mean, rstd, dx, ds_part, db_part, parts, rows, width, vec, p, stream); break;
    case 2: err = bwd_nv<T, W, 2>(x, x_stride, dy, dy_stride, scale, mean, rstd, dx, ds_part, db_part, parts, rows, width, vec, p, stream); break;
  }
  if constexpr (VEC == 4) {
    if (p.nv == 4) err = bwd_nv<T, W, 4>(x, x_stride, dy, dy_stride, scale, mean, rstd, dx, ds_part, db_part, parts, rows, width, vec, p, stream);
  }
  if (err != cudaSuccess || ds_part == nullptr) return err;
  dim3 block(kSumCols, kSumSlices);
  dim3 grid((width + kSumCols - 1) / kSumCols);
  kx_layer_norm_bwd_sum_kernel<W><<<grid, block, 0, stream>>>(
      static_cast<const float*>(ds_part), static_cast<const float*>(db_part),
      static_cast<W*>(dscale), static_cast<W*>(dbias), parts, width);
  return cudaGetLastError();
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16; the scale and bias are
// x's type or float32
enum { kF32 = 0, kBF16 = 1, kF16 = 2 };

}  // namespace

#define KX_LN_DISPATCH(FN, ...)                                              \
  do {                                                                       \
    if (x_dtype == kF32 && w_dtype == kF32) return FN<float, float>(__VA_ARGS__);             \
    if (x_dtype == kBF16 && w_dtype == kF32) return FN<__nv_bfloat16, float>(__VA_ARGS__);    \
    if (x_dtype == kBF16 && w_dtype == kBF16) return FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__); \
    if (x_dtype == kF16 && w_dtype == kF32) return FN<__half, float>(__VA_ARGS__);            \
    if (x_dtype == kF16 && w_dtype == kF16) return FN<__half, __half>(__VA_ARGS__);           \
  } while (0)

// y (rows, width) contiguous from x's rows (x_stride elements apart, the
// last dim contiguous); mean and rstd (rows) fp32, or both null; bias may be
// null. vec: every pointer and x's row stride 16-byte aligned and width a
// multiple of the chunk.
extern "C" int kx_layer_norm_fwd(const void* x, long long x_stride, const void* scale,
                                 const void* bias, void* y, void* mean, void* rstd,
                                 int rows, int width, int x_dtype, int w_dtype,
                                 float eps, int vec, void* stream) {
  if (rows <= 0 || width <= 0 || width > 16384) return cudaErrorInvalidValue;
  KX_LN_DISPATCH(fwd, x, x_stride, scale, bias, y, mean, rstd, rows, width, eps,
                 vec != 0, static_cast<cudaStream_t>(stream));
  return cudaErrorInvalidValue;
}

// dx (rows, width) contiguous in x's type; with ds_part (parts, width) fp32
// scratch, dscale (width) in the scale's type, and with db_part as well,
// dbias. parts: the blocks, each walking every parts-th group of rows (the
// caller picks them from the shape and the card alone, so the order of the
// parameter gradients' sums repeats from process to process).
extern "C" int kx_layer_norm_bwd(const void* x, long long x_stride, const void* dy,
                                 long long dy_stride, const void* scale, const void* mean,
                                 const void* rstd, void* dx, void* ds_part, void* db_part,
                                 void* dscale, void* dbias, int parts, int rows, int width,
                                 int x_dtype, int w_dtype, int vec, void* stream) {
  if (rows <= 0 || width <= 0 || width > 16384 || parts <= 0) return cudaErrorInvalidValue;
  KX_LN_DISPATCH(bwd, x, x_stride, dy, dy_stride, scale, mean, rstd, dx, ds_part,
                 db_part, dscale, dbias, parts, rows, width, vec != 0,
                 static_cast<cudaStream_t>(stream));
  return cudaErrorInvalidValue;
}

// RMSNorm forward: y (rows, width) contiguous from x's rows (x_stride
// elements apart, the last dim contiguous); x, the scale and y each
// float32 or bfloat16; vec as kx_layer_norm_fwd's.
#define KX_RMS_CASE(XT, WT, OT, XC, WC, OC)                                         \
  if (x_dtype == XC && w_dtype == WC && y_dtype == OC)                                \
    return rms<XT, WT, OT>(x, x_stride, scale, y, rows, width, eps, vec != 0, \
                           static_cast<cudaStream_t>(stream));

extern "C" int kx_rms_norm_fwd(const void* x, long long x_stride, const void* scale, void* y,
                               int rows, int width, int x_dtype, int w_dtype, int y_dtype,
                               float eps, int vec, void* stream) {
  if (rows <= 0 || width <= 0 || width > 16384) return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  KX_RMS_CASE(float, float, float, kF32, kF32, kF32)
  KX_RMS_CASE(float, float, bf16, kF32, kF32, kBF16)
  KX_RMS_CASE(float, bf16, float, kF32, kBF16, kF32)
  KX_RMS_CASE(float, bf16, bf16, kF32, kBF16, kBF16)
  KX_RMS_CASE(bf16, float, float, kBF16, kF32, kF32)
  KX_RMS_CASE(bf16, float, bf16, kBF16, kF32, kBF16)
  KX_RMS_CASE(bf16, bf16, float, kBF16, kBF16, kF32)
  KX_RMS_CASE(bf16, bf16, bf16, kBF16, kBF16, kBF16)
  return cudaErrorInvalidValue;
}
