// The memory-bound passes of the LFM2 hybrid decoder (models/lfm2.py), for
// Hopper (sm_90a): the gated short convolution, the QK-norm and RoPE pass
// before the flash forward, and the MoE combine.
//
// Replaces no Pallas kernel: the JAX package has no LFM2 model. Each kernel
// stands for a chain of PyTorch launches that moves the same tensors several
// times (ops/short_conv.py, ops/qk_rope.py, ops/grouped_moe.py keep that
// chain as the plain version the CPU runs and the tests hold the kernels to).
//
// What bounds them on this card: a few flops a value against 2 bytes, so
// only the bytes count. Each kernel reads its inputs once and writes its
// output once, 16 bytes a thread (8 bf16 values, or 2 x 16 bytes of the
// combine's fp32 residual), neighbouring threads on neighbouring chunks of
// a row, fp32 arithmetic, one rounding to the storage type at the end.
// Each takes the one set of dtypes the decoder runs on the card: bf16
// activations and, for the combine, the fp32 residual stream (fp32
// activations run the plain versions, on the CPU).
//
// - kx_short_conv_kernel: y[t] = C[t] * sum_k taps[k] * (B * x~)[t - 2 + k]
//   from in_proj's (T, 3 * D) rows [B | C | x~], zero before a sequence's
//   first position (sequences of seq_len rows, back to back). A thread owns
//   8 channels and walks a run of kConvRun tokens, B * x~ of the two tokens
//   before each kept in registers: each input row is read once (plus a
//   2-token halo a run), each output row written once. The loads of
//   kConvUnroll tokens are issued before any is used, so a thread keeps
//   192 bytes in flight.
// - kx_qk_norm_rope_kernel: from the attention's (T, (H + 2 Hkv) * 64)
//   projection rows [q heads | k heads | v heads], q and k normalised per
//   head (RMSNorm over the 64 values, times the head's weight) and rotated
//   (RoPE, rotate-half form, from fp32 cos/sin tables of (L, 32)), written
//   as (B, H, L, 64) and (B, Hkv, L, 64); v copied to (B, Hkv, L, 64). Eight
//   threads a 64-wide head row, the rotation's partner (i +- 32) four lanes
//   away.
// - kx_moe_combine_kernel: out[t] = res[t] + sum_k gate[t, k] * y[pos[t, k]]
//   in fp32 (k in order), written in the residual's type: the routed
//   experts' rows (bf16) gathered back to their token, gated, and added to
//   the residual stream (fp32 in the LFM2 decoder), in one pass and with no
//   atomics (two runs give the same bits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kConvRun = 32;     // tokens a thread of the short conv walks
constexpr int kConvUnroll = 4;   // tokens whose loads are in flight at once
constexpr int kMaxTopK = 8;

// 8 values of T as raw 16-byte words: one for bf16, two for fp32.
template <typename T>
struct Pack8 {
  static constexpr int kWords = 8 * sizeof(T) / 16;
  uint4 w[kWords];
};

template <typename T>
__device__ __forceinline__ Pack8<T> load8(const T* p) {
  Pack8<T> out;
#pragma unroll
  for (int i = 0; i < Pack8<T>::kWords; ++i) out.w[i] = reinterpret_cast<const uint4*>(p)[i];
  return out;
}

__device__ __forceinline__ void unpack(const Pack8<float>& r, float (&v)[8]) {
  const float* f = reinterpret_cast<const float*>(r.w);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = f[j];
}

__device__ __forceinline__ void unpack(const Pack8<__nv_bfloat16>& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// the gated short convolution
// ---------------------------------------------------------------------------

// blockIdx.x: a run of kConvRun tokens; blockIdx.y * blockDim.x +
// threadIdx.x: a chunk of 8 channels. taps (width, 3), tap k applied to
// the token k - 2 places back... forward: tap 2 to the token itself.
__global__ void __launch_bounds__(kThreads)
kx_short_conv_kernel(const bf16* __restrict__ bcx, const bf16* __restrict__ taps,
                     bf16* __restrict__ y, long long tokens, int width, int seq_len) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * 8;
  if (c0 >= width) return;
  const long long t0 = (long long)blockIdx.x * kConvRun;
  const long long t1 = min(t0 + kConvRun, tokens);
  const long long stride = 3LL * width;
  float w0[8], w1[8], w2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w0[j] = to_f(taps[(c0 + j) * 3]);
    w1[j] = to_f(taps[(c0 + j) * 3 + 1]);
    w2[j] = to_f(taps[(c0 + j) * 3 + 2]);
  }
  // B * x~ of the tokens one and two places back, 0 before the sequence
  float p1[8], p2[8];
  int pos = (int)(t0 % seq_len);
#pragma unroll
  for (int j = 0; j < 8; ++j) p1[j] = p2[j] = 0.f;
  for (int back = 2; back >= 1; --back) {
    if (pos >= back) {
      const bf16* row = bcx + (t0 - back) * stride + c0;
      float b[8], x[8];
      unpack(load8(row), b);
      unpack(load8(row + 2 * width), x);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p2[j] = p1[j];
        p1[j] = b[j] * x[j];
      }
    }
  }
  for (long long t = t0; t < t1; t += kConvUnroll) {
    Pack8<bf16> rb[kConvUnroll], rc[kConvUnroll], rx[kConvUnroll];
#pragma unroll
    for (int u = 0; u < kConvUnroll; ++u) {
      if (t + u < t1) {
        const bf16* row = bcx + (t + u) * stride + c0;
        rb[u] = load8(row);
        rc[u] = load8(row + width);
        rx[u] = load8(row + 2 * width);
      }
    }
#pragma unroll
    for (int u = 0; u < kConvUnroll; ++u) {
      if (t + u >= t1) break;
      if (pos == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) p1[j] = p2[j] = 0.f;
      }
      float b[8], c[8], x[8], out[8];
      unpack(rb[u], b);
      unpack(rc[u], c);
      unpack(rx[u], x);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float cur = b[j] * x[j];
        float acc = w0[j] * p2[j];
        acc = fmaf(w1[j], p1[j], acc);
        acc = fmaf(w2[j], cur, acc);
        out[j] = c[j] * acc;
        p2[j] = p1[j];
        p1[j] = cur;
      }
      store8(y + (t + u) * width + c0, out);
      if (++pos == seq_len) pos = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// QK-norm and RoPE
// ---------------------------------------------------------------------------

// Global thread g: head row g / 8 of the (T * NH) rows, its values
// [8 (g % 8), 8 (g % 8) + 8). NH = H + 2 Hkv heads a token.
__global__ void __launch_bounds__(kThreads)
kx_qk_norm_rope_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ q_scale,
                       const bf16* __restrict__ k_scale, const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t, bf16* __restrict__ q_out,
                       bf16* __restrict__ k_out, bf16* __restrict__ v_out, long long rows,
                       int seq_len, int H, int Hkv, float eps) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int part = (int)(g & 7);
  const long long r = g >> 3;
  const bool valid = r < rows;
  const int NH = H + 2 * Hkv;
  const long long t = valid ? r / NH : 0;
  const int n = valid ? (int)(r % NH) : 0;
  float x[8];
  unpack(load8(qkv + (t * NH + n) * 64 + part * 8), x);
  // every lane takes part in the shuffles, whatever its row
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ss = fmaf(x[j], x[j], ss);
  ss += __shfl_xor_sync(0xffffffffu, ss, 4);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  const float rstd = rsqrtf(ss / 64.f + eps);
  const bool is_q = n < H;
  const bf16* scale = is_q ? q_scale : k_scale;
  float xn[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) xn[j] = x[j] * rstd * to_f(scale[part * 8 + j]);
  // rotate-half: value i pairs with i + 32 (lanes part and part ^ 4)
  float other[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) other[j] = __shfl_xor_sync(0xffffffffu, xn[j], 4);
  if (!valid) return;
  const long long b = t / seq_len;
  const int l = (int)(t % seq_len);
  if (n >= H + Hkv) {  // v: copied as it is
    store8(v_out + ((b * Hkv + (n - H - Hkv)) * (long long)seq_len + l) * 64 + part * 8, x);
    return;
  }
  const float sign = part < 4 ? -1.f : 1.f;
  const int f0 = (part & 3) * 8;
  float out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float c = cos_t[(long long)l * 32 + f0 + j];
    const float s = sin_t[(long long)l * 32 + f0 + j];
    out[j] = xn[j] * c + sign * other[j] * s;
  }
  bf16* dst = is_q ? q_out + ((b * H + n) * (long long)seq_len + l) * 64
                : k_out + ((b * Hkv + (n - H)) * (long long)seq_len + l) * 64;
  store8(dst + part * 8, out);
}

// ---------------------------------------------------------------------------
// the MoE combine
// ---------------------------------------------------------------------------

// blockIdx.x: a token; blockIdx.y * blockDim.x + threadIdx.x: a chunk of 8
// channels. The residual and the output fp32, the experts' rows bf16.
__global__ void __launch_bounds__(kThreads)
kx_moe_combine_kernel(const float* __restrict__ res, const bf16* __restrict__ y,
                      const int* __restrict__ pos, const float* __restrict__ gates,
                      float* __restrict__ out, int width, int top_k) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * 8;
  if (c0 >= width) return;
  const long long t = blockIdx.x;
  Pack8<bf16> rows[kMaxTopK];
  float g[kMaxTopK];
#pragma unroll
  for (int k = 0; k < kMaxTopK; ++k) {
    if (k < top_k) {
      g[k] = gates[t * top_k + k];
      rows[k] = load8(y + (long long)pos[t * top_k + k] * width + c0);
    }
  }
  float acc[8], v[8], r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxTopK; ++k) {
    if (k < top_k) {
      unpack(rows[k], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(g[k], v[j], acc[j]);
    }
  }
  unpack(load8(res + t * width + c0), r);
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] += acc[j];
  store8(out + t * width + c0, r);
}

int short_conv(const void* bcx, const void* taps, void* y, long long tokens, int width,
               int seq_len, cudaStream_t stream) {
  const dim3 grid((unsigned)((tokens + kConvRun - 1) / kConvRun),
                  (width / 8 + kThreads - 1) / kThreads);
  kx_short_conv_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(bcx), static_cast<const bf16*>(taps), static_cast<bf16*>(y),
      tokens, width, seq_len);
  return cudaGetLastError();
}

int qk_norm_rope(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                 const void* sin_t, void* q, void* k, void* v, long long tokens, int seq_len,
                 int H, int Hkv, float eps, cudaStream_t stream) {
  const long long rows = tokens * (H + 2 * Hkv);
  const long long blocks = (rows * 8 + kThreads - 1) / kThreads;
  kx_qk_norm_rope_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(q_scale),
      static_cast<const bf16*>(k_scale), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(q), static_cast<bf16*>(k),
      static_cast<bf16*>(v), rows, seq_len, H, Hkv, eps);
  return cudaGetLastError();
}

int moe_combine(const void* res, const void* y, const void* pos, const void* gates, void* out,
                long long tokens, int width, int top_k, cudaStream_t stream) {
  const dim3 grid((unsigned)tokens, (width / 8 + kThreads - 1) / kThreads);
  kx_moe_combine_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(res), static_cast<const bf16*>(y), static_cast<const int*>(pos),
      static_cast<const float*>(gates), static_cast<float*>(out), width, top_k);
  return cudaGetLastError();
}

}  // namespace

// Every pointer 16-byte aligned, rows contiguous, width a multiple of 8
// (the wrappers in ops/ check). Each returns cudaGetLastError() after its
// launch, or cudaErrorInvalidValue for what it does not take.

// y (tokens, width) from bcx (tokens, 3 * width) and taps (width, 3), all
// bf16; sequences of seq_len rows back to back.
extern "C" int kx_short_conv(const void* bcx, const void* taps, void* y, long long tokens,
                             int width, int seq_len, void* stream) {
  if (tokens <= 0 || width <= 0 || width % 8 || seq_len <= 0 ||
      (tokens + kConvRun - 1) / kConvRun > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return short_conv(bcx, taps, y, tokens, width, seq_len, static_cast<cudaStream_t>(stream));
}

// q (B, H, L, 64), k and v (B, Hkv, L, 64) from qkv (B * L, (H + 2 Hkv) *
// 64), q_scale and k_scale (64), all bf16; cos and sin (L, 32) fp32.
extern "C" int kx_qk_norm_rope(const void* qkv, const void* q_scale, const void* k_scale,
                               const void* cos_t, const void* sin_t, void* q, void* k, void* v,
                               long long tokens, int seq_len, int H, int Hkv, float eps,
                               void* stream) {
  if (tokens <= 0 || seq_len <= 0 || tokens % seq_len || H <= 0 || Hkv <= 0 ||
      (tokens * (H + 2 * Hkv) * 8 + kThreads - 1) / kThreads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return qk_norm_rope(qkv, q_scale, k_scale, cos_t, sin_t, q, k, v, tokens, seq_len, H, Hkv,
                      eps, static_cast<cudaStream_t>(stream));
}

// out (tokens, width) = res + sum_k gates[t, k] * y[pos[t, k]]: res and out
// (tokens, width) fp32, y (assignments, width) bf16, pos (tokens, top_k)
// int32, gates (tokens, top_k) fp32.
extern "C" int kx_moe_combine(const void* res, const void* y, const void* pos,
                              const void* gates, void* out, long long tokens, int width,
                              int top_k, void* stream) {
  if (tokens <= 0 || tokens > 0x7fffffffLL || width <= 0 || width % 8 || top_k <= 0 ||
      top_k > kMaxTopK)
    return cudaErrorInvalidValue;
  return moe_combine(res, y, pos, gates, out, tokens, width, top_k,
                     static_cast<cudaStream_t>(stream));
}
