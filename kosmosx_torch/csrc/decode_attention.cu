// Single-query decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kosmosx_tpu/ops/decode_attention.py::_kernel
// (driven by _decode_attention_4d, pallas_call at :203). It computes the
// function of decode_attention_reference (:59-74): for each (batch, head),
// o = softmax(q . k_j) v over the cache positions j < kv_len[b], with q
// already scaled and rotated by the caller. Online softmax with exp2 in fp32.
// With int8 codes, the per-position k scales multiply the scores and the v
// scales multiply the probabilities (:105-111, :124-125), so the codes are
// dequantised in registers and the cache is never materialised in bf16.
// Positions at or past kv_len are never read; kv_len 0 gives o = 0.
//
// What bounds it on this card: one query row per head does 2 flops per
// cache byte read (bf16), far below the ~295 flops/byte where the H100 turns
// compute-bound, so the kernel is a stream over the cache and only the bytes
// it moves count.
//
// Design (first, simple version): one block of 256 threads per (batch,
// head). Groups of 8 lanes each take one cache position at a time, every lane
// loading 16 contiguous bytes of the key row or more (so a warp reads 4 whole
// rows, coalesced), and reduce the dot product with three shuffles. Each of
// the 32 groups keeps its own running max, sum and output slice over the
// positions it visits; the groups merge once through shared memory at the
// end. The loop stops at the row's kv_len, which takes the place of the TPU
// kernel's clamped index maps (:162-166). The TPU's shape rules (hd % 8, the
// VMEM block_s shrink, :227-250) do not apply. Splitting the cache over
// several blocks per head (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int G = 8;                   // lanes per cache position
constexpr int NGROUPS = NTHREADS / G;  // positions in flight per block
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N contiguous elements (16-byte aligned for float/bf16, 8 for int8) to fp32.
template <int N>
__device__ __forceinline__ void load_vals(const float* src, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(src + i);
    out[i] = x.x;
    out[i + 1] = x.y;
    out[i + 2] = x.z;
    out[i + 3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* src, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(src + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[i + 2 * j] = f.x;
      out[i + 2 * j + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vals(const int8_t* src, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(src + i);
    const int8_t* c = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[i + j] = static_cast<float>(c[j]);
  }
}

struct DecodeParams {
  const void* q;         // (B, H, 1, D)
  const void* k;         // (B, H, S, D)
  const void* v;
  const int* kv_len;     // (B,)
  const float* k_scale;  // (B, H, S) or null
  const float* v_scale;
  void* o;               // (B, H, 1, D), q's type
  int B, H, S;
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(NTHREADS) decode_kernel(DecodeParams p) {
  constexpr int EPL = D / G;  // elements per lane
  __shared__ float sm_m[NGROUPS];
  __shared__ float sm_l[NGROUPS];
  __shared__ float sm_acc[NGROUPS][D];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int grp = threadIdx.x / G;
  const int gl = threadIdx.x % G;
  const int len = min(max(p.kv_len[b], 0), p.S);

  float qf[EPL];
  load_vals<EPL>(static_cast<const TQ*>(p.q) + (size_t)bh * D + gl * EPL, qf);
  const TKV* K = static_cast<const TKV*>(p.k) + (size_t)bh * p.S * D + gl * EPL;
  const TKV* V = static_cast<const TKV*>(p.v) + (size_t)bh * p.S * D + gl * EPL;
  const float* ks = p.k_scale ? p.k_scale + (size_t)bh * p.S : nullptr;
  const float* vs = p.v_scale ? p.v_scale + (size_t)bh * p.S : nullptr;

  float m = -CUDART_INF_F, l = 0.f;
  float acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;

  // the loop bound is uniform over the block so the shuffles see every lane
  for (int s0 = 0; s0 < len; s0 += NGROUPS) {
    const int s = s0 + grp;
    const bool valid = s < len;
    float kf[EPL], vf[EPL];
    float dot = 0.f;
    if (valid) {
      load_vals<EPL>(K + (size_t)s * D, kf);
      load_vals<EPL>(V + (size_t)s * D, vf);
#pragma unroll
      for (int i = 0; i < EPL; ++i) dot += qf[i] * kf[i];
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 4);
    if (valid) {
      float sc = dot * LOG2E;
      if (ks) sc *= ks[s];
      const float m_new = fmaxf(m, sc);
      const float alpha = exp2f(m - m_new);
      const float pr = exp2f(sc - m_new);
      l = l * alpha + pr;
      const float pv = vs ? pr * vs[s] : pr;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] = acc[i] * alpha + pv * vf[i];
      m = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < EPL; ++i) sm_acc[grp][gl * EPL + i] = acc[i];
  if (gl == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
  __syncthreads();

  // merge the groups: o = sum_g acc_g 2^(m_g - M) / sum_g l_g 2^(m_g - M)
  for (int d = threadIdx.x; d < D; d += NTHREADS) {
    float mx = -CUDART_INF_F;
    for (int g = 0; g < NGROUPS; ++g)
      if (sm_l[g] > 0.f) mx = fmaxf(mx, sm_m[g]);
    float num = 0.f, den = 0.f;
    for (int g = 0; g < NGROUPS; ++g) {
      if (sm_l[g] > 0.f) {
        const float w = exp2f(sm_m[g] - mx);
        num += sm_acc[g][d] * w;
        den += sm_l[g] * w;
      }
    }
    const float inv = den == 0.f ? 1.f : 1.f / den;
    static_cast<TQ*>(p.o)[(size_t)bh * D + d] = from_f<TQ>(num * inv);
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  decode_kernel<TQ, TKV, D><<<p.B * p.H, NTHREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const DecodeParams& p, int q_dtype, int kv_dtype,
                     cudaStream_t s) {
  if (q_dtype == 1 && kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16, D>(p, s);
  if (q_dtype == 1 && kv_dtype == 2) return launch<__nv_bfloat16, int8_t, D>(p, s);
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float, D>(p, s);
  if (q_dtype == 0 && kv_dtype == 2) return launch<float, int8_t, D>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16, 2 = int8 (k/v only). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dim or type combination it does not take.
extern "C" int kx_decode_attention(const void* q, const void* k, const void* v,
                                   const void* kv_len, const void* k_scale,
                                   const void* v_scale, void* o,
                                   int B, int H, int S, int head_dim,
                                   int q_dtype, int kv_dtype, void* stream) {
  DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = static_cast<const int*>(kv_len);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.o = o;
  p.B = B;
  p.H = H;
  p.S = S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // head dim 64 only: the flagship decoder's
  if (head_dim == 64) return dispatch<64>(p, q_dtype, kv_dtype, s);
  return cudaErrorInvalidValue;
}
