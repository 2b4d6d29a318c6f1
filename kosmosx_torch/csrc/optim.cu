// Lion over every leaf of an optimizer in three launches, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's optimizer is optax, which XLA
// fuses on the TPU (kosmosx_tpu/train/optim.py:127-162). Its port,
// train/optim.py, runs the chain leaf by leaf: per leaf a square and a sum
// for the global norm, a where, a divide and a multiply for the clip, about
// twelve elementwise launches for Lion itself. Over the training cell's
// leaves that is some 12,000 launches a step, 10-20 us of host each, and
// 13-20 passes over 2.6 B fp32 parameters on the card.
//
// What bounds it on this card: a few operations a value against 12-20
// bytes, far below the ~295 operations a byte where the H100 turns
// compute-bound. The least traffic reads and writes p and m once and reads g
// once where a leaf has one; the clip's norm needs one more read of g before
// any leaf can be updated. So three launches:
//
// 1. kx_lion_sumsq_kernel: the leaves are cut into chunks of `chunk`
//    elements (a leaf's last chunk shorter), listed leaf after leaf in the
//    optimizer's order. Persistent blocks walk the chunks grid-stride; each
//    writes its chunk's fp32 sum of g^2 to the chunk's own slot (0 without a
//    gradient). No atomics: a chunk's sum has one order, whichever block
//    takes it.
// 2. kx_lion_finish_kernel, one block: each leaf's chunks summed in fp64 (a
//    warp a leaf), the leaf's sum kept in leaf_sq (fp32: what a sharded norm
//    sums over its groups), then the leaves in order, in fp64; out[0] is the
//    norm, out[1] the sum of squares of the leaves marked local (every leaf
//    but the pieces of a sharded one).
// 3. kx_lion_update_kernel, the chunks again: one pass an element does the
//    clip, Lion and the decoupled decay, reading p, m and g once and writing
//    p and m once. The norm is read on the device, so the host never waits.
//
// The update is the leaf path's arithmetic, rounding for rounding: each
// PyTorch op there is one rounding here, with __fmul_rn/__fadd_rn/__fdiv_rn
// (no product folded into a sum), the result rounded to the dtype PyTorch
// gives it (bf16 where both operands are bf16, else fp32), and each Python
// float scalar cast once to fp32, as PyTorch's CUDA kernels read a CPU
// scalar. With the same norm, p and m come out bit for bit as from
//
//     g = torch.where(norm < max, g, (g / norm.to(g.dtype)) * max)
//     u = torch.sign((1 - b1) * g + b1 * m)        (no gradient: b1 * m)
//     m.copy_((1 - b2) * g + b2 * m)               (no gradient: b2 * m)
//     u = u + wd * p                               (decayed leaves)
//     p.add_(u * (-lr))
//
// p, m and g may each be fp32 or bf16 (the table says which, per leaf);
// loads and stores are 16-byte vectors of 8 values where all three of a
// leaf's pointers are 16-byte aligned, else scalar; a chunk's tail is scalar.
// Every kernel's name starts with kx_lion and holds none of the words the
// profile readers group PyTorch's own kernels by.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;        // a block of the sums and of the update
constexpr int kFinishThreads = 1024; // the one block of the finish
constexpr int kPack = 8;             // values a thread loads at once
enum Code { kF32 = 0, kBF16 = 1, kNoGrad = 2 };

struct NoGrad {};  // the gradient type of a leaf without one

// One row of the leaf table, four int64 words: p, m, the element count, and
// meta: bits 0-31 the leaf's first chunk, 32-39 p's code, 40-47 m's, bit 48
// decay, bit 49 local (counted in out[1]).
struct Leaf {
  long long p, m, n, meta;
};

// The gradient table of a step, 2 * n_leaves int64 words: the pointers
// (0 where a leaf has none), then the codes.

struct Run {  // a chunk: its leaf, its first element, its length
  int leaf;
  long long start;
  int len;
};

__device__ __forceinline__ Run locate(const Leaf* leaves, const int* chunk_leaf, int c,
                                      int chunk) {
  Run r;
  r.leaf = chunk_leaf[c];
  const Leaf l = leaves[r.leaf];
  r.start = static_cast<long long>(c - static_cast<int>(l.meta & 0xffffffffLL)) * chunk;
  const long long left = l.n - r.start;
  r.len = static_cast<int>(left < chunk ? left : chunk);
  return r;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
__device__ __forceinline__ float load1(const T* src, long long i);
template <>
__device__ __forceinline__ float load1<float>(const float* src, long long i) {
  return src[i];
}
template <>
__device__ __forceinline__ float load1<bf16>(const bf16* src, long long i) {
  return __bfloat162float(src[i]);
}

template <typename T>
__device__ __forceinline__ void store1(T* dst, long long i, float v);
template <>
__device__ __forceinline__ void store1<float>(float* dst, long long i, float v) {
  dst[i] = v;
}
template <>
__device__ __forceinline__ void store1<bf16>(bf16* dst, long long i, float v) {
  dst[i] = __float2bfloat16_rn(v);
}

// 8 values from / to 16-byte aligned memory (fp32: two 16-byte vectors)
template <typename T>
__device__ __forceinline__ void load8(const T* src, float (&v)[kPack]);
template <>
__device__ __forceinline__ void load8<float>(const float* src, float (&v)[kPack]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<bf16>(const bf16* src, float (&v)[kPack]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[kPack]);
template <>
__device__ __forceinline__ void store8<float>(float* dst, const float (&v)[kPack]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<bf16>(bf16* dst, const float (&v)[kPack]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])))
            << 16);
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// x rounded to T and back: what storing a PyTorch op's result in T keeps
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (std::is_same<T, bf16>::value) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// the dtype PyTorch gives an op of an A and a B tensor
template <typename A, typename B>
struct Wider {
  using type = bf16;
};
template <typename B>
struct Wider<float, B> {
  using type = float;
};
template <>
struct Wider<bf16, float> {
  using type = float;
};

// the step's scalars, each a Python float cast once to fp32
struct Hyper {
  float neg_lr, b1, one_minus_b1, b2, one_minus_b2, wd, max_norm;
};

__device__ __forceinline__ float sign_of(float s) {
  return static_cast<float>((0.f < s) - (s < 0.f));  // torch.sign: NaN gives 0
}

// One value of the update: p and m in place, g the raw gradient (unused
// without one), keep: no clip (clipping off, or norm < max), nc: the norm
// in g's dtype.
template <typename TP, typename TM, typename TG>
__device__ __forceinline__ void lion_value(float& p, float& m, float g, bool decay, bool keep,
                                           float nc, const Hyper& h) {
  constexpr bool kHasG = !std::is_same<TG, NoGrad>::value;
  using TU = std::conditional_t<kHasG, typename Wider<TG, TM>::type, TM>;
  using TV = typename Wider<TU, TP>::type;
  float u, m_next;
  if constexpr (kHasG) {
    if (!keep) g = rnd<TG>(__fmul_rn(rnd<TG>(__fdiv_rn(g, nc)), h.max_norm));
    u = sign_of(rnd<TU>(__fadd_rn(rnd<TG>(__fmul_rn(h.one_minus_b1, g)),
                                  rnd<TM>(__fmul_rn(h.b1, m)))));
    m_next = rnd<TM>(rnd<TU>(__fadd_rn(rnd<TG>(__fmul_rn(h.one_minus_b2, g)),
                                       rnd<TM>(__fmul_rn(h.b2, m)))));
  } else {
    u = sign_of(rnd<TM>(__fmul_rn(h.b1, m)));
    m_next = rnd<TM>(__fmul_rn(h.b2, m));
  }
  float step;
  if (decay)
    step = rnd<TV>(__fmul_rn(rnd<TV>(__fadd_rn(u, rnd<TP>(__fmul_rn(h.wd, p)))), h.neg_lr));
  else
    step = rnd<TU>(__fmul_rn(u, h.neg_lr));
  p = rnd<TP>(__fadd_rn(p, step));
  m = m_next;
}

template <typename TP, typename TM, typename TG>
__device__ void update_run(const Leaf& leaf, const void* gv, const Run& r, bool decay, bool keep,
                           float norm, const Hyper& h) {
  constexpr bool kHasG = !std::is_same<TG, NoGrad>::value;
  using TGS = std::conditional_t<kHasG, TG, float>;  // a type to point with
  TP* __restrict__ p = reinterpret_cast<TP*>(leaf.p) + r.start;
  TM* __restrict__ m = reinterpret_cast<TM*>(leaf.m) + r.start;
  const TGS* __restrict__ g = kHasG ? static_cast<const TGS*>(gv) + r.start : nullptr;
  const float nc = kHasG ? rnd<TGS>(norm) : 0.f;
  int done = 0;
  if (aligned16(p) && aligned16(m) && (!kHasG || aligned16(g))) {
    const int full = r.len / kPack * kPack;
#pragma unroll 2
    for (int i = threadIdx.x * kPack; i < full; i += kThreads * kPack) {
      float pv[kPack], mv[kPack], gv8[kPack];
      load8<TP>(p + i, pv);
      load8<TM>(m + i, mv);
      if constexpr (kHasG) load8<TGS>(g + i, gv8);
#pragma unroll
      for (int j = 0; j < kPack; ++j)
        lion_value<TP, TM, TG>(pv[j], mv[j], kHasG ? gv8[j] : 0.f, decay, keep, nc, h);
      store8<TP>(p + i, pv);
      store8<TM>(m + i, mv);
    }
    done = full;
  }
  for (int i = done + threadIdx.x; i < r.len; i += kThreads) {
    float pv = load1<TP>(p, i), mv = load1<TM>(m, i);
    float gv1 = 0.f;
    if constexpr (kHasG) gv1 = load1<TGS>(g, i);
    lion_value<TP, TM, TG>(pv, mv, gv1, decay, keep, nc, h);
    store1<TP>(p, i, pv);
    store1<TM>(m, i, mv);
  }
}

template <typename TP, typename TM>
__device__ void update_g(int gcode, const Leaf& leaf, const void* g, const Run& r, bool decay,
                         bool keep, float norm, const Hyper& h) {
  if (gcode == kF32)
    update_run<TP, TM, float>(leaf, g, r, decay, keep, norm, h);
  else if (gcode == kBF16)
    update_run<TP, TM, bf16>(leaf, g, r, decay, keep, norm, h);
  else
    update_run<TP, TM, NoGrad>(leaf, g, r, decay, keep, norm, h);
}

template <typename TP>
__device__ void update_m(int mcode, int gcode, const Leaf& leaf, const void* g, const Run& r,
                         bool decay, bool keep, float norm, const Hyper& h) {
  if (mcode == kBF16)
    update_g<TP, bf16>(gcode, leaf, g, r, decay, keep, norm, h);
  else
    update_g<TP, float>(gcode, leaf, g, r, decay, keep, norm, h);
}

__global__ void __launch_bounds__(kThreads)
    kx_lion_update_kernel(const Leaf* __restrict__ leaves, const int* __restrict__ chunk_leaf,
                          const long long* __restrict__ gtab, const float* __restrict__ norm_ptr,
                          int n_leaves, int n_chunks, int chunk, int decay_on, int clip,
                          Hyper h) {
  const float norm = *norm_ptr;
  const bool keep = !clip || norm < h.max_norm;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Run r = locate(leaves, chunk_leaf, c, chunk);
    const Leaf leaf = leaves[r.leaf];
    const void* g = reinterpret_cast<const void*>(gtab[r.leaf]);
    const int gcode = static_cast<int>(gtab[n_leaves + r.leaf]);
    const int pcode = static_cast<int>((leaf.meta >> 32) & 0xff);
    const int mcode = static_cast<int>((leaf.meta >> 40) & 0xff);
    const bool decay = decay_on && ((leaf.meta >> 48) & 1);
    if (pcode == kBF16)
      update_m<bf16>(mcode, gcode, leaf, g, r, decay, keep, norm, h);
    else
      update_m<float>(mcode, gcode, leaf, g, r, decay, keep, norm, h);
  }
}

template <typename T>
__device__ float sumsq_run(const void* gv, const Run& r) {
  const T* g = static_cast<const T*>(gv) + r.start;
  float acc = 0.f;
  int done = 0;
  if (aligned16(g)) {
    const int full = r.len / kPack * kPack;
#pragma unroll 4
    for (int i = threadIdx.x * kPack; i < full; i += kThreads * kPack) {
      float v[kPack];
      load8<T>(g + i, v);
#pragma unroll
      for (int j = 0; j < kPack; ++j) acc = __fmaf_rn(v[j], v[j], acc);
    }
    done = full;
  }
  for (int i = done + threadIdx.x; i < r.len; i += kThreads) {
    const float v = load1<T>(g, i);
    acc = __fmaf_rn(v, v, acc);
  }
  return acc;
}

// the block's sum in a fixed order, in thread 0
__device__ float block_sum(float v, float* warp_sum) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sum[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads)
    kx_lion_sumsq_kernel(const Leaf* __restrict__ leaves, const int* __restrict__ chunk_leaf,
                         const long long* __restrict__ gtab, float* __restrict__ partial,
                         int n_leaves, int n_chunks, int chunk) {
  __shared__ float warp_sum[kThreads / 32];
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Run r = locate(leaves, chunk_leaf, c, chunk);
    const void* g = reinterpret_cast<const void*>(gtab[r.leaf]);
    const int gcode = static_cast<int>(gtab[n_leaves + r.leaf]);
    float acc = 0.f;
    if (gcode == kF32)
      acc = sumsq_run<float>(g, r);
    else if (gcode == kBF16)
      acc = sumsq_run<bf16>(g, r);
    acc = block_sum(acc, warp_sum);
    if (threadIdx.x == 0) partial[c] = acc;
  }
}

__global__ void __launch_bounds__(kFinishThreads)
    kx_lion_finish_kernel(const Leaf* __restrict__ leaves, const float* __restrict__ partial,
                          float* leaf_sq, float* __restrict__ out, int n_leaves, int chunk) {
  __shared__ double lane_sum[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int l = warp; l < n_leaves; l += kFinishThreads / 32) {
    const Leaf leaf = leaves[l];
    const int first = static_cast<int>(leaf.meta & 0xffffffffLL);
    const int chunks = static_cast<int>((leaf.n + chunk - 1) / chunk);
    double s = 0.0;
    for (int c = lane; c < chunks; c += 32) s += static_cast<double>(partial[first + c]);
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) leaf_sq[l] = static_cast<float>(s);
  }
  __syncthreads();
  if (warp) return;
  // the leaves in order: lane i a run of them, then the runs in lane order
  const int per = (n_leaves + 31) / 32;
  const int lo = lane * per, hi = min(n_leaves, lo + per);
  double s = 0.0;
  for (int l = lo; l < hi; ++l)
    if ((leaves[l].meta >> 49) & 1) s += static_cast<double>(leaf_sq[l]);
  lane_sum[lane] = s;
  __syncwarp();
  if (lane == 0) {
    double total = 0.0;
    for (int i = 0; i < 32; ++i) total += lane_sum[i];
    out[0] = static_cast<float>(sqrt(total));
    out[1] = static_cast<float>(total);
  }
}

// resident blocks of a persistent kernel on this card, at most `work`
template <typename Kernel>
int persistent_blocks(Kernel kernel, int work) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  return work < blocks ? (work > 0 ? work : 1) : blocks;
}

bool valid(int n_leaves, int n_chunks, int chunk) {
  return n_leaves > 0 && n_chunks >= 0 && chunk > 0 && chunk % kPack == 0;
}

}  // namespace

// leaves: the leaf table (n_leaves rows of 4 int64, above), chunk_leaf: the
// leaf of each of n_chunks chunks (int32), gtab: the step's gradient table,
// all on the card. Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for sizes it does not take.

// partial (n_chunks fp32): each chunk's sum of g^2.
extern "C" int kx_lion_sumsq(const void* leaves, const void* chunk_leaf, const void* gtab,
                             void* partial, int n_leaves, int n_chunks, int chunk,
                             void* stream) {
  if (!valid(n_leaves, n_chunks, chunk)) return cudaErrorInvalidValue;
  const int blocks = persistent_blocks(kx_lion_sumsq_kernel, n_chunks);
  kx_lion_sumsq_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const int*>(chunk_leaf),
      static_cast<const long long*>(gtab), static_cast<float*>(partial), n_leaves, n_chunks,
      chunk);
  return cudaGetLastError();
}

// leaf_sq (n_leaves fp32): each leaf's sum of g^2; out (2 fp32): the norm,
// and the sum of squares of the local leaves.
extern "C" int kx_lion_finish(const void* leaves, const void* partial, void* leaf_sq, void* out,
                              int n_leaves, int chunk, void* stream) {
  if (!valid(n_leaves, 0, chunk)) return cudaErrorInvalidValue;
  kx_lion_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const float*>(partial),
      static_cast<float*>(leaf_sq), static_cast<float*>(out), n_leaves, chunk);
  return cudaGetLastError();
}

// p and m of every leaf in place; norm: the 0-d fp32 global norm on the
// card; clip 0: no clipping; decay_on 0: no leaf decays.
extern "C" int kx_lion_update(const void* leaves, const void* chunk_leaf, const void* gtab,
                              const void* norm, int n_leaves, int n_chunks, int chunk,
                              float neg_lr, float b1, float one_minus_b1, float b2,
                              float one_minus_b2, float wd, float max_norm, int decay_on,
                              int clip, void* stream) {
  if (!valid(n_leaves, n_chunks, chunk)) return cudaErrorInvalidValue;
  const Hyper h{neg_lr, b1, one_minus_b1, b2, one_minus_b2, wd, max_norm};
  const int blocks = persistent_blocks(kx_lion_update_kernel, n_chunks);
  kx_lion_update_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const int*>(chunk_leaf),
      static_cast<const long long*>(gtab), static_cast<const float*>(norm), n_leaves, n_chunks,
      chunk, decay_on, clip, h);
  return cudaGetLastError();
}
