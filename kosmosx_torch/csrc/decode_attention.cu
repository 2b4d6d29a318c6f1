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
// it moves count. The tensor cores stay idle: one query row is M = 1, and a
// 64-row wgmma would be 1/64 used on a bound that is bytes anyway.
//
// Design (split-S, flash-decoding):
// - Work units. Each (b, h) row of the cache is cut into chunks of C =
//   CHUNK = 256 positions. Over the batches and cache lengths of
//   kosmosx_torch/studies/decode_study.py (which builds this source with
//   -DKX_DECODE_CHUNK=128 to compare), 128 won only on short caches and by
//   a few microseconds, 256 on long ones by up to a third (PERF.md). The
//   units are the (b, h, chunk) whose chunk starts below kv_len[b], plus
//   one empty unit for a row of kv_len 0 (it writes o = 0).
//   Every block numbers them in the same order (b, then h, then chunk) from
//   the B lengths it reads, and takes every gridDim.x-th, so no block idles
//   on a short row and chunks of one (b, h) run side by side. The grid is a
//   few blocks per SM, never a function of kv_len: the host does not read
//   the lengths (no sync), and a CUDA graph replays the launch as it is.
// - Chunks through shared memory by Hopper's bulk copy. In the (B, H, S, D)
//   layout a chunk of one row is contiguous (128 bytes a position in bf16,
//   64 in int8, 256 in fp32), so its K and its V are one 1-D cp.async.bulk
//   each, q a third; they complete on an mbarrier. A block has STAGES
//   buffers: thread 0 copies the block's units into them in turn, unit
//   j + STAGES into unit j's buffer as soon as the threads have read unit
//   j, so with one buffer the next copy runs under the current unit's
//   merge. One buffer a block is the build: against two or three (fewer
//   blocks a SM), more resident blocks hid the latency better
//   (kosmosx_torch/studies/decode_study.py builds this source with
//   -DKX_DECODE_STAGES=2 and 3 to time them; PERF.md). The tail chunk copies
//   only its valid positions. The fp32 scales are loaded with ordinary
//   loads (their offsets are 4-byte aligned only), before the wait.
// - Reduce on the CUDA cores. One thread per position: its score is a dot
//   product of q and its K row read from shared memory in 16-byte pieces,
//   each lane starting at another piece so a quarter-warp's loads hit eight
//   distinct bank groups. Each warp takes the max and the sum of its 32
//   probabilities with shuffles, then P.V with each lane owning two output
//   dims; the block's warps merge through shared memory in warp order.
// - Merge in the same launch. A unit of a row with several chunks writes
//   its fp32 (m, l, acc[D]) to scratch; the last unit of that (b, h) to
//   finish (an atomic ticket per (b, h), reset by that block) merges the
//   partials in chunk order, so two launches give the same bits. A row of
//   one chunk writes o directly. One launch, where a second merge kernel
//   would add a launch per layer and token to a host-bound decode step.
// The output divides by l with __fdividef (l >= 1 wherever it divides): an
// IEEE division calls a slow-path routine, and the registers saved around
// that call spilled. The TPU's shape rules (hd % 8, the VMEM block_s
// shrink, :227-250) do not apply; head dim is 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "hopper_common.cuh"

namespace {

using kx_hopper::bulk_load;
using kx_hopper::mbar_arrive_expect_tx;
using kx_hopper::mbar_fence_init;
using kx_hopper::mbar_init;
using kx_hopper::mbar_wait;

constexpr int D = 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PART = 4 + D;  // floats of a unit's partial: m, l, 2 unused, acc[D]
#ifndef KX_DECODE_CHUNK
#define KX_DECODE_CHUNK 256
#endif
#ifndef KX_DECODE_STAGES
#define KX_DECODE_STAGES 1
#endif
constexpr int CHUNK = KX_DECODE_CHUNK;    // cache positions a unit (128 or 256)
constexpr int STAGES = KX_DECODE_STAGES;  // (K, V, q) buffers a block, at most

struct DecodeParams {
  const void* q;         // (B, H, 1, D)
  const void* k;         // (B, H, S, D)
  const void* v;
  const int* kv_len;     // (B,)
  const float* k_scale;  // (B, H, S) or null
  const float* v_scale;
  void* o;               // (B, H, 1, D), q's type
  float* partial;        // (B * H * max_chunks, PART) when max_chunks > 1
  int* tickets;          // (B * H,), 0 between launches, when max_chunks > 1
  int B, H, S;
  int max_chunks;        // ceil(S / C)
};

// Shared memory: NS buffers of a unit's K chunk, V chunk and q (STAGES, or
// as many as fit in 200 KB: one for an fp32 chunk of 256 positions), the
// warps' partial (m, l) and acc, each buffer's mbarrier, the last unit's
// flag.
template <typename TQ, typename TKV, int C>
struct Layout {
  static constexpr int WARPS = C / 32;
  static constexpr uint32_t ROW = D * sizeof(TKV);  // bytes of one cache position
  static constexpr uint32_t KV_BYTES = C * ROW;     // one chunk of K or of V
  static constexpr uint32_t Q_BYTES = D * sizeof(TQ);
  static constexpr size_t v = KV_BYTES;
  static constexpr size_t q = 2 * KV_BYTES;
  static constexpr size_t stage = q + 256;  // bytes of one buffer
  static constexpr int FIT = (int)(200 * 1024 / stage);
  static constexpr int NS = STAGES < FIT ? STAGES : (FIT > 0 ? FIT : 1);
  static constexpr size_t warp_ml = NS * stage;
  static constexpr size_t warp_acc = warp_ml + 2 * WARPS * sizeof(float);
  static constexpr size_t bar = warp_acc + WARPS * D * sizeof(float);
  static constexpr size_t flag = bar + NS * sizeof(uint64_t);
  static constexpr size_t bytes = flag + 16;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of elements to fp32: 4 floats, 8 bf16 or 16 int8 codes. The
// codes go through the mantissa of 2^23 (c + 128 there, minus 2^23 + 128):
// exact, and two simple instructions a code.
template <typename T> struct Piece;
template <> struct Piece<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void to_f(uint4 w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
};
template <> struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void to_f(uint4 w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  }
};
__device__ __forceinline__ float code_to_f(uint32_t biased, uint32_t sel) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.f;
}
template <> struct Piece<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void to_f(uint4 w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b = u[i] ^ 0x80808080u;
      f[4 * i] = code_to_f(b, 0x7440);
      f[4 * i + 1] = code_to_f(b, 0x7441);
      f[4 * i + 2] = code_to_f(b, 0x7442);
      f[4 * i + 3] = code_to_f(b, 0x7443);
    }
  }
};

// q . k of one cache position: its K row and q in shared memory. The row
// is read in 16-byte pieces starting at piece `rot`; the matching q
// elements are read beside each piece.
template <typename TQ, typename TKV>
__device__ __forceinline__ float dot_row(const unsigned char* q_s, const unsigned char* k_row,
                                         int rot) {
  constexpr int EPP = Piece<TKV>::N;      // elements of a K piece
  constexpr int PIECES = D / EPP;         // 16-byte pieces of a row
  constexpr int QP = EPP / Piece<TQ>::N;  // q pieces beside one K piece
  constexpr int NQ = Piece<TQ>::N;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int c = (i + rot) & (PIECES - 1);
    float kf[EPP];
    Piece<TKV>::to_f(*reinterpret_cast<const uint4*>(k_row + 16 * c), kf);
#pragma unroll
    for (int j = 0; j < QP; ++j) {
      float qf[NQ];
      Piece<TQ>::to_f(*reinterpret_cast<const uint4*>(q_s + 16 * (c * QP + j)), qf);
#pragma unroll
      for (int e = 0; e < NQ; ++e) acc = fmaf(qf[e], kf[j * NQ + e], acc);
    }
  }
  return acc;
}

// Dims 2 lane and 2 lane + 1 of a V row in shared memory, as fp32.
__device__ __forceinline__ float2 v_pair(const float* row, int lane) {
  return reinterpret_cast<const float2*>(row)[lane];
}
__device__ __forceinline__ float2 v_pair(const __nv_bfloat16* row, int lane) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[lane]);
}
__device__ __forceinline__ float2 v_pair(const int8_t* row, int lane) {
  const uint32_t b = (uint32_t)reinterpret_cast<const uint16_t*>(row)[lane] ^ 0x8080u;
  return make_float2(code_to_f(b, 0x7440), code_to_f(b, 0x7441));
}

// One (b, h, chunk) of work, and the running position in the numbering of
// the units: every thread walks it in the same order, units only forward.
struct Unit {
  int bh, c, n, nc;  // (b, h), chunk, valid positions in it, chunks of the row
};
template <int C>
struct Cursor {
  int b, base, len, nc;  // row b's units start at unit `base`

  __device__ __forceinline__ void load_row(const DecodeParams& p) {
    len = min(max(__ldg(p.kv_len + b), 0), p.S);
    nc = max(1, (len + C - 1) / C);
  }
  __device__ __forceinline__ void start(const DecodeParams& p) {
    b = 0;
    base = 0;
    load_row(p);
  }
  // Unit u (>= any unit asked before), or false past the last.
  __device__ __forceinline__ bool seek(const DecodeParams& p, int u, Unit& w) {
    if (b >= p.B) return false;
    while (u >= base + p.H * nc) {
      base += p.H * nc;
      if (++b >= p.B) return false;
      load_row(p);
    }
    const int r = u - base;
    const int h = r / nc;
    w.bh = b * p.H + h;
    w.c = r - h * nc;
    w.n = max(0, min(C, len - w.c * C));
    w.nc = nc;
    return true;
  }
};

// The bulk copies of unit w (its K and V rows below kv_len, and q) into
// the buffer at smem, completing on its mbarrier.
template <typename TQ, typename TKV, int C>
__device__ __forceinline__ void issue(const DecodeParams& p, const Unit& w, unsigned char* smem,
                                      uint64_t* bar) {
  using L = Layout<TQ, TKV, C>;
  const uint32_t kv_bytes = w.n * L::ROW;
  mbar_arrive_expect_tx(bar, 2 * kv_bytes + L::Q_BYTES);
  if (kv_bytes > 0) {
    const size_t at = ((size_t)w.bh * p.S + (size_t)w.c * C) * L::ROW;
    bulk_load(smem, static_cast<const unsigned char*>(p.k) + at, kv_bytes, bar);
    bulk_load(smem + L::v, static_cast<const unsigned char*>(p.v) + at, kv_bytes, bar);
  }
  bulk_load(smem + L::q, static_cast<const unsigned char*>(p.q) + (size_t)w.bh * L::Q_BYTES,
            L::Q_BYTES, bar);
}

template <typename TQ, typename TKV, int C>
__global__ void __launch_bounds__(C) decode_split_kernel(const DecodeParams p) {
  using L = Layout<TQ, TKV, C>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* warp_ml = reinterpret_cast<float*>(smem + L::warp_ml);    // [WARPS][2]
  float* warp_acc = reinterpret_cast<float*>(smem + L::warp_acc);  // [WARPS][D]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar);
  int* last_flag = reinterpret_cast<int*>(smem + L::flag);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < L::NS; ++s) mbar_init(bars + s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // a quarter-warp's eight lanes start their K rows at eight distinct bank
  // groups: rows of 8 pieces (bf16) or 16 (fp32) by lane, of 4 (int8) by
  // lane / 2, since two such rows share a 128-byte line
  constexpr int PIECES = D / Piece<TKV>::N;
  const int rot = PIECES >= 8 ? lane : lane >> 1;

  // the block's units j = 0, 1, ...: unit blockIdx.x + j * gridDim.x of the
  // numbering, in buffer j % NS; thread 0 copies the first NS in, then
  // unit j + NS once unit j is read (`ahead` numbers those)
  Cursor<C> units, ahead;
  units.start(p);
  ahead.start(p);
  Unit w{}, next{}, fill{};
  bool have = units.seek(p, blockIdx.x, w), more = false;
  if (tid == 0)
    for (int s = 0; s < L::NS && ahead.seek(p, blockIdx.x + s * gridDim.x, fill); ++s)
      issue<TQ, TKV, C>(p, fill, smem + s * L::stage, bars + s);
  for (int j = 0; have; ++j, w = next, have = more) {
    unsigned char* buf = smem + (j % L::NS) * L::stage;
    uint64_t* bar = bars + j % L::NS;
    const bool valid = tid < w.n;
    const size_t pos = (size_t)w.bh * p.S + (size_t)w.c * C + tid;
    float ks = 1.f, vs = 1.f;
    if (p.k_scale != nullptr && valid) {
      ks = __ldg(p.k_scale + pos);
      vs = __ldg(p.v_scale + pos);
    }
    mbar_wait(bar, (j / L::NS) & 1);

    // this thread's position: score, then the warp's max and sum
    float sc = -CUDART_INF_F;
    if (valid) sc = dot_row<TQ, TKV>(buf + L::q, buf + tid * L::ROW, rot) * (LOG2E * ks);
    float m = sc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float pr = valid ? exp2f(sc - m) : 0.f;
    float l = pr;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    const float pv = pr * vs;

    // P.V over the warp's 32 positions, this lane's two dims. Rows past the
    // chunk's valid ones hold stale shared memory, possibly NaN: there the
    // warp's first row is read, times a probability of 0
    const int n_w = max(0, min(32, w.n - warp * 32));
    const TKV* vrow = reinterpret_cast<const TKV*>(buf + L::v) + warp * 32 * D;
    float a0 = 0.f, a1 = 0.f;
    if (n_w > 0) {
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pv, jj);
        const float2 x = v_pair(vrow + (jj < n_w ? jj : 0) * D, lane);
        a0 = fmaf(pj, x.x, a0);
        a1 = fmaf(pj, x.y, a1);
      }
    }

    // the unit is read and the last unit's merge is done with warp_*: copy
    // unit j + NS into its buffer, publish this warp's partial
    __syncthreads();
    more = units.seek(p, blockIdx.x + (j + 1) * gridDim.x, next);
    if (tid == 0 && ahead.seek(p, blockIdx.x + (j + L::NS) * gridDim.x, fill))
      issue<TQ, TKV, C>(p, fill, buf, bar);
    if (lane == 0) {
      warp_ml[2 * warp] = m;
      warp_ml[2 * warp + 1] = l;
    }
    reinterpret_cast<float2*>(warp_acc + warp * D)[lane] = make_float2(a0, a1);
    __syncthreads();

    // the chunk's (m, l, acc): the warps merged in warp order, one dim a
    // thread
    if (tid < D) {
      float mx = -CUDART_INF_F;
      for (int i = 0; i < L::WARPS; ++i)
        if (warp_ml[2 * i + 1] > 0.f) mx = fmaxf(mx, warp_ml[2 * i]);
      float acc = 0.f, sum = 0.f;
      for (int i = 0; i < L::WARPS; ++i) {
        const float wl = warp_ml[2 * i + 1];
        if (wl > 0.f) {
          const float e = exp2f(warp_ml[2 * i] - mx);
          acc = fmaf(warp_acc[i * D + tid], e, acc);
          sum = fmaf(wl, e, sum);
        }
      }
      if (w.nc == 1) {
        static_cast<TQ*>(p.o)[(size_t)w.bh * D + tid] =
            from_f<TQ>(sum > 0.f ? __fdividef(acc, sum) : 0.f);
      } else {
        float* part = p.partial + ((size_t)w.bh * p.max_chunks + w.c) * PART;
        part[4 + tid] = acc;
        if (tid == 0) {
          part[0] = mx;
          part[1] = sum;
        }
      }
    }
    if (w.nc == 1) continue;

    // a row of several chunks: thread 0 publishes the block's partial (the
    // barrier orders the other threads' stores before its release fence)
    // and takes the row's ticket; the last of the row's units to finish
    // merges the partials in chunk order (every chunk holds a valid
    // position, so l > 0)
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      const int last = atomicAdd(p.tickets + w.bh, 1) == w.nc - 1;
      if (last) {
        atomicExch(p.tickets + w.bh, 0);
        __threadfence();
      }
      *last_flag = last;
    }
    __syncthreads();
    if (!*last_flag) continue;
    // the largest m of the row's chunks, a chunk a thread, then each dim's
    // sum in chunk order with the loads of several chunks in flight
    const float* row = p.partial + (size_t)w.bh * p.max_chunks * PART;
    float mx = -CUDART_INF_F;
    for (int c = tid; c < w.nc; c += C) mx = fmaxf(mx, __ldcg(row + c * PART));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) warp_ml[2 * warp] = mx;
    __syncthreads();
    if (tid >= D) continue;
    for (int i = 0; i < L::WARPS; ++i) mx = fmaxf(mx, warp_ml[2 * i]);
    float acc = 0.f, sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < w.nc; ++c) {
      const float* part = row + c * PART;
      const float e = exp2f(__ldcg(part) - mx);
      sum = fmaf(__ldcg(part + 1), e, sum);
      acc = fmaf(__ldcg(part + 4 + tid), e, acc);
    }
    static_cast<TQ*>(p.o)[(size_t)w.bh * D + tid] = from_f<TQ>(__fdividef(acc, sum));
  }
}

template <typename TQ, typename TKV, int C>
cudaError_t launch(DecodeParams p, cudaStream_t stream) {
  using L = Layout<TQ, TKV, C>;
  const auto kernel = decode_split_kernel<TQ, TKV, C>;
  // blocks that fit on one SM, and the SMs: once per instantiation
  static const int resident = [&] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C, L::bytes) !=
            cudaSuccess)
      return 0;
    return per_sm * sms;
  }();
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  p.max_chunks = (p.S + C - 1) / C;
  if (p.max_chunks > 1 && (p.partial == nullptr || p.tickets == nullptr))
    return cudaErrorInvalidValue;
  const long long units = (long long)p.B * p.H * p.max_chunks;
  const int grid = (int)(units < resident ? units : resident);
  kernel<<<grid, C, L::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch(const DecodeParams& p, int q_dtype, int kv_dtype, cudaStream_t s) {
  if (q_dtype == 1 && kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16, C>(p, s);
  if (q_dtype == 1 && kv_dtype == 2) return launch<__nv_bfloat16, int8_t, C>(p, s);
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float, C>(p, s);
  if (q_dtype == 0 && kv_dtype == 2) return launch<float, int8_t, C>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16, 2 = int8 (k/v only). With S > CHUNK,
// `partial` is fp32 scratch of B * H * ceil(S / CHUNK) * 68 floats and
// `tickets` B * H int32, all 0 (each launch leaves them 0); else both may be
// null. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dim, shape or type combination it does
// not take.
extern "C" int kx_decode_attention(const void* q, const void* k, const void* v,
                                   const void* kv_len, const void* k_scale,
                                   const void* v_scale, void* o, void* partial, void* tickets,
                                   int B, int H, int S, int head_dim, int q_dtype,
                                   int kv_dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || head_dim != D) return cudaErrorInvalidValue;
  DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = static_cast<const int*>(kv_len);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.o = o;
  p.partial = static_cast<float*>(partial);
  p.tickets = static_cast<int*>(tickets);
  p.B = B;
  p.H = H;
  p.S = S;
  p.max_chunks = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<CHUNK>(p, q_dtype, kv_dtype, s);
}
