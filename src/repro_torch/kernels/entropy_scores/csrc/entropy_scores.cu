// Per-row predictive entropy and negative log-likelihood of (B, V) logits,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `entropy_nll_pallas`
// (src/repro/kernels/entropy_scores/entropy_scores.py:56). Per row, with
// m the row's maximum, S = sum exp(l - m) and T = sum exp(l - m) * l:
//   lse = m + log S,  entropy = lse - T / S,  nll = lse - l[label].
// Logits are float32 or bfloat16; every sum is float32.
//
// Bound on this card: bytes. It reads B * V logits once (4.1 MB at the
// serve path's decode shape, 8 x 128,256 float32: 1.2 us at 3.35 TB/s)
// and writes 8 bytes a row.
//
// Design: split-V, two passes. A row is cut into `splits` spans of
// `width` columns (the wrapper picks them, `ops.split_columns`: enough
// blocks to fill the 132 SMs when the rows alone do not, each span at
// least a few thousand columns, one span when the rows fill the card).
// Pass 1, `entropy_nll_part`, runs a block of 256 threads per (row, span):
// each thread walks strided columns of the span, 16-byte loads where the
// row width and the pointer allow it (four in flight, the span's tail
// included, since a span is a few loads a thread), carrying its own
// (m, S, T) merged online — a larger logit rescales S and T by
// exp(m_old - m_new), so each logit costs one exp — then warp shuffles and
// shared memory merge the block's triples, and thread 0 writes the span's
// float32 (m, S, T) to scratch the wrapper allocated. Pass 2,
// `entropy_nll_merge`, gives each row a warp: lane i merges spans i,
// i + 32, ... in span order, then a fixed shuffle tree merges the lanes,
// and lane 0 reads the gold logit by its index (the TPU kernel's one-hot
// contraction exists only for its vector unit) and writes entropy and
// nll. Every merge runs in an order fixed by the span and thread indices,
// never by arrival, so the result does not depend on scheduling; there
// are no atomics. The row is not padded to a tile multiple: loads are
// bounds-checked, which equals the reference's NEG_BIG padding, whose
// columns add exp(-1e30 - m) = 0.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // pass 1, per (row, span)
constexpr int kWarps = kThreads / 32;
constexpr int kMergeRows = 8;  // pass 2: rows per block, a warp each
constexpr float kNegBig = -1e30f;  // the reference's running-max start

struct Acc {
  float m, s, t;
};

__device__ __forceinline__ void add(Acc& a, float x) {
  if (x > a.m) {
    const float r = expf(a.m - x);
    a.s = a.s * r + 1.f;
    a.t = a.t * r + x;
    a.m = x;
  } else {
    const float e = expf(x - a.m);
    a.s += e;
    a.t = fmaf(e, x, a.t);
  }
}

__device__ __forceinline__ Acc merge(Acc a, Acc b) {
  const float m = fmaxf(a.m, b.m);
  const float ra = expf(a.m - m), rb = expf(b.m - m);
  return {m, a.s * ra + b.s * rb, a.t * ra + b.t * rb};
}

// merge across the 32 lanes of a warp by a fixed xor tree (merge is
// commutative, so every lane ends with the same triple)
__device__ __forceinline__ Acc warp_merge(Acc a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Acc b{__shfl_xor_sync(0xffffffffu, a.m, o),
          __shfl_xor_sync(0xffffffffu, a.s, o),
          __shfl_xor_sync(0xffffffffu, a.t, o)};
    a = merge(a, b);
  }
  return a;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of logits: 4 float32 or 8 bfloat16
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
template <typename T>
__device__ __forceinline__ void add16(Acc& a, uint4 raw);
template <>
__device__ __forceinline__ void add16<float>(Acc& a, uint4 raw) {
  add(a, __uint_as_float(raw.x));
  add(a, __uint_as_float(raw.y));
  add(a, __uint_as_float(raw.z));
  add(a, __uint_as_float(raw.w));
}
template <>
__device__ __forceinline__ void add16<__nv_bfloat16>(Acc& a, uint4 raw) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(x[i]);
    add(a, f.x);
    add(a, f.y);
  }
}

// Pass 1. Block x covers span x % splits of row x / splits: columns
// [span * width, min(span * width + width, v)). VEC: 16-byte loads, which
// needs V and width multiples of 16 / sizeof(T) and a 16-byte aligned
// logits pointer (checked by the caller).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
entropy_nll_part(const T* __restrict__ logits, float* __restrict__ part,
                 int64_t v, int splits, int64_t width) {
  __shared__ Acc warps[kWarps];
  const int64_t row = blockIdx.x / splits;
  const int span = blockIdx.x % splits;
  const T* lr = logits + row * v;
  const int64_t c0 = span * width;
  const int64_t c1 = min(c0 + width, v);
  Acc a{kNegBig, 0.f, 0.f};
  if (VEC) {
    // four 16-byte loads in flight per thread (the span's tail too), then
    // their logits
    constexpr int64_t kPer = 16 / sizeof(T);
    constexpr int64_t kStep = kThreads * kPer;
    for (int64_t c = c0 + static_cast<int64_t>(threadIdx.x) * kPer; c < c1;
         c += 4 * kStep) {
      uint4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i * kStep < c1) x[i] = load16(lr + c + i * kStep);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i * kStep < c1) add16<T>(a, x[i]);
    }
  } else {
    for (int64_t c = c0 + threadIdx.x; c < c1; c += kThreads)
      add(a, to_f32(lr[c]));
  }
  a = warp_merge(a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? warps[lane] : Acc{kNegBig, 0.f, 0.f};
    a = warp_merge(a);
    if (lane == 0) {
      float* out = part + (row * splits + span) * 3;
      out[0] = a.m;
      out[1] = a.s;
      out[2] = a.t;
    }
  }
}

// Pass 2: a warp per row merges the row's spans, then reads the gold logit
template <typename T>
__global__ void __launch_bounds__(32 * kMergeRows)
entropy_nll_merge(const T* __restrict__ logits,
                  const float* __restrict__ part,
                  const int32_t* __restrict__ labels, float* __restrict__ ent,
                  float* __restrict__ nll, int64_t b, int64_t v, int splits) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kMergeRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= b) return;  // the whole warp leaves together
  // the gold logit's loads go out before the merge, not after it
  float gold = 0.f;
  if (lane == 0) {
    const int32_t lab = labels[row];
    // a label outside [0, V) hits no column, as in the TPU kernel
    if (lab >= 0 && lab < v) gold = to_f32(logits[row * v + lab]);
  }
  const float* pr = part + row * splits * 3;
  Acc a{kNegBig, 0.f, 0.f};
  for (int i = lane; i < splits; i += 32)
    a = merge(a, Acc{pr[3 * i], pr[3 * i + 1], pr[3 * i + 2]});
  a = warp_merge(a);
  if (lane == 0) {
    const float lse = a.m + logf(a.s);
    ent[row] = lse - a.t / a.s;
    nll[row] = lse - gold;
  }
}

template <typename T>
int launch_typed(const void* logits, const int32_t* labels, float* part,
                 float* ent, float* nll, int64_t b, int64_t v, int splits,
                 int64_t width, int vec, cudaStream_t stream) {
  const T* lp = static_cast<const T*>(logits);
  const int64_t blocks = b * splits;
  if (vec)
    entropy_nll_part<T, true><<<blocks, kThreads, 0, stream>>>(lp, part, v,
                                                               splits, width);
  else
    entropy_nll_part<T, false><<<blocks, kThreads, 0, stream>>>(lp, part, v,
                                                                splits, width);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  entropy_nll_merge<T><<<(b + kMergeRows - 1) / kMergeRows, 32 * kMergeRows,
                         0, stream>>>(lp, part, labels, ent, nll, b, v,
                                      splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches both passes on `stream`; returns the first CUDA error (0 =
// launched). `dtype`: 0 float32, 1 bfloat16 logits, contiguous (B, V).
// `part` is float32 scratch of B * splits * 3; span i of a row covers
// columns [i * width, min(i * width + width, V)). `vec` selects 16-byte
// loads (V and width multiples of 4 or 8 values, aligned logits pointer).
extern "C" int entropy_nll_launch(const void* logits, const int32_t* labels,
                                  float* part, float* ent, float* nll,
                                  int64_t b, int64_t v, int splits,
                                  int64_t width, int dtype, int vec,
                                  cudaStream_t stream) {
  if (dtype == 0)
    return launch_typed<float>(logits, labels, part, ent, nll, b, v, splits,
                               width, vec, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(logits, labels, part, ent, nll, b, v,
                                       splits, width, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
