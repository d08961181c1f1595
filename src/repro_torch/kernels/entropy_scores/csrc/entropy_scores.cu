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
// serve path's decode shape, 8 x 128,256 float32: 1.2 us at 3.35 TB/s, so
// the launch dominates there) and writes 8 bytes a row.
//
// Design: one block of 512 threads per row. Each thread walks strided
// columns of its row, 16-byte loads where the row width and the pointer
// allow it, carrying its own (m, S, T) merged online: a larger logit
// rescales S and T by exp(m_old - m_new), so each logit costs one exp.
// Warp shuffles and then shared memory merge the 512 triples with the same
// rescaling, in a fixed order, so the result does not depend on
// scheduling. Thread 0 reads the gold logit by its index (the TPU kernel's
// one-hot contraction exists only for its vector unit). The row is not
// padded to a tile multiple: loads are bounds-checked, which equals the
// reference's NEG_BIG padding, whose columns add exp(-1e30 - m) = 0.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
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

// VEC: 16-byte loads, which needs V a multiple of 16 / sizeof(T) and a
// 16-byte aligned logits pointer (checked by the caller)
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
entropy_nll_rows(const T* __restrict__ logits,
                 const int32_t* __restrict__ labels, float* __restrict__ ent,
                 float* __restrict__ nll, int64_t v) {
  __shared__ Acc part[kWarps];
  const int64_t row = blockIdx.x;
  const T* lr = logits + row * v;
  Acc a{kNegBig, 0.f, 0.f};
  if (VEC) {
    // four 16-byte loads in flight per thread, then their logits
    constexpr int64_t kStep = kThreads * (16 / sizeof(T));
    int64_t c = static_cast<int64_t>(threadIdx.x) * (16 / sizeof(T));
    for (; c + 3 * kStep < v; c += 4 * kStep) {
      uint4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = load16(lr + c + i * kStep);
#pragma unroll
      for (int i = 0; i < 4; ++i) add16<T>(a, x[i]);
    }
    for (; c < v; c += kStep) add16<T>(a, load16(lr + c));
  } else {
    for (int64_t c = threadIdx.x; c < v; c += kThreads) add(a, to_f32(lr[c]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Acc b{__shfl_xor_sync(0xffffffffu, a.m, o),
          __shfl_xor_sync(0xffffffffu, a.s, o),
          __shfl_xor_sync(0xffffffffu, a.t, o)};
    a = merge(a, b);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? part[lane] : Acc{kNegBig, 0.f, 0.f};
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      Acc b{__shfl_xor_sync(0xffffffffu, a.m, o),
            __shfl_xor_sync(0xffffffffu, a.s, o),
            __shfl_xor_sync(0xffffffffu, a.t, o)};
      a = merge(a, b);
    }
    if (lane == 0) {
      const float lse = a.m + logf(a.s);
      const int32_t lab = labels[row];
      // a label outside [0, V) hits no column, as in the TPU kernel
      const float gold = (lab >= 0 && lab < v) ? to_f32(lr[lab]) : 0.f;
      ent[row] = lse - a.t / a.s;
      nll[row] = lse - gold;
    }
  }
}

template <typename T>
int launch_typed(const void* logits, const int32_t* labels, float* ent,
                 float* nll, int64_t b, int64_t v, int vec,
                 cudaStream_t stream) {
  const T* lp = static_cast<const T*>(logits);
  if (vec)
    entropy_nll_rows<T, true><<<b, kThreads, 0, stream>>>(lp, labels, ent,
                                                          nll, v);
  else
    entropy_nll_rows<T, false><<<b, kThreads, 0, stream>>>(lp, labels, ent,
                                                           nll, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched). `dtype`:
// 0 float32, 1 bfloat16 logits, contiguous (B, V). `vec` selects 16-byte
// loads (V a multiple of 4 or 8 values, aligned logits pointer).
extern "C" int entropy_nll_launch(const void* logits, const int32_t* labels,
                                  float* ent, float* nll, int64_t b, int64_t v,
                                  int dtype, int vec, cudaStream_t stream) {
  if (dtype == 0)
    return launch_typed<float>(logits, labels, ent, nll, b, v, vec, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(logits, labels, ent, nll, b, v, vec,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
