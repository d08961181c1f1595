// What the two translation units of flash_attention's backward
// (flash_attention_bwd.cu: dQ, the group sum and the entry points;
// flash_attention_dkdv.cu: dK and dV) share: the fragment loads, the
// recomputed logit, the dispatch over dtypes,
// head-dim pairs and the cap, and the dK/dV launch's interface.
#pragma once

#include "flash_attention.cuh"

namespace {

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// the A fragment of 16 rows at 8 k columns: p points at row g, column t
// of a padded tile
template <typename T, int LD>
__device__ __forceinline__ void frag_a(const T* p, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split(ld1(p), big[0], small[0]);
  split(ld1(p + 8 * LD), big[1], small[1]);
  split(ld1(p + 4), big[2], small[2]);
  split(ld1(p + 8 * LD + 4), big[3], small[3]);
}

// an accumulator fragment as the A fragment of the next product: its
// column 2t is k index t, column 2t + 1 k index t + 4
__device__ __forceinline__ void frag_acc(const float (&c)[4],
                                         uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  split(c[0], big[0], small[0]);
  split(c[2], big[1], small[1]);
  split(c[1], big[2], small[2]);
  split(c[3], big[3], small[3]);
}

// the B fragment at p (k index t) and p + step (k index t + 4)
template <typename T>
__device__ __forceinline__ void frag_b(const T* p, int step, uint32_t& b0,
                                       uint32_t& s0, uint32_t& b1,
                                       uint32_t& s1) {
  split(ld1(p), b0, s0);
  split(ld1(p + step), b1, s1);
}

// logit2<CAP> of a recomputed product x, as the forward forms it; with
// the cap, `fac` receives the factor 1 - t^2 that dS takes, t the tanhf
// the logit was made of
template <bool CAP>
__device__ __forceinline__ float logit2_grad(float x, float sl, float cs,
                                             float cl, float& fac) {
  if constexpr (CAP) {
    const float t = tanhf(x * cs);
    fac = 1.f - t * t;
    return cl * t;
  }
  return x * sl;
}

template <typename T>
struct Tag {
  using type = T;
};

// the dtype code of the entry points: 0 float32, 1 bfloat16
template <typename T>
constexpr int kDtype = std::is_same<T, float>::value ? 0 : 1;

// f(Tag<T>, HDK, HDV) for the dtype and head-dim pair the kernels are
// built for (the forward's pairs)
template <typename F>
int dispatch(int dtype, int hd, int hd_v, F&& f) {
  if (dtype == 0)
    return forward_pair(hd, hd_v, [&](auto hdk, auto hdv) {
      return f(Tag<float>(), hdk, hdv);
    });
  if (dtype == 1)
    return forward_pair(hd, hd_v, [&](auto hdk, auto hdv) {
      return f(Tag<__nv_bfloat16>(), hdk, hdv);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}

// f(CAP) with the capped build when `cap` (equal head dims only: MLA's
// pairs are built without the cap)
template <int HDK, int HDV, typename F>
int with_cap(bool cap, F&& f) {
  if (cap) {
    if constexpr (HDK == HDV)
      return f(std::true_type());
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return f(std::false_type());
}

// registers a thread, shared memory a block (static and dynamic) and
// blocks an SM of `kernel` launched with `threads` threads and `dyn`
// bytes of dynamic shared memory
template <typename K>
int kernel_info(K kernel, int threads, int dyn, int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel,
                                                        threads, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes) + dyn;
  return 0;
}

}  // namespace

// The dK/dV launch (flash_attention_dkdv.cu, its own translation unit so
// that the two halves of the backward compile in parallel), at the dtype
// (0 float32, 1 bfloat16), head-dim pair and build (`cap`: the capped
// one) the backward dispatched on; the arguments as flash_bwd_dkdv takes
// them. Returns the first CUDA error.
int flash_dkdv_launch(int dtype, int hd, int hd_v, bool cap, const void* q,
                      const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk,
                      void* dv, float* part, int b, int sq, int skv, int h,
                      int kvh, int split, float scale, int causal, int window,
                      float softcap, cudaStream_t stream);
// kernel_info of flash_bwd_dkdv at the same dtype, pair and build.
int flash_dkdv_info(int dtype, int hd, int hd_v, bool cap, int* info);
