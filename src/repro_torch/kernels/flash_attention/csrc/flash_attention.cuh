// What the forward (flash_attention.cu) and the backward
// (flash_attention_bwd.cu) of flash_attention share: the constants,
// the padded tiles and their cp.async loads, the 3xTF32 split and
// mma.sync, the base-2 logit with its optional soft-cap, and the
// head-dim pairs the kernels are built for. Each translation unit
// compiles its own copy (an anonymous namespace).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNeg = -2.0e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;  // 4 warps

// row stride of a Q, K or V tile in elements: 16 bytes of padding
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes from global to shared memory, asynchronously; zero-filled
// (nothing read) when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + ROWS) of a (n, ., HD) tensor whose rows are `stride`
// elements apart, into a padded shared tile; rows past n zero-filled
template <typename T, int HD, int ROWS, int THR = kThreads>
__device__ __forceinline__ void load_tile(T* tile, const T* base, int r0,
                                          int n, int64_t stride) {
  constexpr int kPer = 16 / sizeof(T);  // elements per copy
  constexpr int kCopies = HD / kPer;    // copies per row
  constexpr int kLd = row_stride<T, HD>();
  for (int e = threadIdx.x; e < ROWS * kCopies; e += THR) {
    const int r = e / kCopies, c = (e % kCopies) * kPer;
    const bool in = r0 + r < n;
    cp_async16(tile + r * kLd + c, base + (in ? (r0 + r) * stride : 0) + c,
               in);
  }
}

// x = big + small: big is x rounded to TF32 (half an ulp added, the low 13
// bits cleared), small = x - big exactly; the tensor core reads small's
// top 11 significant bits, so big + small keeps about 22 bits of x
__device__ __forceinline__ void split(float x, uint32_t& big,
                                     uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a * b, m16n8k8, TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// a logit in base-2 units: x * scale * log2 e, or with the cap
// c * tanh(x * scale / c) * log2 e (cs = scale / c, cl = c * log2 e)
template <bool CAP>
__device__ __forceinline__ float logit2(float x, float sl, float cs,
                                        float cl) {
  if constexpr (CAP) return cl * tanhf(x * cs);
  return x * sl;
}

// f(HDK, HDV) for each (q/k, v) head-dim pair the forward is built for;
// cudaErrorInvalidValue for any other
template <typename F>
int forward_pair(int hd, int hd_v, F&& f) {
  using std::integral_constant;
  if (hd == hd_v) {
    switch (hd) {
      case 16:
        return f(integral_constant<int, 16>(), integral_constant<int, 16>());
      case 32:
        return f(integral_constant<int, 32>(), integral_constant<int, 32>());
      case 64:
        return f(integral_constant<int, 64>(), integral_constant<int, 64>());
      case 128:
        return f(integral_constant<int, 128>(),
                 integral_constant<int, 128>());
    }
  } else if (hd == 192 && hd_v == 128) {
    return f(integral_constant<int, 192>(), integral_constant<int, 128>());
  } else if (hd == 24 && hd_v == 16) {
    return f(integral_constant<int, 24>(), integral_constant<int, 16>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
