// What the forward (flash_attention.cu) and the backward
// (flash_attention_bwd.cu, flash_attention_dkdv.cu) of flash_attention
// share, all of it Hopper's (sm_90a): the constants, the 3xTF32 split, the
// base-2 logit with its optional soft-cap, the swizzled float32 panels
// and their wgmma descriptors, the TF32 wgmma with A in registers, the
// mbarriers and the TMA loads, the tensor maps, the conversions of a tile
// into panels, and the dispatch over dtypes, head-dim pairs and the cap.
// Each translation unit compiles its own copy (an anonymous namespace).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNeg = -2.0e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// x = big + small: big is x rounded to TF32 (half an ulp added, the low 13
// bits cleared), small = x - big exactly; the tensor core reads small's
// top 11 significant bits, truncated, so big + small keeps about 22 bits
// of x. The backward reads its small parts so (rounding them measured no
// closer to float64 there and cost time); the forward rounds them too
// (biased, small_of, split_biased below), which its rows with few keys
// need.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                     uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// a logit in base-2 units: x * scale * log2 e, or with the cap
// c * tanh(x * scale / c) * log2 e (cs = scale / c, cl = c * log2 e)
template <bool CAP>
__device__ __forceinline__ float logit2(float x, float sl, float cs,
                                        float cl) {
  if constexpr (CAP) return cl * tanhf(x * cs);
  return x * sl;
}

constexpr int al1k(int x) { return (x + 1023) / 1024 * 1024; }
constexpr int al128(int x) { return (x + 127) / 128 * 128; }

// ---------------------------------------------------------------------------
// swizzled float32 panels and their wgmma descriptors
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a panel's width in floats: the widest of 32, 16 and 8 dividing K, so
// that its rows span the 128, 64 or 32 bytes of a wgmma swizzle
template <int K>
__host__ __device__ constexpr int panel_width() {
  return K % 32 == 0 ? 32 : (K % 16 == 0 ? 16 : 8);
}

// Byte offset of element (r, c) of a K-major float32 tile of ROWS rows by
// K columns: panels of panel_width<K>() columns one after another, each
// ROWS rows of RB bytes, the 16-byte pieces of a row permuted as the
// wgmma swizzle of RB bytes reads them (offset bits 4.. XOR bits 7..).
// ROWS is a multiple of 8 and the tile's base 1024-byte aligned.
template <int ROWS, int K>
__device__ __forceinline__ uint32_t panel_off(int r, int c) {
  constexpr int PW = panel_width<K>(), RB = 4 * PW, M = RB / 16 - 1;
  const uint32_t lin = (c / PW) * (ROWS * RB) + r * RB + (c % PW) * 4;
  return lin ^ (((lin >> 7) & M) << 4);
}

__device__ __forceinline__ void st4(float* base, uint32_t off, float4 x) {
  *reinterpret_cast<float4*>(reinterpret_cast<char*>(base) + off) = x;
}

// the wgmma descriptor of a K-major panel tile (as panel_off lays it out)
// whose k-step starts at shared address `addr`: 8-row groups 8 * RB
// bytes apart, the swizzle of RB bytes (mode 1: 128, 2: 64, 3: 32)
template <int K>
__device__ __forceinline__ uint64_t panel_desc(uint32_t addr) {
  constexpr int RB = 4 * panel_width<K>();
  constexpr uint64_t mode = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * RB) >> 4) << 32) | (mode << 62);
}

// panel_desc's two halves: the low one carries the address (a panel's
// k-step at byte offset o from addr has lo + o / 16), the high one the
// 8-row stride and the swizzle (a constant of K)
__device__ __forceinline__ uint32_t panel_lo(uint32_t addr) {
  return ((addr & 0x3ffff) >> 4) | (1u << 16);
}
template <int K>
__device__ __forceinline__ uint32_t panel_hi() {
  return static_cast<uint32_t>(panel_desc<K>(0) >> 32);
}

// ---------------------------------------------------------------------------
// wgmma (TF32, A in registers), mbarriers, TMA
// ---------------------------------------------------------------------------

// d (m64 nN, this thread's N / 2 floats) = a b + (acc ? d : 0): a this
// warp's m64k8 TF32 fragment (rows g and g + 8, k t and t + 4), b the
// descriptor of a K-major N x 8 tile
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int acc);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// the same with the descriptor given as its two halves (panel_lo and
// panel_hi), joined here rather than the whole one split for the asm: the
// backward, which passes whole descriptors, ran about 1% slower at
// (192, 128) the other way round (chip_smoke.py --fa-ab)
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint32_t lo,
                                      uint32_t hi, int acc) {
  wgmma<N>(d, a, static_cast<uint64_t>(hi) << 32 | lo, acc);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps reads of d after the wait that completes the wgmma writing it
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// after the mbarriers of a block are initialised, before any use
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t at = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(at), "r"(parity)
        : "memory");
  } while (!done);
}
// the generic proxy's shared-memory writes made visible to wgmma and TMA
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a named barrier of `n` threads (ids from 1; 0 is __syncthreads)
__device__ __forceinline__ void sync_group(int id, int n = 128) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the box of a 4-D (2-D) map at (c0, c1, c2, c3) ((c0, c1)) into dst,
// completing on bar
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map,
                                          int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// tensor maps (host)
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime so that
// the library needs no link to libcuda; null where it is missing
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &got);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &got);
#endif
    return got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// a map of a contiguous (b, s, heads, HD) tensor of T whose box is `rows`
// rows of one head, zero past s: float32 unless `raw`, one panel's
// columns (panel_width<HD>) swizzled as panel_off lays them out; bfloat16,
// or float32 with `raw`, [rows][HD] as they lie in memory
template <typename T, int HD>
bool map_rows(CUtensorMap* map, const void* base, int heads, int s, int b,
              int rows, bool raw = false) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int hd = HD, pw = panel_width<HD>();
  const bool swizzled = F32 && !raw;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {dims[0] * es, dims[1] * dims[0] * es,
                                 dims[2] * dims[1] * dims[0] * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(swizzled ? pw : hd), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      !swizzled ? CU_TENSOR_MAP_SWIZZLE_NONE
                : (pw == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : (pw == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                        : CU_TENSOR_MAP_SWIZZLE_32B));
  return encode(map,
                F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// operands: resident fragments, tiles into panels
// ---------------------------------------------------------------------------

// this thread's A fragments of a resident operand (rows r0.. of a (n, .,
// HD) tensor of T whose rows are `stride` elements apart), as float32,
// whole: a[4 kk + j] is row r0 + 16 warp + g + 8 (j & 1), column 8 kk + t
// + 4 (j >> 1), the m64k8 fragment of k-step kk; rows past n zero
template <typename T, int HD>
__device__ __forceinline__ void load_frags(float (&a)[HD / 2], const T* base,
                                           int r0, int n, int64_t stride,
                                           int warp, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 16 * warp + g + 8 * (j & 1);
      a[4 * kk + j] =
          r < n ? ld1(base + r * stride + 8 * kk + t4 + 4 * (j >> 1)) : 0.f;
    }
}

// a bfloat16 tile of ROWS rows x HD, as the TMA landed it, widened into
// a float32 panel tile of ROWS rows (exact in TF32: no lo rows)
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}
template <int ROWS, int HD>
__device__ __forceinline__ void widen(const __nv_bfloat16* raw, float* tile,
                                      int tid) {
  constexpr int C4 = HD / 4;
  for (int e = tid; e < ROWS * C4; e += 128) {
    const int r = e / C4, c = 4 * (e % C4);
    st4(tile, panel_off<ROWS, HD>(r, c), ld4(raw + r * HD + c));
  }
}

// four floats split: their TF32 big parts into hi, the rest into lo
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  uint32_t b[4], l[4];
  split(x.x, b[0], l[0]);
  split(x.y, b[1], l[1]);
  split(x.z, b[2], l[2]);
  split(x.w, b[3], l[3]);
  hi = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                   __uint_as_float(b[2]), __uint_as_float(b[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// A float32 operand as the tensor core should read it: its bits plus half
// a TF32 ulp. The tensor core reads the top 19 bits of a TF32 operand and
// drops the rest, so it reads the value rounded to nearest TF32. A
// fragment held so in registers is its values' big parts as it stands.
__device__ __forceinline__ uint32_t biased(float x) {
  return __float_as_uint(x) + 0x1000u;
}
// the small part x - big of a biased value b (x's bits plus half a TF32
// ulp, big the TF32 value read of it), itself biased: so the small part
// too reaches the tensor core rounded, and big + small keeps about 23 bits
// of x (truncated it kept about 22, which put the output of a row with a
// handful of keys over 3 times as far from a float64 route as a float32
// plain route)
__device__ __forceinline__ uint32_t small_of(uint32_t b) {
  return biased(__uint_as_float(b - 0x1000u) -
                __uint_as_float(b & 0xffffe000u));
}
// four values of a landed tile as the stage's hi (TF32 big parts) and lo
// (small parts, biased)
__device__ __forceinline__ void split_biased(float4 x, float4& hi,
                                             float4& lo) {
  split4(x, hi, lo);
  lo = make_float4(__uint_as_float(biased(lo.x)),
                   __uint_as_float(biased(lo.y)),
                   __uint_as_float(biased(lo.z)),
                   __uint_as_float(biased(lo.w)));
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

// f(HDK, HDV) for each (q/k, v) head-dim pair the kernels are built for;
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

template <typename T>
struct Tag {
  using type = T;
};

// the dtype code of the entry points: 0 float32, 1 bfloat16
template <typename T>
constexpr int kDtype = std::is_same<T, float>::value ? 0 : 1;

// f(Tag<T>, HDK, HDV) for the dtype and head-dim pair the kernels are
// built for
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
