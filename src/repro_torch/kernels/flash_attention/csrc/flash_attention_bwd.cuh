// What the two translation units of flash_attention's backward
// (flash_attention_bwd.cu: the dq launch, the group sum and the entry
// points; flash_attention_dkdv.cu: the dK/dV launch) share: the launch
// layouts, the swizzled float32 panels and their wgmma descriptors, the
// TF32 wgmma with A in registers, the mbarrier ring and the TMA loads,
// the tensor maps, the recomputed logit, the dispatch over dtypes, head-
// dim pairs and the cap, and the one kernel body both launches run
// (bwd_body; its design is described in flash_attention_bwd.cu).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda)

#include "flash_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// layouts
// ---------------------------------------------------------------------------

// A launch's layout by q/k head dim: BN streamed rows a tile (dq: keys;
// dK/dV: queries), PS panel stages, RS TMA slots (bfloat16's; a float32
// tile lands in its stage), NB buffers of each hand-off between the two
// consumer warpgroups, KC k-steps a promoted chunk of S and dP.
// ops.BWD_LAYOUTS mirrors all but KC.
template <int HDK, bool DKDV>
struct Shape {
  static constexpr int BN = 32;
  static constexpr int PS = HDK <= 64 ? 3 : 2;
  static constexpr int RS = HDK <= 64 ? 2 : 1;
  static constexpr int NB = 2;
  // S and dP promoted every KC k-steps (their A fragments split in
  // registers, KC k-steps at a time): the tensor cores truncate inside a
  // chunk's sum, which 8 k-steps leave too far from float64 at head dim
  // 64 (3.3 times the float32 plain route's distance on dk) and 4 at 24
  // (3.2 on dv); 8 hold at 192
  static constexpr int KC = HDK > 128 ? 8 : (HDK > 32 ? 4 : 1);
};

constexpr int al1k(int x) { return (x + 1023) / 1024 * 1024; }
constexpr int al128(int x) { return (x + 127) / 128 * 128; }

// A block: warpgroup 0 the producer; warpgroups 1 and 2 the consumers of
// its 64 resident rows (dq: queries; dK/dV: keys), both on every tile:
// role 0 computes S (its A, the resident Q or K, held in registers) and
// P, role 1 dP (dO or V) and dS; dQ's M-blocks are shared out between
// them, dK/dV gives dV to role 0 and dK to role 1. Byte offsets of its
// shared memory (from a 1024-byte aligned base): PS stages, each a
// streamed tile's float32 panel tiles; the scratch panels (64 x BN, hi
// and lo) that products read as B: dq, NB of dS; dK/dV, role 0's P and
// role 1's dS; NB buffers of role 0's masked P (times the cap's factor)
// for role 1, in accumulator order; RS slots where the TMA lands a tile
// as it lies in memory (and dK/dV's lse and Delta); dK/dV's lse and
// Delta of each stage; the mbarriers.
template <typename T, int HDK, int HDV, bool DKDV>
struct BwdLayout {
  using S = Shape<HDK, DKDV>;
  static constexpr int BN = S::BN, PS = S::PS, NB = S::NB;
  static constexpr int THREADS = 384;
  // the producer gives its registers to the consumers
  static constexpr int REG_P = 40, REG_C = 232;
  static constexpr int KC = S::KC;
  static constexpr int MA = (HDK + 63) / 64, MV = (HDV + 63) / 64;
  // dq: dQ^T's M-blocks [0, MB0) are role 0's, the rest role 1's
  static constexpr int MB0 = (MA + (HDK <= 64 ? 1 : 0)) / 2;
  static constexpr bool LO = std::is_same<T, float>::value;
  // a streamed tile's panel rows: its BN rows' hi, then (float32) their lo
  static constexpr int NPAN = LO ? 2 : 1, PR = NPAN * BN;
  static constexpr int PAN_A = al1k(PR * HDK * 4), PAN_B = al1k(PR * HDV * 4);
  static constexpr int STAGE = PAN_A + PAN_B;
  static constexpr int SCR = al1k(64 * BN * 4);
  static constexpr int NSCR = DKDV ? 4 : 2 * NB;
  static constexpr int PBUF = 64 * BN * 4;
  // float32 tiles land by TMA in their stage's hi rows, already swizzled,
  // and are split there; bfloat16 tiles land in RS slots as they lie in
  // memory and are widened into the stage
  static constexpr int RS = LO ? 0 : S::RS, NLAND = LO ? PS : RS;
  static constexpr int RAW_A = al128(BN * HDK * static_cast<int>(sizeof(T)));
  static constexpr int RAW_B = al128(BN * HDV * static_cast<int>(sizeof(T)));
  static constexpr int RAW_V = DKDV ? al128(BN * 4) : 0;
  static constexpr int RAW = RAW_A + RAW_B + 2 * RAW_V;
  // bytes one slot's TMA loads bring
  static constexpr int TX = BN * (HDK + HDV) * static_cast<int>(sizeof(T)) +
                            (DKDV ? 2 * BN * 4 : 0);
  // dK/dV's lse and Delta of a stage, each VS bytes (128-byte aligned: a
  // TMA destination)
  static constexpr int VS = al128(BN * 4), VEC = DKDV ? PS * 2 * VS : 0;
  static constexpr int O_SCR = PS * STAGE;
  static constexpr int O_PBUF = O_SCR + NSCR * SCR;
  static constexpr int O_RAW = O_PBUF + NB * PBUF;
  static constexpr int O_VEC = O_RAW + RS * RAW;
  static constexpr int O_BAR = (O_VEC + VEC + 7) / 8 * 8;
  static constexpr int NBAR = 2 * PS + NLAND + 4 * NB;
  static constexpr int BYTES = O_BAR + 8 * NBAR + 1024;
  static_assert(BYTES <= 232448, "past the 227 KB a block may have");
  static_assert(BN == 16 || BN == 32, "wgmma widths built");
};

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

__device__ __forceinline__ float ld_at(const float* base, uint32_t off) {
  return *reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(base) + off);
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
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
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
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
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
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
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
// rows of one head, zero past s: float32, one panel's columns
// (panel_width<HD>) swizzled as panel_off lays them out; bfloat16, [rows]
// [HD] as they lie in memory
template <typename T, int HD>
bool map_rows(CUtensorMap* map, const void* base, int heads, int s, int b,
              int rows) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int hd = HD, pw = panel_width<HD>();
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {dims[0] * es, dims[1] * dims[0] * es,
                                 dims[2] * dims[1] * dims[0] * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(F32 ? pw : hd), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      !F32 ? CU_TENSOR_MAP_SWIZZLE_NONE
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

// Row length of the dq launch's copy of lse and of Delta: Sq rounded up to
// 4 floats, so that every row starts 16-byte aligned, as a TMA box must
// (a box at a float offset off 16 bytes faults).
__host__ __device__ constexpr int vec_row(int sq) { return (sq + 3) / 4 * 4; }

// a map of `n` rows of vec_row(sq) float32 values whose box is `rows`
// values of one row, zero past the row's end
bool map_vec(CUtensorMap* map, const float* base, int64_t n, int sq,
             int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(vec_row(sq)),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {dims[0] * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// the kernel body
// ---------------------------------------------------------------------------

__device__ __forceinline__ void st4(float* base, uint32_t off, float4 x) {
  *reinterpret_cast<float4*>(reinterpret_cast<char*>(base) + off) = x;
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

// a float32 tile of ROWS rows x HD that the TMA landed, swizzled, in the
// hi rows of its panel tile (2 ROWS rows a panel): each value split in
// place into its TF32 big part (rounded to nearest), the rest (exact) into
// the lo row ROWS below, which the same swizzle covers
template <int ROWS, int HD>
__device__ __forceinline__ void split_tile(float* tile, int tid) {
  constexpr int RB = 4 * panel_width<HD>(), C = ROWS * RB / 16;
  for (int e = tid; e < HD / (RB / 4) * C; e += 128) {
    const uint32_t o = (e / C) * (2 * ROWS * RB) + (e % C) * 16;
    const float4 x = *reinterpret_cast<const float4*>(
        reinterpret_cast<const char*>(tile) + o);
    uint32_t b[4], l[4];
    split(x.x, b[0], l[0]);
    split(x.y, b[1], l[1]);
    split(x.z, b[2], l[2]);
    split(x.w, b[3], l[3]);
    st4(tile, o,
        make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                    __uint_as_float(b[2]), __uint_as_float(b[3])));
    st4(tile, o + ROWS * RB,
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3])));
  }
}

// acc (the warpgroup's 64 resident rows x BN streamed rows) = A B^T over
// HD: A the resident operand's fragments in registers (load_frags), each
// split into its TF32 big and small parts as it is used; B the stage's
// panel tile of the streamed rows' hi (and, float32, their lo below).
// 3xTF32, big big + big lo + small big, as two wgmma a k-step: A's big
// part against the hi and lo rows at once (N = 2 BN: big big in the first
// BN columns, big lo in the rest) and A's small part against the hi
// rows; bfloat16 inputs, exact in TF32, take the first alone. Promoted:
// each chunk of KC <= 8 k-steps sums into zeroed accumulators (scale-d
// 0), which float32 adds put into acc.
template <int BN, int HD, bool LO, int KC>
__device__ __forceinline__ void rows_product(float (&acc)[BN / 2],
                                             const float (&a)[HD / 2],
                                             const float* tile) {
  constexpr int KS = HD / 8, PR = LO ? 2 * BN : BN;
  const uint32_t t0 = smem_u32(tile);
#pragma unroll
  for (int c0 = 0; c0 < KS; c0 += KC) {
    uint32_t ab[KC][4], as[KC][4];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      if (c0 + kk >= KS) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split(a[4 * (c0 + kk) + j], ab[kk][j], as[kk][j]);
    }
    float t[PR / 2], u[BN / 2];
#pragma unroll
    for (int i = 0; i < PR / 2; ++i) t[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) u[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      if (c0 + kk >= KS) continue;
      const uint64_t d =
          panel_desc<HD>(t0 + panel_off<PR, HD>(0, 8 * (c0 + kk)));
      wgmma<PR>(t, ab[kk], d, kk);
      if constexpr (LO) wgmma<BN>(u, as[kk], d, kk);
    }
    wgmma_commit();
    wgmma_wait();
    hold(t);
    hold(u);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float x = t[i];
      if constexpr (LO) x = (x + t[BN / 2 + i]) + u[i];
      acc[i] = c0 == 0 ? x : acc[i] + x;
    }
  }
}

// acc (HD as rows: its M-blocks of 64 from M0, MB of them, by the
// warpgroup's 64 resident rows) += C^T X^T over the tile's BN streamed
// rows: A = C^T read in registers from the stage's panel tile of C (its
// hi rows, and lo rows below them; rows of A past HD zero), B = X, a
// 64 x BN scratch panel pair xh and xl (X is computed, so always split);
// each M-block's BN / 8 k-steps sum into a zeroed accumulator, which a
// float32 add puts into acc.
template <int BN, int HD, bool LO, int M0, int MB>
__device__ __forceinline__ void out_product(float (&acc)[MB * 32],
                                            const float* tile,
                                            const float* xh, const float* xl,
                                            int warp, int g, int t4) {
  constexpr int KS = BN / 8, PR = LO ? 2 * BN : BN;
  const uint32_t h0 = smem_u32(xh), l0 = smem_u32(xl);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    uint32_t ab[KS][4], as[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = 64 * (M0 + mb) + 16 * warp + g + 8 * (j & 1);
        const int k = 8 * kk + t4 + 4 * (j >> 1);
        ab[kk][j] = as[kk][j] = 0u;
        if (HD % 64 == 0 || m < HD) {
          ab[kk][j] = __float_as_uint(ld_at(tile, panel_off<PR, HD>(k, m)));
          if constexpr (LO)
            as[kk][j] =
                __float_as_uint(ld_at(tile, panel_off<PR, HD>(BN + k, m)));
        }
      }
    float t[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) t[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      // the small products first, so that the big one is added to them
      // and not they, truncated, to it
      const uint32_t o = panel_off<64, BN>(0, 8 * kk);
      const uint64_t dh = panel_desc<BN>(h0 + o), dl = panel_desc<BN>(l0 + o);
      wgmma<64>(t, ab[kk], dl, kk);
      if constexpr (LO) wgmma<64>(t, as[kk], dh, 1);
      wgmma<64>(t, ab[kk], dh, 1);
    }
    wgmma_commit();
    wgmma_wait();
    hold(t);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * mb + i] += t[i];
  }
}

// this thread's part of a 64 x BN accumulator into a scratch panel pair:
// hi, its TF32 big part, and lo
template <int BN>
__device__ __forceinline__ void to_scratch(const float (&x)[BN / 2],
                                           float* hi, float* lo, int warp,
                                           int g, int t4) {
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      uint32_t b0, s0, b1, s1;
      split(x[4 * nb + 2 * hr], b0, s0);
      split(x[4 * nb + 2 * hr + 1], b1, s1);
      const uint32_t o = panel_off<64, BN>(16 * warp + g + 8 * hr,
                                           8 * nb + 2 * t4);
      *reinterpret_cast<uint2*>(reinterpret_cast<char*>(hi) + o) =
          make_uint2(b0, b1);
      *reinterpret_cast<uint2*>(reinterpret_cast<char*>(lo) + o) =
          make_uint2(s0, s1);
    }
}

// A launch's arguments. dq: the resident tensors are Q and dO, the
// streamed K and V; dK/dV: resident K and V, streamed Q and dO, and lse
// and Delta from the (2, B * H, vec_row(Sq)) float32 scratch dq writes.
struct BwdArgs {
  CUtensorMap ma, mb;  // the streamed tensors' maps
  CUtensorMap ml, md;  // dK/dV: lse's and Delta's
  const void* ra;      // the resident tensors
  const void* rb;
  const void* out;     // dq: the forward's output
  const float* lse;    // dq: the forward's log-sum-exp
  float* vecs;         // dq writes its lse copy and Delta there
  void* g1;            // dq: dQ; dK/dV: dK
  void* g2;            // dK/dV: dV
  float* part;         // dK/dV when split > 1: the partials
  int sq, skv, h, kvh, split;
  float scale;
  int causal, window;
  float softcap;
};

// Where a block is: its 64 resident rows from r0 and the streamed tiles
// it walks. dq: query rows, key tiles t_lo.. (longest query tiles
// first); dK/dV: keys, (head, query tile) steps head-major over the
// part's heads from h0, nt query tiles from t_lo a head (with causal
// masking and Sq > Skv the rows with no key are walked too).
struct Geo {
  int head, kvhead, r0, t_lo, total, h0, nt, prt;
};

template <int BN, bool DKDV>
__device__ __forceinline__ Geo locate(const BwdArgs& p) {
  Geo o{0, 0, 0, 0, 0, 0, 1, 0};
  const int off = p.skv - p.sq, grp = p.h / p.kvh;
  if constexpr (DKDV) {
    o.kvhead = blockIdx.x / p.split;
    o.prt = blockIdx.x % p.split;
    o.r0 = blockIdx.z * 64;
    const int nh = grp / p.split;
    o.h0 = o.kvhead * grp + o.prt * nh;
    const int k_hi = min(o.r0 + 64, p.skv) - 1;
    int i_lo = 0, i_hi = p.sq - 1;
    if (p.causal && off >= 0) i_lo = max(0, o.r0 - off);
    if (p.window > 0) i_hi = min(i_hi, k_hi + p.window - 1 - off);
    o.t_lo = i_lo / BN;
    o.nt = i_lo <= i_hi ? i_hi / BN - o.t_lo + 1 : 0;
    o.total = nh * o.nt;
  } else {
    o.head = blockIdx.x;
    o.kvhead = o.head / grp;
    o.r0 = (gridDim.z - 1 - blockIdx.z) * 64;
    const int q_lo = o.r0 + off, q_hi = min(o.r0 + 64, p.sq) - 1 + off;
    int t_hi = (p.skv - 1) / BN;
    if (p.causal) t_hi = q_hi < 0 ? -1 : min(t_hi, q_hi / BN);
    if (p.window > 0) {
      const int first = q_lo - p.window + 1;
      if (first > 0) o.t_lo = first / BN;
    }
    o.total = max(0, t_hi - o.t_lo + 1);
  }
  return o;
}

// the producer. float32: thread 0 loads each tile by TMA into a free
// stage's hi rows, a box a panel, and the warpgroup splits it there.
// bfloat16: thread 0 keeps RS tiles in flight by TMA in slots as they lie
// in memory, and the warpgroup widens each into a free stage. Either way
// dK/dV's lse and Delta go beside the stage, and the warpgroup then
// arrives on the stage's full mbarrier.
template <typename T, int HDK, int HDV, bool DKDV>
__device__ __forceinline__ void produce(const BwdArgs& p, unsigned char* sm,
                                        const Geo& o) {
  using L = BwdLayout<T, HDK, HDV, DKDV>;
  constexpr int BN = L::BN, PS = L::PS, RS = L::RS;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::O_BAR);
  uint64_t* empty = full + PS;
  uint64_t* landed = empty + PS;
  const int tid = threadIdx.x % 128, b = blockIdx.y;
  // the tile's (head, first row) in its tensors' maps
  auto where = [&](int idx, int& hd, int& r0) {
    if constexpr (DKDV) {
      hd = o.h0 + idx / o.nt;
      r0 = (o.t_lo + idx % o.nt) * BN;
    } else {
      hd = o.kvhead;
      r0 = (o.t_lo + idx) * BN;
    }
  };
  auto vecs = [&](int idx, unsigned char* lse, uint64_t* bar) {
    int hd, r0;
    where(idx, hd, r0);
    tma_load2(lse, &p.ml, r0, b * p.h + hd, bar);
    tma_load2(lse + L::VS, &p.md, r0, b * p.h + hd, bar);
  };
  if constexpr (L::LO) {
    constexpr int RA = 4 * panel_width<HDK>(), RB = 4 * panel_width<HDV>();
    auto issue = [&](int idx) {
      const int st = idx % PS;
      unsigned char* stage = sm + st * L::STAGE;
      int hd, r0;
      where(idx, hd, r0);
      mbar_expect(&landed[st], L::TX);
      for (int c = 0; c < HDK / (RA / 4); ++c)
        tma_load4(stage + c * L::PR * RA, &p.ma, c * (RA / 4), hd, r0, b,
                  &landed[st]);
      for (int c = 0; c < HDV / (RB / 4); ++c)
        tma_load4(stage + L::PAN_A + c * L::PR * RB, &p.mb, c * (RB / 4), hd,
                  r0, b, &landed[st]);
      if constexpr (DKDV)
        vecs(idx, sm + L::O_VEC + st * 2 * L::VS, &landed[st]);
    };
    if (tid == 0)
      for (int i = 0; i < PS && i < o.total; ++i) issue(i);
    for (int idx = 0; idx < o.total; ++idx) {
      const int st = idx % PS;
      if (idx >= PS) {
        // the consumers are done with the tile PS back: reload the stage
        mbar_wait(&empty[st], ((idx / PS) & 1) ^ 1);
        if (tid == 0) issue(idx);
      }
      float* stage = reinterpret_cast<float*>(sm + st * L::STAGE);
      mbar_wait(&landed[st], (idx / PS) & 1);
      split_tile<BN, HDK>(stage, tid);
      split_tile<BN, HDV>(stage + L::PAN_A / 4, tid);
      fence_async();
      mbar_arrive(&full[st]);
    }
  } else {
    auto issue = [&](int idx) {
      const int slot = idx % RS;
      unsigned char* raw = sm + L::O_RAW + slot * L::RAW;
      int hd, r0;
      where(idx, hd, r0);
      mbar_expect(&landed[slot], L::TX);
      tma_load4(raw, &p.ma, 0, hd, r0, b, &landed[slot]);
      tma_load4(raw + L::RAW_A, &p.mb, 0, hd, r0, b, &landed[slot]);
      if constexpr (DKDV)
        vecs(idx, raw + L::RAW_A + L::RAW_B, &landed[slot]);
    };
    if (tid == 0)
      for (int i = 0; i < RS && i < o.total; ++i) issue(i);
    for (int idx = 0; idx < o.total; ++idx) {
      const int slot = idx % RS, st = idx % PS;
      const unsigned char* raw = sm + L::O_RAW + slot * L::RAW;
      float* stage = reinterpret_cast<float*>(sm + st * L::STAGE);
      mbar_wait(&landed[slot], (idx / RS) & 1);
      mbar_wait(&empty[st], ((idx / PS) & 1) ^ 1);
      widen<BN, HDK>(reinterpret_cast<const T*>(raw), stage, tid);
      widen<BN, HDV>(reinterpret_cast<const T*>(raw + L::RAW_A),
                     stage + L::PAN_A / 4, tid);
      if constexpr (DKDV) {
        float* vec = reinterpret_cast<float*>(sm + L::O_VEC + st * 2 * L::VS);
        const float* lv =
            reinterpret_cast<const float*>(raw + L::RAW_A + L::RAW_B);
        for (int i = tid; i < BN; i += 128) {
          vec[i] = lv[i];
          vec[L::VS / 4 + i] = lv[L::VS / 4 + i];
        }
      }
      fence_async();
      mbar_arrive(&full[st]);
      sync_group(1);  // every producer thread is done with this slot
      if (tid == 0 && idx + RS < o.total) issue(idx + RS);
    }
  }
}

// A consumer warpgroup of role ROLE (see BwdLayout) over the block's
// tiles. Both roles walk the same tiles and skip the same ones (none of
// the block's pairs in it visible, and in dK/dV no row without keys); a
// live tile's hand-offs go through buffer hc % NB, hc counting live
// tiles: role 0 puts its masked P (times 1 - t^2 under the cap) into the
// P buffer (pready, freed by role 1 with pfree); dq's role 1 puts dS hi
// and lo into the scratch both roles' dQ^T products read (dsready, freed
// by both with dsfree).
template <typename T, int HDK, int HDV, bool CAP, bool DKDV, int ROLE>
__device__ __forceinline__ void consume(const BwdArgs& p, unsigned char* sm,
                                        const Geo& o) {
  using L = BwdLayout<T, HDK, HDV, DKDV>;
  constexpr int BN = L::BN, PS = L::PS, NB = L::NB, MA = L::MA;
  constexpr int MV = L::MV, MB0 = L::MB0;
  constexpr bool LO = L::LO;
  constexpr int HR = ROLE == 0 ? HDK : HDV;  // the resident operand's
  // the M-blocks of this role's output: dq, dQ^T's share; dK/dV, dV^T
  // (role 0) or dK^T (role 1)
  constexpr int M0 = DKDV || ROLE == 0 ? 0 : MB0;
  constexpr int NM =
      DKDV ? (ROLE == 0 ? MV : MA) : (ROLE == 0 ? MB0 : MA - MB0);
  constexpr int HO = DKDV && ROLE == 0 ? HDV : HDK;  // its output's dim
  constexpr int SW = L::SCR / 4;                     // floats a panel
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::O_BAR);
  uint64_t* empty = full + PS;
  uint64_t* pready = empty + PS + L::NLAND;
  uint64_t* pfree = pready + NB;
  uint64_t* dsready = pfree + NB;
  uint64_t* dsfree = dsready + NB;
  float* scr = reinterpret_cast<float*>(sm + L::O_SCR);
  float* pbuf = reinterpret_cast<float*>(sm + L::O_PBUF);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4, bar = 2 + ROLE;
  const int b = blockIdx.y, off = p.skv - p.sq, w0 = o.r0;
  const float sl = p.scale * kLog2e;
  const float cs = CAP ? p.scale / p.softcap : 0.f;
  const float cl = CAP ? p.softcap * kLog2e : 0.f;
  const int64_t qs = static_cast<int64_t>(p.h) * HDK;  // Q rows
  const int64_t os = static_cast<int64_t>(p.h) * HDV;  // O and dO rows
  const int64_t ks = static_cast<int64_t>(p.kvh) * HDK;
  const int64_t vs = static_cast<int64_t>(p.kvh) * HDV;
  const int64_t qoff = (static_cast<int64_t>(b) * p.sq * p.h + o.head) * HDK;
  const int64_t ooff = (static_cast<int64_t>(b) * p.sq * p.h + o.head) * HDV;
  const int64_t koff =
      static_cast<int64_t>(b) * p.skv * ks + o.kvhead * HDK;
  const int64_t voff =
      static_cast<int64_t>(b) * p.skv * vs + o.kvhead * HDV;

  // the resident operand's fragments: dq Q (role 0) or dO (role 1); dK/dV
  // K or V. dq's role 0 takes its rows' lse (base 2); its role 1 their
  // Delta = rowsum(dO * O), from the fragments (four threads a row), and
  // writes lse's copy and Delta for the dK/dV launch.
  float a[HR / 2];
  float l2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if constexpr (DKDV) {
    if constexpr (ROLE == 0)
      load_frags<T, HDK>(a, static_cast<const T*>(p.ra) + koff, w0, p.skv,
                         ks, warp, g, t4);
    else
      load_frags<T, HDV>(a, static_cast<const T*>(p.rb) + voff, w0, p.skv,
                         vs, warp, g, t4);
  } else {
    const int64_t roff = (static_cast<int64_t>(b) * p.h + o.head) * p.sq;
    if constexpr (ROLE == 0) {
      load_frags<T, HDK>(a, static_cast<const T*>(p.ra) + qoff, w0, p.sq, qs,
                         warp, g, t4);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = w0 + 16 * warp + g + 8 * hr;
        l2[hr] = r < p.sq ? p.lse[roff + r] * kLog2e : 0.f;
      }
    } else {
      load_frags<T, HDV>(a, static_cast<const T*>(p.rb) + ooff, w0, p.sq, os,
                         warp, g, t4);
      float ov[HDV / 2];
      load_frags<T, HDV>(ov, static_cast<const T*>(p.out) + ooff, w0, p.sq,
                         os, warp, g, t4);
#pragma unroll
      for (int i = 0; i < HDV / 2; ++i) dl[(i & 1)] += a[i] * ov[i];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dl[hr] += __shfl_xor_sync(0xffffffffu, dl[hr], 1);
        dl[hr] += __shfl_xor_sync(0xffffffffu, dl[hr], 2);
      }
      const int sqp = vec_row(p.sq);
      const int64_t vrow = (static_cast<int64_t>(b) * p.h + o.head) * sqp;
      const int64_t nvec = static_cast<int64_t>(gridDim.y) * p.h * sqp;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = w0 + 16 * warp + g + 8 * hr;
        if (t4 == 0 && r < p.sq) {
          p.vecs[vrow + r] = p.lse[roff + r];
          p.vecs[nvec + vrow + r] = dl[hr];
        }
      }
    }
  }

  float acc[NM > 0 ? NM * 32 : 1];
#pragma unroll
  for (int i = 0; i < (NM > 0 ? NM * 32 : 1); ++i) acc[i] = 0.f;
  const float uniform = 1.f / static_cast<float>(p.skv);
  int hc = 0;  // live tiles so far

  for (int idx = 0; idx < o.total; ++idx) {
    const int st = idx % PS;
    const float* ca = reinterpret_cast<const float*>(sm + st * L::STAGE);
    const float* cb = ca + L::PAN_A / 4;  // dq: K, V; dK/dV: Q, dO
    // the tile's first streamed row (dq: key; dK/dV: query) and whether any
    // of the block's pairs in it is visible (in dK/dV also: any row
    // without keys)
    int i0;
    bool live;
    if constexpr (DKDV) {
      i0 = (o.t_lo + idx % o.nt) * BN;
      const int p_lo = i0 + off, p_hi = p_lo + BN - 1;
      const bool dead = p.causal && p_lo < 0;
      live = w0 < p.skv &&
             (dead || !((p.causal && w0 > p_hi) ||
                        (p.window > 0 && w0 + 63 <= p_lo - p.window)));
    } else {
      i0 = (o.t_lo + idx) * BN;
      const int w_lo = w0 + off;
      live = w0 < p.sq && !((p.causal && i0 > w_lo + 63) ||
                            (p.window > 0 && i0 + BN - 1 <= w_lo - p.window));
    }
    mbar_wait(&full[st], (idx / PS) & 1);
    if (live) {
      const int j = hc % NB, ph = (hc / NB) & 1;
      ++hc;
      float* pb = pbuf + j * (L::PBUF / 4);
      // S = Q K^T or dP = dO V^T over the resident head dim (dK/dV: S^T,
      // dP^T)
      float x[BN / 2];
      rows_product<BN, HR, LO, L::KC>(x, a, ROLE == 0 ? ca : cb);
      if constexpr (ROLE == 0) {
        // P, and into the buffer P masked (times 1 - t^2 under the cap)
        float pv[BN / 2];
        if constexpr (DKDV) {
          const float* vec =
              reinterpret_cast<const float*>(sm + L::O_VEC + st * 2 * L::VS);
          const int p_lo = i0 + off, p_hi = p_lo + BN - 1;
          const bool edge = i0 + BN > p.sq || w0 + 64 > p.skv ||
                            (p.causal && w0 + 63 > p_lo) ||
                            (p.window > 0 && w0 <= p_hi - p.window);
#pragma unroll
          for (int nb = 0; nb < BN / 8; ++nb) {
            const float2 lv =
                *reinterpret_cast<const float2*>(vec + 8 * nb + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cc = e & 1, y = 4 * nb + e;  // query col, key row
              float fac = 1.f;
              const float pr =
                  exp2f(logit2_grad<CAP>(x[y], sl, cs, cl, fac) -
                        (cc ? lv.y : lv.x) * kLog2e);
              if (!edge) {
                pv[y] = pr;
                x[y] = pr * fac;
              } else {
                const int kpos = w0 + 16 * warp + g + 8 * (e >> 1);
                const int qi = i0 + 8 * nb + 2 * t4 + cc, qpos = qi + off;
                const bool in = qi < p.sq && kpos < p.skv;
                bool ok = in;
                if (p.causal) ok = ok && kpos <= qpos;
                if (p.window > 0) ok = ok && kpos > qpos - p.window;
                // a row with no key averages v over all keys
                pv[y] =
                    ok ? pr : (in && p.causal && qpos < 0 ? uniform : 0.f);
                x[y] = ok ? pr * fac : 0.f;
              }
            }
          }
        } else {
          const int w_lo = w0 + off;
          const bool edge = i0 + BN > p.skv ||
                            (p.causal && i0 + BN - 1 > w_lo) ||
                            (p.window > 0 && i0 <= w_lo + 63 - p.window);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int qpos = w_lo + 16 * warp + g + 8 * hr;
#pragma unroll
            for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const int y = 4 * nb + 2 * hr + cc;
                const int kpos = i0 + 8 * nb + 2 * t4 + cc;
                bool ok = true;
                if (edge) {
                  ok = kpos < p.skv;
                  if (p.causal) ok = ok && kpos <= qpos;
                  if (p.window > 0) ok = ok && kpos > qpos - p.window;
                }
                float fac = 1.f;
                const float pr = exp2f(
                    logit2_grad<CAP>(x[y], sl, cs, cl, fac) - l2[hr]);
                x[y] = ok ? pr * fac : 0.f;
              }
          }
        }
        mbar_wait(&pfree[j], ph ^ 1);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) pb[i * 128 + tid] = x[i];
        mbar_arrive(&pready[j]);
        if constexpr (DKDV) {
          // dV^T += dO^T P
          sync_group(bar);  // the last tile's product has read the scratch
          to_scratch<BN>(pv, scr, scr + SW, warp, g, t4);
          fence_async();
          sync_group(bar);
          out_product<BN, HDV, LO, 0, MV>(acc, cb, scr, scr + SW, warp, g,
                                          t4);
        } else if constexpr (NM > 0) {
          // dQ^T's first M-blocks += K^T dS^T
          mbar_wait(&dsready[j], ph);
          out_product<BN, HDK, LO, 0, NM>(acc, ca, scr + 2 * j * SW,
                                          scr + (2 * j + 1) * SW, warp, g,
                                          t4);
          mbar_arrive(&dsfree[j]);
        }
      } else {
        // dS = P (dP - Delta) (times 1 - t^2 under the cap), 0 where role
        // 0 masked P
        mbar_wait(&pready[j], ph);
        float pm[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) pm[i] = pb[i * 128 + tid];
        mbar_arrive(&pfree[j]);
        if constexpr (DKDV) {
          const float* dlt = reinterpret_cast<const float*>(
              sm + L::O_VEC + (st * 2 + 1) * L::VS);
#pragma unroll
          for (int nb = 0; nb < BN / 8; ++nb) {
            const float2 dv2 =
                *reinterpret_cast<const float2*>(dlt + 8 * nb + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int y = 4 * nb + e;
              const float dd = (e & 1) ? dv2.y : dv2.x;
              x[y] = pm[y] != 0.f ? pm[y] * (x[y] - dd) : 0.f;
            }
          }
          // dK^T += Q^T dS
          sync_group(bar);  // the last tile's product has read the scratch
          to_scratch<BN>(x, scr + 2 * SW, scr + 3 * SW, warp, g, t4);
          fence_async();
          sync_group(bar);
          out_product<BN, HDK, LO, 0, MA>(acc, ca, scr + 2 * SW,
                                          scr + 3 * SW, warp, g, t4);
        } else {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            x[i] = pm[i] != 0.f ? pm[i] * (x[i] - dl[(i >> 1) & 1]) : 0.f;
          mbar_wait(&dsfree[j], ph ^ 1);
          to_scratch<BN>(x, scr + 2 * j * SW, scr + (2 * j + 1) * SW, warp,
                         g, t4);
          fence_async();
          mbar_arrive(&dsready[j]);
          if constexpr (NM > 0) {
            // dQ^T's other M-blocks += K^T dS^T
            mbar_wait(&dsready[j], ph);
            out_product<BN, HDK, LO, M0, NM>(acc, ca, scr + 2 * j * SW,
                                             scr + (2 * j + 1) * SW, warp, g,
                                             t4);
            mbar_arrive(&dsfree[j]);
          }
        }
      }
    }
    mbar_arrive(&empty[st]);
  }

  // this thread's elements: column m of the output (a head dim) at row
  // 64 mb + 16 warp + g + 8 hr, resident row w0 + 8 nb + 2 t + cc
  const int64_t nk = static_cast<int64_t>(gridDim.y) * p.skv * ks;
  const int64_t nv = static_cast<int64_t>(gridDim.y) * p.skv * vs;
#pragma unroll
  for (int mb = 0; mb < NM; ++mb)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 64 * (M0 + mb) + 16 * warp + g + 8 * (e >> 1);
        const int row = w0 + 8 * nb + 2 * t4 + (e & 1);
        const float y = acc[32 * mb + 4 * nb + e];
        if (m >= HO) continue;
        if constexpr (DKDV) {
          if (row >= p.skv) continue;
          if constexpr (ROLE == 0) {
            const int64_t at = voff + row * vs + m;
            if (p.split == 1)
              store(static_cast<T*>(p.g2) + at, y);
            else
              p.part[p.split * nk + o.prt * nv + at] = y;
          } else {
            const int64_t at = koff + row * ks + m;
            if (p.split == 1)
              store(static_cast<T*>(p.g1) + at, y * p.scale);
            else
              p.part[o.prt * nk + at] = y;
          }
        } else {
          if (row < p.sq)
            store(static_cast<T*>(p.g1) + qoff + row * qs + m, y * p.scale);
        }
      }
}

// One block of either launch: warpgroup 0 the producer, 1 and 2 the
// consumers of roles 0 and 1.
template <typename T, int HDK, int HDV, bool CAP, bool DKDV>
__device__ __forceinline__ void bwd_body(const BwdArgs& p) {
  using L = BwdLayout<T, HDK, HDV, DKDV>;
  constexpr int PS = L::PS, NB = L::NB, MB0 = L::MB0;
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  unsigned char* sm =
      smem_dyn + ((1024u - (smem_u32(smem_dyn) & 1023u)) & 1023u);
  const Geo o = locate<L::BN, DKDV>(p);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::O_BAR);
    // full, empty, landed, pready, pfree, dsready, dsfree
    for (int i = 0; i < PS; ++i) {
      mbar_init(&bars[i], 128);
      mbar_init(&bars[PS + i], 256);
    }
    for (int i = 0; i < L::NLAND; ++i) mbar_init(&bars[2 * PS + i], 1);
    // dQ^T's readers of dS: role 0 where it holds M-blocks, and role 1
    const int readers = 128 * ((MB0 > 0) + (L::MA - MB0 > 0));
    for (int i = 0; i < NB; ++i) {
      uint64_t* hand = bars + 2 * PS + L::NLAND;
      mbar_init(&hand[i], 128);
      mbar_init(&hand[NB + i], 128);
      mbar_init(&hand[2 * NB + i], 128);
      mbar_init(&hand[3 * NB + i], readers > 0 ? readers : 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<L::REG_P>();
    produce<T, HDK, HDV, DKDV>(p, sm, o);
  } else if (wg == 1) {
    setmaxnreg_inc<L::REG_C>();
    consume<T, HDK, HDV, CAP, DKDV, 0>(p, sm, o);
  } else {
    setmaxnreg_inc<L::REG_C>();
    consume<T, HDK, HDV, CAP, DKDV, 1>(p, sm, o);
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
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
// one) the backward dispatched on; reads the copy of lse and Delta the dq
// launch wrote into `vecs`. Returns the first CUDA error.
int flash_dkdv_launch(int dtype, int hd, int hd_v, bool cap, const void* q,
                      const void* k, const void* v, const void* dout,
                      const float* vecs, void* dk, void* dv, float* part,
                      int b, int sq, int skv, int h, int kvh, int split,
                      float scale, int causal, int window, float softcap,
                      cudaStream_t stream);
// kernel_info of flash_bwd_dkdv at the same dtype, pair and build.
int flash_dkdv_info(int dtype, int hd, int hd_v, bool cap, int* info);
