// Forward attention with an online softmax over key tiles, written by hand
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/flash_attention.py:64). For q
// (B, Sq, H, hd) and k, v (B, Skv, KV, hd), KV | H, query head h reads KV
// head h / (H / KV), so grouped heads are never expanded in memory. Query
// row i sits at position i + Skv - Sq, key j at position j. Causal and
// sliding-window masks (kpos > qpos - window) put the reference's -2e9 on
// the logit; keys past Skv take no part. Output is acc / max(l, 1e-30) in
// q's type, with (m, l, acc) carried in float32, as the TPU kernel does.
// Head dims 16, 32, 64 and 128.
//
// Bound on this card: operations. The function does 4 * hd operations per
// visible (query, key) pair: 3.4e10 at llama3.2-1b's prefill (B=8,
// S=1024, H=32, hd=64, causal) and 5.2e10 at starcoder2-3b's (H=24,
// hd=128); the bytes take 0.05-0.07 ms. The serve path runs in float32
// and holds the kernel to 2e-5 of its plain version, which TF32 alone
// (about three decimal digits) would miss. So both products run on the
// tensor cores as 3xTF32: each float32 operand x is split into
// big = x rounded to TF32 and small = x - big, and a * b is taken as
// big*big + big*small + small*big (the small*small term, 2^-22 of the
// product, is dropped), each an m16n8k8 TF32 mma.sync with float32
// accumulation. Three TF32 products per multiply-add put the bound at
// 495 / 3 = 165 TFLOP/s (0.21 ms and 0.31 ms at the shapes above),
// against 67 TFLOP/s on the float32 units (0.51 ms and 0.77 ms). The
// split uses integer operations (add half a TF32 ulp, clear the low 13
// bits), not cvt.rna.tf32, which issues at a quarter of the rate.
//
// Design: a block of 4 warps owns 64 * MT query rows of one (batch, head);
// warp w owns MT m-tiles of 16 rows, so it needs no other warp's rows and
// the block meets only once per key tile. Lane (g = lane / 4, t = lane %
// 4) holds rows g and g + 8 of each 8-key column tile of S and of each
// 8-dim column tile of O. Row maxima and sums are merged with shuffles
// among the 4 lanes of a row, in a fixed order; the softmax runs in base
// 2 (logits times log2 e), so each p is one exp2, and masks are computed
// only on tiles that cut the causal diagonal, the window's edge or Skv. P
// never leaves registers: S's accumulator fragment becomes P·V's A
// fragment directly, by reading the k index t of an 8-key chunk as key 2t
// and t + 4 as key 2t + 1, and loading V's B fragment in the same order.
// With two m-tiles a warp (hd <= 64), each K and V fragment, loaded and
// split once, feeds two products.
//
// K and V tiles of 32 keys arrive by cp.async into two buffers in dynamic
// shared memory: the next tile loads while this one is computed (one
// block barrier a tile). Rows past Sq or Skv are zero-filled by the copy,
// so no padding exists in device memory. Row strides are padded by 16
// bytes, which keeps every fragment load free of bank conflicts. Shared
// memory per block, float32: (64 * MT + 4 * 32) rows of (hd + 4) * 4 bytes
// — 70 KB at hd 64 (MT 2, three blocks an SM), 101 KB at hd 128 (MT 1,
// two); bfloat16 tiles take half (their values are exact in TF32, so
// their small parts are zero). The tile shapes were chosen by timing 64-
// and 128-row blocks with 32- and 64-key tiles at both serve shapes.
// Tiles that every row of the block masks out (beyond the causal
// diagonal, or older than the window) are skipped; when a row has no
// visible key at all (causal, Sq > Skv) nothing is skipped, so such a row
// averages v over all Skv keys as the reference's plain version does.
// Query tiles run longest first (the causal diagonal's last tiles). No
// atomics: the result does not depend on scheduling.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNeg = -2.0e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 128;  // 4 warps

// m-tiles of 16 rows a warp owns, and blocks an SM is built for
template <int HD>
struct Shape {
  static constexpr int MT = HD <= 64 ? 2 : 1;
  static constexpr int MINB = HD <= 64 ? 3 : 2;
};

// row stride of a Q, K or V tile in elements: 16 bytes of padding
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int HD>
constexpr int smem_bytes() {
  return (64 * Shape<HD>::MT + 4 * kBK) * row_stride<T, HD>() * sizeof(T);
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, Shape<HD>::MINB)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ lse, int sq, int skv, int h, int kvh,
          float scale, int causal, int window) {
  constexpr int MT = Shape<HD>::MT, BK = kBK;
  constexpr int BQ = 64 * MT, NT = BK / 8, DT = HD / 8;
  constexpr int kLd = row_stride<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * kLd;       // two K buffers
  T* vs = ks + 2 * BK * kLd;   // two V buffers

  const int head = blockIdx.x, b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;  // longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kvhead = head / (h / kvh);
  const int q0 = tile * BQ;
  const int off = skv - sq;

  const int q_lo = q0 + off;
  const int q_hi = min(q0 + BQ, sq) - 1 + off;
  int t_lo = 0, t_hi = (skv - 1) / BK;
  if (!(causal && q_lo < 0)) {
    if (causal) t_hi = min(t_hi, q_hi / BK);
    if (window > 0) {
      const int first = q_lo - window + 1;
      if (first > 0) t_lo = first / BK;
    }
  }

  const int64_t kv_stride = static_cast<int64_t>(kvh) * HD;
  const T* qb = q + (static_cast<int64_t>(b) * sq * h + head) * HD;
  const T* kb = k + static_cast<int64_t>(b) * skv * kv_stride + kvhead * HD;
  const T* vb = v + static_cast<int64_t>(b) * skv * kv_stride + kvhead * HD;
  load_tile<T, HD, BQ>(qs, qb, q0, sq, static_cast<int64_t>(h) * HD);
  load_tile<T, HD, BK>(ks, kb, t_lo * BK, skv, kv_stride);
  load_tile<T, HD, BK>(vs, vb, t_lo * BK, skv, kv_stride);
  cp_async_commit();

  const float sl = scale * kLog2e;
  const float neg = kNeg * kLog2e;
  float o[MT][DT][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = neg;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[mt][d][c] = 0.f;
  }
  const T* qw = qs + (16 * MT * warp + g) * kLd + t4;  // row g, dim t

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; tile t - 1 is no longer read
    if (t < t_hi) {
      load_tile<T, HD, BK>(ks + (buf ^ 1) * BK * kLd, kb, (t + 1) * BK, skv,
                           kv_stride);
      load_tile<T, HD, BK>(vs + (buf ^ 1) * BK * kLd, vb, (t + 1) * BK, skv,
                           kv_stride);
      cp_async_commit();
    }
    const T* kt = ks + buf * BK * kLd;
    const T* vt = vs + buf * BK * kLd;

    // S = Q K^T, each product as three TF32 mma
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mt][n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const T* qr = qw + 16 * mt * kLd + kk;
        split(ld1(qr), ab[mt][0], as[mt][0]);
        split(ld1(qr + 8 * kLd), ab[mt][1], as[mt][1]);
        split(ld1(qr + 4), ab[mt][2], as[mt][2]);
        split(ld1(qr + 8 * kLd + 4), ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        const T* kr = kt + (8 * n + g) * kLd + kk + t4;
        split(ld1(kr), bb0, bs0);
        split(ld1(kr + 4), bb1, bs1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_tf32(s[mt][n], as[mt][0], as[mt][1], as[mt][2], as[mt][3], bb0,
                   bb1);
          mma_tf32(s[mt][n], ab[mt][0], ab[mt][1], ab[mt][2], ab[mt][3], bs0,
                   bs1);
          mma_tf32(s[mt][n], ab[mt][0], ab[mt][1], ab[mt][2], ab[mt][3], bb0,
                   bb1);
        }
      }
    }

    // masks (on the tiles that need them), then the online softmax of
    // each row
    const int k0 = t * BK;
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > q_lo) ||
                      (window > 0 && k0 <= q_hi - window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8
        const int qpos = q0 + 16 * (MT * warp + mt) + g + 8 * hr + off;
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[mt][n][2 * hr + c];
            const int kpos = k0 + 8 * n + 2 * t4 + c;
            bool ok = true;
            if (causal) ok = kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            x = !edge ? x * sl
                      : (kpos >= skv ? -INFINITY : (ok ? x * sl : neg));
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][hr], mx);
        const float alpha = exp2f(m[mt][hr] - m_new);
        m[mt][hr] = m_new;
        l[mt][hr] *= alpha;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          o[mt][d][2 * hr] *= alpha;
          o[mt][d][2 * hr + 1] *= alpha;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[mt][n][2 * hr + c];
            x = exp2f(x - m_new);
            l[mt][hr] += x;
          }
      }

    // O += P V
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // P fragments of keys 8n..8n+7: k index t is key 2t, t + 4 key 2t + 1
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split(s[mt][n][0], ab[mt][0], as[mt][0]);
        split(s[mt][n][2], ab[mt][1], as[mt][1]);
        split(s[mt][n][1], ab[mt][2], as[mt][2]);
        split(s[mt][n][3], ab[mt][3], as[mt][3]);
      }
      const T* vr = vt + (8 * n + 2 * t4) * kLd + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t bb0, bs0, bb1, bs1;
        split(ld1(vr + 8 * d), bb0, bs0);
        split(ld1(vr + kLd + 8 * d), bb1, bs1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_tf32(o[mt][d], as[mt][0], as[mt][1], as[mt][2], as[mt][3], bb0,
                   bb1);
          mma_tf32(o[mt][d], ab[mt][0], ab[mt][1], ab[mt][2], ab[mt][3], bs0,
                   bs1);
          mma_tf32(o[mt][d], ab[mt][0], ab[mt][1], ab[mt][2], ab[mt][3], bb0,
                   bb1);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float sum = l[mt][hr];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = q0 + 16 * (MT * warp + mt) + g + 8 * hr;
      if (row < sq) {
        // the row's log-sum-exp in natural units, for the backward
        if (lse != nullptr && t4 == 0)
          lse[(static_cast<int64_t>(b) * h + head) * sq + row] =
              (m[mt][hr] + log2f(sum)) * kLn2;
        const float inv = 1.f / fmaxf(sum, 1e-30f);
        T* op = out + ((static_cast<int64_t>(b) * sq + row) * h + head) * HD;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          store(op + 8 * d + 2 * t4, o[mt][d][2 * hr] * inv);
          store(op + 8 * d + 2 * t4 + 1, o[mt][d][2 * hr + 1] * inv);
        }
      }
    }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              float* lse, int b, int sq, int skv, int h, int kvh,
              float scale, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, HD>();
  constexpr int rows = 64 * Shape<HD>::MT;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, b, (sq + rows - 1) / rows);
  flash_fwd<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, skv, h, kvh,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 float* lse, int b, int sq, int skv, int h, int kvh, int hd,
                 float scale, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, out, lse, b, sq, skv, h, kvh, scale,
                              causal, window, stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, out, lse, b, sq, skv, h, kvh, scale,
                              causal, window, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, out, lse, b, sq, skv, h, kvh, scale,
                              causal, window, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, lse, b, sq, skv, h, kvh, scale,
                               causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Backward: FlashAttention-2's on the tensor cores, two launches and a
// fixed-order sum
// ---------------------------------------------------------------------------
//
// The gradient of the function above, the counterpart of XLA's derivative
// of the reference's training attention (src/repro/models/attention.py:
// grouped_attention / chunked_attention); the reference has no Pallas
// backward. With P = exp(S * scale - lse) recomputed from the forward's
// row log-sum-exp, dP = dO V^T and Delta = rowsum(dO * O):
// dS = P * (dP - Delta) on visible (query, key) pairs and 0 on masked
// ones (the reference's -2e9 is a constant, so no gradient reaches q or
// k through a masked logit); dQ = dS K * scale, dK = dS^T Q * scale,
// dV = P^T dO. A row whose keys are all masked (causal, Sq > Skv: query
// position < 0) is the uniform average of v over all Skv keys in the
// forward, so it gives each key's dV dO / Skv and no dS.
//
// Bound on this card: operations. Five products of the forward's size
// (S, dP, dV, dQ, dK: 2 * hd operations each per visible pair), 8.598e10
// at llama3.2-1b's training shape (B=8, S=1024, H=32, KV=8, hd=64,
// causal): 0.5211 ms as 3xTF32 at 495/3 TFLOP/s, the card's fastest rate
// for float32 products at the 1e-4 the gradients are held to (TF32 alone
// keeps about three decimal digits). Both launches recompute S and dP, so
// seven products run: 0.7295 ms is this design's floor. The bytes take
// ~0.1 ms. Every product runs as the forward's does: each float32
// operand split into a TF32 big part and a small rest, three m16n8k8
// TF32 mma.sync a product, float32 accumulation.
//
// dq launch (flash_bwd_dq): a block of 4 warps per (batch, head, 64 * MT
// query rows), warp w owning MT m-tiles of 16 rows as in the forward. Its
// prologue writes Delta of its rows to a (B, H, Sq) float32 scratch. Q and
// dO land once; K and V tiles of BK keys arrive by cp.async into two
// buffers, the next loading while this one is computed. S = Q K^T and
// dP = dO V^T go to accumulator fragments, dS is formed there, and dS's
// accumulator fragment is dS K's A fragment directly (the k index t read
// as key 2t, t + 4 as key 2t + 1, K's B fragment loaded in the same
// order, as the forward turns S into P V's A fragment): dS never leaves
// registers. dkdv launch (flash_bwd_dkdv): a block of NW warps per
// (batch, KV head, part of the group, 16 * NW keys), warp w owning 16
// keys. K and V land once; Q, dO, lse and Delta tiles of BM query rows
// stream through two buffers across the part's query heads. S^T = K Q^T
// and dP^T = V dO^T have the keys as rows, so P^T and dS^T become the A
// fragments of P^T dO and dS^T Q in registers, and the warp's dK and dV
// (HD floats a thread) sum in registers over every head of the part.
// The tensor cores add inside an mma with truncation, so a sum carried in
// one accumulator through thousands of mma drifts, the more the longer
// the sum: 4.2e-5 of dK's largest magnitude at llama3.2-1b's training
// shape (4 heads of 1024 queries), half that with the group split in
// two. Each query tile's products therefore go into a zeroed fragment
// (a chain of 3 * BM / 8 mma), which a float32 add, rounded to nearest,
// puts into the totals: 2.6e-6 at the training shape, 3.3e-6 over 8
// heads of 4096 queries. dQ's sums over keys, whose dS rows sum to zero,
// stay within 4e-6 at 4096 keys and are carried as they are.
//
// Splitting the group: when kvh * B * ceil(Skv / (16 NW)) blocks cannot
// fill the card (ops.backward_plan decides), the g query heads of each KV
// head are cut into s contiguous parts of g / s heads, a block each. A
// part writes its float32 dK and dV partials to a (2, s, B, Skv, KV, hd)
// scratch, and flash_bwd_group_sum adds them in part order 0..s-1,
// scales dK and casts both. With s = 1 dkdv writes dK and dV itself. No atomics anywhere:
// every sum runs in an order the code fixes, so the same inputs and s give
// the same bits run to run. (A single fused pass would add dQ from every
// key block with atomics, whose order changes from run to run.)
//
// Tiles and layouts, chosen by timing on the card at both training
// shapes of PERF.md (head dims 64 and 128): dq takes 2 m-tiles a warp and
// 32-key tiles at head dim <= 64 (two blocks an SM, 105 KB each in
// float32), 1 m-tile and 16-key tiles at 128 (two blocks, 102 KB); one
// m-tile a warp, or 32-key tiles at 128 (one block an SM), were slower.
// dkdv takes 32-row query tiles and NW = 4 warps (64 keys a block) at
// head dim <= 64, NW = 8 (128 keys, 203 KB, one block an SM) at 128; the
// other layout at each (8 warps at 64; 4 warps with 16-row tiles at 128)
// was slower (PERF.md, row 7b), and ops.BWD_WARPS mirrors this choice.
//
// Masks are computed only on tiles that cut the causal diagonal, the
// window's edge, Sq or Skv; a warp skips a tile in which none of its
// pairs is visible (and, in dkdv, no row is without keys). Query tiles
// run longest first in dq, early keys (most queries) first in dkdv.
// bfloat16 tiles are converted when a fragment is loaded: their values
// are exact in TF32, so a bfloat16 call runs the same arithmetic and
// rounds its gradients once, at the store.

// the dq launch: m-tiles of 16 rows a warp and keys a tile
template <int HD>
struct DqShape {
  static constexpr int MT = HD <= 64 ? 2 : 1;
  static constexpr int BK = HD <= 64 ? 32 : 16;
};

template <typename T, int HD>
constexpr int dq_smem_bytes() {
  return (2 * 64 * DqShape<HD>::MT + 4 * DqShape<HD>::BK) *
         row_stride<T, HD>() * sizeof(T);
}

// the dkdv launch: warps of 16 keys a block and query rows a tile
template <int HD>
struct DkdvShape {
  static constexpr int NW = HD == 128 ? 8 : 4;
  static constexpr int BN = 16 * NW;
  static constexpr int BM = 32;
};

template <typename T, int HD>
constexpr int dkdv_smem_bytes() {
  using S = DkdvShape<HD>;
  return (2 * S::BN + 4 * S::BM) * row_stride<T, HD>() * sizeof(T) +
         4 * S::BM * sizeof(float);
}

constexpr int kSumThreads = 256;

// 4 bytes from global to shared memory, asynchronously; zero-filled when
// !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

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

// d += a * b as 3xTF32: small * big, big * small, big * big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bs0, uint32_t bb1,
                                     uint32_t bs1) {
  mma_tf32(d, as[0], as[1], as[2], as[3], bb0, bb1);
  mma_tf32(d, ab[0], ab[1], ab[2], ab[3], bs0, bs1);
  mma_tf32(d, ab[0], ab[1], ab[2], ab[3], bb0, bb1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ out,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, T* __restrict__ dq, int sq, int skv,
             int h, int kvh, float scale, int causal, int window) {
  constexpr int MT = DqShape<HD>::MT, BK = DqShape<HD>::BK;
  constexpr int BQ = 64 * MT, NT = BK / 8, DT = HD / 8;
  constexpr int kLd = row_stride<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + BQ * kLd;
  T* ks = dos + BQ * kLd;     // two K buffers
  T* vs = ks + 2 * BK * kLd;  // two V buffers
  __shared__ float dlt[BQ];

  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kvhead = head / (h / kvh);
  const int off = skv - sq;
  const int64_t qstride = static_cast<int64_t>(h) * HD;
  const int64_t kvstride = static_cast<int64_t>(kvh) * HD;
  const int64_t qoff = (static_cast<int64_t>(b) * sq * h + head) * HD;
  const int64_t koff = static_cast<int64_t>(b) * skv * kvstride + kvhead * HD;
  const int64_t roff = (static_cast<int64_t>(b) * h + head) * sq;

  // key tiles the masks leave live (none when every row has no key)
  const int q_lo = q0 + off, q_hi = min(q0 + BQ, sq) - 1 + off;
  int t_lo = 0, t_hi = (skv - 1) / BK;
  if (causal) t_hi = q_hi < 0 ? -1 : min(t_hi, q_hi / BK);
  if (window > 0) {
    const int first = q_lo - window + 1;
    if (first > 0) t_lo = first / BK;
  }

  load_tile<T, HD, BQ>(qs, q + qoff, q0, sq, qstride);
  load_tile<T, HD, BQ>(dos, dout + qoff, q0, sq, qstride);
  if (t_lo <= t_hi) {
    load_tile<T, HD, BK>(ks, k + koff, t_lo * BK, skv, kvstride);
    load_tile<T, HD, BK>(vs, v + koff, t_lo * BK, skv, kvstride);
  }
  cp_async_commit();

  // Delta = rowsum(dO * O), four threads a row
  for (int r = threadIdx.x / 4; r < BQ; r += kThreads / 4) {
    const int part = threadIdx.x % 4;
    float s = 0.f;
    if (q0 + r < sq) {
      const T* orow = out + qoff + (q0 + r) * qstride;
      const T* drow = dout + qoff + (q0 + r) * qstride;
      for (int c = part; c < HD; c += 4) s += ld1(orow + c) * ld1(drow + c);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) {
      dlt[r] = s;
      if (q0 + r < sq) delta[roff + q0 + r] = s;
    }
  }
  __syncthreads();

  // this thread's rows g and g + 8 of each m-tile: lse (base 2), Delta
  const float sl = scale * kLog2e;
  float l2[MT][2], dl[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * (MT * warp + mt) + g + 8 * hr;
      l2[mt][hr] = q0 + r < sq ? lse[roff + q0 + r] * kLog2e : 0.f;
      dl[mt][hr] = dlt[r];
    }

  float acc[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][d][c] = 0.f;
  const T* qw = qs + (16 * MT * warp + g) * kLd + t4;  // row g, dim t
  const T* dw = dos + (16 * MT * warp + g) * kLd + t4;
  const int w_lo = q0 + 16 * MT * warp + off;  // the warp's query positions
  const int w_hi = w_lo + 16 * MT - 1;
  const bool w_in = q0 + 16 * MT * warp < sq;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; tile t - 1 is no longer read
    if (t < t_hi) {
      load_tile<T, HD, BK>(ks + (buf ^ 1) * BK * kLd, k + koff, (t + 1) * BK,
                           skv, kvstride);
      load_tile<T, HD, BK>(vs + (buf ^ 1) * BK * kLd, v + koff, (t + 1) * BK,
                           skv, kvstride);
      cp_async_commit();
    }
    const int k0 = t * BK;
    // a warp none of whose pairs in this tile is visible skips it
    if (!w_in || (causal && k0 > w_hi) ||
        (window > 0 && k0 + BK - 1 <= w_lo - window))
      continue;
    const T* kt = ks + buf * BK * kLd;
    const T* vt = vs + buf * BK * kLd;

    // S = Q K^T and dP = dO V^T
    float s[MT][NT][4], dp[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mt][n][c] = dp[mt][n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      uint32_t qb[MT][4], qsm[MT][4], ob[MT][4], osm[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        frag_a<T, kLd>(qw + 16 * mt * kLd + kk, qb[mt], qsm[mt]);
        frag_a<T, kLd>(dw + 16 * mt * kLd + kk, ob[mt], osm[mt]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        frag_b(kt + (8 * n + g) * kLd + kk + t4, 4, bb0, bs0, bb1, bs1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3(s[mt][n], qb[mt], qsm[mt], bb0, bs0, bb1, bs1);
        frag_b(vt + (8 * n + g) * kLd + kk + t4, 4, bb0, bs0, bb1, bs1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3(dp[mt][n], ob[mt], osm[mt], bb0, bs0, bb1, bs1);
      }
    }

    // dS = P * (dP - Delta) into dp, masks on the tiles that need them
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > w_lo) ||
                      (window > 0 && k0 <= w_hi - window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qpos = w_lo + 16 * mt + g + 8 * hr;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = k0 + 8 * n + 2 * t4 + c;
            bool ok = true;
            if (edge) {
              ok = kpos < skv;
              if (causal) ok = ok && kpos <= qpos;
              if (window > 0) ok = ok && kpos > qpos - window;
            }
            const float p = exp2f(s[mt][n][2 * hr + c] * sl - l2[mt][hr]);
            float& y = dp[mt][n][2 * hr + c];
            y = ok ? p * (y - dl[mt][hr]) : 0.f;
          }
      }

    // dQ += dS K
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) frag_acc(dp[mt][n], ab[mt], as[mt]);
      const T* kr = kt + (8 * n + 2 * t4) * kLd + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t bb0, bs0, bb1, bs1;
        frag_b(kr + 8 * d, kLd, bb0, bs0, bb1, bs1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3(acc[mt][d], ab[mt], as[mt], bb0, bs0, bb1, bs1);
      }
    }
  }
  cp_async_wait_all();  // nothing in flight when the block ends

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = q0 + 16 * (MT * warp + mt) + g + 8 * hr;
      if (row < sq) {
        T* dst = dq + qoff + row * qstride + 2 * t4;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          store2(dst + 8 * d, acc[mt][d][2 * hr] * scale,
                 acc[mt][d][2 * hr + 1] * scale);
      }
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * DkdvShape<HD>::NW,
                                  DkdvShape<HD>::NW == 4 ? 2 : 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, float* __restrict__ part, int sq, int skv,
               int h, int kvh, int split, float scale, int causal,
               int window) {
  constexpr int BN = DkdvShape<HD>::BN, BM = DkdvShape<HD>::BM;
  constexpr int NT = BM / 8, DT = HD / 8, THR = 32 * DkdvShape<HD>::NW;
  constexpr int kLd = row_stride<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BN * kLd;
  T* qs = vs + BN * kLd;         // two Q buffers
  T* dos = qs + 2 * BM * kLd;    // two dO buffers
  float* ls = reinterpret_cast<float*>(dos + 2 * BM * kLd);  // two lse
  float* dls = ls + 2 * BM;                                  // two Delta

  const int kvhead = blockIdx.x / split, prt = blockIdx.x % split;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BN;  // early keys (most queries) first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int grp = h / kvh, off = skv - sq;
  // this part's query heads: [h0, h0 + nh); split divides the group
  const int nh = grp / split, h0 = kvhead * grp + prt * nh;
  const int64_t qstride = static_cast<int64_t>(h) * HD;
  const int64_t kvstride = static_cast<int64_t>(kvh) * HD;
  const int64_t koff = static_cast<int64_t>(b) * skv * kvstride + kvhead * HD;

  // query tiles these keys are visible to; with causal masking and
  // Sq > Skv the rows with no key (the first Sq - Skv) are walked too
  const int k_hi = min(k0 + BN, skv) - 1;
  int i_lo = 0, i_hi = sq - 1;
  if (causal && off >= 0) i_lo = max(0, k0 - off);
  if (window > 0) i_hi = min(i_hi, k_hi + window - 1 - off);
  const int ti_lo = i_lo / BM;
  const int nt = i_lo <= i_hi ? i_hi / BM - ti_lo + 1 : 0;
  const int total = nh * nt;  // (head, query tile) steps, head-major

  // Q, dO, lse and Delta of step `idx` into buffer `buf`
  auto prefetch = [&](int idx, int buf) {
    const int head = h0 + idx / nt, i0 = (ti_lo + idx % nt) * BM;
    const int64_t qoff = (static_cast<int64_t>(b) * sq * h + head) * HD;
    const int64_t roff = (static_cast<int64_t>(b) * h + head) * sq;
    load_tile<T, HD, BM, THR>(qs + buf * BM * kLd, q + qoff, i0, sq, qstride);
    load_tile<T, HD, BM, THR>(dos + buf * BM * kLd, dout + qoff, i0, sq,
                              qstride);
    for (int r = threadIdx.x; r < BM; r += THR) {
      const bool in = i0 + r < sq;
      const int64_t at = roff + (in ? i0 + r : 0);
      cp_async4(ls + buf * BM + r, lse + at, in);
      cp_async4(dls + buf * BM + r, delta + at, in);
    }
  };

  load_tile<T, HD, BN, THR>(ks, k + koff, k0, skv, kvstride);
  load_tile<T, HD, BN, THR>(vs, v + koff, k0, skv, kvstride);
  if (total > 0) prefetch(0, 0);
  cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[d][c] = dva[d][c] = 0.f;
  const int kw0 = k0 + 16 * warp;  // the warp's first key
  const bool w_in = kw0 < skv;
  const T* kw = ks + (16 * warp + g) * kLd + t4;  // key g, dim t
  const T* vw = vs + (16 * warp + g) * kLd + t4;
  const float sl = scale * kLog2e;
  const float uniform = 1.f / static_cast<float>(skv);

  for (int idx = 0; idx < total; ++idx) {
    const int buf = idx & 1;
    cp_async_wait_all();
    __syncthreads();  // step idx has landed; step idx - 1 is no longer read
    if (idx + 1 < total) {
      prefetch(idx + 1, buf ^ 1);
      cp_async_commit();
    }
    const int i0 = (ti_lo + idx % nt) * BM;
    const int p_lo = i0 + off, p_hi = i0 + BM - 1 + off;  // query positions
    // a warp skips a tile where none of its pairs is visible and no row
    // is without keys
    const bool dead = causal && p_lo < 0;
    if (!w_in || (!dead && ((causal && kw0 > p_hi) ||
                            (window > 0 && kw0 + 15 <= p_lo - window))))
      continue;
    const T* qt = qs + buf * BM * kLd;
    const T* dt = dos + buf * BM * kLd;
    const float* lt = ls + buf * BM;
    const float* dlt = dls + buf * BM;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys by BM queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      uint32_t kb[4], ksm[4], vb[4], vsm[4];
      frag_a<T, kLd>(kw + kk, kb, ksm);
      frag_a<T, kLd>(vw + kk, vb, vsm);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        frag_b(qt + (8 * n + g) * kLd + kk + t4, 4, bb0, bs0, bb1, bs1);
        mma3(s[n], kb, ksm, bb0, bs0, bb1, bs1);
        frag_b(dt + (8 * n + g) * kLd + kk + t4, 4, bb0, bs0, bb1, bs1);
        mma3(dp[n], vb, vsm, bb0, bs0, bb1, bs1);
      }
    }

    // P^T into s and dS^T into dp, masks on the tiles that need them
    const bool edge = i0 + BM > sq || kw0 + 16 > skv ||
                      (causal && kw0 + 15 > p_lo) ||
                      (window > 0 && kw0 <= p_hi - window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 lv = *reinterpret_cast<const float2*>(lt + 8 * n + 2 * t4);
      const float2 dv2 =
          *reinterpret_cast<const float2*>(dlt + 8 * n + 2 * t4);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cc = c & 1;  // query 8n + 2t + cc, key g + 8 (c / 2)
        const float l2 = (cc ? lv.y : lv.x) * kLog2e;
        const float dd = cc ? dv2.y : dv2.x;
        const float p = exp2f(s[n][c] * sl - l2);
        if (!edge) {
          s[n][c] = p;
          dp[n][c] = p * (dp[n][c] - dd);
        } else {
          const int kpos = kw0 + g + 8 * (c >> 1);
          const int qi = i0 + 8 * n + 2 * t4 + cc, qpos = qi + off;
          const bool in = qi < sq && kpos < skv;
          bool ok = in;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          // a row with no key averages v over all keys
          s[n][c] = ok ? p : (in && causal && qpos < 0 ? uniform : 0.f);
          dp[n][c] = ok ? p * (dp[n][c] - dd) : 0.f;
        }
      }
    }

    // dV += P^T dO, dK += dS^T Q: the tile's BM queries summed into a
    // zeroed fragment, then added to the totals with a float32 add
    uint32_t pb[NT][4], psm[NT][4], db[NT][4], dsm[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      frag_acc(s[n], pb[n], psm[n]);
      frag_acc(dp[n], db[n], dsm[n]);
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      float tv[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        const int at = (8 * n + 2 * t4) * kLd + g + 8 * d;
        frag_b(dt + at, kLd, bb0, bs0, bb1, bs1);
        mma3(tv, pb[n], psm[n], bb0, bs0, bb1, bs1);
        frag_b(qt + at, kLd, bb0, bs0, bb1, bs1);
        mma3(tk, db[n], dsm[n], bb0, bs0, bb1, bs1);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dva[d][c] += tv[c];
        dka[d][c] += tk[c];
      }
    }
  }
  cp_async_wait_all();  // nothing in flight when the block ends

  const int64_t n_all = static_cast<int64_t>(gridDim.y) * skv * kvstride;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = kw0 + g + 8 * hr;
    if (key >= skv) continue;
    const int64_t at = koff + key * kvstride + 2 * t4;
    if (split == 1) {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        store2(dk + at + 8 * d, dka[d][2 * hr] * scale,
               dka[d][2 * hr + 1] * scale);
        store2(dv + at + 8 * d, dva[d][2 * hr], dva[d][2 * hr + 1]);
      }
    } else {  // this part's float32 partials, dK unscaled
      float* pk = part + prt * n_all + at;
      float* pv = part + (split + prt) * n_all + at;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        store2(pk + 8 * d, dka[d][2 * hr], dka[d][2 * hr + 1]);
        store2(pv + 8 * d, dva[d][2 * hr], dva[d][2 * hr + 1]);
      }
    }
  }
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  store2(p, x.x, x.y);
  store2(p + 2, x.z, x.w);
}

// dK and dV from `part`, (2, split, n) float32 (dK's partials, then
// dV's): four elements a thread, summed over the parts in order 0..split-1;
// dK times scale; both cast to T
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
flash_bwd_group_sum(const float* __restrict__ part, T* __restrict__ dk,
                    T* __restrict__ dv, int64_t n, int split, float scale) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const bool is_k = i < n;
  const int64_t j = is_k ? i : i - n;
  const float* src = part + (is_k ? 0 : split * n) + j;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int p = 1; p < split; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(src + p * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  if (is_k) {
    acc.x *= scale;
    acc.y *= scale;
    acc.z *= scale;
    acc.w *= scale;
    store4(dk + j, acc);
  } else {
    store4(dv + j, acc);
  }
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>, HD) for the dtype and head dim the kernels are built for
template <typename F>
int dispatch(int dtype, int hd, F&& f) {
  auto at_hd = [&](auto tag) {
    switch (hd) {
      case 16: return f(tag, std::integral_constant<int, 16>());
      case 32: return f(tag, std::integral_constant<int, 32>());
      case 64: return f(tag, std::integral_constant<int, 64>());
      case 128: return f(tag, std::integral_constant<int, 128>());
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (dtype == 0) return at_hd(Tag<float>());
  if (dtype == 1) return at_hd(Tag<__nv_bfloat16>());
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int HD>
int dkdv_hd(const T* q, const T* k, const T* v, const T* dout,
            const float* lse, const float* delta, T* dk, T* dv, float* part,
            int b, int sq, int skv, int h, int kvh, int split, float scale,
            int causal, int window, cudaStream_t stream) {
  constexpr int bytes = dkdv_smem_bytes<T, HD>();
  using S = DkdvShape<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<T, HD><<<dim3(kvh * split, b, (skv + S::BN - 1) / S::BN),
                          32 * S::NW, bytes, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, part, sq, skv, h, kvh, split,
          scale, causal, window);
  return static_cast<int>(cudaGetLastError());
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

template <typename T, int HD>
int bwd_hd(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, float* part, int b, int sq, int skv, int h,
           int kvh, float scale, int causal, int window, int split,
           cudaStream_t stream) {
  constexpr int dq_bytes = dq_smem_bytes<T, HD>();
  constexpr int rows = 64 * DqShape<HD>::MT;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  flash_bwd_dq<T, HD><<<dim3(h, b, (sq + rows - 1) / rows), kThreads,
                        dq_bytes, stream>>>(
      qt, kt, vt, static_cast<const T*>(out), dot, lse, delta,
      static_cast<T*>(dq), sq, skv, h, kvh, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // reads the Delta the dq launch wrote: same stream, so in order
  const int got = dkdv_hd<T, HD>(qt, kt, vt, dot, lse, delta, dkt, dvt, part,
                                 b, sq, skv, h, kvh, split, scale, causal,
                                 window, stream);
  if (got != 0 || split == 1) return got;
  const int64_t n = static_cast<int64_t>(b) * skv * kvh * HD;
  const int64_t threads = 2 * n / 4;
  flash_bwd_group_sum<T>
      <<<static_cast<unsigned>((threads + kSumThreads - 1) / kSumThreads),
         kSumThreads, 0, stream>>>(part, dkt, dvt, n, split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int bwd_info(int which, int* info) {
  if (which == 0)
    return kernel_info(flash_bwd_dq<T, HD>, kThreads, dq_smem_bytes<T, HD>(),
                       info);
  if (which == 1)
    return kernel_info(flash_bwd_dkdv<T, HD>, 32 * DkdvShape<HD>::NW,
                       dkdv_smem_bytes<T, HD>(), info);
  if (which == 2)
    return kernel_info(flash_bwd_group_sum<T>, kSumThreads, 0, info);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int smem_typed(int hd) {
  switch (hd) {
    case 16: return smem_bytes<T, 16>();
    case 32: return smem_bytes<T, 32>();
    case 64: return smem_bytes<T, 64>();
    case 128: return smem_bytes<T, 128>();
    default: return -1;
  }
}

}  // namespace

// Dynamic shared memory of one block in bytes (-1: no such build).
extern "C" int flash_attention_smem_bytes(int hd, int dtype) {
  return dtype == 0 ? smem_typed<float>(hd) : smem_typed<__nv_bfloat16>(hd);
}

// Launches on `stream`; returns the first CUDA error (0 = launched).
// `dtype`: 0 float32, 1 bfloat16 (q, k, v and out alike). All four
// tensors are contiguous and 16-byte aligned; `hd` is 16, 32, 64 or 128;
// b <= 65535 and Sq <= 64 * 65535. `lse`, when not null, is a float32
// (B, H, Sq) tensor that receives each row's log-sum-exp of its scaled,
// masked logits (natural units), which the backward reads.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int b, int sq, int skv, int h, int kvh,
                                      int hd, float scale, int causal,
                                      int window, int dtype,
                                      cudaStream_t stream) {
  if (dtype == 0)
    return launch_typed<float>(q, k, v, out, lse, b, sq, skv, h, kvh, hd,
                               scale, causal, window, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, out, lse, b, sq, skv, h, kvh,
                                       hd, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of flash_attention_launch's function on `stream`: the dq
// launch, the dkdv launch with each group of H / KV query heads cut into
// `split` parts of as many heads (split divides H / KV), and, when
// split > 1, the group sum; returns the first CUDA error. q, k, v, out and
// dout as the forward takes them (`out` the forward's output, `dout` its
// gradient), `lse` the forward's (B, H, Sq) float32 output, `delta` a
// (B, H, Sq) float32 scratch the first launch writes and the second
// reads, `part` a (2, split, B, Skv, KV, hd) float32 scratch (null when
// split = 1); dq, dk and dv are written in the inputs' type, each
// contiguous and shaped as its input. No atomics: the same inputs and
// split give the same bits.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* part, int b, int sq, int skv, int h, int kvh, int hd,
    float scale, int causal, int window, int split, int dtype,
    cudaStream_t stream) {
  if (split < 1 || (h / kvh) % split != 0 || (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, hd, [&](auto tag, auto hdc) {
    using T = typename decltype(tag)::type;
    return bwd_hd<T, decltype(hdc)::value>(
        q, k, v, out, dout, lse, delta, dq, dk, dv, part, b, sq, skv, h, kvh,
        scale, causal, window, split, stream);
  });
}

// Registers a thread, shared memory a block in bytes (static and dynamic)
// and resident blocks an SM of one backward launch, into info[0..2]:
// `which` 0 is flash_bwd_dq, 1 flash_bwd_dkdv, 2 flash_bwd_group_sum.
// Returns a CUDA error (0 = none).
extern "C" int flash_attention_backward_info(int hd, int dtype, int which,
                                             int* info) {
  return dispatch(dtype, hd, [&](auto tag, auto hdc) {
    using T = typename decltype(tag)::type;
    return bwd_info<T, decltype(hdc)::value>(which, info);
  });
}
