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

namespace {

constexpr float kNeg = -2.0e9f;
constexpr float kLog2e = 1.4426950408889634f;
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
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(T* tile, const T* base, int r0,
                                          int n, int64_t stride) {
  constexpr int kPer = 16 / sizeof(T);  // elements per copy
  constexpr int kCopies = HD / kPer;    // copies per row
  constexpr int kLd = row_stride<T, HD>();
  for (int e = threadIdx.x; e < ROWS * kCopies; e += kThreads) {
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
          const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
          int h, int kvh, float scale, int causal, int window) {
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
int launch_hd(const void* q, const void* k, const void* v, void* out, int b,
              int sq, int skv, int h, int kvh, float scale, int causal,
              int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, HD>();
  constexpr int rows = 64 * Shape<HD>::MT;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, b, (sq + rows - 1) / rows);
  flash_fwd<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, h, kvh, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int b, int sq, int skv, int h, int kvh, int hd, float scale,
                 int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, out, b, sq, skv, h, kvh, scale,
                              causal, window, stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, out, b, sq, skv, h, kvh, scale,
                              causal, window, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, out, b, sq, skv, h, kvh, scale,
                              causal, window, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, b, sq, skv, h, kvh, scale,
                               causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
// b <= 65535 and Sq <= 64 * 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int sq,
                                      int skv, int h, int kvh, int hd,
                                      float scale, int causal, int window,
                                      int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch_typed<float>(q, k, v, out, b, sq, skv, h, kvh, hd, scale,
                               causal, window, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, out, b, sq, skv, h, kvh, hd,
                                       scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
