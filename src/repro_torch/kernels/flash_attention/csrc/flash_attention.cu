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
//
// Bound on this card: operations. At the serve path's prefill shape
// (B=8, S=1024, H=32, hd=64, causal) it does about 3.4e10 floating-point
// operations against 0.05 ms of bytes, 0.51 ms at the 67 TFLOP/s of the
// float32 units (no tensor cores in this first version).
//
// Design: one block of 128 threads per (batch, head, tile of 128 query
// rows); each thread owns one query row, holding q (pre-scaled) and its
// output accumulator in registers. Key and value tiles of 64 rows are
// staged in shared memory as float32 and read as 16-byte broadcasts (every
// thread of a warp reads the same key), one load per four fused
// multiply-adds. Scores are taken 16 keys at a time, so the rescaling of
// the accumulator costs one multiply per 16 keys and dimension. Tiles that
// every row of the block masks out (beyond the causal diagonal, or older
// than the window) are skipped; when a row has no visible key at all
// (causal, Sq > Skv) nothing is skipped, so such a row averages v over all
// Skv keys as the reference's plain version does. No atomics: the result
// does not depend on scheduling.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;   // query rows per block, one per thread
constexpr int kKeys = 64;    // keys per shared-memory tile
constexpr int kChunk = 16;   // keys scored at once by a thread
constexpr float kNeg = -2.0e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kRows)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
          int h, int kvh, float scale, int causal, int window) {
  __shared__ __align__(16) float ks[kKeys][HD];
  __shared__ __align__(16) float vs[kKeys][HD];
  const int tile = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int kvhead = head / (h / kvh);
  const int row = tile * kRows + threadIdx.x;
  const int off = skv - sq;
  const int qpos = row + off;
  const bool live = row < sq;

  float qr[HD], acc[HD];
  {
    const T* qp = q + ((static_cast<int64_t>(b) * sq + (live ? row : 0)) * h
                       + head) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[d] = live ? to_f32(qp[d]) * scale : 0.f;
      acc[d] = 0.f;
    }
  }
  float m = kNeg, l = 0.f;

  // key tiles this block must visit
  const int q_lo = tile * kRows + off;
  const int q_hi = min(tile * kRows + kRows, sq) - 1 + off;
  int t_lo = 0, t_hi = (skv - 1) / kKeys;
  if (!(causal && q_lo < 0)) {  // every row sees some key: skip dead tiles
    if (causal) t_hi = min(t_hi, q_hi / kKeys);
    if (window > 0) {
      const int first = q_lo - window + 1;  // oldest key any row sees
      if (first > 0) t_lo = first / kKeys;
    }
  }

  const int64_t kv_row = static_cast<int64_t>(kvh) * HD;
  const T* kb = k + static_cast<int64_t>(b) * skv * kv_row + kvhead * HD;
  const T* vb = v + static_cast<int64_t>(b) * skv * kv_row + kvhead * HD;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kKeys * HD; e += kRows) {
      const int j = e / HD, d = e % HD;
      const bool in = k0 + j < skv;
      const int64_t at = (k0 + j) * kv_row + d;
      ks[j][d] = in ? to_f32(kb[at]) : 0.f;
      vs[j][d] = in ? to_f32(vb[at]) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kKeys; c += kChunk) {
      float s[kChunk];
      float mx = kNeg;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks[c + jj]);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 kk = kr[d4];
          a0 = fmaf(qr[4 * d4], kk.x, a0);
          a1 = fmaf(qr[4 * d4 + 1], kk.y, a1);
          a2 = fmaf(qr[4 * d4 + 2], kk.z, a2);
          a3 = fmaf(qr[4 * d4 + 3], kk.w, a3);
        }
        const int kpos = k0 + c + jj;
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        // keys past Skv are not keys: weight 0 (exp(-inf) below)
        s[jj] = kpos >= skv ? -INFINITY : (ok ? (a0 + a1) + (a2 + a3) : kNeg);
        mx = fmaxf(mx, s[jj]);
      }
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs[c + jj]);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }
  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = out + ((static_cast<int64_t>(b) * sq + row) * h + head) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) store(op + d, acc[d] * inv);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int b, int sq, int skv, int h, int kvh, int hd, float scale,
                 int causal, int window, cudaStream_t stream) {
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 16:
      flash_fwd<T, 16><<<grid, kRows, 0, stream>>>(qt, kt, vt, ot, sq, skv,
                                                   h, kvh, scale, causal,
                                                   window);
      break;
    case 32:
      flash_fwd<T, 32><<<grid, kRows, 0, stream>>>(qt, kt, vt, ot, sq, skv,
                                                   h, kvh, scale, causal,
                                                   window);
      break;
    case 64:
      flash_fwd<T, 64><<<grid, kRows, 0, stream>>>(qt, kt, vt, ot, sq, skv,
                                                   h, kvh, scale, causal,
                                                   window);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched). `dtype`:
// 0 float32, 1 bfloat16 (q, k, v and out alike). All four tensors are
// contiguous; `hd` is 16, 32 or 64.
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
