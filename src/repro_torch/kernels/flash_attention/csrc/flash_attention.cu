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
// Head dims 16, 32, 64 and 128, with v's head dim equal to q's and k's;
// and for MLA (deepseek-v2) q/k head dim 192 with v head dim 128, and its
// reduced config's 24 and 16: S = Q K^T runs over the q/k head dim, O =
// P V over v's. These two pairs are built without the soft-cap, since the
// reference's MLA attention has none.
//
// Logit soft-capping (grok-1): with softcap c > 0 a logit x * scale
// becomes c * tanh(x * scale / c) before the mask, as the reference's
// models/attention.py caps and then masks (its Pallas kernel has no cap).
// The cap is a template flag, so the uncapped launches run the code they
// ran before. It uses the accurate tanhf (2 ulp), never tanh.approx.f32,
// whose 2^-11 relative error is ~1.5e-2 on a cap of 30, beyond the 2e-5
// the kernel is held to. The row log-sum-exp is that of the capped logits.
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
// K and V tiles of 32 keys (16 at MLA's q/k head dim of 192, below)
// arrive by cp.async into two buffers in dynamic shared memory: the next
// tile loads while this one is computed (one block barrier a tile). Rows
// past Sq or Skv are zero-filled by the copy, so no padding exists in
// device memory. Row strides are padded by 16 bytes, which keeps every
// fragment load free of bank conflicts. Shared memory per block,
// float32: (64 * MT + 4 * 32) rows of (hd + 4) * 4 bytes
// — 70 KB at hd 64 (MT 2, three blocks an SM), 101 KB at hd 128 (MT 1,
// two); bfloat16 tiles take half (their values are exact in TF32, so
// their small parts are zero). The tile shapes were chosen by timing 64-
// and 128-row blocks with 32- and 64-key tiles at both serve shapes.
// MLA's pair keeps the hd 128 layout (MT 1) with Q and K rows of 192 and
// V rows of 128, but key tiles of 16: (64 + 2 * 16) * 196 * 4 + 2 * 16 *
// 132 * 4 = 90 KB in float32, so two blocks share an SM (32-key tiles
// take 131 KB, one block; timed slower at deepseek-v2's prefill). Its
// bound is operations too: 2 * (192 + 128) a visible pair, 3.4e11 at
// deepseek-v2's prefill (B=8, S=1024, H=128, causal), 2.08 ms as
// 3xTF32; the bytes take 0.80.
// Tiles that every row of the block masks out (beyond the causal
// diagonal, or older than the window) are skipped; when a row has no
// visible key at all (causal, Sq > Skv) nothing is skipped, so such a row
// averages v over all Skv keys as the reference's plain version does.
// Query tiles run longest first (the causal diagonal's last tiles). No
// atomics: the result does not depend on scheduling.
#include "flash_attention.cuh"

namespace {

// m-tiles of 16 rows a warp owns, keys a tile and blocks an SM it is
// built for, by the q/k head dim (at 192, key tiles of 16 keep a float32
// block at 90 KB, so that two fit an SM)
template <int HD>
struct Shape {
  static constexpr int MT = HD <= 64 ? 2 : 1;
  static constexpr int BK = HD <= 128 ? 32 : 16;
  static constexpr int MINB = HD <= 64 ? 3 : 2;
};

// a Q tile and two K tiles of rows HDK wide, two V tiles of rows HDV wide
template <typename T, int HDK, int HDV>
constexpr int smem_bytes() {
  using S = Shape<HDK>;
  return ((64 * S::MT + 2 * S::BK) * row_stride<T, HDK>() +
          2 * S::BK * row_stride<T, HDV>()) *
         sizeof(T);
}

// HDK: the head dim of q and k; HDV: that of v and the output
template <typename T, int HDK, int HDV, bool CAP>
__global__ void __launch_bounds__(kThreads, Shape<HDK>::MINB)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ lse, int sq, int skv, int h, int kvh,
          float scale, int causal, int window, float softcap) {
  constexpr int MT = Shape<HDK>::MT, BK = Shape<HDK>::BK;
  constexpr int BQ = 64 * MT, NT = BK / 8, DT = HDV / 8;
  constexpr int kLd = row_stride<T, HDK>();  // Q and K rows
  constexpr int vLd = row_stride<T, HDV>();  // V rows
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

  const int64_t kv_stride = static_cast<int64_t>(kvh) * HDK;
  const int64_t v_stride = static_cast<int64_t>(kvh) * HDV;
  const T* qb = q + (static_cast<int64_t>(b) * sq * h + head) * HDK;
  const T* kb = k + static_cast<int64_t>(b) * skv * kv_stride + kvhead * HDK;
  const T* vb = v + static_cast<int64_t>(b) * skv * v_stride + kvhead * HDV;
  load_tile<T, HDK, BQ>(qs, qb, q0, sq, static_cast<int64_t>(h) * HDK);
  load_tile<T, HDK, BK>(ks, kb, t_lo * BK, skv, kv_stride);
  load_tile<T, HDV, BK>(vs, vb, t_lo * BK, skv, v_stride);
  cp_async_commit();

  const float sl = scale * kLog2e;
  const float cs = CAP ? scale / softcap : 0.f;
  const float cl = CAP ? softcap * kLog2e : 0.f;
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
      load_tile<T, HDK, BK>(ks + (buf ^ 1) * BK * kLd, kb, (t + 1) * BK, skv,
                            kv_stride);
      load_tile<T, HDV, BK>(vs + (buf ^ 1) * BK * vLd, vb, (t + 1) * BK, skv,
                            v_stride);
      cp_async_commit();
    }
    const T* kt = ks + buf * BK * kLd;
    const T* vt = vs + buf * BK * vLd;

    // S = Q K^T, each product as three TF32 mma
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mt][n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDK; kk += 8) {
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
            x = !edge ? logit2<CAP>(x, sl, cs, cl)
                      : (kpos >= skv ? -INFINITY
                                     : (ok ? logit2<CAP>(x, sl, cs, cl)
                                           : neg));
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
      const T* vr = vt + (8 * n + 2 * t4) * vLd + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t bb0, bs0, bb1, bs1;
        split(ld1(vr + 8 * d), bb0, bs0);
        split(ld1(vr + vLd + 8 * d), bb1, bs1);
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
        T* op = out + ((static_cast<int64_t>(b) * sq + row) * h + head) * HDV;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          store(op + 8 * d + 2 * t4, o[mt][d][2 * hr] * inv);
          store(op + 8 * d + 2 * t4 + 1, o[mt][d][2 * hr + 1] * inv);
        }
      }
    }
}

template <typename T, int HDK, int HDV, bool CAP>
int launch_cap(const void* q, const void* k, const void* v, void* out,
               float* lse, int b, int sq, int skv, int h, int kvh,
               float scale, int causal, int window, float softcap,
               cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, HDK, HDV>();
  constexpr int rows = 64 * Shape<HDK>::MT;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HDK, HDV, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, b, (sq + rows - 1) / rows);
  flash_fwd<T, HDK, HDV, CAP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, skv, h, kvh,
      scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HDK, int HDV>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              float* lse, int b, int sq, int skv, int h, int kvh,
              float scale, int causal, int window, float softcap,
              cudaStream_t stream) {
  if (softcap > 0.f) {
    if constexpr (HDK == HDV)
      return launch_cap<T, HDK, HDV, true>(q, k, v, out, lse, b, sq, skv, h,
                                           kvh, scale, causal, window,
                                           softcap, stream);
    else  // MLA's pairs are built without the cap
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_cap<T, HDK, HDV, false>(q, k, v, out, lse, b, sq, skv, h,
                                        kvh, scale, causal, window, 0.f,
                                        stream);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 float* lse, int b, int sq, int skv, int h, int kvh, int hd,
                 int hd_v, float scale, int causal, int window, float softcap,
                 cudaStream_t stream) {
  return forward_pair(hd, hd_v, [&](auto hdk, auto hdv) {
    return launch_hd<T, decltype(hdk)::value, decltype(hdv)::value>(
        q, k, v, out, lse, b, sq, skv, h, kvh, scale, causal, window,
        softcap, stream);
  });
}

}  // namespace

// Dynamic shared memory of one forward block in bytes at the head-dim
// pair (hd of q and k, hd_v of v) and type (-1: no such build).
extern "C" int flash_attention_smem_bytes(int hd, int hd_v, int dtype) {
  const int got = forward_pair(hd, hd_v, [&](auto hdk, auto hdv) {
    constexpr int K = decltype(hdk)::value, V = decltype(hdv)::value;
    return dtype == 0 ? smem_bytes<float, K, V>()
                      : smem_bytes<__nv_bfloat16, K, V>();
  });
  return got == static_cast<int>(cudaErrorInvalidValue) ? -1 : got;
}

// Launches on `stream`; returns the first CUDA error (0 = launched).
// `dtype`: 0 float32, 1 bfloat16 (q, k, v and out alike). All four
// tensors are contiguous and 16-byte aligned; (`hd`, `hd_v`), the head
// dims of q and k and of v and out, is (16, 16), (32, 32), (64, 64),
// (128, 128), (192, 128) or (24, 16), the last two only uncapped;
// b <= 65535 and Sq <= 64 * 65535. `lse`, when not null, is a float32
// (B, H, Sq) tensor that receives each row's log-sum-exp of its scaled,
// capped, masked logits (natural units), which the backward reads.
// `softcap` > 0 caps each scaled logit x at softcap * tanh(x / softcap)
// before the mask; 0 leaves it uncapped.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int b, int sq, int skv, int h, int kvh,
                                      int hd, int hd_v, float scale,
                                      int causal, int window, float softcap,
                                      int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch_typed<float>(q, k, v, out, lse, b, sq, skv, h, kvh, hd,
                               hd_v, scale, causal, window, softcap, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, out, lse, b, sq, skv, h, kvh,
                                       hd, hd_v, scale, causal, window,
                                       softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
