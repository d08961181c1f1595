// Backward of flash_attention.cu's function, written by hand for Hopper
// (sm_90a): FlashAttention-2's on the tensor cores, two launches and a
// fixed-order sum. Built into the same library as the forward.
//
// The gradient of the forward's function, the counterpart of XLA's
// derivative of the reference's training attention
// (src/repro/models/attention.py: grouped_attention / chunked_attention);
// the reference has no Pallas backward. With P = exp(S * scale - lse)
// recomputed from the forward's row log-sum-exp, dP = dO V^T and
// Delta = rowsum(dO * O):
// dS = P * (dP - Delta) on visible (query, key) pairs and 0 on masked
// ones (the reference's -2e9 is a constant, so no gradient reaches q or
// k through a masked logit); dQ = dS K * scale, dK = dS^T Q * scale,
// dV = P^T dO. A row whose keys are all masked (causal, Sq > Skv: query
// position < 0) is the uniform average of v over all Skv keys in the
// forward, so it gives each key's dV dO / Skv and no dS.
//
// Soft-capped (grok-1): the logit is c * t, t = tanh(S * scale / c), so P
// is recomputed from it and dS takes the factor 1 - t^2. Both launches
// recompute t with the forward's logit2 arithmetic (the accurate tanhf of
// the same scaled value), so P meets the saved log-sum-exp as the forward
// formed it. The cap is the forward's template flag: the uncapped
// launches run the code they ran before. At MLA's head-dim pairs
// (deepseek-v2's (192, 128), its reduced config's (24, 16); uncapped, as
// in the forward) S, dQ and dK run over the q/k head dim HDK, dP, Delta
// and dV over v's HDV; the loops run to the longer of the two, each
// product guarded at compile time, so an equal pair compiles as before.
//
// Bound on this card: operations. Five products of the forward's size
// (S, dQ, dK: 2 * HDK operations each per visible pair; dP, dV: 2 * HDV),
// 8.598e10 at llama3.2-1b's training shape (B=8, S=1024, H=32, KV=8,
// hd=64, causal): 0.5211 ms as 3xTF32 at 495/3 TFLOP/s, the card's
// fastest rate for float32 products at the 1e-4 the gradients are held to
// (TF32 alone keeps about three decimal digits); 8.942e11 and 5.4195 ms at
// deepseek-v2's (B=8, S=1024, H=128, (192, 128)). Both launches recompute
// S and dP, so seven products run: 0.7295 ms is this design's floor at
// llama's shape. The bytes take ~0.1 ms. Every product runs as the
// forward's does: each float32 operand split into a TF32 big part and a
// small rest, three m16n8k8 TF32 mma.sync a product, float32
// accumulation. Capped, each launch adds a tanhf a visible pair on the
// float32 units.
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
// (HDK + HDV floats a thread) sum in registers over every head of the
// part. The tensor cores add inside an mma with truncation, so a sum
// carried in one accumulator through thousands of mma drifts, the more
// the longer the sum: 4.2e-5 of dK's largest magnitude at llama3.2-1b's
// training shape (4 heads of 1024 queries), half that with the group
// split in two. Each query tile's products therefore go into a zeroed
// fragment (a chain of 3 * BM / 8 mma), which a float32 add, rounded to
// nearest, puts into the totals: 2.6e-6 at the training shape, 3.3e-6
// over 8 heads of 4096 queries. dQ's sums over keys drift the same way:
// carried in one accumulator they sit up to 8.8 times as far from a
// float64 route as a float32 plain route's, so dS K is promoted every 8
// keys (mma3_add: three mma into a zeroed fragment, then a float32 add).
// The recomputed S and dP, sums over the head dim, are promoted every 8
// dims in both launches, as the forward's S is: carried whole in the dq
// launch they would put dQ up to 4.5 times as far from float64 as the plain
// route, in the dK/dV launch dK up to 2.8 and dV up to 3.2 times. With
// all of them, every gradient sits closer to a float64 route than a
// float32 plain route does (PERF.md, the float64 table).
//
// Splitting the group: when kvh * B * ceil(Skv / (16 NW)) blocks cannot
// fill the card (ops.backward_plan decides), the g query heads of each KV
// head are cut into s contiguous parts of g / s heads, a block each. A
// part writes its float32 dK and dV partials to a scratch of (s, B, Skv,
// KV, HDK) then (s, B, Skv, KV, HDV), and flash_bwd_group_sum adds them
// in part order 0..s-1, scales dK and casts both. With s = 1 dkdv writes
// dK and dV itself. No atomics anywhere:
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
// MLA's (192, 128), float32: dq takes 1 m-tile and 8-key tiles (rows of
// 196 and 132 floats: 103 KB, two blocks an SM; 16-key tiles take 123 KB,
// one); dkdv NW = 8 with 16-row query tiles (205 KB, one block an SM; 32-
// row tiles take 246 KB, past the 227 KB a block may have), whose dK and
// dV accumulators (160 floats a thread) leave room for the P^T and dS^T
// fragments of two 8-query columns. (24, 16) takes head dim 64's layouts.
//
// Masks are computed only on tiles that cut the causal diagonal, the
// window's edge, Sq or Skv; a warp skips a tile in which none of its
// pairs is visible (and, in dkdv, no row is without keys). Query tiles
// run longest first in dq, early keys (most queries) first in dkdv.
// bfloat16 tiles are converted when a fragment is loaded: their values
// are exact in TF32, so a bfloat16 call runs the same arithmetic and
// rounds its gradients once, at the store.

#include "flash_attention_bwd.cuh"

namespace {

// the dq launch: m-tiles of 16 rows a warp and keys a tile, by the q/k
// head dim
template <int HD>
struct DqShape {
  static constexpr int MT = HD <= 64 ? 2 : 1;
  static constexpr int BK = HD <= 64 ? 32 : (HD <= 128 ? 16 : 8);
};

// a Q and a dO tile of 64 * MT rows, two K and two V tiles of BK rows
template <typename T, int HDK, int HDV>
constexpr int dq_smem_bytes() {
  using S = DqShape<HDK>;
  return (64 * S::MT + 2 * S::BK) *
         (row_stride<T, HDK>() + row_stride<T, HDV>()) * sizeof(T);
}

constexpr int kSumThreads = 256;

template <typename T, int HDK, int HDV, bool CAP>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ out,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, T* __restrict__ dq, int sq, int skv,
             int h, int kvh, float scale, int causal, int window,
             float softcap) {
  constexpr int MT = DqShape<HDK>::MT, BK = DqShape<HDK>::BK;
  constexpr int BQ = 64 * MT, NT = BK / 8, DT = HDK / 8;
  constexpr int HDM = HDK > HDV ? HDK : HDV;  // the longer head dim
  constexpr int kLd = row_stride<T, HDK>();   // Q and K rows
  constexpr int vLd = row_stride<T, HDV>();   // dO and V rows
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + BQ * kLd;
  T* ks = dos + BQ * vLd;     // two K buffers
  T* vs = ks + 2 * BK * kLd;  // two V buffers
  __shared__ float dlt[BQ];

  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kvhead = head / (h / kvh);
  const int off = skv - sq;
  const int64_t qstride = static_cast<int64_t>(h) * HDK;
  const int64_t ostride = static_cast<int64_t>(h) * HDV;  // O and dO
  const int64_t kvstride = static_cast<int64_t>(kvh) * HDK;
  const int64_t vstride = static_cast<int64_t>(kvh) * HDV;
  const int64_t qoff = (static_cast<int64_t>(b) * sq * h + head) * HDK;
  const int64_t ooff = (static_cast<int64_t>(b) * sq * h + head) * HDV;
  const int64_t koff = static_cast<int64_t>(b) * skv * kvstride + kvhead * HDK;
  const int64_t voff = static_cast<int64_t>(b) * skv * vstride + kvhead * HDV;
  const int64_t roff = (static_cast<int64_t>(b) * h + head) * sq;

  // key tiles the masks leave live (none when every row has no key)
  const int q_lo = q0 + off, q_hi = min(q0 + BQ, sq) - 1 + off;
  int t_lo = 0, t_hi = (skv - 1) / BK;
  if (causal) t_hi = q_hi < 0 ? -1 : min(t_hi, q_hi / BK);
  if (window > 0) {
    const int first = q_lo - window + 1;
    if (first > 0) t_lo = first / BK;
  }

  load_tile<T, HDK, BQ>(qs, q + qoff, q0, sq, qstride);
  load_tile<T, HDV, BQ>(dos, dout + ooff, q0, sq, ostride);
  if (t_lo <= t_hi) {
    load_tile<T, HDK, BK>(ks, k + koff, t_lo * BK, skv, kvstride);
    load_tile<T, HDV, BK>(vs, v + voff, t_lo * BK, skv, vstride);
  }
  cp_async_commit();

  // Delta = rowsum(dO * O), four threads a row
  for (int r = threadIdx.x / 4; r < BQ; r += kThreads / 4) {
    const int part = threadIdx.x % 4;
    float s = 0.f;
    if (q0 + r < sq) {
      const T* orow = out + ooff + (q0 + r) * ostride;
      const T* drow = dout + ooff + (q0 + r) * ostride;
      for (int c = part; c < HDV; c += 4) s += ld1(orow + c) * ld1(drow + c);
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
  const float cs = CAP ? scale / softcap : 0.f;
  const float cl = CAP ? softcap * kLog2e : 0.f;
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
  const T* dw = dos + (16 * MT * warp + g) * vLd + t4;
  const int w_lo = q0 + 16 * MT * warp + off;  // the warp's query positions
  const int w_hi = w_lo + 16 * MT - 1;
  const bool w_in = q0 + 16 * MT * warp < sq;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; tile t - 1 is no longer read
    if (t < t_hi) {
      load_tile<T, HDK, BK>(ks + (buf ^ 1) * BK * kLd, k + koff, (t + 1) * BK,
                            skv, kvstride);
      load_tile<T, HDV, BK>(vs + (buf ^ 1) * BK * vLd, v + voff, (t + 1) * BK,
                            skv, vstride);
      cp_async_commit();
    }
    const int k0 = t * BK;
    // a warp none of whose pairs in this tile is visible skips it
    if (!w_in || (causal && k0 > w_hi) ||
        (window > 0 && k0 + BK - 1 <= w_lo - window))
      continue;
    const T* kt = ks + buf * BK * kLd;
    const T* vt = vs + buf * BK * vLd;

    // S = Q K^T over HDK and dP = dO V^T over HDV, promoted every 8 dims
    float s[MT][NT][4], dp[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mt][n][c] = dp[mt][n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDM; kk += 8) {
      uint32_t qb[MT][4], qsm[MT][4], ob[MT][4], osm[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (kk < HDK)
          frag_a<T, kLd>(qw + 16 * mt * kLd + kk, qb[mt], qsm[mt]);
        if (kk < HDV)
          frag_a<T, vLd>(dw + 16 * mt * vLd + kk, ob[mt], osm[mt]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        if (kk < HDK) {
          frag_b(kt + (8 * n + g) * kLd + kk + t4, 4, bb0, bs0, bb1, bs1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma3_add(s[mt][n], qb[mt], qsm[mt], bb0, bs0, bb1, bs1);
        }
        if (kk < HDV) {
          frag_b(vt + (8 * n + g) * vLd + kk + t4, 4, bb0, bs0, bb1, bs1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma3_add(dp[mt][n], ob[mt], osm[mt], bb0, bs0, bb1, bs1);
        }
      }
    }

    // dS = P * (dP - Delta) (times 1 - t^2 under the cap) into dp, masks
    // on the tiles that need them
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
            float fac = 1.f;
            const float p =
                exp2f(logit2_grad<CAP>(s[mt][n][2 * hr + c], sl, cs, cl, fac) -
                      l2[mt][hr]);
            float& y = dp[mt][n][2 * hr + c];
            float ds = p * (y - dl[mt][hr]);
            if constexpr (CAP) ds *= fac;
            y = ok ? ds : 0.f;
          }
      }

    // dQ += dS K, promoted every 8 keys
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
          mma3_add(acc[mt][d], ab[mt], as[mt], bb0, bs0, bb1, bs1);
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

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  store2(p, x.x, x.y);
  store2(p + 2, x.z, x.w);
}

// dK (nk elements) and dV (nv) from `part`, float32: split partials of
// dK, then split of dV; four elements a thread, summed over the parts in
// order 0..split-1; dK times scale; both cast to T
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
flash_bwd_group_sum(const float* __restrict__ part, T* __restrict__ dk,
                    T* __restrict__ dv, int64_t nk, int64_t nv, int split,
                    float scale) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x) * 4;
  if (i >= nk + nv) return;
  const bool is_k = i < nk;
  const int64_t j = is_k ? i : i - nk, n = is_k ? nk : nv;
  const float* src = part + (is_k ? 0 : split * nk) + j;
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

template <typename T, int HDK, int HDV, bool CAP>
int bwd_hd(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, float* part, int b, int sq, int skv, int h,
           int kvh, float scale, int causal, int window, float softcap,
           int split, cudaStream_t stream) {
  constexpr int dq_bytes = dq_smem_bytes<T, HDK, HDV>();
  constexpr int rows = 64 * DqShape<HDK>::MT;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, HDK, HDV, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq<T, HDK, HDV, CAP>
      <<<dim3(h, b, (sq + rows - 1) / rows), kThreads, dq_bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(out),
          static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sq,
          skv, h, kvh, scale, causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // reads the Delta the dq launch wrote: same stream, so in order
  const int got = flash_dkdv_launch(
      kDtype<T>, HDK, HDV, CAP, q, k, v, dout, lse, delta, dk, dv, part, b,
      sq, skv, h, kvh, split, scale, causal, window, softcap, stream);
  if (got != 0 || split == 1) return got;
  const int64_t nk = static_cast<int64_t>(b) * skv * kvh * HDK;
  const int64_t nv = static_cast<int64_t>(b) * skv * kvh * HDV;
  const int64_t threads = (nk + nv) / 4;
  flash_bwd_group_sum<T>
      <<<static_cast<unsigned>((threads + kSumThreads - 1) / kSumThreads),
         kSumThreads, 0, stream>>>(part, static_cast<T*>(dk),
                                   static_cast<T*>(dv), nk, nv, split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HDK, int HDV, bool CAP>
int bwd_info(int which, int* info) {
  if (which == 0)
    return kernel_info(flash_bwd_dq<T, HDK, HDV, CAP>, kThreads,
                       dq_smem_bytes<T, HDK, HDV>(), info);
  if (which == 1) return flash_dkdv_info(kDtype<T>, HDK, HDV, CAP, info);
  if (which == 2)
    return kernel_info(flash_bwd_group_sum<T>, kSumThreads, 0, info);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace


// The backward of flash_attention_launch's function on `stream`: the dq
// launch, the dkdv launch with each group of H / KV query heads cut into
// `split` parts of as many heads (split divides H / KV), and, when
// split > 1, the group sum; returns the first CUDA error. q, k, v, out and
// dout as the forward takes them (`out` the forward's output, `dout` its
// gradient), at the forward's head-dim pairs (`hd` of q and k, `hd_v` of
// v, out and dout) and `softcap` (> 0 only at equal head dims), `lse` the
// forward's (B, H, Sq) float32 output, `delta` a (B, H, Sq) float32
// scratch the first launch writes and the second reads, `part` a float32
// scratch of split * B * Skv * KV * (hd + hd_v) elements (dK's partials,
// then dV's; null when split = 1); dq, dk and dv are written in the
// inputs' type, each contiguous and shaped as its input. No atomics: the
// same inputs and split give the same bits.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* part, int b, int sq, int skv, int h, int kvh, int hd,
    int hd_v, float scale, int causal, int window, float softcap, int split,
    int dtype, cudaStream_t stream) {
  if (split < 1 || (h / kvh) % split != 0 || (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, hd, hd_v, [&](auto tag, auto hdk, auto hdv) {
    using T = typename decltype(tag)::type;
    constexpr int K = decltype(hdk)::value, V = decltype(hdv)::value;
    return with_cap<K, V>(softcap > 0.f, [&](auto cap) {
      return bwd_hd<T, K, V, decltype(cap)::value>(
          q, k, v, out, dout, lse, delta, dq, dk, dv, part, b, sq, skv, h,
          kvh, scale, causal, window, softcap, split, stream);
    });
  });
}

// Registers a thread, shared memory a block in bytes (static and dynamic)
// and resident blocks an SM of one backward launch at the head-dim pair,
// build (`cap` non-zero: the capped one) and type, into info[0..2]:
// `which` 0 is flash_bwd_dq, 1 flash_bwd_dkdv, 2 flash_bwd_group_sum.
// Returns a CUDA error (0 = none).
extern "C" int flash_attention_backward_info(int hd, int hd_v, int cap,
                                             int dtype, int which,
                                             int* info) {
  return dispatch(dtype, hd, hd_v, [&](auto tag, auto hdk, auto hdv) {
    using T = typename decltype(tag)::type;
    constexpr int K = decltype(hdk)::value, V = decltype(hdv)::value;
    return with_cap<K, V>(cap != 0, [&](auto c) {
      return bwd_info<T, K, V, decltype(c)::value>(which, info);
    });
  });
}
