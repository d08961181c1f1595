// Backward of flash_attention.cu's function, written by hand for Hopper
// (sm_90a): two launches (dq, then dK/dV) of one warp-specialised kernel
// body (flash_attention_bwd.cuh: bwd_body), every product on wgmma, the
// streamed tiles brought by TMA into an mbarrier ring, and a fixed-order
// sum. Built into the same library as the forward.
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
// is recomputed from it and dS takes the factor 1 - t^2, with the
// forward's logit2 arithmetic (the accurate tanhf of the same scaled
// value), so P meets the saved log-sum-exp as the forward formed it. The
// cap is a template flag. At MLA's head-dim pairs (deepseek-v2's (192,
// 128), its reduced config's (24, 16); uncapped) S, dQ and dK run over
// the q/k head dim HDK, dP, Delta and dV over v's HDV.
//
// Bound on this card: operations. Five products of the forward's size
// (S, dQ, dK: 2 * HDK operations each per visible pair; dP, dV: 2 * HDV),
// 8.598e10 at llama3.2-1b's training shape (B=8, S=1024, H=32, KV=8,
// hd=64, causal): 0.5211 ms as 3xTF32 at 495/3 TFLOP/s, the card's
// fastest rate for float32 products at the 1e-4 the gradients are held to
// (TF32 alone keeps about three decimal digits); 8.942e11 and 5.4195 ms at
// deepseek-v2's (B=8, S=1024, H=128, (192, 128)). Both launches recompute
// S and dP, so seven products run. The bytes take ~0.1 ms at llama's
// shape. Capped, each launch adds a tanhf a visible pair on the float32
// units.
//
// One kernel body for both launches (bwd_body). A block holds 64
// resident rows (dq: query rows, their Q and dO; dK/dV: keys, their K and
// V) and streams tiles of BN rows of the other side (dq: K and V; dK/dV:
// Q, dO, lse and Delta) through PS stages of shared memory. Warpgroup 0
// is the producer: its thread 0 loads each tile by cp.async.bulk.tensor
// (4-D maps of (B, S, heads, hd), a box of BN rows of one head, zero past
// S; lse and Delta by 2-D maps), completing on an mbarrier. A float32
// tile lands straight in a free stage (an empty mbarrier both consumers
// arrive on), a box a panel, swizzled as wgmma reads it, and the
// warpgroup splits it there; a bfloat16 tile lands in one of RS slots as
// it lies in memory and the warpgroup widens it into a free stage. Then
// the warpgroup arrives on the stage's full mbarrier. setmaxnreg gives the
// producer 40 registers a thread and the consumers 232. The two consumer
// warpgroups work on every tile, each in a role: role 0 holds the A
// fragments of S (Q, or K) in registers for the whole block and computes
// S and P; role 1 holds dO's (or V's) and computes dP and dS. Role 0
// hands P (masked, times 1 - t^2 under the cap) to role 1 through NB
// buffers in shared memory (mbarriers pready / pfree). In dq, role 1
// writes dS and both roles then add K^T dS^T into their share of dQ^T's
// M-blocks (dsready / dsfree); in dK/dV, role 0 adds dO^T P into dV^T and
// role 1 Q^T dS into dK^T. The work splits evenly at (192, 128): S and one
// M-block of dQ against dP and two; S and dV against dP and dK.
//
// TF32 wgmma reads both operands K-major and B from shared memory. The
// panels are K-major by construction: a tile of R rows by K float32
// columns is cut into panels of 32, 16 or 8 columns (the widest dividing
// K), each swizzled over 128, 64 or 32 bytes as the wgmma descriptor
// names it. The two products that contract over the streamed rows (dQ =
// dS K; dK = dS^T Q and dV = P^T dO) would need the streamed tile
// transposed, which TMA does not do for float32. They run transposed
// instead: dQ^T = K^T dS^T, dK^T = Q^T dS, dV^T = dO^T P, with the head
// dim as M (blocks of 64, zero rows past hd) and the 64 resident rows as
// N. A = K^T (Q^T, dO^T) is read into registers straight from the
// stage's panels of K (Q, dO), which any order of reads allows; B is dS
// (P) written as a 64 x BN K-major scratch panel from the accumulator of
// S. The accumulators of dQ^T, dK^T and dV^T are written out transposed.
//
// 3xTF32: every product is big big + big small + small big, float32 split
// as the forward splits it (big rounded to TF32, small = x - big). The
// operand in registers is split there; a B operand needs its small part
// in shared memory, so a stage holds each streamed tile as one panel tile
// of its rows' hi and, below them, their lo (the TMA lands x in the hi
// rows; the split leaves hi there and writes lo below), and each scratch
// its hi and lo. S and dP then take two wgmma a k-step: A's big part
// against the hi and lo rows at once (N = 2 BN) and A's small part against
// the hi rows (N = BN); the products over the streamed rows take three
// (N = 64).
// bfloat16 runs the same TF32 path: its values are exact in TF32, so its
// inputs have no small part and those products are skipped (S and dP one
// wgmma a k-step, the others two); it rounds its gradients once, at the
// store.
//
// Promotion: the tensor cores truncate inside a sum, so a sum
// carried in one accumulator through many k-steps drifts. Each chunk of a
// product therefore goes into zeroed accumulators (scale-d 0), and a
// float32 add puts it into S, dP, dQ, dK or dV: S and dP every KC
// k-steps (8 at (192, 128), 4 at 64 and 128, 1 below, where more put a
// gradient over 3 times as far from a float64 route as the float32 plain
// route's), dQ^T, dK^T and dV^T each tile (BN / 8 <= 4 k-steps, the two
// small products of each k-step added before its big one).
//
// Layouts (Shape; ops.BWD_LAYOUTS mirrors them), chosen by timing on the
// card at the training shapes of PERF.md (row 7b; chip_smoke.py
// --fa-layouts times the alternatives at (192, 128)): 32-row tiles, two
// hand-off buffers; three stages at head dim <= 64, two above. At (192,
// 128) float32 the dq block takes 209 KB and the dK/dV block 210 KB of the
// 227 KB a block may have, one block an SM; a wgmma over 16 or 24
// streamed rows does too little to cover its issue, so the tiles are as
// long as shared memory allows. The resident fragments take HD / 2
// registers a thread: 96 for Q or K at 192.
//
// Masks are computed only on tiles that cut the causal diagonal, the
// window's edge, Sq or Skv; both roles skip a tile in which none of the
// block's pairs is visible (and, in dK/dV, no row is without keys),
// arriving on the stage all the same. Query tiles run longest first in
// dq, early keys (most queries) first in dK/dV. The dq launch writes, for
// the dK/dV launch, a copy of lse and Delta into a (2, B, H, Sq rounded up
// to 4) scratch: a TMA box must start 16-byte aligned, which a row of Sq
// floats does not when Sq is not a multiple of 4.
//
// Splitting the group: when kvh * B * ceil(Skv / 64) dK/dV blocks cannot
// fill the card (ops.backward_plan decides), the g query heads of each KV
// head are cut into s contiguous parts of g / s heads, a block each. A
// part writes its float32 dK and dV partials to a scratch of (s, B, Skv,
// KV, HDK) then (s, B, Skv, KV, HDV), and flash_bwd_group_sum adds them
// in part order 0..s-1, scales dK and casts both. With s = 1 dkdv writes
// dK and dV itself. No atomics anywhere: every sum runs in an order the
// code fixes, so the same inputs and s give the same bits run to run.

#include "flash_attention_bwd.cuh"

namespace {

constexpr int kSumThreads = 256;

template <typename T, int HDK, int HDV, bool CAP>
__global__ void __launch_bounds__(BwdLayout<T, HDK, HDV, false>::THREADS, 1)
flash_bwd_dq(const __grid_constant__ BwdArgs p) {
  bwd_body<T, HDK, HDV, CAP, false>(p);
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
  using L = BwdLayout<T, HDK, HDV, false>;
  BwdArgs a{};
  if (!map_rows<T, HDK>(&a.ma, k, kvh, skv, b, L::BN) ||
      !map_rows<T, HDV>(&a.mb, v, kvh, skv, b, L::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  a.ra = q;
  a.rb = dout;
  a.out = out;
  a.lse = lse;
  a.vecs = delta;
  a.g1 = dq;
  a.sq = sq;
  a.skv = skv;
  a.h = h;
  a.kvh = kvh;
  a.split = 1;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, HDK, HDV, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq<T, HDK, HDV, CAP>
      <<<dim3(h, b, (sq + 63) / 64), L::THREADS, L::BYTES, stream>>>(
          a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // reads the lse copy and Delta the dq launch wrote: same stream, so in
  // order
  const int got = flash_dkdv_launch(
      kDtype<T>, HDK, HDV, CAP, q, k, v, dout, delta, dk, dv, part, b,
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
  using L = BwdLayout<T, HDK, HDV, false>;
  if (which == 0)
    return kernel_info(flash_bwd_dq<T, HDK, HDV, CAP>, L::THREADS, L::BYTES,
                       info);
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
// forward's (B, H, Sq) float32 output, `delta` a (2, B, H, Sq rounded up
// to 4) float32 scratch the first launch writes (a copy of lse, then
// Delta, each row 16-byte aligned for the TMA) and the second reads,
// `part` a float32
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
