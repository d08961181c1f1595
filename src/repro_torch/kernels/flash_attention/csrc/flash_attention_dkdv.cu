// The dK/dV launch of flash_attention's backward (flash_bwd_dkdv),
// written by hand for Hopper (sm_90a): its design, bound and layouts
// are described in flash_attention_bwd.cu, which calls it through
// flash_dkdv_launch.

#include "flash_attention_bwd.cuh"

namespace {

// the dkdv launch: warps of 16 keys a block and query rows a tile, by the
// q/k head dim
template <int HD>
struct DkdvShape {
  static constexpr int NW = HD >= 128 ? 8 : 4;
  static constexpr int BN = 16 * NW;
  static constexpr int BM = HD > 128 ? 16 : 32;
};

// a K and a V tile of BN rows, two Q and two dO tiles of BM rows, two lse
// and two Delta tiles
template <typename T, int HDK, int HDV>
constexpr int dkdv_smem_bytes() {
  using S = DkdvShape<HDK>;
  return (S::BN + 2 * S::BM) *
             (row_stride<T, HDK>() + row_stride<T, HDV>()) * sizeof(T) +
         4 * S::BM * sizeof(float);
}

// 4 bytes from global to shared memory, asynchronously; zero-filled when
// !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

template <typename T, int HDK, int HDV, bool CAP>
__global__ void __launch_bounds__(32 * DkdvShape<HDK>::NW,
                                  DkdvShape<HDK>::NW == 4 ? 2 : 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, float* __restrict__ part, int sq, int skv,
               int h, int kvh, int split, float scale, int causal,
               int window, float softcap) {
  constexpr int BN = DkdvShape<HDK>::BN, BM = DkdvShape<HDK>::BM;
  constexpr int NT = BM / 8, DTK = HDK / 8, DTV = HDV / 8;
  constexpr int HDM = HDK > HDV ? HDK : HDV, DTM = HDM / 8;
  constexpr int THR = 32 * DkdvShape<HDK>::NW;
  constexpr int kLd = row_stride<T, HDK>();  // K and Q rows
  constexpr int vLd = row_stride<T, HDV>();  // V and dO rows
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BN * kLd;
  T* qs = vs + BN * vLd;         // two Q buffers
  T* dos = qs + 2 * BM * kLd;    // two dO buffers
  float* ls = reinterpret_cast<float*>(dos + 2 * BM * vLd);  // two lse
  float* dls = ls + 2 * BM;                                  // two Delta

  const int kvhead = blockIdx.x / split, prt = blockIdx.x % split;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BN;  // early keys (most queries) first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int grp = h / kvh, off = skv - sq;
  // this part's query heads: [h0, h0 + nh); split divides the group
  const int nh = grp / split, h0 = kvhead * grp + prt * nh;
  const int64_t qstride = static_cast<int64_t>(h) * HDK;
  const int64_t ostride = static_cast<int64_t>(h) * HDV;  // dO
  const int64_t kvstride = static_cast<int64_t>(kvh) * HDK;
  const int64_t vstride = static_cast<int64_t>(kvh) * HDV;
  const int64_t koff = static_cast<int64_t>(b) * skv * kvstride + kvhead * HDK;
  const int64_t voff = static_cast<int64_t>(b) * skv * vstride + kvhead * HDV;

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
    const int64_t qoff = (static_cast<int64_t>(b) * sq * h + head) * HDK;
    const int64_t ooff = (static_cast<int64_t>(b) * sq * h + head) * HDV;
    const int64_t roff = (static_cast<int64_t>(b) * h + head) * sq;
    load_tile<T, HDK, BM, THR>(qs + buf * BM * kLd, q + qoff, i0, sq,
                               qstride);
    load_tile<T, HDV, BM, THR>(dos + buf * BM * vLd, dout + ooff, i0, sq,
                               ostride);
    for (int r = threadIdx.x; r < BM; r += THR) {
      const bool in = i0 + r < sq;
      const int64_t at = roff + (in ? i0 + r : 0);
      cp_async4(ls + buf * BM + r, lse + at, in);
      cp_async4(dls + buf * BM + r, delta + at, in);
    }
  };

  load_tile<T, HDK, BN, THR>(ks, k + koff, k0, skv, kvstride);
  load_tile<T, HDV, BN, THR>(vs, v + voff, k0, skv, vstride);
  if (total > 0) prefetch(0, 0);
  cp_async_commit();

  float dka[DTK][4], dva[DTV][4];
#pragma unroll
  for (int d = 0; d < DTK; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[d][c] = 0.f;
#pragma unroll
  for (int d = 0; d < DTV; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dva[d][c] = 0.f;
  const int kw0 = k0 + 16 * warp;  // the warp's first key
  const bool w_in = kw0 < skv;
  const T* kw = ks + (16 * warp + g) * kLd + t4;  // key g, dim t
  const T* vw = vs + (16 * warp + g) * vLd + t4;
  const float sl = scale * kLog2e;
  const float cs = CAP ? scale / softcap : 0.f;
  const float cl = CAP ? softcap * kLog2e : 0.f;
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
    const T* dt = dos + buf * BM * vLd;
    const float* lt = ls + buf * BM;
    const float* dlt = dls + buf * BM;

    // S^T = K Q^T over HDK and dP^T = V dO^T over HDV: the warp's 16 keys
    // by BM queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDM; kk += 8) {
      uint32_t kb[4], ksm[4], vb[4], vsm[4];
      if (kk < HDK) frag_a<T, kLd>(kw + kk, kb, ksm);
      if (kk < HDV) frag_a<T, vLd>(vw + kk, vb, vsm);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        if (kk < HDK) {
          frag_b(qt + (8 * n + g) * kLd + kk + t4, 4, bb0, bs0, bb1, bs1);
          mma3(s[n], kb, ksm, bb0, bs0, bb1, bs1);
        }
        if (kk < HDV) {
          frag_b(dt + (8 * n + g) * vLd + kk + t4, 4, bb0, bs0, bb1, bs1);
          mma3(dp[n], vb, vsm, bb0, bs0, bb1, bs1);
        }
      }
    }

    // P^T into s and dS^T (times 1 - t^2 under the cap) into dp, masks on
    // the tiles that need them
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
        float fac = 1.f;
        const float p =
            exp2f(logit2_grad<CAP>(s[n][c], sl, cs, cl, fac) - l2);
        float ds = p * (dp[n][c] - dd);
        if constexpr (CAP) ds *= fac;
        if (!edge) {
          s[n][c] = p;
          dp[n][c] = ds;
        } else {
          const int kpos = kw0 + g + 8 * (c >> 1);
          const int qi = i0 + 8 * n + 2 * t4 + cc, qpos = qi + off;
          const bool in = qi < sq && kpos < skv;
          bool ok = in;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          // a row with no key averages v over all keys
          s[n][c] = ok ? p : (in && causal && qpos < 0 ? uniform : 0.f);
          dp[n][c] = ok ? ds : 0.f;
        }
      }
    }

    // dV += P^T dO over HDV, dK += dS^T Q over HDK: the tile's BM queries
    // summed into a zeroed fragment, then added to the totals with a
    // float32 add
    uint32_t pb[NT][4], psm[NT][4], db[NT][4], dsm[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      frag_acc(s[n], pb[n], psm[n]);
      frag_acc(dp[n], db[n], dsm[n]);
    }
#pragma unroll
    for (int d = 0; d < DTM; ++d) {
      float tv[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        if (d < DTV) {
          frag_b(dt + (8 * n + 2 * t4) * vLd + g + 8 * d, vLd, bb0, bs0, bb1,
                 bs1);
          mma3(tv, pb[n], psm[n], bb0, bs0, bb1, bs1);
        }
        if (d < DTK) {
          frag_b(qt + (8 * n + 2 * t4) * kLd + g + 8 * d, kLd, bb0, bs0, bb1,
                 bs1);
          mma3(tk, db[n], dsm[n], bb0, bs0, bb1, bs1);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (d < DTV) dva[d][c] += tv[c];
        if (d < DTK) dka[d][c] += tk[c];
      }
    }
  }
  cp_async_wait_all();  // nothing in flight when the block ends

  const int64_t nk = static_cast<int64_t>(gridDim.y) * skv * kvstride;
  const int64_t nv = static_cast<int64_t>(gridDim.y) * skv * vstride;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = kw0 + g + 8 * hr;
    if (key >= skv) continue;
    const int64_t atk = koff + key * kvstride + 2 * t4;
    const int64_t atv = voff + key * vstride + 2 * t4;
    if (split == 1) {
#pragma unroll
      for (int d = 0; d < DTK; ++d)
        store2(dk + atk + 8 * d, dka[d][2 * hr] * scale,
               dka[d][2 * hr + 1] * scale);
#pragma unroll
      for (int d = 0; d < DTV; ++d)
        store2(dv + atv + 8 * d, dva[d][2 * hr], dva[d][2 * hr + 1]);
    } else {  // this part's float32 partials, dK unscaled
      float* pk = part + prt * nk + atk;
      float* pv = part + split * nk + prt * nv + atv;
#pragma unroll
      for (int d = 0; d < DTK; ++d)
        store2(pk + 8 * d, dka[d][2 * hr], dka[d][2 * hr + 1]);
#pragma unroll
      for (int d = 0; d < DTV; ++d)
        store2(pv + 8 * d, dva[d][2 * hr], dva[d][2 * hr + 1]);
    }
  }
}

template <typename T, int HDK, int HDV, bool CAP>
int dkdv_hd(const T* q, const T* k, const T* v, const T* dout,
            const float* lse, const float* delta, T* dk, T* dv, float* part,
            int b, int sq, int skv, int h, int kvh, int split, float scale,
            int causal, int window, float softcap, cudaStream_t stream) {
  constexpr int bytes = dkdv_smem_bytes<T, HDK, HDV>();
  using S = DkdvShape<HDK>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, HDK, HDV, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<T, HDK, HDV, CAP>
      <<<dim3(kvh * split, b, (skv + S::BN - 1) / S::BN), 32 * S::NW, bytes,
         stream>>>(q, k, v, dout, lse, delta, dk, dv, part, sq, skv, h, kvh,
                   split, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash_dkdv_launch(int dtype, int hd, int hd_v, bool cap, const void* q,
                      const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk,
                      void* dv, float* part, int b, int sq, int skv, int h,
                      int kvh, int split, float scale, int causal, int window,
                      float softcap, cudaStream_t stream) {
  return dispatch(dtype, hd, hd_v, [&](auto tag, auto hdk, auto hdv) {
    using T = typename decltype(tag)::type;
    constexpr int K = decltype(hdk)::value, V = decltype(hdv)::value;
    return with_cap<K, V>(cap, [&](auto c) {
      return dkdv_hd<T, K, V, decltype(c)::value>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
          static_cast<T*>(dk), static_cast<T*>(dv), part, b, sq, skv, h, kvh,
          split, scale, causal, window, softcap, stream);
    });
  });
}

int flash_dkdv_info(int dtype, int hd, int hd_v, bool cap, int* info) {
  return dispatch(dtype, hd, hd_v, [&](auto tag, auto hdk, auto hdv) {
    using T = typename decltype(tag)::type;
    constexpr int K = decltype(hdk)::value, V = decltype(hdv)::value;
    return with_cap<K, V>(cap, [&](auto c) {
      return kernel_info(flash_bwd_dkdv<T, K, V, decltype(c)::value>,
                         32 * DkdvShape<K>::NW, dkdv_smem_bytes<T, K, V>(),
                         info);
    });
  });
}
