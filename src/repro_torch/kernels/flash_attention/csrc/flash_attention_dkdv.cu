// The dK/dV launch of flash_attention's backward (flash_bwd_dkdv),
// written by hand for Hopper (sm_90a): bwd_body's dK/dV role (its design,
// bound and layouts are described in flash_attention_bwd.cu, which calls
// it through flash_dkdv_launch).

#include "flash_attention_bwd.cuh"

namespace {

template <typename T, int HDK, int HDV, bool CAP>
__global__ void __launch_bounds__(BwdLayout<T, HDK, HDV, true>::THREADS, 1)
flash_bwd_dkdv(const __grid_constant__ BwdArgs p) {
  bwd_body<T, HDK, HDV, CAP, true>(p);
}

template <typename T, int HDK, int HDV, bool CAP>
int dkdv_hd(const void* q, const void* k, const void* v, const void* dout,
            const float* vecs, void* dk, void* dv, float* part, int b,
            int sq, int skv, int h, int kvh, int split, float scale,
            int causal, int window, float softcap, cudaStream_t stream) {
  using L = BwdLayout<T, HDK, HDV, true>;
  BwdArgs a{};
  // lse's copy and Delta, as the dq launch wrote them into `vecs`
  const int64_t n = static_cast<int64_t>(b) * h;
  if (!map_rows<T, HDK>(&a.ma, q, h, sq, b, L::BN) ||
      !map_rows<T, HDV>(&a.mb, dout, h, sq, b, L::BN) ||
      !map_vec(&a.ml, vecs, n, sq, L::BN) ||
      !map_vec(&a.md, vecs + n * vec_row(sq), n, sq, L::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  a.ra = k;
  a.rb = v;
  a.g1 = dk;
  a.g2 = dv;
  a.part = part;
  a.sq = sq;
  a.skv = skv;
  a.h = h;
  a.kvh = kvh;
  a.split = split;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, HDK, HDV, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<T, HDK, HDV, CAP>
      <<<dim3(kvh * split, b, (skv + 63) / 64), L::THREADS, L::BYTES,
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash_dkdv_launch(int dtype, int hd, int hd_v, bool cap, const void* q,
                      const void* k, const void* v, const void* dout,
                      const float* vecs, void* dk, void* dv, float* part,
                      int b, int sq, int skv, int h, int kvh, int split,
                      float scale, int causal, int window, float softcap,
                      cudaStream_t stream) {
  return dispatch(dtype, hd, hd_v, [&](auto tag, auto hdk, auto hdv) {
    using T = typename decltype(tag)::type;
    constexpr int K = decltype(hdk)::value, V = decltype(hdv)::value;
    return with_cap<K, V>(cap, [&](auto c) {
      return dkdv_hd<T, K, V, decltype(c)::value>(
          q, k, v, dout, vecs, dk, dv, part, b, sq, skv, h, kvh, split,
          scale, causal, window, softcap, stream);
    });
  });
}

int flash_dkdv_info(int dtype, int hd, int hd_v, bool cap, int* info) {
  return dispatch(dtype, hd, hd_v, [&](auto tag, auto hdk, auto hdv) {
    using T = typename decltype(tag)::type;
    constexpr int K = decltype(hdk)::value, V = decltype(hdv)::value;
    using L = BwdLayout<T, K, V, true>;
    return with_cap<K, V>(cap, [&](auto c) {
      return kernel_info(flash_bwd_dkdv<T, K, V, decltype(c)::value>,
                         L::THREADS, L::BYTES, info);
    });
  });
}
