// One-stream threshold scan for top-K maintenance, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `topk_filter_pallas`
// (src/repro/kernels/topk_filter/topk_filter.py:33). For scores (N,) f32
// against one threshold (a device scalar, so the caller never waits for
// it) it writes the survivor mask `s > thr` (N,) int8 and, per tile of
// `bn` columns, the survivor count (int32) and the tile maximum (f32).
// NaN scores count as NEG_BIG = -1e30, as the reference's wrapper
// demotes them before its kernel runs.
//
// The reference pads the row to a multiple of `bn` with NEG_BIG in
// device memory and scans the padded copy: pad columns enter the last
// tile's max, and they are counted where thr is below NEG_BIG (thr =
// -inf, an unfull reservoir). This kernel reads only the real columns
// and adds the pad columns of the last tile arithmetically, so no padded
// copy exists.
//
// Bound on this card: bytes. It reads 4N + 4 bytes and writes
// N + 8*tiles bytes with one compare per score. One stream has too few
// columns per tile for a warp: a 4,096-wide tile is one block of 256
// threads, 16 scores per thread as four 16-byte loads when the width and
// the pointer allow it, each followed by a 4-byte store of 4 mask bytes;
// count and max are reduced by warp shuffles and then across the 8 warps
// through shared memory. No atomics: results do not depend on scheduling.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegBig = -1e30f;  // the reference's NEG_BIG as float32
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// one score: NaN demoted to NEG_BIG, folded into the tile's count and
// max; returns its mask
__device__ __forceinline__ signed char scan_one(float s, float thr, int& cnt,
                                                float& mx) {
  s = isnan(s) ? kNegBig : s;
  const bool hit = s > thr;
  cnt += hit ? 1 : 0;
  mx = fmaxf(mx, s);
  return hit ? 1 : 0;
}

// one block per tile; VEC: 4 scores per thread per step, which needs
// n % 4 == 0 and a 16-byte aligned score pointer (checked by the caller)
template <bool VEC>
__global__ void filter_tile(const float* __restrict__ scores,
                            const float* __restrict__ thr_ptr,
                            int8_t* __restrict__ mask,
                            int32_t* __restrict__ counts,
                            float* __restrict__ tmax, int64_t n, int bn) {
  __shared__ int s_cnt[kWarps];
  __shared__ float s_mx[kWarps];
  const int tile = blockIdx.x;
  const float thr = *thr_ptr;
  const int64_t c0 = static_cast<int64_t>(tile) * bn;
  const int64_t c1 = c0 + bn < n ? c0 + bn : n;
  int cnt = 0;
  float mx = -INFINITY;
  if (VEC) {
    for (int64_t c = c0 + 4 * threadIdx.x; c < c1; c += 4 * kThreads) {
      const float4 s = *reinterpret_cast<const float4*>(scores + c);
      char4 hit;
      hit.x = scan_one(s.x, thr, cnt, mx);
      hit.y = scan_one(s.y, thr, cnt, mx);
      hit.z = scan_one(s.z, thr, cnt, mx);
      hit.w = scan_one(s.w, thr, cnt, mx);
      *reinterpret_cast<char4*>(mask + c) = hit;
    }
  } else {
    for (int64_t c = c0 + threadIdx.x; c < c1; c += kThreads) {
      mask[c] = scan_one(scores[c], thr, cnt, mx);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kWarps ? s_cnt[lane] : 0;
    mx = lane < kWarps ? s_mx[lane] : -INFINITY;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      // the NEG_BIG columns that pad the last tile to `bn`
      const int64_t pad = bn - (c1 - c0);
      if (pad > 0) {
        if (kNegBig > thr) cnt += static_cast<int>(pad);
        mx = fmaxf(mx, kNegBig);
      }
      counts[tile] = cnt;
      tmax[tile] = mx;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched). `vec`
// selects 16-byte loads (n % 4 == 0, aligned score pointer).
extern "C" int topk_filter_launch(const float* scores, const float* thr,
                                  int8_t* mask, int32_t* counts, float* tmax,
                                  int64_t n, int bn, int tiles, int vec,
                                  cudaStream_t stream) {
  if (vec) {
    filter_tile<true><<<tiles, kThreads, 0, stream>>>(scores, thr, mask,
                                                      counts, tmax, n, bn);
  } else {
    filter_tile<false><<<tiles, kThreads, 0, stream>>>(scores, thr, mask,
                                                       counts, tmax, n, bn);
  }
  return static_cast<int>(cudaGetLastError());
}
