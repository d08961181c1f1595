// Logmem admission scan for the O(log K) reservoir backend, written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `logmem_admit_pallas`
// (src/repro/kernels/logmem_update/logmem_update.py:40). For scores
// (M, N) f32 and ids (M, N) i32 (id < 0 is padding) against one
// acceptance threshold per stream tau (M,) it writes the admit mask
// `id >= 0 && s > tau` (M, N) int8 and, per (stream, tile) of `bn`
// columns, the admit count and the live count (int32) and the live
// maximum (f32, -inf on a tile without a live entry).
//
// The reference pads every row to a multiple of `bn` with id -1 in
// device memory. Pad columns are inert in every output, even under
// tau = -inf, so this kernel reads only the real columns and adds
// nothing for the pad: no padded copy exists.
//
// Bound on this card: bytes. It reads 8MN + 4M bytes and writes
// MN + 12M*tiles bytes with two compares per entry, far below the card's
// compute rate. Design against that bound, with no atomics (results do
// not depend on scheduling):
// - rows of at most 32 entries: one thread per row, so a warp covers 32
//   rows and no cross-lane reduction is needed;
// - wider rows (8,192 at the documented deployment): one warp per
//   (stream, tile), neighbouring lanes on neighbouring entries, with
//   16-byte loads of 4 scores and 4 ids and a 4-byte store of 4 mask
//   bytes per lane when the row width and the pointers allow it; counts
//   and max reduced by warp shuffles.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNarrow = 32;  // widest row scanned by a single thread

// max that propagates NaN, like jnp.max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// one entry: folds it into the tile's counts and max, returns its mask
__device__ __forceinline__ signed char scan_one(float s, int id, float tau,
                                                int& acnt, int& lcnt,
                                                float& mx) {
  const bool live = id >= 0;
  const bool hit = live && s > tau;
  acnt += hit ? 1 : 0;
  lcnt += live ? 1 : 0;
  if (live) mx = nan_max(mx, s);
  return hit ? 1 : 0;
}

// n <= kNarrow: one tile per row, one thread per row
__global__ void admit_narrow(const float* __restrict__ scores,
                             const int32_t* __restrict__ ids,
                             const float* __restrict__ tau,
                             int8_t* __restrict__ mask,
                             int32_t* __restrict__ acounts,
                             int32_t* __restrict__ lcounts,
                             float* __restrict__ tmax, int64_t m, int n) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= m) return;
  const float t = tau[row];
  int acnt = 0, lcnt = 0;
  float mx = -INFINITY;
  for (int c = 0; c < n; ++c) {
    mask[row * n + c] =
        scan_one(scores[row * n + c], ids[row * n + c], t, acnt, lcnt, mx);
  }
  acounts[row] = acnt;
  lcounts[row] = lcnt;
  tmax[row] = mx;
}

// one warp per (stream, tile); VEC: 4 entries per lane per step, which
// needs n % 4 == 0 and 16-byte aligned scores and ids (checked by the
// caller)
template <bool VEC>
__global__ void admit_wide(const float* __restrict__ scores,
                           const int32_t* __restrict__ ids,
                           const float* __restrict__ tau,
                           int8_t* __restrict__ mask,
                           int32_t* __restrict__ acounts,
                           int32_t* __restrict__ lcounts,
                           float* __restrict__ tmax, int64_t m, int n,
                           int bn, int tiles) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= m * tiles) return;  // uniform across the warp
  const int64_t row = warp / tiles;
  const int tile = static_cast<int>(warp - row * tiles);
  const float t = tau[row];
  const int c0 = tile * bn;
  const int c1 = min(c0 + bn, n);
  const float* srow = scores + row * n;
  const int32_t* irow = ids + row * n;
  int8_t* mrow = mask + row * n;
  int acnt = 0, lcnt = 0;
  float mx = -INFINITY;
  if (VEC) {
    for (int c = c0 + 4 * lane; c < c1; c += 128) {
      const float4 s = *reinterpret_cast<const float4*>(srow + c);
      const int4 id = *reinterpret_cast<const int4*>(irow + c);
      char4 hit;
      hit.x = scan_one(s.x, id.x, t, acnt, lcnt, mx);
      hit.y = scan_one(s.y, id.y, t, acnt, lcnt, mx);
      hit.z = scan_one(s.z, id.z, t, acnt, lcnt, mx);
      hit.w = scan_one(s.w, id.w, t, acnt, lcnt, mx);
      *reinterpret_cast<char4*>(mrow + c) = hit;
    }
  } else {
    for (int c = c0 + lane; c < c1; c += 32) {
      mrow[c] = scan_one(srow[c], irow[c], t, acnt, lcnt, mx);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acnt += __shfl_xor_sync(0xffffffffu, acnt, off);
    lcnt += __shfl_xor_sync(0xffffffffu, lcnt, off);
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if (lane == 0) {
    acounts[warp] = acnt;
    lcounts[warp] = lcnt;
    tmax[warp] = mx;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched). `vec`
// selects 16-byte loads on wide rows (n % 4 == 0, aligned pointers).
extern "C" int logmem_admit_launch(const float* scores, const int32_t* ids,
                                   const float* tau, int8_t* mask,
                                   int32_t* acounts, int32_t* lcounts,
                                   float* tmax, int64_t m, int n, int bn,
                                   int tiles, int vec, cudaStream_t stream) {
  if (n <= kNarrow && tiles == 1) {
    const int64_t blocks = (m + kThreads - 1) / kThreads;
    admit_narrow<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
        scores, ids, tau, mask, acounts, lcounts, tmax, m, n);
  } else {
    const int64_t threads = m * tiles * 32;
    const auto blocks =
        static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
    if (vec) {
      admit_wide<true><<<blocks, kThreads, 0, stream>>>(
          scores, ids, tau, mask, acounts, lcounts, tmax, m, n, bn, tiles);
    } else {
      admit_wide<false><<<blocks, kThreads, 0, stream>>>(
          scores, ids, tau, mask, acounts, lcounts, tmax, m, n, bn, tiles);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
