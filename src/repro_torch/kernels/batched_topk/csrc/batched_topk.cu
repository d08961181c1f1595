// Fleet bar scan for the multi-tenant top-K engine, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `batched_topk_pallas`
// (src/repro/kernels/batched_topk/batched_topk.py:32). For scores (M, N)
// f32 against one bar per stream (M,) it writes the survivor mask
// `s > bar` (M, N) int8 and, per (stream, tile) of `bn` columns, the
// survivor count (int32) and the tile maximum (f32).
//
// The reference pads every row to a multiple of `bn` with the finite
// NEG_BIG = -1e30 in device memory and scans the padded copy: pad columns
// enter each tile's max, and they are counted wherever the bar is below
// NEG_BIG (an unfull reservoir, bar = -inf). This kernel reads only the
// real columns and adds the pad columns of the last tile arithmetically,
// so no padded copy exists. At the engine's width N = 16 the reference's
// padded copy is 8x the real scores.
//
// Bound on this card: bytes. It reads 4MN + 4M bytes and writes
// MN + 8M*tiles bytes with one compare per score, far below the card's
// compute rate. Design against that bound, with no atomics (results do
// not depend on scheduling):
// - rows of at most 32 scores (the engine's chunks; one tile per row):
//   one thread per row, so a warp covers 32 rows and no cross-lane
//   reduction is needed; the row's scores stay in L1 between the
//   thread's loads, so each byte comes from device memory once;
// - wider rows: one warp per (stream, tile), neighbouring lanes on
//   neighbouring scores (coalesced), count and max reduced by shuffles.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegBig = -1e30f;  // the reference's NEG_BIG as float32
constexpr int kThreads = 256;
constexpr int kNarrow = 32;  // widest row scanned by a single thread

// max that propagates NaN, like jnp.max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// the NEG_BIG columns that pad a tile of `real` columns to `bn`
__device__ __forceinline__ void add_pad(int real, int bn, float bar,
                                        int& cnt, float& mx) {
  const int pad = bn - real;
  if (pad > 0) {
    if (kNegBig > bar) cnt += pad;
    mx = nan_max(mx, kNegBig);
  }
}

// n <= kNarrow and n <= bn: one tile per row, one thread per row
__global__ void scan_narrow(const float* __restrict__ scores,
                            const float* __restrict__ bars,
                            int8_t* __restrict__ mask,
                            int32_t* __restrict__ counts,
                            float* __restrict__ tmax, int64_t m, int n,
                            int bn) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= m) return;
  const float bar = bars[row];
  const float* srow = scores + row * n;
  int8_t* mrow = mask + row * n;
  int cnt = 0;
  float mx = -INFINITY;
  for (int c = 0; c < n; ++c) {
    const float s = srow[c];
    const bool hit = s > bar;
    mrow[c] = hit ? 1 : 0;
    cnt += hit ? 1 : 0;
    mx = nan_max(mx, s);
  }
  add_pad(n, bn, bar, cnt, mx);
  counts[row] = cnt;
  tmax[row] = mx;
}

// one warp per (stream, tile)
__global__ void scan_wide(const float* __restrict__ scores,
                          const float* __restrict__ bars,
                          int8_t* __restrict__ mask,
                          int32_t* __restrict__ counts,
                          float* __restrict__ tmax, int64_t m, int n,
                          int bn, int tiles) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= m * tiles) return;  // uniform across the warp
  const int64_t row = warp / tiles;
  const int tile = static_cast<int>(warp - row * tiles);
  const float bar = bars[row];
  const int c0 = tile * bn;
  const int c1 = min(c0 + bn, n);
  const float* srow = scores + row * n;
  int8_t* mrow = mask + row * n;
  int cnt = 0;
  float mx = -INFINITY;
  for (int c = c0 + lane; c < c1; c += 32) {
    const float s = srow[c];
    const bool hit = s > bar;
    mrow[c] = hit ? 1 : 0;
    cnt += hit ? 1 : 0;
    mx = nan_max(mx, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if (lane == 0) {
    add_pad(c1 - c0, bn, bar, cnt, mx);
    counts[warp] = cnt;
    tmax[warp] = mx;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int batched_topk_launch(const float* scores, const float* bars,
                                   int8_t* mask, int32_t* counts, float* tmax,
                                   int64_t m, int n, int bn, int tiles,
                                   cudaStream_t stream) {
  if (n <= kNarrow && tiles == 1) {
    const int64_t blocks = (m + kThreads - 1) / kThreads;
    scan_narrow<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
        scores, bars, mask, counts, tmax, m, n, bn);
  } else {
    const int64_t threads = m * tiles * 32;
    const int64_t blocks = (threads + kThreads - 1) / kThreads;
    scan_wide<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
        scores, bars, mask, counts, tmax, m, n, bn, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
