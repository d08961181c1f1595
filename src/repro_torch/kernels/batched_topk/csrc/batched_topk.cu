// Fleet bar scan for the multi-tenant top-K engine, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `batched_topk_pallas`
// (src/repro/kernels/batched_topk/batched_topk.py:32). For scores (M, N)
// f32 against one bar per stream (M,) it writes the survivor mask
// `s > bar` (M, N) int8 and, per (stream, tile) of `bn` columns, the
// survivor count (int32) and the tile maximum (f32, NaN if any score of
// the tile is NaN, and +0.0 if the maximum is zero and the tile holds a
// +0.0, as jnp.max).
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
// compute rate; at the engine's (1,000,000 x 16) that is 92 MB, 0.0275 ms
// at 3.35 TB/s. What costs is the memory instructions, not the bytes.
// With a thread a row, a warp covered 32 rows of 64 bytes: each of its
// 16 scalar loads touched 32 sectors for 4 useful bytes of each, and each
// of its 16 byte stores of the mask wrote 32 partial sectors 16 bytes
// apart, which go to L2 one by one (L1 does not keep writes): 32 memory
// instructions a warp for 32 rows, 1,024 sectors moved for 2.5 KB.
// Design against that, with no atomics: integer sums and a max taken
// over order-preserving ints (NaN above +inf, -0.0 below +0.0) do not
// depend on the order of the reduction, so results do not depend on
// scheduling; `ops.launch_plan` picks the kernel from the shape and the
// alignment and the launcher refuses a pick the inputs do not allow:
// - scan_vec<G>, rows of N = 4G scores (G a power of two up to 32, one
//   tile a row) from a 16-byte aligned base: a group of G lanes a row,
//   one float4 a lane. Consecutive streams' rows are contiguous, so lane
//   i of the grid reads 16-byte chunk i of `scores` and writes 4-byte
//   word i of the mask (its 4 mask bytes packed): at N = 16 a warp takes
//   8 rows with one 512-byte load and one 128-byte store, both fully
//   coalesced: 32 rows take 8 such instructions over 80 sectors where a
//   thread a row took 32 over 1,024. Count and max are reduced over the
//   group with log2 G shuffles; the group's first lane adds the pad
//   columns and writes them (at G = 4 a warp's 8 counts fill one 32-byte
//   sector).
//   No staging in shared memory: a lane's chunk is already the
//   coalesced unit, so staging would only add a copy and a barrier;
// - scan_narrow, other rows of at most 32 scores (N = 7 or 12, or a base
//   off 16-byte alignment): one thread a row, scalar loads, as before;
// - scan_wide, wider rows: one warp per (stream, tile), neighbouring
//   lanes on neighbouring scores (coalesced 4-byte loads), count and max
//   reduced by one `redux.sync` each.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegBig = -1e30f;  // the reference's NEG_BIG as float32
constexpr int kThreads = 256;
constexpr int kNarrow = 32;  // widest row scanned by a single thread

// the kernel ids of `ops.launch_plan`
enum Kernel { kScanNarrow = 0, kScanWide = 1, kScanVec = 2 };

// a float as an int of the same order, NaN above +inf (so a NaN max
// propagates and +0.0 ranks above -0.0, as jnp.max gives), and back
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return isnan(f) ? 0x7fffffff : (i >= 0 ? i : i ^ 0x7fffffff);
}
__device__ __forceinline__ float from_ordered(int k) {
  return k == 0x7fffffff ? __int_as_float(0x7fc00000)
                         : __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// the NEG_BIG columns that pad a tile of `real` columns to `bn`
__device__ __forceinline__ void add_pad(int real, int bn, float bar,
                                        int& cnt, int& mx) {
  const int pad = bn - real;
  if (pad > 0) {
    if (kNegBig > bar) cnt += pad;
    mx = max(mx, ordered(kNegBig));
  }
}

// n = 4G <= bn: a group of G lanes a row, one float4 a lane; chunk i of
// the scores is lane i of the grid
template <int G>
__global__ void scan_vec(const float4* __restrict__ scores,
                         const float* __restrict__ bars,
                         uint32_t* __restrict__ mask,
                         int32_t* __restrict__ counts,
                         float* __restrict__ tmax, int64_t m, int bn) {
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t row = chunk / G;
  // G divides 32, so a group is live or dead as a whole; dead lanes of the
  // last warp still take part in the shuffles
  const bool live = row < m;
  float bar = 0.0f;
  int cnt = 0, mx = ordered(-INFINITY);
  if (live) {
    bar = bars[row];
    const float4 s = scores[chunk];
    const uint32_t h0 = s.x > bar, h1 = s.y > bar, h2 = s.z > bar,
                   h3 = s.w > bar;
    mask[chunk] = h0 | (h1 << 8) | (h2 << 16) | (h3 << 24);
    cnt = static_cast<int>(h0 + h1 + h2 + h3);
    mx = max(max(ordered(s.x), ordered(s.y)),
             max(ordered(s.z), ordered(s.w)));
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if (live && (threadIdx.x & (G - 1)) == 0) {
    add_pad(4 * G, bn, bar, cnt, mx);
    counts[row] = cnt;
    tmax[row] = from_ordered(mx);
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
  int cnt = 0, mx = ordered(-INFINITY);
  for (int c = 0; c < n; ++c) {
    const float s = srow[c];
    const bool hit = s > bar;
    mrow[c] = hit ? 1 : 0;
    cnt += hit ? 1 : 0;
    mx = max(mx, ordered(s));
  }
  add_pad(n, bn, bar, cnt, mx);
  counts[row] = cnt;
  tmax[row] = from_ordered(mx);
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
  int cnt = 0, mx = ordered(-INFINITY);
  for (int c = c0 + lane; c < c1; c += 32) {
    const float s = srow[c];
    const bool hit = s > bar;
    mrow[c] = hit ? 1 : 0;
    cnt += hit ? 1 : 0;
    mx = max(mx, ordered(s));
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) {
    add_pad(c1 - c0, bn, bar, cnt, mx);
    counts[warp] = cnt;
    tmax[warp] = from_ordered(mx);
  }
}

unsigned int blocks_for(int64_t threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

template <int G>
void launch_vec(const float* scores, const float* bars, int8_t* mask,
                int32_t* counts, float* tmax, int64_t m, int bn,
                cudaStream_t stream) {
  scan_vec<G><<<blocks_for(m * G), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(scores), bars,
      reinterpret_cast<uint32_t*>(mask), counts, tmax, m, bn);
}

}  // namespace

// Launches `kernel` (an id of `ops.launch_plan`; `lanes` a row for
// scan_vec) on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue, launching nothing, when the shape or the
// alignment does not allow that kernel.
extern "C" int batched_topk_launch(const float* scores, const float* bars,
                                   int8_t* mask, int32_t* counts, float* tmax,
                                   int64_t m, int n, int bn, int tiles,
                                   int kernel, int lanes,
                                   cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(scores) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  if (kernel == kScanVec) {
    if (!aligned || tiles != 1 || n != 4 * lanes)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (lanes) {
      case 1: launch_vec<1>(scores, bars, mask, counts, tmax, m, bn, stream);
        break;
      case 2: launch_vec<2>(scores, bars, mask, counts, tmax, m, bn, stream);
        break;
      case 4: launch_vec<4>(scores, bars, mask, counts, tmax, m, bn, stream);
        break;
      case 8: launch_vec<8>(scores, bars, mask, counts, tmax, m, bn, stream);
        break;
      case 16: launch_vec<16>(scores, bars, mask, counts, tmax, m, bn,
                              stream);
        break;
      case 32: launch_vec<32>(scores, bars, mask, counts, tmax, m, bn,
                              stream);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (kernel == kScanNarrow) {
    if (n > kNarrow || tiles != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    scan_narrow<<<blocks_for(m), kThreads, 0, stream>>>(
        scores, bars, mask, counts, tmax, m, n, bn);
  } else if (kernel == kScanWide) {
    scan_wide<<<blocks_for(m * tiles * 32), kThreads, 0, stream>>>(
        scores, bars, mask, counts, tmax, m, n, bn, tiles);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
