// Logmem admission scan for the O(log K) reservoir backend, written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `logmem_admit_pallas`
// (src/repro/kernels/logmem_update/logmem_update.py:40). For scores
// (M, N) f32 and ids (M, N) i32 (id < 0 is padding) against one
// acceptance threshold per stream tau (M,) it writes the admit mask
// `id >= 0 && s > tau` (M, N) int8 and, per (stream, tile) of `bn`
// columns, the admit count and the live count (int32) and the live
// maximum (f32, NaN if a live score is NaN, -inf on a tile without a live
// entry).
//
// The reference pads every row to a multiple of `bn` with id -1 in
// device memory. Pad columns are inert in every output, even under
// tau = -inf, so this kernel reads only the real columns and adds
// nothing for the pad: no padded copy exists.
//
// Bound on this card: bytes. It reads 8MN + 4M bytes and writes
// MN + 12M*tiles bytes with two compares per entry, far below the card's
// compute rate. At the mixed fleet's chunk (64 x 8,192) that is 4.7 MB,
// 0.0014 ms at 3.35 TB/s, and what costs is latency: a warp a tile
// would be 1,024 warps in 128 blocks, one block an SM, each lane walking
// its four 16-byte chunks in a loop whose trip count is known only at
// run time, so waiting for up to four memory round trips in a row.
// Design against that, with no atomics: integer sums and a max taken
// over order-preserving ints do not depend on the order of the
// reduction, so the outputs do not depend on scheduling and equal the
// plain version's (a NaN max is the canonical NaN; a tile whose largest
// live scores are -0.0 and +0.0 gives +0.0, as jnp.max does, where
// torch.amax may give either). `ops.launch_plan` picks the kernel from
// the shape and the alignment and the launcher refuses a pick the inputs
// do not allow:
// - admit_vec, rows of N = 4j entries from 16-byte aligned bases: a
//   block of 128 threads per (stream, tile), one float4 of scores and one
//   int4 of ids a thread (a tile is at most 512 columns) and a 4-byte
//   store of its 4 mask bytes. Every load of a thread is issued before
//   its first compare, and at 64 x 8,192 the 1,024 blocks (~7.75 an SM)
//   put the whole chunk in flight at once. Counts and the max (as
//   order-preserving ints, NaN above +inf) are reduced in each warp by
//   one `redux.sync` each, then across the 4 warps through shared
//   memory;
// - admit_tile, other rows wider than 32 (N % 4 != 0, or a base off
//   16-byte alignment): the same block a tile with up to 4 scalar loads
//   of each a thread, 128 apart, all issued before the first compare;
// - admit_narrow, rows of at most 32 entries: one thread per row, so a
//   warp covers 32 rows and no cross-lane reduction is needed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNarrowThreads = 256;
constexpr int kNarrow = 32;        // widest row scanned by a single thread
constexpr int kTileThreads = 128;  // threads of a block a tile
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kPerThread = 4;      // entries a thread of a block a tile

// the kernel ids of `ops.launch_plan`
enum Kernel { kAdmitNarrow = 0, kAdmitTile = 1, kAdmitVec = 2 };

// a float as an int of the same order, NaN above +inf (so +0.0 ranks
// above -0.0, as jnp.max gives), and back; a warp takes the max of these
// in one redux.sync
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return isnan(f) ? 0x7fffffff : (i >= 0 ? i : i ^ 0x7fffffff);
}
__device__ __forceinline__ float from_ordered(int k) {
  return k == 0x7fffffff ? __int_as_float(0x7fc00000)
                         : __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// one entry: folds it into the counts and the ordered max, returns its
// mask
__device__ __forceinline__ signed char scan_one(float s, int id, float tau,
                                                int& acnt, int& lcnt,
                                                int& mx) {
  const bool live = id >= 0;
  const bool hit = live && s > tau;
  acnt += hit ? 1 : 0;
  lcnt += live ? 1 : 0;
  if (live) mx = max(mx, ordered(s));
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
  int acnt = 0, lcnt = 0, mx = ordered(-INFINITY);
  for (int c = 0; c < n; ++c) {
    mask[row * n + c] =
        scan_one(scores[row * n + c], ids[row * n + c], t, acnt, lcnt, mx);
  }
  acounts[row] = acnt;
  lcounts[row] = lcnt;
  tmax[row] = from_ordered(mx);
}

// block `blockIdx.x` = (stream, tile) of kTileThreads threads; VEC: one
// float4 and one int4 a thread (n % 4 == 0, 16-byte aligned rows), else
// kPerThread scalars a thread, kTileThreads apart. bn <= 4 * kTileThreads
// and m * tiles < 2^31 (checked by the launcher), so the block's row is a
// 32-bit division: a 64-bit one delayed every load measurably.
template <bool VEC>
__device__ __forceinline__ void admit_block(
    const float* __restrict__ scores, const int32_t* __restrict__ ids,
    const float* __restrict__ tau, int8_t* __restrict__ mask,
    int32_t* __restrict__ acounts, int32_t* __restrict__ lcounts,
    float* __restrict__ tmax, int n, int bn, int tiles) {
  __shared__ int s_acnt[kTileWarps], s_lcnt[kTileWarps], s_mx[kTileWarps];
  const unsigned blk = blockIdx.x;
  const unsigned r = blk / static_cast<unsigned>(tiles);
  const int c0 = static_cast<int>(blk - r * tiles) * bn;
  const int c1 = min(c0 + bn, n);
  const int64_t row = r;
  const float* srow = scores + row * n;
  const int32_t* irow = ids + row * n;
  int8_t* mrow = mask + row * n;
  const float t = tau[row];
  int acnt = 0, lcnt = 0, mx = ordered(-INFINITY);
  if (VEC) {
    const int c = c0 + 4 * static_cast<int>(threadIdx.x);
    if (c < c1) {
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
    float s[kPerThread];
    int id[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {  // every load before any compare
      const int c = c0 + static_cast<int>(threadIdx.x) + j * kTileThreads;
      s[j] = c < c1 ? srow[c] : 0.0f;
      id[j] = c < c1 ? irow[c] : -1;  // past the tile: inert, not stored
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int c = c0 + static_cast<int>(threadIdx.x) + j * kTileThreads;
      const signed char hit = scan_one(s[j], id[j], t, acnt, lcnt, mx);
      if (c < c1) mrow[c] = hit;
    }
  }
  acnt = __reduce_add_sync(0xffffffffu, acnt);
  lcnt = __reduce_add_sync(0xffffffffu, lcnt);
  mx = __reduce_max_sync(0xffffffffu, mx);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_acnt[warp] = acnt;
    s_lcnt[warp] = lcnt;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kTileWarps; ++w) {
      acnt += s_acnt[w];
      lcnt += s_lcnt[w];
      mx = max(mx, s_mx[w]);
    }
    acounts[blk] = acnt;
    lcounts[blk] = lcnt;
    tmax[blk] = from_ordered(mx);
  }
}

__global__ void __launch_bounds__(kTileThreads)
    admit_vec(const float* __restrict__ scores,
              const int32_t* __restrict__ ids, const float* __restrict__ tau,
              int8_t* __restrict__ mask, int32_t* __restrict__ acounts,
              int32_t* __restrict__ lcounts, float* __restrict__ tmax,
              int n, int bn, int tiles) {
  admit_block<true>(scores, ids, tau, mask, acounts, lcounts, tmax, n, bn,
                    tiles);
}

__global__ void __launch_bounds__(kTileThreads)
    admit_tile(const float* __restrict__ scores,
               const int32_t* __restrict__ ids, const float* __restrict__ tau,
               int8_t* __restrict__ mask, int32_t* __restrict__ acounts,
               int32_t* __restrict__ lcounts, float* __restrict__ tmax,
               int n, int bn, int tiles) {
  admit_block<false>(scores, ids, tau, mask, acounts, lcounts, tmax, n, bn,
                     tiles);
}

}  // namespace

// Launches `kernel` (an id of `ops.launch_plan`) with `threads` a block on
// `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue, launching nothing, when the shape, the block or
// the alignment does not allow that kernel.
extern "C" int logmem_admit_launch(const float* scores, const int32_t* ids,
                                   const float* tau, int8_t* mask,
                                   int32_t* acounts, int32_t* lcounts,
                                   float* tmax, int64_t m, int n, int bn,
                                   int tiles, int kernel, int threads,
                                   cudaStream_t stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (kernel == kAdmitNarrow) {
    if (n > kNarrow || tiles != 1 || threads != kNarrowThreads) return bad;
    const auto blocks = static_cast<unsigned int>(
        (m + kNarrowThreads - 1) / kNarrowThreads);
    admit_narrow<<<blocks, kNarrowThreads, 0, stream>>>(
        scores, ids, tau, mask, acounts, lcounts, tmax, m, n);
  } else if (kernel == kAdmitTile || kernel == kAdmitVec) {
    const int64_t blocks = m * tiles;
    if (threads != kTileThreads || bn > kPerThread * kTileThreads ||
        blocks > 0x7fffffff || static_cast<int64_t>(bn) * tiles < n)
      return bad;
    if (kernel == kAdmitVec) {
      const bool aligned = reinterpret_cast<uintptr_t>(scores) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(mask) % 4 == 0;
      if (!aligned || n % 4 != 0 || bn % 4 != 0) return bad;
      admit_vec<<<static_cast<unsigned int>(blocks), kTileThreads, 0,
                  stream>>>(scores, ids, tau, mask, acounts, lcounts, tmax,
                            n, bn, tiles);
    } else {
      admit_tile<<<static_cast<unsigned int>(blocks), kTileThreads, 0,
                   stream>>>(scores, ids, tau, mask, acounts, lcounts, tmax,
                             n, bn, tiles);
    }
  } else {
    return bad;
  }
  return static_cast<int>(cudaGetLastError());
}
