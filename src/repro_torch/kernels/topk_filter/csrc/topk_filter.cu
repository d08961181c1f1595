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
// N + 8*tiles bytes with one compare per score: at the single-stream
// path's batch of 2^20 scores that is 5.2 MB, 0.0016 ms at 3.35 TB/s.
// What costs at that size is latency: the batch is read once, long after
// it was written, so every load goes to device memory, and a thread that
// waits for one load before it issues the next pays a round trip per
// load. filter_vec issues all of a thread's loads, and the threshold's,
// before its first compare. What is left is not in the kernel's hands:
// on an H100 (700 W) one tile of 4,096 takes 0.0016 ms with its bytes in
// L2, a floor every launch pays; and with the L2 full of other kernels'
// dirty lines, as the caller leaves it, each line this kernel brings in
// first writes one back: 0.0044 ms at 2^20 against 0.0035 with a clean
// L2. Design against the latency, with no atomics (integer sums, and a max
// over order-preserving ints, do not depend on the order of the
// reduction, so the outputs do not depend on scheduling; a tile whose
// maximum is zero gives +0.0 if it holds a +0.0, as jnp.max does).
// `ops.launch_plan` picks the kernel from the width and the alignment,
// and the launcher refuses a pick the inputs do not allow:
// - filter_vec, N % 4 == 0 from a 16-byte aligned base: a block of 512
//   threads a tile of up to 4,096 scores, two float4 loads a thread, both
//   issued (with the threshold's) before the first compare; a warp's
//   loads of one round are 512 contiguous bytes. Each float4 gives a
//   4-byte store of its 4 mask bytes. Chunks past a partial last tile are
//   predicated off, so the trip count is a compile-time constant. Count
//   and max are reduced in each warp by one `redux.sync` each, then across
//   the warps through shared memory by warp 0. Of the layouts timed on
//   the card (PERF.md), 512 threads a tile tied or beat 256 (four float4 a
//   thread), 1,024 (one: at 2^26 its two blocks an SM keep too few bytes
//   in flight) and the loop of float4 loads it replaced;
// - filter_tile, the general kernel (N % 4 != 0, or a base off 16-byte
//   alignment): a block of 256 threads a tile, scalar loads in a loop.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegBig = -1e30f;  // the reference's NEG_BIG as float32
constexpr int kTileThreads = 256;  // threads of filter_tile
constexpr int kVecThreads = 512;   // threads of filter_vec
constexpr int kMaxTile = 4096;     // the widest tile (ops.tile_width)

// the kernel ids of `ops.launch_plan`
enum Kernel { kFilterTile = 0, kFilterVec = 1 };

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

// one score: NaN demoted to NEG_BIG, folded into the tile's count and
// ordered max; returns its mask
__device__ __forceinline__ uint32_t scan_one(float s, float thr, int& cnt,
                                             int& mx) {
  s = isnan(s) ? kNegBig : s;
  const bool hit = s > thr;
  cnt += hit ? 1 : 0;
  mx = max(mx, ordered(s));
  return hit ? 1u : 0u;
}

// four scores; returns their 4 mask bytes packed in one word
__device__ __forceinline__ uint32_t scan_four(float4 s, float thr, int& cnt,
                                              int& mx) {
  const uint32_t h0 = scan_one(s.x, thr, cnt, mx);
  const uint32_t h1 = scan_one(s.y, thr, cnt, mx);
  const uint32_t h2 = scan_one(s.z, thr, cnt, mx);
  const uint32_t h3 = scan_one(s.w, thr, cnt, mx);
  return h0 | h1 << 8 | h2 << 16 | h3 << 24;
}

// the block's count and ordered max: one redux.sync each in every warp,
// then warp 0 over the warps' partials; thread 0 adds the NEG_BIG columns
// that pad the tile to `bn` and writes the tile's outputs
template <int THREADS>
__device__ __forceinline__ void finish_tile(int cnt, int mx, int real,
                                            int bn, float thr, int tile,
                                            int32_t* __restrict__ counts,
                                            float* __restrict__ tmax) {
  constexpr int kWarps = THREADS / 32;
  __shared__ int s_cnt[kWarps], s_mx[kWarps];
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  mx = __reduce_max_sync(0xffffffffu, mx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    cnt = __reduce_add_sync(0xffffffffu, lane < kWarps ? s_cnt[lane] : 0);
    mx = __reduce_max_sync(0xffffffffu,
                           lane < kWarps ? s_mx[lane] : ordered(-INFINITY));
    if (lane == 0) {
      if (real < bn) {
        if (kNegBig > thr) cnt += bn - real;
        mx = max(mx, ordered(kNegBig));
      }
      counts[tile] = cnt;
      tmax[tile] = from_ordered(mx);
    }
  }
}

// block `blockIdx.x` = one tile of `bn` <= kMaxTile columns (bn % 4 == 0);
// n % 4 == 0 and 16-byte aligned scores (checked by the launcher)
__global__ void __launch_bounds__(kVecThreads)
    filter_vec(const float4* __restrict__ scores,
               const float* __restrict__ thr_ptr,
               uint32_t* __restrict__ mask, int32_t* __restrict__ counts,
               float* __restrict__ tmax, int64_t n, int bn) {
  constexpr int kPer = kMaxTile / 4 / kVecThreads;  // float4 a thread
  const int tile = blockIdx.x;
  const int64_t q0 = static_cast<int64_t>(tile) * (bn / 4);
  const int64_t left = n / 4 - q0;
  const int len = left < bn / 4 ? static_cast<int>(left) : bn / 4;
  const float4* src = scores + q0;
  uint32_t* dst = mask + q0;
  float4 s[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {  // every load before any compare
    const int i = threadIdx.x + j * kVecThreads;
    if (i < len) s[j] = src[i];
  }
  const float thr = *thr_ptr;
  int cnt = 0, mx = ordered(-INFINITY);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kVecThreads;
    if (i < len) dst[i] = scan_four(s[j], thr, cnt, mx);
  }
  finish_tile<kVecThreads>(cnt, mx, 4 * len, bn, thr, tile, counts, tmax);
}

// one block of kTileThreads per tile, a loop of scalar loads over the tile
__global__ void __launch_bounds__(kTileThreads)
    filter_tile(const float* __restrict__ scores,
                const float* __restrict__ thr_ptr, int8_t* __restrict__ mask,
                int32_t* __restrict__ counts, float* __restrict__ tmax,
                int64_t n, int bn) {
  const int tile = blockIdx.x;
  const float thr = *thr_ptr;
  const int64_t c0 = static_cast<int64_t>(tile) * bn;
  const int64_t c1 = c0 + bn < n ? c0 + bn : n;
  int cnt = 0, mx = ordered(-INFINITY);
  for (int64_t c = c0 + threadIdx.x; c < c1; c += kTileThreads) {
    mask[c] = static_cast<int8_t>(scan_one(scores[c], thr, cnt, mx));
  }
  finish_tile<kTileThreads>(cnt, mx, static_cast<int>(c1 - c0), bn, thr,
                            tile, counts, tmax);
}

}  // namespace

// Launches `kernel` (an id of `ops.launch_plan`) on `stream`; returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue, launching
// nothing, when the tiling or the alignment does not allow that kernel.
extern "C" int topk_filter_launch(const float* scores, const float* thr,
                                  int8_t* mask, int32_t* counts, float* tmax,
                                  int64_t n, int bn, int tiles, int kernel,
                                  cudaStream_t stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || bn <= 0 || bn > kMaxTile ||
      static_cast<int64_t>(bn) * tiles < n ||
      static_cast<int64_t>(bn) * (tiles - 1) >= n)
    return bad;
  if (kernel == kFilterVec) {
    if (n % 4 != 0 || bn % 4 != 0 ||
        reinterpret_cast<uintptr_t>(scores) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(mask) % 4 != 0)
      return bad;
    filter_vec<<<tiles, kVecThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(scores), thr,
        reinterpret_cast<uint32_t*>(mask), counts, tmax, n, bn);
  } else if (kernel == kFilterTile) {
    filter_tile<<<tiles, kTileThreads, 0, stream>>>(scores, thr, mask,
                                                   counts, tmax, n, bn);
  } else {
    return bad;
  }
  return static_cast<int>(cudaGetLastError());
}
