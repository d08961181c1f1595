// Finalize-time tier assignment of survivor ids, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `tier_assign_pallas`
// (src/repro/kernels/tier_assign/tier_assign.py:47). For survivor ids
// (M, K) int32 (-1 = padding), integer boundaries (M, B) int32 (ceil of
// the float boundary, INT32_MAX for +inf) and cascade floors (M,) int32:
// tier = number of boundaries <= id, raised to the floor, capped at T-1,
// and -1 for padding; plus each stream's survivor count per tier (M, T).
//
// On the TPU the per-tier counts are carried across the sequential grid
// axis over K tiles (tier_assign.py:39-44). Hopper blocks run in no
// order, so here a whole stream row belongs to one lane group, one
// thread or one warp, which keeps the per-tier counts in registers — no
// atomics, so the counts do not depend on scheduling.
//
// Bound on this card: bytes. It reads 4MK + 4MB + 4M bytes and writes
// 4MK + 4MT bytes with B + T integer compares per id; at the engine's
// K = 8, B = 2, T = 3 and 1,000,000 streams that is 88 MB, 0.0263 ms at
// 3.35 TB/s. What costs is the memory instructions. With a thread a row,
// a warp covered 32 rows of 32 bytes: 8 scalar loads of ids 32 bytes
// apart, 8 scalar stores of tiers 32 bytes apart (each of them 32 partial
// sectors, which L1 does not merge), 2 loads of bounds 8 bytes apart and
// 3 stores of counts 12 bytes apart: 22 memory instructions a warp for
// 32 rows, some 570 sectors for the 2.3 KB they carry. Design against
// that; `ops.launch_plan` picks the kernel from the shape and the
// alignment and the launcher refuses a pick the inputs do not allow:
// - assign_vec<G>, rows of K = 4G ids (G a power of two up to 32) from a
//   16-byte aligned base: a group of G lanes a row, one int4 of ids a
//   lane in, one int4 of tiers out. Consecutive streams' rows are
//   contiguous, so lane i of the grid reads and writes 16-byte chunk i:
//   at K = 8 a warp takes 16 rows with one 512-byte load and one
//   512-byte store. The row's B bounds are read once for the group, bound
//   b by lane b mod G (at G = 2, B = 2 one 128-byte load a warp), and
//   handed round by shuffles; the per-tier counts are reduced over the
//   group by shuffles, and tier t is written by lane t mod G, G tiers a
//   store. So 32 rows take 12 memory instructions over some 105 sectors.
//   No staging in shared memory: a lane's chunk is already the coalesced
//   unit, so staging would only add a copy and a barrier;
// - assign_narrow, other rows of at most 32 ids (K = 5 or 6, or a base
//   off 16-byte alignment): one thread a row, scalar loads, as before;
// - assign_wide, wider rows: one warp per row, lanes striding over the
//   ids (coalesced), per-tier counts reduced by shuffles.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTiers = 8;  // the planner's MAX_TIERS
constexpr int kThreads = 256;
constexpr int kNarrow = 32;  // widest row handled by a single thread

// the kernel ids of `ops.launch_plan`
enum Kernel { kAssignNarrow = 0, kAssignWide = 1, kAssignVec = 2 };

// tier of one id (-1 for padding) against the first `nb` bounds; counts
// it into cnt
__device__ __forceinline__ int assign_one(int32_t id,
                                          const int32_t (&bnd)[kMaxTiers - 1],
                                          int nb, int floor_tier, int nt,
                                          int (&cnt)[kMaxTiers]) {
  if (id < 0) return -1;
  int tier = 0;
#pragma unroll
  for (int b = 0; b < kMaxTiers - 1; ++b)
    tier += (b < nb && id >= bnd[b]) ? 1 : 0;
  tier = min(max(tier, floor_tier), nt - 1);
#pragma unroll
  for (int t = 0; t < kMaxTiers; ++t) cnt[t] += tier == t ? 1 : 0;
  return tier;
}

struct Row {
  int32_t bnd[kMaxTiers - 1];
  int32_t floor_tier;
  int nb, nt;

  __device__ Row(const int32_t* bounds, const int32_t* floors, int64_t row,
                 int nb_, int nt_)
      : floor_tier(floors[row]), nb(nb_), nt(nt_) {
#pragma unroll
    for (int b = 0; b < kMaxTiers - 1; ++b)
      bnd[b] = b < nb ? bounds[row * nb + b] : INT32_MAX;
  }

  __device__ __forceinline__ int assign(int32_t id, int (&cnt)[kMaxTiers])
      const {
    return assign_one(id, bnd, nb, floor_tier, nt, cnt);
  }
};

// k = 4G: a group of G lanes a row, one int4 of ids and of tiers a lane;
// chunk i of the ids is lane i of the grid
template <int G>
__global__ void assign_vec(const int4* __restrict__ ids,
                           const int32_t* __restrict__ bounds,
                           const int32_t* __restrict__ floors,
                           int4* __restrict__ tiers,
                           int32_t* __restrict__ counts, int64_t m, int nb,
                           int nt) {
  constexpr int kRounds = (kMaxTiers - 1 + G - 1) / G;  // bounds a lane
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t row = chunk / G;
  const int j = threadIdx.x & (G - 1);  // the lane's place in its group
  const int first = threadIdx.x & 31 & ~(G - 1);  // the group's lane 0
  // G divides 32, so a group is live or dead as a whole; dead lanes of the
  // last warp still take part in the shuffles
  const bool live = row < m;
  int32_t own[kRounds];  // bound r * G + j of the row
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int b = r * G + j;
    own[r] = live && b < nb ? bounds[row * nb + b] : INT32_MAX;
  }
  int32_t bnd[kMaxTiers - 1];
#pragma unroll
  for (int b = 0; b < kMaxTiers - 1; ++b) {
    if constexpr (G == 1)
      bnd[b] = own[b];
    else
      bnd[b] = __shfl_sync(0xffffffffu, own[b / G], first | (b % G));
  }
  int cnt[kMaxTiers] = {};
  if (live) {
    const int floor_tier = floors[row];
    const int4 v = ids[chunk];
    int4 t;
    t.x = assign_one(v.x, bnd, nb, floor_tier, nt, cnt);
    t.y = assign_one(v.y, bnd, nb, floor_tier, nt, cnt);
    t.z = assign_one(v.z, bnd, nb, floor_tier, nt, cnt);
    t.w = assign_one(v.w, bnd, nb, floor_tier, nt, cnt);
    tiers[chunk] = t;
  }
#pragma unroll
  for (int t = 0; t < kMaxTiers; ++t) {
    if (t < nt) {  // uniform across the warp
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        cnt[t] += __shfl_xor_sync(0xffffffffu, cnt[t], off);
    }
  }
  if (live) {  // round r: lane j of the group writes tier r * G + j
#pragma unroll
    for (int r = 0; r * G < kMaxTiers; ++r) {
      const int t = r * G + j;
      int v = 0;
#pragma unroll
      for (int u = r * G; u < r * G + G && u < kMaxTiers; ++u)
        v = u == t ? cnt[u] : v;
      if (t < nt) counts[row * nt + t] = v;
    }
  }
}

// k <= kNarrow: one thread per row
__global__ void assign_narrow(const int32_t* __restrict__ ids,
                              const int32_t* __restrict__ bounds,
                              const int32_t* __restrict__ floors,
                              int32_t* __restrict__ tiers,
                              int32_t* __restrict__ counts, int64_t m, int k,
                              int nb, int nt) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= m) return;
  const Row r(bounds, floors, row, nb, nt);
  int cnt[kMaxTiers] = {};
  for (int c = 0; c < k; ++c)
    tiers[row * k + c] = r.assign(ids[row * k + c], cnt);
#pragma unroll
  for (int t = 0; t < kMaxTiers; ++t)
    if (t < nt) counts[row * nt + t] = cnt[t];
}

// one warp per row
__global__ void assign_wide(const int32_t* __restrict__ ids,
                            const int32_t* __restrict__ bounds,
                            const int32_t* __restrict__ floors,
                            int32_t* __restrict__ tiers,
                            int32_t* __restrict__ counts, int64_t m, int k,
                            int nb, int nt) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;  // uniform across the warp
  const Row r(bounds, floors, row, nb, nt);
  int cnt[kMaxTiers] = {};
  for (int c = lane; c < k; c += 32)
    tiers[row * k + c] = r.assign(ids[row * k + c], cnt);
#pragma unroll
  for (int t = 0; t < kMaxTiers; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt[t] += __shfl_xor_sync(0xffffffffu, cnt[t], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kMaxTiers; ++t)
      if (t < nt) counts[row * nt + t] = cnt[t];
  }
}

unsigned int blocks_for(int64_t threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

template <int G>
void launch_vec(const int32_t* ids, const int32_t* bounds,
                const int32_t* floors, int32_t* tiers, int32_t* counts,
                int64_t m, int nb, int nt, cudaStream_t stream) {
  assign_vec<G><<<blocks_for(m * G), kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(ids), bounds, floors,
      reinterpret_cast<int4*>(tiers), counts, m, nb, nt);
}

}  // namespace

// Launches `kernel` (an id of `ops.launch_plan`; `lanes` a row for
// assign_vec) on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue, launching nothing, when the shape or the
// alignment does not allow that kernel.
// Needs 1 <= nt <= 8 and 0 <= nb <= 7 (checked by the Python wrapper).
extern "C" int tier_assign_launch(const int32_t* ids, const int32_t* bounds,
                                  const int32_t* floors, int32_t* tiers,
                                  int32_t* counts, int64_t m, int k, int nb,
                                  int nt, int kernel, int lanes,
                                  cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(tiers) % 16 == 0;
  if (kernel == kAssignVec) {
    if (!aligned || k != 4 * lanes)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (lanes) {
      case 1: launch_vec<1>(ids, bounds, floors, tiers, counts, m, nb, nt,
                            stream);
        break;
      case 2: launch_vec<2>(ids, bounds, floors, tiers, counts, m, nb, nt,
                            stream);
        break;
      case 4: launch_vec<4>(ids, bounds, floors, tiers, counts, m, nb, nt,
                            stream);
        break;
      case 8: launch_vec<8>(ids, bounds, floors, tiers, counts, m, nb, nt,
                            stream);
        break;
      case 16: launch_vec<16>(ids, bounds, floors, tiers, counts, m, nb, nt,
                              stream);
        break;
      case 32: launch_vec<32>(ids, bounds, floors, tiers, counts, m, nb, nt,
                              stream);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (kernel == kAssignNarrow) {
    if (k > kNarrow) return static_cast<int>(cudaErrorInvalidValue);
    assign_narrow<<<blocks_for(m), kThreads, 0, stream>>>(
        ids, bounds, floors, tiers, counts, m, k, nb, nt);
  } else if (kernel == kAssignWide) {
    assign_wide<<<blocks_for(m * 32), kThreads, 0, stream>>>(
        ids, bounds, floors, tiers, counts, m, k, nb, nt);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
