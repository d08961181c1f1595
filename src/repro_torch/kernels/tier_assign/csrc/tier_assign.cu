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
// order, so here a whole stream row belongs to one thread or one warp,
// which keeps the per-tier counts in registers — no atomics, so the counts
// do not depend on scheduling.
//
// Bound on this card: bytes. It reads 4MK + 4MB + 4M bytes and writes
// 4MK + 4MT bytes with B + T integer compares per id. Design against it:
// - rows of at most 32 ids (the engine's reservoirs): one thread per
//   row, so a warp covers 32 rows with no cross-lane reduction; the row's
//   ids stay in L1 between the thread's loads;
// - wider rows: one warp per row, lanes striding over the ids
//   (coalesced), per-tier counts reduced by shuffles.
// Each thread loads its row's boundaries once into registers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTiers = 8;  // the planner's MAX_TIERS
constexpr int kThreads = 256;
constexpr int kNarrow = 32;  // widest row handled by a single thread

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

  // tier of one id (-1 for padding); counts it into cnt
  __device__ __forceinline__ int assign(int32_t id, int (&cnt)[kMaxTiers])
      const {
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
};

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

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// Needs 1 <= nt <= 8 and 0 <= nb <= 7 (checked by the Python wrapper).
extern "C" int tier_assign_launch(const int32_t* ids, const int32_t* bounds,
                                  const int32_t* floors, int32_t* tiers,
                                  int32_t* counts, int64_t m, int k, int nb,
                                  int nt, cudaStream_t stream) {
  const int64_t threads = k <= kNarrow ? m : m * 32;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  if (k <= kNarrow) {
    assign_narrow<<<blocks, kThreads, 0, stream>>>(ids, bounds, floors, tiers,
                                                  counts, m, k, nb, nt);
  } else {
    assign_wide<<<blocks, kThreads, 0, stream>>>(ids, bounds, floors, tiers,
                                                counts, m, k, nb, nt);
  }
  return static_cast<int>(cudaGetLastError());
}
