// The fused plan-solve reduction of the device planner, written by hand
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `plan_solve_pallas`
// (src/repro/kernels/plan_solve/plan_solve.py:81). Per stream m, over S
// stacked tier subsets and the G monotone boundary tuples g of a subset
// (combos (G, J), in itertools.combinations_with_replacement order):
//
//   tot = ((0 + fs[m,s,0,c0]) + fs[m,s,1,c1] + ...) + const[m,s,0] + ...
//
// lifted to +inf when `masked` and the tuple is infeasible (a masked step,
// a violated pairwise lower bound prev < lb*(1-1e-12) - 1e-12, or summed
// latency deltas above rhs + atol); the first minimum over g, then a
// strict running minimum over s, emitted as (val, s*G + g). A subset that
// holds a NaN tuple is skipped whole; a stream whose result is +inf keeps
// the index 0.
//
// On the TPU the terms are expanded onto the tuples with one-hot matmuls
// on the MXU, which forces finite terms (inf * 0) and pads G to 128. Here
// each tuple gathers fs[m, s, j, c_j] directly from shared memory, and no
// padded tuple exists.
//
// What bounds it on this card, and the two mappings (the wrapper picks
// one from G and J, ops.launch_plan):
//
// - plan_solve_rows, G < 64 and J <= 3 (the 3-tier planner's G in {4, 6,
//   21, 36} at up to millions of streams): bytes, a few adds per element
//   read. A stream's rows are S*J*C values, so a thread per stream
//   reading global memory makes a warp's loads land S*J*C*sizeof(T)
//   bytes apart and gathers the masked grids once per tuple from there.
//   So the streams go in tiles (~16 KB of rows), whose rows are one
//   contiguous span in every input; each block walks its tiles and copies
//   the next one into its second buffer by coalesced cp.async while it
//   solves the current one. A thread takes a stream and walks its tuples
//   as J nested loops c0 <= c1 <= c2 (the table's order), carrying each
//   step's partial sum, mask and deltas from the loop above, so a tuple
//   costs one gather per input, not J, and no table. At these shapes the
//   instructions a stream, not the bytes, come close to setting the time,
//   so an input is copied as aligned 16-byte chunks, unpadded, unless
//   more than 4 threads of a warp (one stream each, all at one column)
//   would then read one bank at once; such an input (e.g. S*J*C = 16
//   doubles) is copied element by element to an odd stride of 4- or
//   8-byte words, which spreads a warp's gathers over distinct banks. The
//   mask, bytes, always comes in chunks. The tuples of one stream are not
//   split over lanes: a shuffle reduction costs ~100 instructions a
//   (stream, subset), more than adding up its 4-36 tuples.
// - plan_solve_streams, G >= 64 or J > 3 (the 4-tier planner's G in {78,
//   190, 969, 5456} at thousands of streams): the shared-memory gathers,
//   adds and compares of G tuples a subset (operations, for J = 3). A
//   thread per stream would leave 4,096 streams on 32 blocks of 132 SMs;
//   one block per stream fills the card 31 times over. The stream's rows and
//   the combo table are staged as aligned 16-byte chunks, unpadded (every
//   thread reads the one stream's rows); the threads stride the tuples of
//   each subset in turn, each keeping its first minimum and NaN flag;
//   then a warp-shuffle and a shared-memory reduction pick the winner.
//
// Exactness: a tuple's total is still summed by one thread, in step order
// from zero and then the constants in order; parallelism runs across
// tuples, subsets and streams, never inside one sum. In
// plan_solve_streams the partial minima meet as a lexicographic minimum
// over (value, g) under float < and == (-0.0 ties +0.0, the smaller
// index wins), which is the sequential first minimum, and NaN flags are
// OR-reduced per subset before a subset's minimum meets the others. The
// one multiply-add (the lower-bound slack) is written with
// round-to-nearest intrinsics, so nvcc cannot contract it into an FMA
// that the plain PyTorch version does not make.
//
// A span copied as 16-byte chunks aligned in global memory (the combo
// table, the mask, every input of plan_solve_streams) may have up to 15
// bytes beside it in its first and last chunk; each such chunk also holds
// a byte of the span, so it lies in a mapped page. Those bytes are never
// used.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxConsts = 4;
constexpr int kParts = 7;  // fs, const, cand, mask, lb, deltas, rhs_atol
constexpr int kMask = 3;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

int64_t align16(int64_t x) { return (x + 15) & ~int64_t(15); }

// Elements between two streams' rows in shared memory, for `len`
// elements of 4 or 8 bytes a stream: an odd number, so the threads of a
// warp, one stream each, read distinct banks.
int64_t pad(int64_t len) { return len | 1; }

// Threads of a warp, one stream each, that read one shared-memory bank
// at once when streams lie `len` elements of `size` bytes apart: a load
// of 8 bytes is served a half-warp at a time.
int64_t bank_ways(int64_t len, int size) {
  int64_t a = len, b = size == 8 ? 16 : 32;
  while (b) {
    const int64_t r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// One staged input: `len` elements a stream in global memory, `stride`
// in shared memory, from byte `off` of its buffer on; `chunks` when it is
// copied as the aligned 16-byte chunks that hold its span (unpadded).
struct Part {
  int off, len, stride, chunks;
};

// Where the inputs of a block's streams lie in its dynamic shared memory,
// computed on the host and passed to the kernel: `buffers` buffers of
// `rows` bytes, each holding every staged input, then the combo table,
// then `nres` partial results (value at `res_v`, index at `res_i`).
// ops.py's `_smem_bytes` computes the same total.
struct Layout {
  Part part[kParts];
  int rows, combos, res_v, res_i, total;
};

// `n` streams a buffer; `padded` rows (plan_solve_rows) or chunks
// (plan_solve_streams); `table` bytes of combo table.
Layout layout(int64_t n, int ns, int nj, int nc, int np, int masked,
              int tsize, bool padded, int buffers, int64_t table,
              int64_t nres) {
  const int64_t nlb = nj > 1 ? nj - 1 : 1;
  const int64_t grid = static_cast<int64_t>(ns) * nj * nc;
  const int64_t lens[kParts] = {grid,           static_cast<int64_t>(ns) * np,
                                int64_t(ns) * nc, grid,
                                ns * nlb * nc,  grid,
                                2 * int64_t(ns)};
  Layout l{};
  int64_t off = 0;
  for (int a = 0; a < kParts; ++a) {
    const int size = a == kMask ? 1 : tsize;
    // chunks (16-byte copies, unpadded) unless more than 4 threads of a
    // warp would read one bank at once; the mask always
    const bool chunks =
        !padded || a == kMask || bank_ways(lens[a], size) <= 4;
    const int64_t stride = chunks ? lens[a] : pad(lens[a]);
    l.part[a] = {static_cast<int>(off), static_cast<int>(lens[a]),
                 static_cast<int>(stride), chunks};
    if (a < 2 || masked)
      off += chunks ? align16(n * lens[a] * size) + 16
                    : align16(n * stride * size);
  }
  l.rows = static_cast<int>(off);
  off *= buffers;
  l.combos = static_cast<int>(off);
  off += table ? align16(table) + 16 : 0;
  l.res_v = static_cast<int>(off);
  off += align16(nres * tsize);
  l.res_i = static_cast<int>(off);
  off += align16(nres * 4);
  l.total = off > (1 << 30) ? -1 : static_cast<int>(off);
  return l;
}

template <int E>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(E)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying `n` streams' rows of one input, `p.len` elements of E
// bytes each from `src` on, to `dst` at `p.stride` elements a stream:
// consecutive threads on consecutive elements.
template <int E>
__device__ __forceinline__ void stage_padded(uint8_t* dst, const uint8_t* src,
                                             int n, const Part& p) {
  const int total = n * p.len;
  const int tid = threadIdx.x, step = blockDim.x;
  const int dk = step / p.len, dc = step - dk * p.len;
  int k = tid / p.len, col = tid - k * p.len;
  for (int e = tid; e < total; e += step) {
    cp_async<E>(dst + (k * p.stride + col) * E,
                src + static_cast<int64_t>(e) * E);
    k += dk;
    col += dc;
    if (col >= p.len) {
      col -= p.len;
      ++k;
    }
  }
}

// Byte offset of `src`'s first byte in its aligned 16-byte chunk.
__device__ __forceinline__ int lead(const void* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
}

// Start copying bytes [0, n) of `src` into `dst` (16-byte aligned shared
// memory) as the 16-byte chunks of global memory that hold them; the
// first byte lands at dst + lead(src).
__device__ __forceinline__ void stage_chunks(uint8_t* dst, const void* src,
                                             int64_t n) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const uintptr_t a1 = (reinterpret_cast<uintptr_t>(src) + n + 15) &
                       ~uintptr_t(15);
  for (uintptr_t o = threadIdx.x * 16u; a0 + o < a1; o += blockDim.x * 16u)
    cp_async<16>(dst + o, reinterpret_cast<const void*>(a0 + o));
}

template <typename T>
struct Inputs {
  const T *fs, *cst, *cand;
  const bool* mask;
  const T *lb, *dl, *ra;
  const uint8_t* combos;

  // first byte of input a's rows of stream m0
  __device__ __forceinline__ const uint8_t* from(int a, const Part& p,
                                                 int64_t m0) const {
    const void* base;
    switch (a) {
      case 0: base = fs; break;
      case 1: base = cst; break;
      case 2: base = cand; break;
      case kMask: base = mask; break;
      case 4: base = lb; break;
      case 5: base = dl; break;
      default: base = ra;
    }
    return static_cast<const uint8_t*>(base) +
           m0 * p.len * (a == kMask ? 1 : static_cast<int>(sizeof(T)));
  }
};

// Start copying streams [m0, m0 + n) into the buffer at `buf`.
template <typename T>
__device__ __forceinline__ void stage_tile(uint8_t* buf, const Layout& l,
                                           const Inputs<T>& in, int64_t m0,
                                           int n, int masked) {
#pragma unroll
  for (int a = 0; a < kParts; ++a) {
    if (a >= 2 && !masked) continue;
    const Part& p = l.part[a];
    const uint8_t* src = in.from(a, p, m0);
    if (p.chunks)
      stage_chunks(buf + p.off, src,
                   static_cast<int64_t>(n) * p.len *
                       (a == kMask ? 1 : static_cast<int>(sizeof(T))));
    else
      stage_padded<static_cast<int>(sizeof(T))>(buf + p.off, src, n, p);
  }
}

// Subset u of staged stream k (streams from m0 on in the buffer at
// `buf`): its rows in shared memory and its constants in registers.
template <typename T>
struct Rows {
  const T *f, *cd, *lbp, *dl;
  const bool* mk;
  T c_add[kMaxConsts];
  T budget;
};

template <typename T>
__device__ __forceinline__ Rows<T> rows_of(const uint8_t* buf,
                                           const Layout& l,
                                           const Inputs<T>& in, int64_t m0,
                                           int k, int u, int nj, int nc,
                                           int np, int masked) {
  auto at = [&](int a) {
    const Part& p = l.part[a];
    return buf + p.off + (p.chunks ? lead(in.from(a, p, m0)) : 0);
  };
  const int nlb = nj > 1 ? nj - 1 : 1;
  Rows<T> r;
  r.f = reinterpret_cast<const T*>(at(0)) + k * l.part[0].stride +
        u * nj * nc;
  const T* c = reinterpret_cast<const T*>(at(1)) + k * l.part[1].stride +
               u * np;
#pragma unroll
  for (int p = 0; p < kMaxConsts; ++p) r.c_add[p] = p < np ? c[p] : T(0);
  r.budget = static_cast<T>(INFINITY);
  r.cd = r.lbp = r.dl = nullptr;
  r.mk = nullptr;
  if (masked) {
    r.cd = reinterpret_cast<const T*>(at(2)) + k * l.part[2].stride +
           u * nc;
    r.mk = reinterpret_cast<const bool*>(at(kMask)) +
           k * l.part[kMask].stride + u * nj * nc;
    r.lbp = reinterpret_cast<const T*>(at(4)) + k * l.part[4].stride +
            u * nlb * nc;
    r.dl = reinterpret_cast<const T*>(at(5)) + k * l.part[5].stride +
           u * nj * nc;
    const T* ra = reinterpret_cast<const T*>(at(6)) + k * l.part[6].stride +
                  u * 2;
    r.budget = ra[0] + ra[1];
  }
  return r;
}

// Is `prev` below the pairwise lower bound `lbd` (with its slack)? The
// reference's constants, rounded to T as the plain version's Python
// scalars are.
template <typename T>
__device__ __forceinline__ bool below_lb(T prev, T lbd) {
  const T one_m = static_cast<T>(1.0 - 1e-12);
  const T eps = static_cast<T>(1e-12);
  return prev < sub_rn(mul_rn(lbd, one_m), eps);
}

// First minimum over tuples g0, g0 + step, ... of one subset, read from
// the combo table: (v, i) moves only on a strict <; a NaN total sets
// `nan` and ends the scan.
template <typename T>
__device__ __forceinline__ void scan_tuples(const Rows<T>& r,
                                            const uint8_t* combos, int g0,
                                            int step, int ng, int nj, int nc,
                                            int np, int masked, T& v, int& i,
                                            bool& nan) {
  for (int g = g0; g < ng; g += step) {
    const uint8_t* cb = combos + g * nj;
    T tot = T(0);
    for (int j = 0; j < nj; ++j) tot = tot + r.f[j * nc + cb[j]];
#pragma unroll
    for (int p = 0; p < kMaxConsts; ++p)
      if (p < np) tot = tot + r.c_add[p];
    if (masked) {
      bool bad = false;
      T acc = T(0);
      for (int j = 0; j < nj; ++j) {
        bad |= !r.mk[j * nc + cb[j]];
        acc = acc + r.dl[j * nc + cb[j]];
      }
      for (int j = 1; j < nj; ++j)
        bad |= below_lb(r.cd[cb[j - 1]], r.lbp[(j - 1) * nc + cb[j]]);
      bad |= acc > r.budget;
      if (bad) tot = static_cast<T>(INFINITY);
    }
    if (tot != tot) {  // NaN: the subset's minimum is NaN, never taken
      nan = true;
      return;
    }
    if (tot < v) {
      v = tot;
      i = g;
    }
  }
}

// The same first minimum over all G tuples of one subset, walked as J
// nested loops c0 <= c1 <= c2 (the table's order): each loop carries its
// partial sum, mask and deltas to the loops below, which add the same
// terms in the same order as scan_tuples.
template <typename T, int J, bool MASKED>
__device__ __forceinline__ void scan_monotone(const Rows<T>& r, int nc,
                                              int np, T& v, int& i,
                                              bool& nan) {
  int g = 0;
  auto take = [&](T s, bool bad, T acc) {  // true on a NaN total
    T tot = s;
#pragma unroll
    for (int p = 0; p < kMaxConsts; ++p)
      if (p < np) tot = tot + r.c_add[p];
    if (MASKED && (bad || acc > r.budget)) tot = static_cast<T>(INFINITY);
    if (tot != tot) return true;
    if (tot < v) {
      v = tot;
      i = g;
    }
    ++g;
    return false;
  };
  for (int c0 = 0; c0 < nc; ++c0) {
    const T s0 = T(0) + r.f[c0];
    bool b0 = false;
    T a0 = T(0);
    if constexpr (MASKED) {
      b0 = !r.mk[c0];
      a0 = a0 + r.dl[c0];
    }
    if constexpr (J == 1) {
      if (take(s0, b0, a0)) {
        nan = true;
        return;
      }
    } else {
      for (int c1 = c0; c1 < nc; ++c1) {
        const T s1 = s0 + r.f[nc + c1];
        bool b1 = b0;
        T a1 = a0;
        if constexpr (MASKED) {
          b1 = b1 || !r.mk[nc + c1] || below_lb(r.cd[c0], r.lbp[c1]);
          a1 = a1 + r.dl[nc + c1];
        }
        if constexpr (J == 2) {
          if (take(s1, b1, a1)) {
            nan = true;
            return;
          }
        } else {
          for (int c2 = c1; c2 < nc; ++c2) {
            const T s2 = s1 + r.f[2 * nc + c2];
            bool b2 = b1;
            T a2 = a1;
            if constexpr (MASKED) {
              b2 = b2 || !r.mk[2 * nc + c2] ||
                   below_lb(r.cd[c1], r.lbp[nc + c2]);
              a2 = a2 + r.dl[2 * nc + c2];
            }
            if (take(s2, b2, a2)) {
              nan = true;
              return;
            }
          }
        }
      }
    }
  }
}

// (v, i) <- the lexicographic minimum of (v, i) and (ov, oi).
template <typename T>
__device__ __forceinline__ void take_first_min(T& v, int& i, T ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Tiles of `tile` streams, a thread a stream; each block walks tiles
// blockIdx.x, + gridDim.x, ..., copying the next tile into its second
// buffer while it solves the current one.
template <typename T, int J, bool MASKED>
__global__ void __launch_bounds__(kMaxThreads)
    plan_solve_rows(Inputs<T> in, T* __restrict__ val,
                    int32_t* __restrict__ idx, const Layout l, int64_t m,
                    int ns, int nc, int ng, int np, int tile) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t ntiles = (m + tile - 1) / tile;
  auto streams_in = [&](int64_t t) {
    return static_cast<int>(m - t * tile < tile ? m - t * tile : tile);
  };
  int64_t t = blockIdx.x;
  stage_tile(smem, l, in, t * tile, streams_in(t), MASKED);
  cp_async_commit();
  for (int b = 0; t < ntiles; t += gridDim.x, b ^= 1) {
    const int64_t after = t + gridDim.x;
    if (after < ntiles)
      stage_tile(smem + (b ^ 1) * l.rows, l, in, after * tile,
                 streams_in(after), MASKED);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const uint8_t* buf = smem + b * l.rows;
    const int64_t m0 = t * tile;
    const int nb = streams_in(t);
    for (int k = threadIdx.x; k < nb; k += blockDim.x) {
      T best = static_cast<T>(INFINITY);
      int32_t best_idx = 0;
      for (int u = 0; u < ns; ++u) {
        T v = static_cast<T>(INFINITY);
        int i = 0;
        bool nan = false;
        scan_monotone<T, J, MASKED>(
            rows_of(buf, l, in, m0, k, u, J, nc, np, MASKED), nc, np, v, i,
            nan);
        if (!nan && v < best) {
          best = v;
          best_idx = u * ng + i;
        }
      }
      val[m0 + k] = best;
      idx[m0 + k] = best_idx;
    }
    __syncthreads();  // buffer b is refilled by the next round's copies
  }
}

// One block per stream; the threads stride each subset's tuples.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    plan_solve_streams(Inputs<T> in, T* __restrict__ val,
                       int32_t* __restrict__ idx, const Layout l, int ns,
                       int nj, int nc, int ng, int np, int masked) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warps = blockDim.x / 32;
  const int64_t row = blockIdx.x;
  stage_tile(smem, l, in, row, 1, masked);
  stage_chunks(smem + l.combos, in.combos, static_cast<int64_t>(ng) * nj);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const uint8_t* combos = smem + l.combos + lead(in.combos);
  T* res_v = reinterpret_cast<T*>(smem + l.res_v);
  int* res_i = reinterpret_cast<int*>(smem + l.res_i);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = 0; t < ns; ++t) {
    T v = static_cast<T>(INFINITY);
    int i = 0;
    bool nan = false;
    scan_tuples(rows_of(smem, l, in, row, 0, t, nj, nc, np, masked), combos,
                threadIdx.x, blockDim.x, ng, nj, nc, np, masked, v, i, nan);
    // the warp's first minimum and NaN flag, in lane 0
    nan = __any_sync(0xffffffffu, nan);
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      take_first_min(v, i, ov, oi);
    }
    if (lane == 0) {
      res_v[t * warps + warp] = v;
      res_i[t * warps + warp] = nan ? -1 : i;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  T best = static_cast<T>(INFINITY);
  int32_t best_idx = 0;
  for (int t = 0; t < ns; ++t) {
    T v = static_cast<T>(INFINITY);
    int i = 0;
    bool nan = false;
    for (int w = 0; w < warps; ++w) {
      const int k = t * warps + w;
      nan |= res_i[k] < 0;
      take_first_min(v, i, res_v[k], res_i[k]);
    }
    if (!nan && v < best) {
      best = v;
      best_idx = t * ng + i;
    }
  }
  val[row] = best;
  idx[row] = best_idx;
}

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <typename K>
int allow_smem(K kernel, int64_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// As many plan_solve_rows blocks as are resident at once (at most one a
// tile), each walking its tiles.
template <typename T, int J, bool MASKED>
int launch_rows(const Inputs<T>& in, T* val, int32_t* idx, const Layout& l,
                int64_t m, int ns, int nc, int ng, int np, int tile,
                int threads, cudaStream_t stream) {
  const auto kernel = plan_solve_rows<T, J, MASKED>;
  int err = allow_smem(kernel, l.total);
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, l.total);
  if (err) return err;
  const int64_t ntiles = (m + tile - 1) / tile;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm
                                                                   : 1);
  const unsigned int blocks =
      static_cast<unsigned int>(ntiles < resident ? ntiles : resident);
  kernel<<<blocks, threads, l.total, stream>>>(in, val, idx, l, m, ns, nc,
                                                ng, np, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* fs, const T* cst, const T* cand, const bool* mask,
           const T* lb, const T* deltas, const T* rhs_atol,
           const uint8_t* combos, T* val, int32_t* idx, int64_t m, int ns,
           int nj, int nc, int ng, int np, int masked, int streams,
           int tile, int threads, int64_t smem, cudaStream_t stream) {
  const Layout l =
      streams ? layout(1, ns, nj, nc, np, masked, sizeof(T), false, 1,
                       static_cast<int64_t>(ng) * nj,
                       static_cast<int64_t>(ns) * (threads / 32))
              : layout(tile, ns, nj, nc, np, masked, sizeof(T), true, 2, 0, 0);
  if (l.total != smem || tile < 1 || threads % 32 || threads < 32 ||
      threads > kMaxThreads || (streams && tile != 1) ||
      (!streams && (nj < 1 || nj > 3)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs<T> in{fs, cst, cand, mask, lb, deltas, rhs_atol, combos};
  if (streams) {
    int err = allow_smem(plan_solve_streams<T>, smem);
    if (err) return err;
    plan_solve_streams<T><<<static_cast<unsigned int>(m), threads, smem,
                            stream>>>(in, val, idx, l, ns, nj, nc, ng, np,
                                      masked);
    return static_cast<int>(cudaGetLastError());
  }
  switch (nj * 2 + (masked ? 1 : 0)) {
    case 2: return launch_rows<T, 1, false>(
        in, val, idx, l, m, ns, nc, ng, np, tile, threads, stream);
    case 3: return launch_rows<T, 1, true>(
        in, val, idx, l, m, ns, nc, ng, np, tile, threads, stream);
    case 4: return launch_rows<T, 2, false>(
        in, val, idx, l, m, ns, nc, ng, np, tile, threads, stream);
    case 5: return launch_rows<T, 2, true>(
        in, val, idx, l, m, ns, nc, ng, np, tile, threads, stream);
    case 6: return launch_rows<T, 3, false>(
        in, val, idx, l, m, ns, nc, ng, np, tile, threads, stream);
    default: return launch_rows<T, 3, true>(
        in, val, idx, l, m, ns, nc, ng, np, tile, threads, stream);
  }
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue when the launch plan does not fit the kernels.
// The grids (cand, mask, lb, deltas, rhs_atol) are read only when
// `masked`, and may be null otherwise. `streams` picks plan_solve_streams
// (tile 1) over plan_solve_rows (`tile` streams a block, J <= 3); `smem`
// must equal the layout's bytes. Needs C <= 256 and P <= 4 (checked by
// the Python wrapper, which also plans the launch: ops.launch_plan).
extern "C" int plan_solve_launch_f32(
    const float* fs, const float* cst, const float* cand, const bool* mask,
    const float* lb, const float* deltas, const float* rhs_atol,
    const uint8_t* combos, float* val, int32_t* idx, int64_t m, int ns,
    int nj, int nc, int ng, int np, int masked, int streams, int tile,
    int threads, int64_t smem, cudaStream_t stream) {
  return launch<float>(fs, cst, cand, mask, lb, deltas, rhs_atol, combos, val,
                       idx, m, ns, nj, nc, ng, np, masked, streams, tile,
                       threads, smem, stream);
}

extern "C" int plan_solve_launch_f64(
    const double* fs, const double* cst, const double* cand,
    const bool* mask, const double* lb, const double* deltas,
    const double* rhs_atol, const uint8_t* combos, double* val, int32_t* idx,
    int64_t m, int ns, int nj, int nc, int ng, int np, int masked,
    int streams, int tile, int threads, int64_t smem, cudaStream_t stream) {
  return launch<double>(fs, cst, cand, mask, lb, deltas, rhs_atol, combos,
                        val, idx, m, ns, nj, nc, ng, np, masked, streams,
                        tile, threads, smem, stream);
}
