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
// strict running minimum over s, emitted as (val, s*G + g).
//
// On the TPU the terms are expanded onto the tuples with one-hot matmuls
// on the MXU, which forces finite terms (inf * 0) and pads G to 128. Here
// each thread gathers fs[m, s, j, combos[g, j]] directly, with the combo
// table (uint8) in shared memory, and no padded tuples exist.
//
// Bound on this card: bytes at the planner's shapes (G <= 36 tuples per
// subset: a few adds per element read); operations for deep constrained
// hierarchies (T = 4: J = 3, G in the thousands). Design: one thread per
// stream, looping subsets, then tuples. A stream's rows (S*J*C values)
// stay in L1 across its tuple loop. Making it fast is later work.
//
// Rounding: the sums are plain adds in the reference's order; the one
// multiply-add (the lower-bound slack) is written with round-to-nearest
// intrinsics, so nvcc cannot contract it into an FMA that the plain
// PyTorch version does not make.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxConsts = 4;

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

template <typename T>
__global__ void plan_solve_kernel(
    const T* __restrict__ fs, const T* __restrict__ cst,
    const T* __restrict__ cand, const bool* __restrict__ mask,
    const T* __restrict__ lb, const T* __restrict__ deltas,
    const T* __restrict__ rhs_atol, const uint8_t* __restrict__ combos_g,
    T* __restrict__ val, int32_t* __restrict__ idx, int64_t m, int ns,
    int nj, int nc, int ng, int np, int masked) {
  extern __shared__ uint8_t combos[];  // (G, J)
  for (int i = threadIdx.x; i < ng * nj; i += blockDim.x)
    combos[i] = combos_g[i];
  __syncthreads();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= m) return;
  const T inf = static_cast<T>(INFINITY);
  // the reference's constants, rounded to T as the plain version's
  // Python scalars are
  const T one_m = static_cast<T>(1.0 - 1e-12);
  const T eps = static_cast<T>(1e-12);
  const int nlb = nj > 1 ? nj - 1 : 1;
  T best = inf;
  int32_t best_idx = 0;
  for (int s = 0; s < ns; ++s) {
    const int64_t ms = row * ns + s;
    const T* f = fs + ms * nj * nc;
    T c_add[kMaxConsts];
#pragma unroll
    for (int p = 0; p < kMaxConsts; ++p) c_add[p] = p < np ? cst[ms * np + p]
                                                         : T(0);
    T budget = inf;
    const bool* mk = nullptr;
    const T *cd = nullptr, *lbp = nullptr, *dl = nullptr;
    if (masked) {
      mk = mask + ms * nj * nc;
      cd = cand + ms * nc;
      lbp = lb + ms * nlb * nc;
      dl = deltas + ms * nj * nc;
      budget = rhs_atol[ms * 2] + rhs_atol[ms * 2 + 1];
    }
    T vmin = inf;
    int amin = 0;
    bool has_nan = false;
    for (int g = 0; g < ng; ++g) {
      const uint8_t* cb = combos + g * nj;
      T tot = T(0);
      for (int j = 0; j < nj; ++j) tot = tot + f[j * nc + cb[j]];
#pragma unroll
      for (int p = 0; p < kMaxConsts; ++p)
        if (p < np) tot = tot + c_add[p];
      if (masked) {
        bool bad = false;
        T acc = T(0);
        for (int j = 0; j < nj; ++j) {
          bad |= !mk[j * nc + cb[j]];
          acc = acc + dl[j * nc + cb[j]];
        }
        for (int j = 1; j < nj; ++j) {
          const T lbd = lbp[(j - 1) * nc + cb[j]];
          bad |= cd[cb[j - 1]] < sub_rn(mul_rn(lbd, one_m), eps);
        }
        bad |= acc > budget;
        if (bad) tot = inf;
      }
      if (tot != tot) {  // NaN: the subset's minimum is NaN, never taken
        has_nan = true;
        break;
      }
      if (tot < vmin) {
        vmin = tot;
        amin = g;
      }
    }
    if (!has_nan && vmin < best) {
      best = vmin;
      best_idx = s * ng + amin;
    }
  }
  val[row] = best;
  idx[row] = best_idx;
}

template <typename T>
int launch(const T* fs, const T* cst, const T* cand, const bool* mask,
           const T* lb, const T* deltas, const T* rhs_atol,
           const uint8_t* combos, T* val, int32_t* idx, int64_t m, int ns,
           int nj, int nc, int ng, int np, int masked, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(ng) * nj;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        plan_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks =
      static_cast<unsigned int>((m + kThreads - 1) / kThreads);
  plan_solve_kernel<T><<<blocks, kThreads, smem, stream>>>(
      fs, cst, cand, mask, lb, deltas, rhs_atol, combos, val, idx, m, ns, nj,
      nc, ng, np, masked);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 = launched). The grids
// (cand, mask, lb, deltas, rhs_atol) are read only when `masked`, and may
// be null otherwise. Needs C <= 256, P <= 4 and G*J bytes of shared memory
// (checked by the Python wrapper).
extern "C" int plan_solve_launch_f32(
    const float* fs, const float* cst, const float* cand, const bool* mask,
    const float* lb, const float* deltas, const float* rhs_atol,
    const uint8_t* combos, float* val, int32_t* idx, int64_t m, int ns,
    int nj, int nc, int ng, int np, int masked, cudaStream_t stream) {
  return launch<float>(fs, cst, cand, mask, lb, deltas, rhs_atol, combos, val,
                       idx, m, ns, nj, nc, ng, np, masked, stream);
}

extern "C" int plan_solve_launch_f64(
    const double* fs, const double* cst, const double* cand,
    const bool* mask, const double* lb, const double* deltas,
    const double* rhs_atol, const uint8_t* combos, double* val, int32_t* idx,
    int64_t m, int ns, int nj, int nc, int ng, int np, int masked,
    cudaStream_t stream) {
  return launch<double>(fs, cst, cand, mask, lb, deltas, rhs_atol, combos,
                        val, idx, m, ns, nj, nc, ng, np, masked, stream);
}
