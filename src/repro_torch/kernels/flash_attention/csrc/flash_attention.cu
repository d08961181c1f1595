// Forward attention with an online softmax over key tiles, written by hand
// for Hopper (sm_90a): a warp-specialised kernel, every product on the
// tensor cores as 3xTF32 wgmma, the key and value tiles brought by TMA and
// turned into wgmma panels by a producer warpgroup.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/flash_attention.py:64). For q
// (B, Sq, H, hd) and k, v (B, Skv, KV, hd), KV | H, query head h reads KV
// head h / (H / KV), so grouped heads are never expanded in memory. Query
// row i sits at position i + Skv - Sq, key j at position j. Causal and
// sliding-window masks (kpos > qpos - window) put the reference's -2e9 on
// the logit; keys past Skv take no part. Output is acc / max(l, 1e-30) in
// q's type, with (m, l, acc) carried in float32, as the TPU kernel does.
// Head dims 16, 32, 64 and 128, with v's head dim equal to q's and k's;
// and for MLA (deepseek-v2) q/k head dim 192 with v head dim 128, and its
// reduced config's 24 and 16: S = Q K^T runs over the q/k head dim, O =
// P V over v's. These two pairs are built without the soft-cap, since the
// reference's MLA attention has none.
//
// Logit soft-capping (grok-1): with softcap c > 0 a logit x * scale
// becomes c * tanh(x * scale / c) before the mask, as the reference's
// models/attention.py caps and then masks (its Pallas kernel has no cap).
// The cap is a template flag, so the uncapped launches carry none of it.
// It uses the accurate tanhf (2 ulp), never tanh.approx.f32, whose 2^-11
// relative error is ~1.5e-2 on a cap of 30, beyond the 2e-5 the kernel is
// held to. The row log-sum-exp is that of the capped logits.
//
// Bound on this card: operations. The function does 2 * (hd + hd_v)
// operations per visible (query, key) pair: 3.4e10 at llama3.2-1b's
// prefill (B=8, S=1024, H=32, hd=64, causal), 3.4e11 at deepseek-v2's
// (H=128, (192, 128)); the bytes take 0.05-0.8 ms. The serve path runs in
// float32 and holds the kernel to 2e-5 of its plain version, which TF32
// alone (about three decimal digits) would miss. So both products run on
// the tensor cores as 3xTF32: each float32 operand x is split into big =
// x rounded to TF32 and small = x - big, and a * b is taken as big*big +
// big*small + small*big (the small*small term, 2^-22 of the product, is
// dropped). Three TF32 products per multiply-add put the bound at 495 / 3
// = 165 TFLOP/s (0.21 ms and 2.08 ms at the shapes above), against 67
// TFLOP/s on the float32 units.
//
// Design. A block owns 128 query rows of one (batch, head) and streams the
// KV head's keys in tiles of BN through PS stages of shared memory.
// Warpgroup 0 is the producer: its thread 0 keeps RS tiles in flight by
// cp.async.bulk.tensor (4-D maps of (B, Skv, KV, hd), a box of BN rows of
// one head as they lie in memory, zero past Skv), each completing on an
// mbarrier; the warpgroup then turns a landed tile into a free stage's
// panels (an empty mbarrier both consumers arrive on) and arrives on the
// stage's full mbarrier. setmaxnreg gives the producer REG_P registers a
// thread and the consumers REG_C. Warpgroups 1 and 2 are the consumers,
// 64 query rows each, both on every tile: each holds its rows' Q as m64k8
// A fragments in registers for the whole block (biased, below) and its O
// accumulator, (m, l) per row.
//
// TF32 wgmma reads both operands K-major and B from shared memory. S = Q
// K^T has K (keys by head dim) as B, K-major as it lies: the producer
// writes the tile into a panel tile whose rows are the keys, cut into
// panels of 32, 16 or 8 columns (the widest dividing hd), each swizzled
// over 128, 64 or 32 bytes as the wgmma descriptor names it; in float32
// it holds each value's TF32 big part in the hi rows and the rest in the
// lo rows below. O += P V needs V^T (head dim by keys) K-major, and TMA
// does not transpose float32: the producer writes V's tile as a K-major
// V^T panel tile (hd_v rows over the tile's keys, hi and lo). In each
// chunk of 8 keys it writes the keys in the order 0, 2, 4, 6, 1, 3, 5, 7:
// then S's accumulator fragment (keys 2t and 2t + 1 of rows g and g + 8)
// is P's m64k8 A fragment as it stands (k = t and t + 4), so P never
// leaves registers and O stays in query-row layout, where each row's
// rescale by alpha stays inside its thread. (The backward's transposed
// form, O^T = V^T P^T with P through a scratch panel, would pad M to 64 at
// the small head dims and pass alpha through shared memory.)
//
// 3xTF32 per k-step of 8: small * hi, big * lo, big * hi chained into one
// accumulator, the small products first so that the big one is added to
// them and not they, truncated, to it. Each operand reaches the tensor
// core rounded to nearest TF32, its small part too (biased; small_of).
// Q's fragments are held biased, and their small parts are formed a chunk
// of k-steps at a time behind a barrier to the compiler (opaque), which
// would otherwise hoist them out of the loop over tiles into registers it
// does not have (at (192, 128) every wgmma was then serialized and 1 KB a
// thread spilled). bfloat16 inputs are exact in TF32,
// so K and V carry no lo rows and S takes one wgmma a k-step, P V two (P
// is computed, so always split). Promotion: the tensor cores truncate
// inside a sum, so a sum carried in one accumulator through many k-steps
// drifts. Each chunk of a product goes into a fresh accumulator (scale-d
// 0) that a float32 add puts into its total: S every KC k-steps of the
// head dim, O every OC k-steps (8 keys each) of the tile, its first chunk
// with O's rescale (O = alpha * O + chunk, one fma). P V runs in NH
// halves of hd_v, so that its chunk's accumulator (hd_v / 2 / NH floats a
// thread) fits beside Q's fragments and O: at (192, 128) a consumer holds
// 96 + 64 registers of those.
//
// Layouts (FwdShape; ops.FWD_LAYOUTS mirrors them): 64-key tiles at head
// dim <= 64, 32 above; two stages (three at <= 32); two TMA slots, one at
// (192, 128), where float32 takes 200 KB of the 227 KB a block may have.
// chip_smoke.py --fa-layouts times the alternatives at (192, 128): 16-key
// tiles, one consumer warpgroup and P V as one product of N = 128 were
// each slower.
// Masks are computed only on tiles that cut the causal diagonal, the
// window's edge or Skv; a consumer skips a tile that masks all its rows
// (it still waits for the tile and arrives on its stage), and the block
// streams only tiles that some row sees. When a row has no visible key at
// all (causal, Sq > Skv) nothing is skipped, so such a row averages v over
// all Skv keys as the reference's plain version does. Query tiles run
// longest first (the causal diagonal's last tiles). No atomics: the
// result does not depend on scheduling.
#include "flash_attention.cuh"

namespace {

// A launch's layout by head-dim pair: W consumer warpgroups of 64 query
// rows, BN keys a tile, PS panel stages, RS TMA slots, KC k-steps a
// promoted chunk of S, OC k-steps (of 8 keys) a promoted chunk of O, NH
// halves of P V's N; REG_P and REG_C the producer's and the consumers'
// registers a thread. ops.FWD_LAYOUTS mirrors W, BN, PS and RS. S is
// promoted every k-step at head dims up to 32, as the backward found it
// must be there; O every 16 keys, for precision: every 32 (which
// chip_smoke.py --fa-layouts times about 0.5% faster at (192, 128)),
// with the small parts truncated, put a row with few keys (Sq > Skv,
// head dim 16) 3.5 times as far from a float64 route as the float32
// plain route; rounding the small parts and promoting O every 16 keys
// together brought it under 2.
template <int HDK, int HDV>
struct FwdShape {
  static constexpr int W = 2;
  static constexpr int BN = HDK <= 64 ? 64 : 32;
  static constexpr int PS = HDK <= 32 ? 3 : 2;
  static constexpr int RS = HDK > 128 ? 1 : 2;
  static constexpr int KC = HDK > 32 ? 4 : 1;
  static constexpr int OC = 2;
  static constexpr int NH = HDV > 64 ? 2 : 1;
  static constexpr int REG_P = HDK > 128 ? 24 : 40;
  static constexpr int REG_C = HDK > 128 ? 240 : 232;
};

// Byte offsets of a block's shared memory (from a 1024-byte aligned
// base): PS stages, each the K panel tile (BN rows of hd; float32: hi,
// then lo) and the V^T panel tile (hd_v rows of BN keys; float32: hi,
// then lo); RS slots where the TMA lands a K and a V tile as they lie in
// memory; the mbarriers (full and empty of each stage, landed of each
// slot).
template <typename T, int HDK, int HDV>
struct FwdLayout {
  using S = FwdShape<HDK, HDV>;
  static constexpr int W = S::W, BN = S::BN, PS = S::PS, RS = S::RS;
  static constexpr int THREADS = 128 * (1 + W);
  static constexpr bool LO = std::is_same<T, float>::value;
  static constexpr int NPAN = LO ? 2 : 1;
  static constexpr int PAN_K = al1k(NPAN * BN * HDK * 4);
  static constexpr int PAN_V = al1k(NPAN * HDV * BN * 4);
  static constexpr int STAGE = PAN_K + PAN_V;
  static constexpr int RAW_K = al128(BN * HDK * static_cast<int>(sizeof(T)));
  static constexpr int RAW_V = al128(BN * HDV * static_cast<int>(sizeof(T)));
  static constexpr int RAW = RAW_K + RAW_V;
  // bytes one slot's two TMA loads bring
  static constexpr int TX = BN * (HDK + HDV) * static_cast<int>(sizeof(T));
  static constexpr int O_RAW = PS * STAGE;
  static constexpr int O_BAR = (O_RAW + RS * RAW + 7) / 8 * 8;
  static constexpr int NBAR = 2 * PS + RS;
  static constexpr int BYTES = O_BAR + 8 * NBAR + 1024;
  static_assert(BYTES <= 232448, "past the 227 KB a block may have");
  static_assert(128 * (S::REG_P + W * S::REG_C) <= 65536,
                "past the SM's registers");
};

// A launch's arguments: K's and V's maps (BN rows of one KV head as they
// lie in memory), q, the output and the row log-sum-exp (or null).
struct FwdArgs {
  CUtensorMap mk, mv;
  const void* q;
  void* out;
  float* lse;
  int sq, skv, h, kvh;
  float scale;
  int causal, window;
  float softcap;
};

// a K tile of BN rows x HD as the TMA landed it, into its stage's panel
// tile (rows the keys): bfloat16 widened, float32 split into hi rows and
// the lo rows BN below
template <typename T, int BN, int HD>
__device__ __forceinline__ void keys_to_panel(const T* raw, float* pan,
                                              int tid) {
  if constexpr (!std::is_same<T, float>::value) {
    widen<BN, HD>(raw, pan, tid);
  } else {
    constexpr int C4 = HD / 4;
    for (int e = tid; e < BN * C4; e += 128) {
      const int r = e / C4, c = 4 * (e % C4);
      float4 hi, lo;
      split_biased(*reinterpret_cast<const float4*>(raw + r * HD + c), hi,
                   lo);
      st4(pan, panel_off<2 * BN, HD>(r, c), hi);
      st4(pan, panel_off<2 * BN, HD>(BN + r, c), lo);
    }
  }
}

// a V tile of BN keys x HD as the TMA landed it, into its stage's K-major
// V^T panel tile: HD rows (float32: hi rows, then lo rows) over the keys,
// each chunk of 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7 (k index t of
// a k-step is key 2t, t + 4 key 2t + 1: P's A fragment as S's
// accumulator holds it). A thread writes 4 columns of one row (the keys
// k0, k0 + 2, k0 + 4, k0 + 6): neighbouring threads take neighbouring
// rows, which the swizzle spreads over the banks.
template <typename T, int BN, int HD>
__device__ __forceinline__ void values_to_panel(const T* raw, float* pan,
                                                int tid) {
  constexpr bool LO = std::is_same<T, float>::value;
  constexpr int PR = LO ? 2 * HD : HD;
  for (int e = tid; e < HD * (BN / 4); e += 128) {
    const int d = e % HD, u = e / HD;
    const T* x = raw + (8 * (u >> 1) + (u & 1)) * HD + d;
    const float4 v =
        make_float4(ld1(x), ld1(x + 2 * HD), ld1(x + 4 * HD), ld1(x + 6 * HD));
    if constexpr (LO) {
      float4 hi, lo;
      split_biased(v, hi, lo);
      st4(pan, panel_off<PR, BN>(d, 4 * u), hi);
      st4(pan, panel_off<PR, BN>(HD + d, 4 * u), lo);
    } else {
      st4(pan, panel_off<PR, BN>(d, 4 * u), v);
    }
  }
}

// tells the compiler x may have changed here, so that nothing computed
// from it (Q's small parts, constant over the tiles) is hoisted out of the
// loop over tiles or ahead of the k-steps that use it, where it would
// hold registers the whole time
__device__ __forceinline__ void opaque(uint32_t& x) {
  asm volatile("" : "+r"(x));
}

// s (the warpgroup's 64 query rows x BN keys) = Q K^T over HD: Q's
// fragments in registers, biased (load_frags, then biased); K the stage's
// panel tile. Each chunk of KC k-steps sums into a fresh accumulator
// (scale-d 0 on its first) that a float32 add puts into s.
template <int BN, int HD, bool LO, int KC>
__device__ __forceinline__ void qk_product(float (&s)[BN / 2],
                                           uint32_t (&qb)[HD / 2],
                                           uint32_t tile) {
  constexpr int KS = HD / 8, PR = LO ? 2 * BN : BN;
  const uint32_t lo = panel_lo(tile), hi = panel_hi<HD>();
#pragma unroll
  for (int c0 = 0; c0 < KS; c0 += KC) {
    uint32_t as[KC][4];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + kk >= KS) continue;
        uint32_t& x = qb[4 * (c0 + kk) + j];
        opaque(x);
        if constexpr (LO) as[kk][j] = small_of(x);
      }
    float t[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      if (c0 + kk >= KS) continue;
      const int c = 8 * (c0 + kk);
      const int y = 4 * (c0 + kk);
      const uint32_t ab[4] = {qb[y], qb[y + 1], qb[y + 2], qb[y + 3]};
      const uint32_t dh = lo + (panel_off<PR, HD>(0, c) >> 4);
      if constexpr (LO) {
        wgmma<BN>(t, as[kk], dh, hi, kk);
        wgmma<BN>(t, ab, lo + (panel_off<PR, HD>(BN, c) >> 4), hi, 1);
        wgmma<BN>(t, ab, dh, hi, 1);
      } else {
        wgmma<BN>(t, ab, dh, hi, kk);
      }
    }
    wgmma_commit();
    wgmma_wait();
    hold(t);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = c0 == 0 ? t[i] : s[i] + t[i];
  }
}

// o (the warpgroup's 64 query rows x HDV) = alpha * o + P V over the
// tile's BN keys: P from S's accumulator as it stands, biased in place
// (pb); V the stage's V^T panel tile. In NH halves of HDV, each in chunks
// of OC k-steps into a fresh accumulator; the first chunk of a half takes
// the rescale (o = alpha * o + chunk), the others a float32 add.
template <int BN, int HDV, bool LO, int NH, int OC>
__device__ __forceinline__ void pv_product(float (&o)[HDV / 2],
                                           uint32_t (&pb)[BN / 2],
                                           const float (&alpha)[2],
                                           uint32_t tile) {
  constexpr int KS = BN / 8, HN = HDV / NH, PR = LO ? 2 * HDV : HDV;
  const uint32_t lo = panel_lo(tile), hi = panel_hi<BN>();
#pragma unroll
  for (int hv = 0; hv < NH; ++hv)
#pragma unroll
    for (int c0 = 0; c0 < KS; c0 += OC) {
      // P's m64k8 fragments of these k-steps: k index t is key 2t, t + 4
      // key 2t + 1 (the V^T panel's key order)
      uint32_t ab[OC][4], as[OC][4];
#pragma unroll
      for (int kk = 0; kk < OC; ++kk) {
        if (c0 + kk >= KS) continue;
        const int y = 4 * (c0 + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) opaque(pb[y + j]);
        ab[kk][0] = pb[y];
        ab[kk][1] = pb[y + 2];
        ab[kk][2] = pb[y + 1];
        ab[kk][3] = pb[y + 3];
#pragma unroll
        for (int j = 0; j < 4; ++j) as[kk][j] = small_of(ab[kk][j]);
      }
      float t[HN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < OC; ++kk) {
        if (c0 + kk >= KS) continue;
        const int c = 8 * (c0 + kk);
        const uint32_t dh = lo + (panel_off<PR, BN>(hv * HN, c) >> 4);
        wgmma<HN>(t, as[kk], dh, hi, kk);
        if constexpr (LO)
          wgmma<HN>(t, ab[kk], lo + (panel_off<PR, BN>(HDV + hv * HN, c) >> 4),
                    hi, 1);
        wgmma<HN>(t, ab[kk], dh, hi, 1);
      }
      wgmma_commit();
      wgmma_wait();
      hold(t);
#pragma unroll
      for (int i = 0; i < HN / 2; ++i) {
        float& y = o[hv * (HN / 2) + i];
        y = c0 == 0 ? fmaf(y, alpha[(i >> 1) & 1], t[i]) : y + t[i];
      }
    }
}

// the producer: thread 0 keeps RS tiles in flight by TMA in the slots,
// and the warpgroup turns each landed tile into a free stage's panels,
// then arrives on the stage's full mbarrier
template <typename T, int HDK, int HDV>
__device__ __forceinline__ void produce(const FwdArgs& p, unsigned char* sm,
                                        int kvhead, int t_lo, int total) {
  using L = FwdLayout<T, HDK, HDV>;
  constexpr int BN = L::BN, PS = L::PS, RS = L::RS;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::O_BAR);
  uint64_t* empty = full + PS;
  uint64_t* landed = empty + PS;
  const int tid = threadIdx.x % 128, b = blockIdx.y;
  auto issue = [&](int idx) {
    const int slot = idx % RS, r0 = (t_lo + idx) * BN;
    unsigned char* raw = sm + L::O_RAW + slot * L::RAW;
    mbar_expect(&landed[slot], L::TX);
    tma_load4(raw, &p.mk, 0, kvhead, r0, b, &landed[slot]);
    tma_load4(raw + L::RAW_K, &p.mv, 0, kvhead, r0, b, &landed[slot]);
  };
  if (tid == 0)
    for (int i = 0; i < RS && i < total; ++i) issue(i);
  for (int idx = 0; idx < total; ++idx) {
    const int slot = idx % RS, st = idx % PS;
    const unsigned char* raw = sm + L::O_RAW + slot * L::RAW;
    float* stage = reinterpret_cast<float*>(sm + st * L::STAGE);
    mbar_wait(&landed[slot], (idx / RS) & 1);
    mbar_wait(&empty[st], ((idx / PS) & 1) ^ 1);
    keys_to_panel<T, BN, HDK>(reinterpret_cast<const T*>(raw), stage, tid);
    values_to_panel<T, BN, HDV>(reinterpret_cast<const T*>(raw + L::RAW_K),
                                stage + L::PAN_K / 4, tid);
    fence_async();
    mbar_arrive(&full[st]);
    sync_group(1);  // every producer thread is done with this slot
    if (tid == 0 && idx + RS < total) issue(idx + RS);
  }
}

// a consumer warpgroup over its 64 query rows from w0 (the block's tiles
// t_lo.., all of them waited for and released; those none of its rows
// sees skipped)
template <typename T, int HDK, int HDV, bool CAP>
__device__ __forceinline__ void consume(const FwdArgs& p, unsigned char* sm,
                                        int w0, int t_lo, int total) {
  using L = FwdLayout<T, HDK, HDV>;
  using S = FwdShape<HDK, HDV>;
  constexpr int BN = L::BN, PS = L::PS;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::O_BAR);
  uint64_t* empty = full + PS;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int head = blockIdx.x, b = blockIdx.y;
  const int off = p.skv - p.sq;
  const int w_lo = w0 + off, w_hi = min(w0 + 63, p.sq - 1) + off;
  // rows with no visible key (causal, position < 0) see every tile
  const bool dead = p.causal && w_lo < 0;
  const float sl = p.scale * kLog2e;
  const float cs = CAP ? p.scale / p.softcap : 0.f;
  const float cl = CAP ? p.softcap * kLog2e : 0.f;
  const float neg = kNeg * kLog2e;

  uint32_t qb[HDK / 2];
  {
    float a[HDK / 2];
    load_frags<T, HDK>(
        a, static_cast<const T*>(p.q) +
               (static_cast<int64_t>(b) * p.sq * p.h + head) * HDK,
        w0, p.sq, static_cast<int64_t>(p.h) * HDK, warp, g, t4);
#pragma unroll
    for (int i = 0; i < HDK / 2; ++i) qb[i] = biased(a[i]);
  }
  float o[HDV / 2], m[2] = {neg, neg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;

  for (int idx = 0; idx < total; ++idx) {
    const int st = idx % PS, i0 = (t_lo + idx) * BN;
    const bool live =
        w0 < p.sq &&
        (dead || !((p.causal && i0 > w_hi) ||
                   (p.window > 0 && i0 + BN - 1 <= w_lo - p.window)));
    mbar_wait(&full[st], (idx / PS) & 1);
    if (live) {
      const uint32_t kt = smem_u32(sm + st * L::STAGE);
      float s[BN / 2];
      qk_product<BN, HDK, L::LO, S::KC>(s, qb, kt);
      // masks (on the tiles that need them), then the online softmax of
      // each row: s becomes P, alpha each row's rescale
      const bool edge = i0 + BN > p.skv || (p.causal && i0 + BN - 1 > w_lo) ||
                        (p.window > 0 && i0 <= w_hi - p.window);
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8
        const int qpos = w_lo + 16 * warp + g + 8 * hr;
        float mx = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float& x = s[4 * nb + 2 * hr + cc];
            const int kpos = i0 + 8 * nb + 2 * t4 + cc;
            bool ok = true;
            if (p.causal) ok = kpos <= qpos;
            if (p.window > 0) ok = ok && kpos > qpos - p.window;
            x = !edge ? logit2<CAP>(x, sl, cs, cl)
                      : (kpos >= p.skv ? -INFINITY
                                       : (ok ? logit2<CAP>(x, sl, cs, cl)
                                             : neg));
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        alpha[hr] = exp2f(m[hr] - m_new);
        m[hr] = m_new;
        l[hr] *= alpha[hr];
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float& x = s[4 * nb + 2 * hr + cc];
            x = exp2f(x - m_new);
            l[hr] += x;
          }
      }
      uint32_t pb[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) pb[i] = biased(s[i]);
      pv_product<BN, HDV, L::LO, S::NH, S::OC>(o, pb, alpha, kt + L::PAN_K);
    }
    mbar_arrive(&empty[st]);
  }

  // this thread's elements: row w0 + 16 warp + g + 8 hr, column 8 nb + 2t
  // and the next
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = l[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = w0 + 16 * warp + g + 8 * hr;
    if (row >= p.sq) continue;
    // the row's log-sum-exp in natural units, for the backward
    if (p.lse != nullptr && t4 == 0)
      p.lse[(static_cast<int64_t>(b) * p.h + head) * p.sq + row] =
          (m[hr] + log2f(sum)) * kLn2;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    T* op = static_cast<T*>(p.out) +
            ((static_cast<int64_t>(b) * p.sq + row) * p.h + head) * HDV;
#pragma unroll
    for (int nb = 0; nb < HDV / 8; ++nb)
      store2(op + 8 * nb + 2 * t4, o[4 * nb + 2 * hr] * inv,
             o[4 * nb + 2 * hr + 1] * inv);
  }
}

// One block: warpgroup 0 the producer, 1.. the consumers of 64 query
// rows each.
template <typename T, int HDK, int HDV, bool CAP>
__global__ void __launch_bounds__(FwdLayout<T, HDK, HDV>::THREADS, 1)
flash_fwd(const __grid_constant__ FwdArgs p) {
  using L = FwdLayout<T, HDK, HDV>;
  using S = FwdShape<HDK, HDV>;
  constexpr int BN = L::BN, PS = L::PS, BQ = 64 * L::W;
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  unsigned char* sm =
      smem_dyn + ((1024u - (smem_u32(smem_dyn) & 1023u)) & 1023u);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int off = p.skv - p.sq;
  // the key tiles some row of the block sees
  const int q_lo = q0 + off, q_hi = min(q0 + BQ, p.sq) - 1 + off;
  int t_lo = 0, t_hi = (p.skv - 1) / BN;
  if (!(p.causal && q_lo < 0)) {
    if (p.causal) t_hi = min(t_hi, q_hi / BN);
    if (p.window > 0) {
      const int first = q_lo - p.window + 1;
      if (first > 0) t_lo = first / BN;
    }
  }
  const int total = t_hi - t_lo + 1;
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::O_BAR);
    // full, empty, landed
    for (int i = 0; i < PS; ++i) {
      mbar_init(&bars[i], 128);
      mbar_init(&bars[PS + i], 128 * L::W);
    }
    for (int i = 0; i < L::RS; ++i) mbar_init(&bars[2 * PS + i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<S::REG_P>();
    produce<T, HDK, HDV>(p, sm, blockIdx.x / (p.h / p.kvh), t_lo, total);
  } else {
    setmaxnreg_inc<S::REG_C>();
    consume<T, HDK, HDV, CAP>(p, sm, q0 + 64 * (wg - 1), t_lo, total);
  }
}

template <typename T, int HDK, int HDV, bool CAP>
int fwd_hd(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int sq, int skv, int h, int kvh, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  using L = FwdLayout<T, HDK, HDV>;
  FwdArgs a{};
  if (!map_rows<T, HDK>(&a.mk, k, kvh, skv, b, L::BN, true) ||
      !map_rows<T, HDV>(&a.mv, v, kvh, skv, b, L::BN, true))
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.out = out;
  a.lse = lse;
  a.sq = sq;
  a.skv = skv;
  a.h = h;
  a.kvh = kvh;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HDK, HDV, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows = 64 * L::W;
  flash_fwd<T, HDK, HDV, CAP>
      <<<dim3(h, b, (sq + rows - 1) / rows), L::THREADS, L::BYTES, stream>>>(
          a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one forward block in bytes at the head-dim
// pair (hd of q and k, hd_v of v) and type (-1: no such build).
extern "C" int flash_attention_smem_bytes(int hd, int hd_v, int dtype) {
  const int got = dispatch(dtype, hd, hd_v, [&](auto tag, auto hdk,
                                                auto hdv) {
    using T = typename decltype(tag)::type;
    return FwdLayout<T, decltype(hdk)::value, decltype(hdv)::value>::BYTES;
  });
  return got == static_cast<int>(cudaErrorInvalidValue) ? -1 : got;
}

// Registers a thread, shared memory a block in bytes (static and dynamic)
// and resident blocks an SM of flash_fwd at the head-dim pair, build
// (`cap` non-zero: the capped one) and type, into info[0..2]. Returns a
// CUDA error (0 = none).
extern "C" int flash_attention_forward_info(int hd, int hd_v, int cap,
                                            int dtype, int* info) {
  return dispatch(dtype, hd, hd_v, [&](auto tag, auto hdk, auto hdv) {
    using T = typename decltype(tag)::type;
    constexpr int K = decltype(hdk)::value, V = decltype(hdv)::value;
    using L = FwdLayout<T, K, V>;
    return with_cap<K, V>(cap != 0, [&](auto c) {
      return kernel_info(flash_fwd<T, K, V, decltype(c)::value>, L::THREADS,
                         L::BYTES, info);
    });
  });
}

// Launches on `stream`; returns the first CUDA error (0 = launched).
// `dtype`: 0 float32, 1 bfloat16 (q, k, v and out alike). All four
// tensors are contiguous and 16-byte aligned; (`hd`, `hd_v`), the head
// dims of q and k and of v and out, is (16, 16), (32, 32), (64, 64),
// (128, 128), (192, 128) or (24, 16), the last two only uncapped;
// b <= 65535 and Sq <= 128 * 65535. `lse`, when not null, is a float32
// (B, H, Sq) tensor that receives each row's log-sum-exp of its scaled,
// capped, masked logits (natural units), which the backward reads.
// `softcap` > 0 caps each scaled logit x at softcap * tanh(x / softcap)
// before the mask; 0 leaves it uncapped.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int b, int sq, int skv, int h, int kvh,
                                      int hd, int hd_v, float scale,
                                      int causal, int window, float softcap,
                                      int dtype, cudaStream_t stream) {
  return dispatch(dtype, hd, hd_v, [&](auto tag, auto hdk, auto hdv) {
    using T = typename decltype(tag)::type;
    constexpr int K = decltype(hdk)::value, V = decltype(hdv)::value;
    return with_cap<K, V>(softcap > 0.f, [&](auto c) {
      return fwd_hd<T, K, V, decltype(c)::value>(
          q, k, v, out, lse, b, sq, skv, h, kvh, scale, causal, window,
          softcap, stream);
    });
  });
}
