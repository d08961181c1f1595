"""Logarithmic-memory reservoir backend on torch tensors — the port of the
reference's ``streams.logmem``: huge-K tenants in O(log K) state.

The exact engine keeps (K,) score/id rows per stream; at K = 65,536 one
tenant costs 512 KB of device state. This backend (after "Optimal
k-Secretary with Logarithmic Memory", arXiv 2502.09834) replaces the
reservoir with a phase-bucketed acceptance threshold:

* a doc enters iff its score beats the stream's threshold ``tau``, the
  running estimate of the K-th largest score;
* ``tau`` is re-estimated from each chunk's order statistics (the r-th
  largest of a W-wide chunk at position t targets the K/t quantile when
  r = round(W·K/t)), folded into an accumulator whose weights halve per
  chunk, and committed into a monotone floor at phase boundaries
  p = ⌊log₂(t/K)⌋;
* before t reaches K every doc enters; the crossing chunk (and any chunk
  too narrow to resolve the quantile while tau is still -inf) admits its
  top-B by score, B the chunk-law mean, so admit counts stay on the
  closed-form write law E[writes] = Σ min(1, K/j).

The admission scan is ``kernels.logmem_update`` (the hand-written CUDA
kernel on the card, its plain version on the CPU); the O(M·W log W)
threshold epilogue is plain torch. Every float32 expression keeps the
reference's operation order, so tau and the accumulator are bit-equal to
the reference's, with one documented exception: the phase is
⌊log₂(t/K)⌋ computed with ``torch.log2``, which is exact at powers of two
where the reference's ``jnp.log2`` on XLA's CPU backend can land below
the integer (ROADMAP queue 3).

Contract differences from the exact backend: no ids are stored, so
re-observed ids are not deduped, survivors are empty and nothing is ever
evicted; admission follows the write law up to a 1 − O(1/√K) slack
(``law_slack``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import shp, topk
from repro_torch.kernels.logmem_update import ops as lm_ops

from . import router

PAD_ID = router.PAD_ID

# persistent phase buckets: covers windows up to K·2^N_PHASES docs
N_PHASES = 24
# per-chunk decay of the quantile accumulator: recent chunks aim at the
# current K/t quantile, old chunks at stale (larger) ones
DECAY = 0.5
# admit-count slack constant: |admits − law| ≤ LAW_SLACK_C/√K · law
LAW_SLACK_C = 4.0


def law_slack(k, c: float = LAW_SLACK_C) -> float:
    """Fractional admit-count slack of the logmem backend at width K: the
    1 − O(1/√K) approximation budget."""
    return float(c) / math.sqrt(float(k))


class LogmemState(NamedTuple):
    """M logmem streams stacked on a leading axis — 7 scalars and 2
    per-phase vectors per stream, against the exact backend's O(K)."""

    seen: torch.Tensor  # (M,) int32 — docs observed (padding excluded)
    admits: torch.Tensor  # (M,) int32 — total docs admitted
    tau: torch.Tensor  # (M,) float32 — active threshold (-inf cold)
    tau_floor: torch.Tensor  # (M,) float32 — floor from committed phases
    q_num: torch.Tensor  # (M,) float32 — decayed quantile numerator
    q_den: torch.Tensor  # (M,) float32 — decayed quantile weight
    phase: torch.Tensor  # (M,) int32 — current phase (-1 pre-warm)
    phase_tau: torch.Tensor  # (M, P) float32 — committed threshold/phase
    phase_admits: torch.Tensor  # (M, P) int32 — admits per phase


def init(m: int, k: int | None = None, phases: int = N_PHASES,
         device=None) -> LogmemState:
    """Fresh state for M streams on ``device`` (the CUDA card unless
    given). ``k`` is accepted for signature parity with the exact
    ``engine.init`` but not stored."""
    del k
    dev = device_mod.resolve(device)
    f32, i32 = torch.float32, torch.int32
    ninf = float("-inf")
    return LogmemState(
        seen=torch.zeros((m,), dtype=i32, device=dev),
        admits=torch.zeros((m,), dtype=i32, device=dev),
        tau=torch.full((m,), ninf, dtype=f32, device=dev),
        tau_floor=torch.full((m,), ninf, dtype=f32, device=dev),
        q_num=torch.zeros((m,), dtype=f32, device=dev),
        q_den=torch.zeros((m,), dtype=f32, device=dev),
        phase=torch.full((m,), -1, dtype=i32, device=dev),
        phase_tau=torch.full((m, phases), ninf, dtype=f32, device=dev),
        phase_admits=torch.zeros((m, phases), dtype=i32, device=dev),
    )


def state_from_numpy(leaves, device=None) -> LogmemState:
    """The port's state from a reference ``LogmemState`` given as its 9
    leaves in field order, as numpy arrays."""
    dev = device_mod.resolve(device)
    dtypes = [np.int32, np.int32, np.float32, np.float32, np.float32,
              np.float32, np.int32, np.float32, np.int32]
    if len(leaves) != len(dtypes):
        raise ValueError(f"need {len(dtypes)} leaves, got {len(leaves)}")
    return LogmemState(*(torch.tensor(np.asarray(x, dt), device=dev)
                         for x, dt in zip(leaves, dtypes)))


def state_to_numpy(state: LogmemState) -> Tuple[np.ndarray, ...]:
    """Inverse of ``state_from_numpy``: the 9 leaves as numpy arrays."""
    return tuple(x.cpu().numpy() for x in state)


def state_bytes_per_stream(state: LogmemState) -> float:
    """Device bytes per stream of this state (leaves / M)."""
    m = state.seen.shape[0]
    return sum(x.numel() * x.element_size() for x in state) / max(m, 1)


def exact_bytes_per_stream(k: int) -> float:
    """Device bytes per stream of the exact backend at width K (f32
    scores + i32 ids + i32 seen)."""
    return 8.0 * k + 4.0


def update(state: LogmemState, batch_scores: torch.Tensor,
           batch_ids: torch.Tensor, k: int
           ) -> Tuple[LogmemState, torch.Tensor]:
    """Advance M logmem streams by one chunk: scores/ids (M, W), padding =
    (-inf, -1). Returns (new_state, wrote (M, W) bool), the contract of
    the exact ``engine.update``. Live scores must be finite (the engine
    quarantines the others); pad entries are inert."""
    m, w = batch_scores.shape
    dev = batch_scores.device
    scores = batch_scores.to(torch.float32).contiguous()
    ids = batch_ids.to(torch.int32).contiguous()
    # a full tensor, not a Python scalar: CUDA divides by a host scalar
    # through its reciprocal, which can round differently
    kf = torch.full((m,), float(k), dtype=torch.float32, device=dev)

    mask, _, lcounts, _ = lm_ops.logmem_admit(scores, ids,
                                              state.tau.contiguous())
    live = ids >= 0
    wl = lcounts.sum(dim=1, dtype=torch.int32)  # live docs this chunk
    wl_f = wl.to(torch.float32)
    t_after = state.seen + wl
    t_f = t_after.to(torch.float32)

    # one descending sort per row serves the cold top-B selection (ranks)
    # and the quantile estimate (r-th largest); the reference's stable
    # argsort of -s ties to the lower column with -0.0 equal to +0.0,
    # which is the order of ``topk.rank_key`` with the column as id
    s_masked = torch.where(live, scores, float("-inf"))
    col = torch.arange(w, dtype=torch.int32, device=dev).expand(m, w)
    order = torch.sort(topk.rank_key(s_masked, col), dim=1).indices
    sorted_desc = torch.gather(s_masked, 1, order)
    ranks = torch.empty((m, w), dtype=torch.int32, device=dev)
    ranks.scatter_(1, order, col)

    admit_all = t_after <= k  # reservoir not yet full: everything enters
    cold = ~admit_all & torch.isneginf(state.tau)
    steady = ~admit_all & ~cold
    # cold/unresolvable fallback: admit the chunk-law mean count (top-B
    # by score), keeping admit counts on the closed-form write law
    one = torch.ones_like(t_f)
    budget = torch.minimum(
        torch.maximum(torch.round(torch.minimum(t_f, kf) * wl_f
                                  / torch.maximum(t_f, one)),
                      torch.zeros_like(t_f)), wl_f).to(torch.int32)
    topb = live & (ranks < budget[:, None])
    wrote = torch.where(admit_all[:, None], live,
                        torch.where(cold[:, None], topb, mask > 0))

    # quantile estimate: r = round(W·K/t); chunks too narrow to resolve
    # it (r_raw < 1/2) contribute nothing
    r_raw = wl_f * kf / torch.maximum(t_f, one)
    resolvable = ~admit_all & (r_raw >= 0.5) & (wl > 0)
    r = torch.minimum(torch.maximum(torch.round(r_raw), one),
                      torch.maximum(wl_f, one)).to(torch.int64)
    est = torch.gather(sorted_desc, 1, (r - 1)[:, None])[:, 0]

    # phase boundary: commit the finished phase's estimate into the
    # monotone floor, restart the accumulator
    p = torch.floor(torch.log2(torch.maximum(t_f / kf, one))).to(torch.int32)
    boundary = steady & (p > state.phase)
    tiny = torch.full_like(t_f, 1e-30)
    ratio_old = state.q_num / torch.maximum(state.q_den, tiny)
    commit_ok = boundary & (state.q_den > 0)
    tau_floor = torch.where(commit_ok,
                            torch.maximum(state.tau_floor, ratio_old),
                            state.tau_floor)
    zero = torch.zeros_like(t_f)
    q_num = torch.where(boundary, zero, state.q_num)
    q_den = torch.where(boundary, zero, state.q_den)
    phase = torch.where(boundary, p, state.phase)

    q_num = torch.where(resolvable, DECAY * q_num + wl_f * est, q_num)
    q_den = torch.where(resolvable, DECAY * q_den + wl_f, q_den)
    tau = torch.where(q_den > 0,
                      torch.maximum(tau_floor,
                                    q_num / torch.maximum(q_den, tiny)),
                      tau_floor)

    # O(log K) diagnostics: the committed threshold of the finished
    # phase, and admits attributed to the (post-commit) current phase
    n_ph = state.phase_tau.shape[1]
    ph_idx = torch.arange(n_ph, dtype=torch.int32, device=dev)[None, :]
    pt_hot = ph_idx == state.phase.clamp(0, n_ph - 1)[:, None]
    phase_tau = torch.where(pt_hot & commit_ok[:, None], ratio_old[:, None],
                            state.phase_tau)
    chunk_admits = wrote.sum(dim=1, dtype=torch.int32)
    pa_hot = ph_idx == phase.clamp(0, n_ph - 1)[:, None]
    phase_admits = state.phase_admits + \
        pa_hot.to(torch.int32) * chunk_admits[:, None]

    return LogmemState(seen=t_after, admits=state.admits + chunk_admits,
                       tau=tau, tau_floor=tau_floor, q_num=q_num,
                       q_den=q_den, phase=phase, phase_tau=phase_tau,
                       phase_admits=phase_admits), wrote


def thresholds(state: LogmemState) -> torch.Tensor:
    """(M,) active acceptance thresholds — the logmem analog of the exact
    backend's entry bar (-inf while cold)."""
    return state.tau


def expected_admits(n, k: int) -> np.ndarray:
    """Closed-form E[total admits] after n docs — the write law
    E[writes] = Σ_{j≤n} min(1, K/j) both backends are metered against
    (``shp.expected_cum_writes_batched`` at batch=1)."""
    n = np.asarray(n, np.int64)
    out = shp.expected_cum_writes_batched(np.maximum(n, 1) - 1, int(k), 1)
    return np.where(n > 0, out, 0.0)


def trace_competitive_ratio(scores, k: int, chunk: int, *,
                            device=None) -> Dict:
    """Replay score traces through ``update`` on ``device`` (the CUDA card
    unless given) and quantify the realized gap to the exact reservoir.

    ``scores``: (n,) or (M, n) float — one window per row. Returns per
    stream the realized competitive ratio (top-K mass kept by the
    admitted set over the trace's true top-K mass), the constant
    c = (1 − ratio)·√K of the 1 − c/√K guarantee, and the admit count
    against the write law. The last (possibly partial) chunk is padded
    with (-inf, -1), so the harness also exercises pad inertness."""
    arr = np.atleast_2d(np.asarray(scores, np.float32))
    m, n = arr.shape
    if n <= 0 or chunk <= 0:
        raise ValueError("need a non-empty trace and chunk > 0")
    dev = device_mod.resolve(device)
    st = init(m, device=dev)
    admitted = [[] for _ in range(m)]
    for start in range(0, n, chunk):
        sl = arr[:, start:start + chunk]
        wl = sl.shape[1]
        s = np.full((m, chunk), router.PAD_SCORE, np.float32)
        i = np.full((m, chunk), PAD_ID, np.int32)
        s[:, :wl] = sl
        i[:, :wl] = np.arange(start, start + wl, dtype=np.int32)[None, :]
        st, wrote = update(st, torch.tensor(s, device=dev),
                           torch.tensor(i, device=dev), k)
        wr = wrote.cpu().numpy()
        for row in range(m):
            admitted[row].append(sl[row][wr[row, :wl]])
    admits = st.admits.cpu().numpy().astype(np.int64)
    ratio = np.empty(m, np.float64)
    for row in range(m):
        got = np.concatenate(admitted[row]) if admitted[row] else \
            np.empty(0, np.float32)
        top_all = np.sort(arr[row].astype(np.float64))[-k:].sum()
        top_got = np.sort(got.astype(np.float64))[-min(k, got.size):].sum()
        ratio[row] = top_got / top_all if top_all else 1.0
    law = float(expected_admits(np.asarray([n]), k)[0])
    return {
        "k": k, "n": n, "chunk": chunk,
        "ratio": ratio,
        "c": (1.0 - ratio) * math.sqrt(k),
        "admits": admits,
        "expected_admits": law,
        "admit_ratio": admits / max(law, 1e-12),
        "min_ratio": float(ratio.min()),
        "max_c": float(((1.0 - ratio) * math.sqrt(k)).max()),
        "bytes_per_stream": state_bytes_per_stream(st),
        "exact_bytes_per_stream": exact_bytes_per_stream(k),
    }
