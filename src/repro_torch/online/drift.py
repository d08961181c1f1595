"""Sequential drift detection for the fleet engine — observed
reservoir-entry counts tested against the analytic top-K entry law; the
port of the reference's ``online.drift`` on (M,) torch tensors of the
engine's device.

Under the paper's i.u.d. assumption, a merge that extends a stream's
prefix from ``a`` to ``b`` docs admits a hypergeometric number of new
reservoir entries: the top-``min(b, K)`` of ``b`` exchangeable docs are
uniformly located, so the count of them landing in the last ``b − a``
positions has mean ``min(b,K)·(b−a)/b`` (the batched form of eq. 9/10)
and the matching hypergeometric variance. Real streams drift: bursty
scoring functions make entries arrive faster (or slower) than the law
predicts.

``update`` maintains, per stream, (M,) float32 tensors advanced inside
the engine's step:

* a cumulative deviation ``dev = Σ (observed − expected)`` and its
  variance budget ``var = Σ Var`` since the last reset, tested each chunk
  against a Bernstein bound calibrated from half the ``alpha`` budget
  (Bonferroni over ``max_checks`` chunk checkpoints);
* one-sided CUSUM excursions ``S± = max(0, S± ± (observed − expected))``
  with their own variance budgets (reset whenever the excursion touches
  zero), tested against the same Bernstein form from the other half of
  the budget — the test that keeps its power when the drift begins
  mid-window;
* exponentially-windowed recent observed/expected totals, whose ratio is
  the re-planner's rate-multiplier estimate ``rho_hat``.

Detection is *latched* (``fired`` stays up until ``reset_where``); the
engine re-plans the flagged streams between chunks and resets them.

Arithmetic: elementwise float32 in the reference's order of operations.
The reference runs ``update`` inside its jitted engine step, where XLA
contracts the two decayed windows' ``decay·x + d`` into one fused
multiply-add; ``update`` computes them fused too (``_fma32``), so the
detector leaves equal the reference's bit for bit on the CPU and the same
bits come out on the card. The Bernstein budget overrun is ``2·log(1) =
0`` exactly while ``checks <= max_checks``. The thresholds take a
float32 ``sqrt``, which torch rounds correctly on both devices and XLA
on the CPU may round one ulp off, so a threshold (and a ``scores``
value) may differ from the reference's in its last bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod


@dataclass(frozen=True)
class DriftConfig:
    """Static detector configuration."""

    alpha: float = 0.01  # total false-positive budget per stream-window
    max_checks: int = 1024  # Bonferroni budget: checkpoints at full power
    decay: float = 0.9  # per-chunk decay of the recent-rate window
    rho_min: float = 0.125  # clip range of the rate-multiplier estimate
    rho_max: float = 16.0

    @property
    def bernstein_a(self) -> float:
        """Whole-window test exponent: ln(2·max_checks/(alpha/2)).

        Checkpoints beyond ``max_checks`` keep testing with a
        quadratically decaying per-check budget (exponent grows by
        ``2·ln(checks/max_checks)``), which adds at most ~alpha/2 of
        lifetime false-positive mass instead of going permanently blind
        on long windows."""
        return math.log(4.0 * self.max_checks / self.alpha)

    @property
    def bernstein_a_cusum(self) -> float:
        """Per-side excursion test exponent (alpha/4 each side; same
        decaying extension beyond ``max_checks``)."""
        return math.log(4.0 * self.max_checks / self.alpha)


class DriftState(NamedTuple):
    """Per-stream sequential statistics, one leading (M,) axis."""

    seen: torch.Tensor  # (M,) f32 — docs observed (the law's prefix length)
    dev: torch.Tensor  # (M,) f32 — Σ (observed − expected) since reset
    var: torch.Tensor  # (M,) f32 — Σ chunk variance since reset
    expected: torch.Tensor  # (M,) f32 — Σ expected entries since reset
    dev_recent: torch.Tensor  # (M,) f32 — decayed deviation window
    exp_recent: torch.Tensor  # (M,) f32 — decayed expectation window
    cusum_pos: torch.Tensor  # (M,) f32 — positive excursion sum
    cusum_pos_var: torch.Tensor  # (M,) f32 — its variance budget
    cusum_pos_exp: torch.Tensor  # (M,) f32 — expected entries in excursion
    cusum_pos_seen: torch.Tensor  # (M,) f32 — docs seen at excursion anchor
    cusum_neg: torch.Tensor  # (M,) f32
    cusum_neg_var: torch.Tensor  # (M,) f32
    cusum_neg_exp: torch.Tensor  # (M,) f32
    cusum_neg_seen: torch.Tensor  # (M,) f32
    checks: torch.Tensor  # (M,) i32 — chunk checkpoints consumed
    fired: torch.Tensor  # (M,) bool — latched detection flag


def init(m: int, device=None) -> DriftState:
    """M fresh detectors on ``device`` (the CUDA card unless given)."""
    dev = device_mod.resolve(device)
    z = torch.zeros((m,), dtype=torch.float32, device=dev)
    return DriftState(seen=z, dev=z, var=z, expected=z, dev_recent=z,
                      exp_recent=z, cusum_pos=z, cusum_pos_var=z,
                      cusum_pos_exp=z, cusum_pos_seen=z, cusum_neg=z,
                      cusum_neg_var=z, cusum_neg_exp=z, cusum_neg_seen=z,
                      checks=torch.zeros((m,), dtype=torch.int32,
                                         device=dev),
                      fired=torch.zeros((m,), dtype=torch.bool, device=dev))


def state_from_numpy(leaves, device=None) -> DriftState:
    """The port's state from a reference ``DriftState`` given as a mapping
    (or sequence in field order) of numpy arrays."""
    dev = device_mod.resolve(device)
    if not isinstance(leaves, dict):
        leaves = dict(zip(DriftState._fields, leaves))
    out = {}
    for f in DriftState._fields:
        dtype = {"checks": np.int32, "fired": np.bool_}.get(f, np.float32)
        out[f] = torch.tensor(np.asarray(leaves[f], dtype), device=dev)
    return DriftState(**out)


def state_to_numpy(state: DriftState) -> dict:
    """Inverse of ``state_from_numpy``: {field: numpy array}."""
    return {f: getattr(state, f).cpu().numpy() for f in DriftState._fields}


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _fma32(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 ``a·x + y`` with one rounding, as XLA's fused multiply-add
    gives it: the float32 product is exact in float64, the float64 sum is
    rounded to float32 (equal to the fused result except when that sum
    lies on a float32 rounding midpoint)."""
    a64 = float(np.float32(a))
    return (a64 * x.double() + y.double()).float()


def chunk_law(seen_before, seen_after, k) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) of the null entry count for a merge extending the
    prefix from ``seen_before`` to ``seen_after`` docs — hypergeometric:
    the top-``min(b,K)`` of b exchangeable docs, sampled by the last
    ``b − a`` positions."""
    device = next((x.device for x in (seen_before, seen_after, k)
                   if isinstance(x, torch.Tensor)), torch.device("cpu"))
    a = _f32(seen_before, device)
    b = _f32(seen_after, device)
    kf = _f32(k, device)
    w = b - a
    kc = torch.minimum(b, kf)
    mean = torch.where(b > 0, kc * w / torch.clamp_min(b, 1.0), 0.0)
    frac = kc / torch.clamp_min(b, 1.0)
    var = torch.where(b > 1,
                      w * frac * (1.0 - frac) * (b - w)
                      / torch.clamp_min(b - 1.0, 1.0), 0.0)
    return mean, var


def bernstein_threshold(var, a_const):
    """Deviation bound t with P(|Σ increments| > t) <= 2·exp(−a_const)
    for centered increments bounded by 1 with variance budget ``var``."""
    return a_const / 3.0 + torch.sqrt(a_const * a_const / 9.0
                                      + 2.0 * a_const * var)


def _budget_overrun(checks, cfg: DriftConfig):
    """Extra threshold exponent past the Bonferroni budget: checkpoints
    j > max_checks spend a per-check budget decaying like
    (max_checks/j)², so testing never stops but the added lifetime
    false-positive mass stays bounded (~alpha/2)."""
    over = torch.clamp_min(checks.to(torch.float32) / cfg.max_checks, 1.0)
    return 2.0 * torch.log(over)


def update(state: DriftState, wrote_count, seen_after,
           k, cfg: DriftConfig, slack: float = 0.0) -> DriftState:
    """One chunk of evidence per stream ((M,) batched).

    ``wrote_count``: reservoir entries this chunk; ``seen_after``: docs
    observed after the merge; ``k``: per-stream (or scalar) reservoir
    width. Streams that observed nothing this chunk are untouched.

    ``slack`` is the fractional admit-count tolerance of an approximate
    engine backend (``streams.logmem.law_slack`` — the 1−O(1/√K)
    budget): each test's threshold grows by ``slack × expected mass``
    accumulated since its anchor, so the backend's systematic law bias
    is absorbed without loosening the null guarantee (thresholds only
    grow; slack = 0 reproduces the exact-backend test bitwise).
    """
    device = state.seen.device
    w = _f32(wrote_count, device)
    b = _f32(seen_after, device)
    active = b > state.seen
    mean, var_c = chunk_law(state.seen, b, _f32(k, device))
    mean = torch.where(active, mean, 0.0)
    var_c = torch.where(active, var_c, 0.0)
    d = torch.where(active, w - mean, 0.0)
    dev = state.dev + d
    var = state.var + var_c
    expected = state.expected + mean
    dev_recent = _fma32(cfg.decay, state.dev_recent, d)
    exp_recent = _fma32(cfg.decay, state.exp_recent, mean)
    cusum_pos = torch.clamp_min(state.cusum_pos + d, 0.0)
    pos_live = cusum_pos > 0.0
    was_pos = state.cusum_pos > 0.0
    cusum_pos_var = torch.where(pos_live, state.cusum_pos_var + var_c, 0.0)
    cusum_pos_exp = torch.where(pos_live, state.cusum_pos_exp + mean, 0.0)
    cusum_pos_seen = torch.where(
        pos_live, torch.where(was_pos, state.cusum_pos_seen, state.seen),
        0.0)
    cusum_neg = torch.clamp_min(state.cusum_neg - d, 0.0)
    neg_live = cusum_neg > 0.0
    was_neg = state.cusum_neg > 0.0
    cusum_neg_var = torch.where(neg_live, state.cusum_neg_var + var_c, 0.0)
    cusum_neg_exp = torch.where(neg_live, state.cusum_neg_exp + mean, 0.0)
    cusum_neg_seen = torch.where(
        neg_live, torch.where(was_neg, state.cusum_neg_seen, state.seen),
        0.0)
    checks = state.checks + active.to(torch.int32)
    extra = _budget_overrun(checks, cfg)
    hit = (torch.abs(dev) > bernstein_threshold(var, cfg.bernstein_a + extra)
           + slack * expected) \
        | (cusum_pos > bernstein_threshold(cusum_pos_var,
                                           cfg.bernstein_a_cusum + extra)
           + slack * cusum_pos_exp) \
        | (cusum_neg > bernstein_threshold(cusum_neg_var,
                                           cfg.bernstein_a_cusum + extra)
           + slack * cusum_neg_exp)
    fired = state.fired | (active & hit)
    return DriftState(seen=torch.where(active, b, state.seen), dev=dev,
                      var=var, expected=expected, dev_recent=dev_recent,
                      exp_recent=exp_recent, cusum_pos=cusum_pos,
                      cusum_pos_var=cusum_pos_var,
                      cusum_pos_exp=cusum_pos_exp,
                      cusum_pos_seen=cusum_pos_seen, cusum_neg=cusum_neg,
                      cusum_neg_var=cusum_neg_var,
                      cusum_neg_exp=cusum_neg_exp,
                      cusum_neg_seen=cusum_neg_seen, checks=checks,
                      fired=fired)


def rho_hat(state: DriftState, cfg: DriftConfig) -> torch.Tensor:
    """(M,) rate-multiplier estimate for the re-planner.

    The re-planner's suffix laws are parametrized by the *instantaneous*
    observed/expected ratio (the drifted weight cancels out of the
    conditioned write law — see ``replan._w_suffix``), so the primary
    estimate is the short decayed recent window. When that window carries
    too little expected mass to be informative (tiny K, sparse chunks)
    the active CUSUM excursion's average ratio stands in. Clipped to the
    configured range."""
    recent = ((state.exp_recent + state.dev_recent)
              / torch.clamp_min(state.exp_recent, 1e-6))
    pos_r = 1.0 + state.cusum_pos / torch.clamp_min(state.cusum_pos_exp,
                                                    1e-6)
    neg_r = 1.0 - state.cusum_neg / torch.clamp_min(state.cusum_neg_exp,
                                                    1e-6)
    s_pos = state.cusum_pos / torch.sqrt(torch.clamp_min(
        state.cusum_pos_var, 1.0))
    s_neg = state.cusum_neg / torch.sqrt(torch.clamp_min(
        state.cusum_neg_var, 1.0))
    exc = torch.where(s_pos >= s_neg, pos_r, neg_r)
    exc = torch.where(torch.maximum(s_pos, s_neg) >= 1.0, exc, 1.0)
    rho = torch.where(state.exp_recent >= 3.0, recent, exc)
    return torch.clamp(rho, cfg.rho_min, cfg.rho_max)


def anchor_seen(state: DriftState) -> torch.Tensor:
    """(M,) estimated drift-onset position: the dominant excursion's
    anchor (docs seen when it left zero), falling back to the current
    position when neither excursion carries signal. Diagnostic: the
    suffix laws themselves are anchor-free."""
    s_pos = state.cusum_pos / torch.sqrt(torch.clamp_min(
        state.cusum_pos_var, 1.0))
    s_neg = state.cusum_neg / torch.sqrt(torch.clamp_min(
        state.cusum_neg_var, 1.0))
    anchor = torch.where(s_pos >= s_neg, state.cusum_pos_seen,
                         state.cusum_neg_seen)
    return torch.where(torch.maximum(s_pos, s_neg) >= 1.0, anchor,
                       state.seen)


def scores(state: DriftState, cfg: DriftConfig,
           slack: float = 0.0) -> torch.Tensor:
    """(M,) normalized change score: the largest of the three test
    statistics over its own threshold — >= 1 means the stream has (or
    would have) fired. ``slack`` widens the thresholds exactly as in
    ``update`` (approximate-backend law tolerance)."""
    extra = _budget_overrun(state.checks, cfg)
    whole = torch.abs(state.dev) / torch.clamp_min(
        bernstein_threshold(state.var, cfg.bernstein_a + extra)
        + slack * state.expected, 1e-9)
    pos = state.cusum_pos / torch.clamp_min(
        bernstein_threshold(state.cusum_pos_var,
                            cfg.bernstein_a_cusum + extra)
        + slack * state.cusum_pos_exp, 1e-9)
    neg = state.cusum_neg / torch.clamp_min(
        bernstein_threshold(state.cusum_neg_var,
                            cfg.bernstein_a_cusum + extra)
        + slack * state.cusum_neg_exp, 1e-9)
    return torch.maximum(whole, torch.maximum(pos, neg))


def reset_where(state: DriftState, mask) -> DriftState:
    """Restart the sequential statistics of the masked streams (after a
    re-plan consumed their evidence); ``seen`` is preserved — the law's
    prefix keeps growing."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=state.seen.device)

    def keep(old):
        return torch.where(mask, torch.zeros_like(old), old)

    return DriftState(seen=state.seen, **{
        f: keep(getattr(state, f)) for f in DriftState._fields[1:]})


class DriftEstimator:
    """Host-side convenience wrapper: owns a ``DriftState`` and its update
    for one (M,) fleet slice (the engine advances the pure ``update``
    inside its own step instead)."""

    def __init__(self, m: int, k, cfg: DriftConfig | None = None,
                 device=None):
        self.cfg = cfg if cfg is not None else DriftConfig()
        self.state = init(m, device=device)
        self.k = _f32(np.broadcast_to(np.asarray(k), (m,)).copy(),
                      self.state.seen.device)

    def observe(self, wrote_count, seen_after) -> np.ndarray:
        """Feed one chunk; returns the (M,) latched detection flags."""
        self.state = update(self.state, wrote_count, seen_after, self.k,
                            self.cfg)
        return self.state.fired.cpu().numpy()

    def rho_hat(self) -> np.ndarray:
        return rho_hat(self.state, self.cfg).cpu().numpy()

    def reset(self, mask) -> None:
        self.state = reset_where(self.state, mask)
