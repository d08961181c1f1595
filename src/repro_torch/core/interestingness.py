"""Interestingness functions (paper §IV, §VIII) — the port of the
reference's ``core.interestingness``.

The paper requires a cheap online scorer H(d) inducing a ranking; in the
training/serving integration the natural scorers are per-example loss,
predictive entropy, and margin. All scorers map (logits, labels, mask) →
(batch,) float32.

The entropy/NLL scorers run the ``entropy_scores`` kernel's wrapper: on a
CUDA tensor it launches the kernel or raises (the reference falls back to
plain jnp on any exception; the port does not), on a CPU tensor it runs
the plain version. ``use_kernel=False`` picks the plain formula
explicitly.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.entropy_scores import ops as _ops

Scorer = Callable[..., torch.Tensor]


def _masked_mean(x, mask: Optional[torch.Tensor], dim):
    if mask is None:
        return torch.mean(x, dim=dim)
    mask = mask.to(x.dtype)
    return (torch.sum(x * mask, dim=dim)
            / torch.clamp(torch.sum(mask, dim=dim), min=1.0))


def nll_score(logits, labels, mask: Optional[torch.Tensor] = None,
              use_kernel: bool = True):
    """Mean per-token negative log-likelihood per example.

    logits: (B, S, V) — labels: (B, S) int — mask: (B, S) optional.
    Hard examples (high loss) rank as most interesting.
    """
    _, nll = _entropy_nll(logits, labels, use_kernel)
    return _masked_mean(nll, mask, dim=-1)


def entropy_score(logits, labels: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  use_kernel: bool = True):
    """Mean predictive entropy per example — the paper's §VIII scorer
    (uncertain predictions are the interesting ones for HITL reanalysis)."""
    if labels is None:
        labels = torch.zeros(logits.shape[:-1], dtype=torch.int32,
                             device=logits.device)
    ent, _ = _entropy_nll(logits, labels, use_kernel)
    return _masked_mean(ent, mask, dim=-1)


def margin_score(logits, labels: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None):
    """Negative top-1/top-2 margin: small margin = uncertain = interesting.
    Equal logits tie as in ``jax.lax.top_k``: the two largest values, so a
    tied maximum gives margin 0."""
    top2 = torch.topk(logits.to(torch.float32), 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    return -_masked_mean(margin, mask, dim=-1)


def random_score(gen: torch.Generator, batch: int):
    """Random ranking — the control matching the classic SHP assumption —
    drawn uniform in [0, 1) on ``gen``'s device."""
    return torch.rand((batch,), generator=gen, dtype=torch.float32,
                      device=gen.device)


def _entropy_nll(logits, labels, use_kernel: bool):
    """(entropy, nll) per position, shape = labels.shape."""
    b = logits.shape[:-1]
    v = logits.shape[-1]
    flat, lab = logits.reshape(-1, v), labels.reshape(-1)
    if use_kernel:
        ent, nll = _ops.entropy_nll(flat, lab)
    else:
        ent, nll = _ops.reference(flat, lab)
    return ent.reshape(b), nll.reshape(b)


def batch_centered(scores):
    """Subtract the batch mean: removes any per-step trend exactly, so the
    reservoir sees a stationary rank stream. Loses absolute difficulty
    levels; use ema_relative when those matter."""
    scores = scores.to(torch.float32)
    return scores - torch.mean(scores)


def ema_relative(scores, ema, step, decay: float = 0.9):
    """Re-stationarize a trending score stream: ranking by
    ``score − EMA(score)`` removes the trend, restoring the analytic write
    law. Returns (relative_scores, new_ema). ``ema`` is bias-corrected à
    la Adam, so step 0 works from a zero init."""
    scores = scores.to(torch.float32)
    new_ema = decay * ema + (1.0 - decay) * torch.mean(scores)
    t = torch.as_tensor(step + 1, dtype=torch.float32)
    ema_hat = new_ema / (1.0 - decay ** t)
    return scores - ema_hat, new_ema


SCORERS: dict[str, Scorer] = {
    "nll": nll_score,
    "entropy": entropy_score,
    "margin": margin_score,
}


def get_scorer(name: str) -> Scorer:
    if name not in SCORERS:
        raise KeyError(f"unknown interestingness scorer {name!r}; have "
                       f"{list(SCORERS)}")
    return SCORERS[name]
