"""Shared step functions: train / prefill / decode — the port of the
reference's ``runtime.steps``.

The paper's feature is wired in here: every train step scores each example
(interestingness = per-example NLL) and merges the batch into the SHP top-K
reservoir on the device; the reservoir is part of the carried train state,
so curation costs one small top-k merge per step.

Where the reference takes ``jax.value_and_grad`` of ``lm.lm_loss``, the
port runs ``torch.autograd.grad`` over the parameter leaves; on the card
the attention's gradient is the ``flash_attention`` backward kernel pair.
``microbatches > 1`` accumulates float32 gradients in a Python loop where
the reference scans. Nothing in ``train_step`` reads a value back to the
host: the caller's read of the loss is the step's one sync.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import interestingness
from repro_torch.core import topk as topk_mod
from repro_torch.models import lm
from repro_torch.optim import adamw

SCORE_MODES = ("nll", "nll_centered", "nll_relative")


class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState
    step: torch.Tensor  # () int32 global step
    reservoir: topk_mod.ReservoirState  # SHP top-K over example NLL
    score_ema: torch.Tensor  # () float32 — EMA of mean NLL (relative scoring)


def init_train_state(cfg, seed: int = 0, reservoir_k: int = 1024,
                     device=None) -> TrainState:
    """Random weights from ``seed`` (``lm.init_params``), zero moments, an
    empty reservoir of width ``reservoir_k``, on ``device`` (the CUDA card
    unless given)."""
    dev = device_mod.resolve(device)
    params = lm.init_params(cfg, seed, device=dev)
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      reservoir=topk_mod.init(reservoir_k, device=dev),
                      score_ema=torch.zeros((), dtype=torch.float32,
                                            device=dev))


def abstract_train_state(cfg, reservoir_k: int = 1024) -> TrainState:
    """``init_train_state``'s shapes and dtypes as tensors on the ``meta``
    device, with no storage — the counterpart of ``jax.eval_shape``."""
    params = lm.abstract_params(cfg)
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32, device="meta"),
                      reservoir=topk_mod.init(reservoir_k, device="meta"),
                      score_ema=torch.zeros((), dtype=torch.float32,
                                            device="meta"))


def from_reference_train_state(state_np, cfg, device=None) -> TrainState:
    """The reference's ``TrainState``, its leaves as numpy arrays, in the
    port's layout on ``device`` (the CUDA card unless given): params and
    the AdamW moments split over the layer axis by
    ``lm.from_reference_params``, the step counters, the reservoir and
    ``score_ema`` as tensors."""
    dev = device_mod.resolve(device)
    tensor = lambda x: torch.tensor(np.asarray(x), device=dev)  # noqa: E731
    conv = lambda tree: lm.from_reference_params(tree, cfg,  # noqa: E731
                                                 device=dev)
    res = state_np.reservoir
    return TrainState(
        params=conv(state_np.params),
        opt=adamw.AdamWState(step=tensor(state_np.opt.step),
                             m=conv(state_np.opt.m), v=conv(state_np.opt.v)),
        step=tensor(state_np.step),
        reservoir=topk_mod.ReservoirState(scores=tensor(res.scores),
                                          ids=tensor(res.ids),
                                          seen=tensor(res.seen)),
        score_ema=tensor(state_np.score_ema))


def loss_and_grads(params, cfg, batch: dict, aux_weight: float = 0.01, *,
                   use_kernel: bool = True):
    """``jax.value_and_grad(lm.lm_loss, has_aux=True)``'s counterpart:
    (loss, metrics, grads) with grads a tree like ``params``, everything
    detached. Every parameter must take part in the loss."""
    leaves = adamw.tree_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        tree = adamw.tree_map(lambda _: next(it), params)
        loss, metrics = lm.lm_loss(tree, cfg, batch, aux_weight,
                                   use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, live)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            adamw.tree_map(lambda _: next(it), params))


def _accumulate(params, cfg, batch, aux_weight, microbatches):
    """Gradient accumulation over ``microbatches`` equal slices of the
    batch: float32 gradient sums from zero, divided by the count; the
    per-example NLL in batch order and the mean of the slices' losses."""
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"a batch of {b} does not split into "
                         f"{microbatches} microbatches")
    n = b // microbatches
    gsum = adamw.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
    nll, losses = [], []
    for i in range(microbatches):
        micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        _, met, g = loss_and_grads(params, cfg, micro, aux_weight)
        gsum = adamw.tree_map(lambda a, c: a + c.to(torch.float32), gsum, g)
        nll.append(met["per_example_nll"])
        losses.append(met["loss"])
    grads = adamw.tree_map(lambda g: g / microbatches, gsum)
    dev = batch["tokens"].device
    metrics = {"loss": torch.mean(torch.stack(losses)),
               "aux_loss": torch.zeros((), dtype=torch.float32, device=dev),
               "per_example_nll": torch.cat(nll),
               "tokens": torch.tensor(float(batch["tokens"].numel()),
                                      dtype=torch.float32, device=dev)}
    return metrics, grads


def train_step(state: TrainState, batch: dict, cfg, *, lr: float = 3e-4,
               aux_weight: float = 0.01, grad_clip: float = 1.0,
               microbatches: int = 1, score_mode: str = "nll"):
    """One optimizer step + reservoir merge: (new state, metrics). batch
    holds ``tokens`` and ``labels`` (B, S) and, for the reservoir,
    ``example_ids`` (B,) int32 global stream indices (when absent:
    step · B + slot), as tensors on the state's device.

    ``score_mode``: "nll" ranks by the per-example NLL, "nll_centered" by
    its deviation from the batch mean, "nll_relative" by its deviation
    from a bias-corrected EMA of the batch means
    (``core.interestingness.ema_relative``)."""
    if score_mode not in SCORE_MODES:
        raise ValueError(f"unknown score_mode {score_mode!r}; have "
                         f"{SCORE_MODES}")
    if microbatches > 1:
        metrics, grads = _accumulate(state.params, cfg, batch, aux_weight,
                                     microbatches)
    else:
        _, metrics, grads = loss_and_grads(state.params, cfg, batch,
                                           aux_weight)
    params, opt, gnorm = adamw.apply(state.params, grads, state.opt, lr=lr,
                                     grad_clip=grad_clip)
    ids = batch.get("example_ids")
    if ids is None:
        b = batch["tokens"].shape[0]
        ids = state.step * b + torch.arange(b, dtype=torch.int32,
                                            device=state.step.device)
    nll = metrics["per_example_nll"]
    if score_mode == "nll_centered":
        # batch-mean centering removes the training-loss trend and
        # restores the SHP write law
        scores, score_ema = nll - torch.mean(nll), state.score_ema
    elif score_mode == "nll_relative":
        # EMA de-trending keeps absolute difficulty comparable across
        # steps; it partially restores the law
        scores, score_ema = interestingness.ema_relative(
            nll, state.score_ema, state.step)
    else:
        scores, score_ema = nll, state.score_ema
    reservoir, wrote = topk_mod.update(state.reservoir, scores, ids)
    out_metrics = {
        "loss": metrics["loss"], "aux_loss": metrics["aux_loss"],
        "grad_norm": gnorm, "tokens": metrics["tokens"],
        "reservoir_writes": wrote.sum(),
        "reservoir_threshold": topk_mod.threshold(reservoir),
        "per_example_nll": nll,
        "wrote_mask": wrote,
    }
    new_state = TrainState(params=params, opt=opt, step=state.step + 1,
                           reservoir=reservoir, score_ema=score_ema)
    return new_state, out_metrics


def prefill_step(params, batch: dict, cache, cfg):
    return lm.prefill(params, cfg, batch, cache)


def decode_step(params, token, cache, cfg):
    return lm.decode_step(params, cfg, token, cache)
