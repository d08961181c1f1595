"""Deterministic synthetic data — a NumPy copy of the reference's
``data.synthetic`` with its imports rewritten: batches are a pure function of
(config, global_step, example-index), so any worker can materialize any
slice of the global stream — the property that makes the pipeline elastic
and fault-tolerant (DESIGN.md §5).

Token streams follow a Zipf-ish marginal with a Markov twist so the LM loss
is learnable (quickstart/e2e examples train against it).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _rng_for(seed: int, step: int, index: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step, index)))


def example_tokens(cfg: ModelConfig, seq_len: int, seed: int, step: int,
                   index: int) -> np.ndarray:
    """One example's tokens — pure function of its global identity."""
    rng = _rng_for(seed, step, index)
    v = cfg.vocab_size
    # Zipf marginal over a 256-symbol alphabet embedded in the vocab, with
    # a deterministic successor rule 2/3 of the time (learnable structure).
    base = rng.zipf(1.3, size=seq_len + 1).clip(max=256) - 1
    tok = base.astype(np.int64)
    follow = rng.random(seq_len + 1) < (2.0 / 3.0)
    for i in range(1, seq_len + 1):
        if follow[i]:
            tok[i] = (tok[i - 1] * 31 + 7) % 256
    return (tok % v).astype(np.int32)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
               step: int = 0, indices=None, batch: int | None = None,
               seq_len: int | None = None) -> dict:
    """Materialize a batch dict for ``indices`` (global example ids)."""
    b = batch or shape.global_batch
    s = seq_len or shape.seq_len
    if indices is None:
        indices = np.arange(b) + step * b
    dec_len = cfg.decoder_len if cfg.is_encoder_decoder else s
    toks = np.stack([example_tokens(cfg, dec_len, seed, step, int(i))
                     for i in indices])
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "labels": toks[:, 1:].astype(np.int32)}
    if cfg.is_encoder_decoder:
        rng = _rng_for(seed, step, 2**31 - 1)
        out["frames"] = rng.standard_normal(
            (len(indices), s, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_patches":
        rng = _rng_for(seed, step, 2**31 - 2)
        out["patch_embeds"] = rng.standard_normal(
            (len(indices), cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out
