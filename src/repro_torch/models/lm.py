"""Top-level model: embedding → layer groups → norm → LM head — the port
of the reference's ``models.lm`` for decoder-only attention models with
dense FFNs (llama3.2-1b, yi-9b, starcoder2-3b, command-r-plus-104b).

* ``forward(params, cfg, batch)``          — full-sequence logits
* ``prefill(params, cfg, batch, cache)``   — fill caches, last logits
* ``decode_step(params, cfg, tok, cache)`` — one token with cache
* ``lm_loss(params, cfg, batch)``          — the training loss and the
  per-example NLL that curation scores by

Parameters are a plain dict in the reference's layout, with each group a
list of per-layer dicts where the reference stacks the layers on a
leading axis; the layers run in a Python loop where the reference scans.
Caches are updated in place; the forward writes into no tensor that
autograd saved, so ``lm_loss`` differentiates through it.
``use_kernel=False`` takes the plain grouped attention for prefill and
the forward, the reference's own route; otherwise they run on the
``flash_attention`` kernel, and a gradient through the forward on the
card runs the kernel's backward.

Encoder-decoder models, vision/audio frontends, MoE, SSM, MLA and
cross-attention raise ``NotImplementedError`` (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import LayerSpec, ModelConfig

from . import attention as attn_mod
from . import blocks
from .common import apply_norm, dtype_of, init_dense, norm_params


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the model families the port does not run."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encoder-decoder models "
                                  f"{attn_mod.UNPORTED}")
    if cfg.frontend != "none" or cfg.learned_pos_embed:
        raise NotImplementedError(f"the {cfg.frontend!r} frontend and "
                                  f"learned positions {attn_mod.UNPORTED}")
    attn_mod.check_supported(cfg)
    for spec in cfg.layers:
        blocks.check_supported(spec)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, in ``init_params``' layout."""
    check_supported(cfg)
    shapes: dict[str, Any] = {
        "embed": (cfg.vocab_size, cfg.d_model),
        "final_norm": ({"scale": (cfg.d_model,), "bias": (cfg.d_model,)}
                       if cfg.use_layernorm else {"scale": (cfg.d_model,)}),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    shapes["dec"] = [[blocks.block_shapes(s, cfg) for _ in range(s.count)]
                     for s in cfg.layers]
    return shapes


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtypes, no storage — the counterpart of the reference's
    ``jax.eval_shape`` of ``init_params``."""
    dtype = dtype_of(cfg.param_dtype)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v) for v in tree]
        return torch.empty(tree, dtype=dtype, device="meta")

    return conv(param_shapes(cfg))


def param_count(cfg: ModelConfig) -> int:
    return sum(int(np.prod(s)) for s in _leaves(param_shapes(cfg)))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (the CUDA card unless given): truncated-normal fan-in
    matrices, zero norm scales and biases, as the reference draws them."""
    check_supported(cfg)
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)
    p: dict[str, Any] = {
        "embed": init_dense(gen, (cfg.vocab_size, cfg.d_model), (1,), dtype),
        "final_norm": norm_params(cfg.d_model, cfg.use_layernorm, dtype, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_dense(gen, (cfg.d_model, cfg.vocab_size), (0,),
                                  dtype)
    p["dec"] = [[blocks.block_params(gen, s, cfg, dtype)
                 for _ in range(s.count)] for s in cfg.layers]
    return p


def from_reference_params(params_np, cfg: ModelConfig, device=None) -> dict:
    """The reference's ``lm.init_params`` tree, as numpy arrays, in the
    port's layout: each group's leaves, stacked over the layer axis by the
    reference, are split into per-layer dicts."""
    check_supported(cfg)
    dev = device_mod.resolve(device)

    def conv(tree, layer=None):
        if isinstance(tree, dict):
            return {k: conv(v, layer) for k, v in tree.items()}
        a = np.asarray(tree)
        return torch.tensor(a if layer is None else a[layer], device=dev)

    p = {k: conv(v) for k, v in params_np.items() if k != "dec"}
    p["dec"] = [[conv(g, i) for i in range(s.count)]
                for g, s in zip(params_np["dec"], cfg.layers)]
    return p


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed_tokens(p, cfg, tokens):
    x = p["embed"][tokens.to(torch.int64)]  # (B, S, D)
    return x.to(dtype_of(cfg.activation_dtype))


def _head(p, cfg, x):
    """Final norm, then the tied embedding (or the LM head): float32
    logits, soft-capped when the config says so."""
    x = apply_norm(p["final_norm"], x, cfg.norm_eps, cfg.use_layernorm)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    logits = (x @ w).to(torch.float32)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _run_layers(p, cfg, x, positions, cache_groups=None, flash=False):
    """Every layer in order; returns (x, new cache groups or None)."""
    new_groups = []
    for gi, (gp, spec) in enumerate(zip(p["dec"], cfg.layers)):
        windows = spec.window_list()
        new_layers = []
        for li, lp in enumerate(gp):
            lc = None if cache_groups is None else cache_groups[gi][li]
            x, lc = blocks.block_forward(lp, spec, cfg, x, positions,
                                         cache=lc, window=windows[li],
                                         flash=flash)
            new_layers.append(lc)
        new_groups.append(new_layers)
    return x, (None if cache_groups is None else new_groups)


# ---------------------------------------------------------------------------
# Forward / caches / prefill / decode
# ---------------------------------------------------------------------------

def forward(p, cfg: ModelConfig, batch: dict, *, use_kernel: bool = True):
    """batch: tokens (B,S). Returns (logits (B,S,V) float32, aux loss 0)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    positions = _positions(*tokens.shape, tokens.device)
    x = _embed_tokens(p, cfg, tokens)
    x, _ = _run_layers(p, cfg, x, positions, flash=use_kernel)
    return _head(p, cfg, x), torch.zeros((), dtype=torch.float32,
                                         device=x.device)


def group_kv_len(spec: LayerSpec, kv_len: int) -> int:
    """Per-group cache depth: a purely sliding-window group only ever needs
    its largest window (rolling cache); any full-attention layer in the
    group forces the full length."""
    ws = spec.window_list()
    if any(w == 0 for w in ws):
        return kv_len
    return min(max(ws), kv_len)


def init_cache(cfg: ModelConfig, batch: int, kv_len: int, device=None):
    """Per-layer KV caches on ``device`` (the CUDA card unless given) and
    the global position, a Python int."""
    check_supported(cfg)
    dev = device_mod.resolve(device)
    dtype = dtype_of(cfg.activation_dtype)
    return {
        "pos": 0,
        "groups": [[blocks.init_layer_cache(s, cfg, batch,
                                            group_kv_len(s, kv_len), dtype,
                                            dev)
                    for _ in range(s.count)] for s in cfg.layers],
    }


def prefill(p, cfg: ModelConfig, batch: dict, cache, *,
            use_kernel: bool = True):
    """Run the prompt through the decoder, writing caches.
    Returns (logits of the last position (B,V), cache)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed_tokens(p, cfg, tokens)
    x, groups = _run_layers(p, cfg, x, positions, cache["groups"],
                            flash=use_kernel)
    logits = _head(p, cfg, x[:, -1:])[:, 0]
    return logits, {"pos": s, "groups": groups}


def decode_step(p, cfg: ModelConfig, token, cache):
    """token: (B,) integer. Returns (logits (B,V), cache)."""
    check_supported(cfg)
    b = token.shape[0]
    pos = cache["pos"]
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=token.device)
    x = _embed_tokens(p, cfg, token[:, None])
    x, groups = _run_layers(p, cfg, x, positions, cache["groups"])
    logits = _head(p, cfg, x)[:, 0]
    return logits, {"pos": pos + 1, "groups": groups}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(p, cfg: ModelConfig, batch: dict, aux_weight: float = 0.01, *,
            use_kernel: bool = True):
    """Causal-LM cross-entropy. Returns (loss, metrics): masked
    log-sum-exp minus the gold logit, averaged over the labelled tokens
    (labels < 0 are masked), plus ``aux_weight`` times the aux loss (0:
    no MoE is ported). metrics carries ``per_example_nll`` (B,) — the
    interestingness hook — and the token count."""
    logits, aux = forward(p, cfg, batch, use_kernel=use_kernel)
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    labels_safe = torch.clamp(labels, min=0).to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom + aux_weight * aux
    per_example_nll = nll.sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
    metrics = {
        "loss": nll.sum() / denom,
        "aux_loss": aux,
        "per_example_nll": per_example_nll,
        "tokens": mask.sum(),
    }
    return loss, metrics
