"""Top-level model: embedding → layer groups → norm → LM head — the port
of the reference's ``models.lm`` for all ten configs: decoder-only
models whose layers mix by attention (grouped-query, soft-capped where
the config says so, or MLA), the SSD scan or both in parallel, with
dense or Mixture-of-Experts FFNs; the vision-patch frontend
(pixtral-12b); and the encoder-decoder (whisper-base).

* ``encode(params, cfg, frames)``          — the encoder's states
* ``forward(params, cfg, batch)``          — full-sequence logits
* ``prefill(params, cfg, batch, cache)``   — fill caches, last logits
* ``decode_step(params, cfg, tok, cache)`` — one token with cache
* ``lm_loss(params, cfg, batch)``          — the training loss and the
  per-example NLL that curation scores by

``batch`` holds ``tokens`` (B, S) and, where the config says so,
``frames`` (B, S_enc, D) (encoder-decoder: the audio frontend's stub,
precomputed frame embeddings) or ``patch_embeds`` (B, n_patches, D)
(``vision_patches``: they replace the first n_patches positions of the
sequence, in the forward and at prefill). Parameters are a plain dict in
the reference's layout, with each group a list of per-layer dicts where
the reference stacks the layers on a leading axis; the layers run in a
Python loop where the reference scans. KV and MLA latent caches are
updated in place and SSM states replaced; a cross-attention layer's
encoder K/V are written into its cache once, at prefill. The forward
writes into no tensor that autograd saved, so ``lm_loss`` differentiates
through it; under ``cfg.remat`` each layer is rematerialised in the
backward (``torch.utils.checkpoint``). ``use_kernel=False`` takes the
plain grouped attention for prefill, the encoder and the forward, the
reference's own route; otherwise their attention runs on the
``flash_attention`` kernel (cross-attention too, under its non-causal
mask), and a gradient through the forward on the card runs the kernel's
backward (soft-capped and at MLA's head dims too). Decode's attention,
MLA's decode over its latent cache, the SSD scan and the MoE's routing,
dispatch and combine are plain tensor operations on either route
(``models.attention``, ``models.ssm``, ``models.ffn``).
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_mod
from repro_torch.configs.base import LayerSpec, ModelConfig

from . import attention as attn_mod
from . import blocks
from . import ssm as ssm_mod
from .common import (apply_norm, dtype_of, init_dense, norm_params,
                     sinusoidal_pos)

# leaves kept in float32 whatever param_dtype is: the SSM's decay and skip
# terms and the MoE router
FLOAT32_LEAVES = ssm_mod.FLOAT32_LEAVES + ("router",)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _norm_shapes(cfg) -> dict:
    return ({"scale": (cfg.d_model,), "bias": (cfg.d_model,)}
            if cfg.use_layernorm else {"scale": (cfg.d_model,)})


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, in ``init_params``' layout."""
    shapes: dict[str, Any] = {
        "embed": (cfg.vocab_size, cfg.d_model),
        "final_norm": _norm_shapes(cfg),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    if cfg.learned_pos_embed:
        shapes["pos_embed"] = (max(cfg.decoder_len, 1), cfg.d_model)
    if cfg.encoder_layers:
        shapes["enc"] = [[blocks.block_shapes(s, cfg)
                          for _ in range(s.count)]
                         for s in cfg.encoder_layers]
        shapes["enc_norm"] = _norm_shapes(cfg)
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
    ``jax.eval_shape`` of ``init_params``. Leaves take ``param_dtype``,
    except ``FLOAT32_LEAVES``: the SSM's ``a_log``, ``dt_bias`` and
    ``d_skip`` and the MoE's ``router``."""
    dtype = dtype_of(cfg.param_dtype)

    def conv(tree, name=None):
        if isinstance(tree, dict):
            return {k: conv(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v) for v in tree]
        leaf = torch.float32 if name in FLOAT32_LEAVES else dtype
        return torch.empty(tree, dtype=leaf, device="meta")

    return conv(param_shapes(cfg))


def param_count(cfg: ModelConfig) -> int:
    return sum(int(np.prod(s)) for s in _leaves(param_shapes(cfg)))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (the CUDA card unless given): truncated-normal fan-in
    matrices (the learned positions' fan-in over d_model), zero norm
    scales and biases (LayerNorm scales one), as the reference draws
    them."""
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)
    ln = cfg.use_layernorm
    p: dict[str, Any] = {
        "embed": init_dense(gen, (cfg.vocab_size, cfg.d_model), (1,), dtype),
        "final_norm": norm_params(cfg.d_model, ln, dtype, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_dense(gen, (cfg.d_model, cfg.vocab_size), (0,),
                                  dtype)
    if cfg.learned_pos_embed:
        p["pos_embed"] = init_dense(gen, (max(cfg.decoder_len, 1),
                                          cfg.d_model), (1,), dtype)
    if cfg.encoder_layers:
        p["enc"] = [[blocks.block_params(gen, s, cfg, dtype)
                     for _ in range(s.count)] for s in cfg.encoder_layers]
        p["enc_norm"] = norm_params(cfg.d_model, ln, dtype, dev)
    p["dec"] = [[blocks.block_params(gen, s, cfg, dtype)
                 for _ in range(s.count)] for s in cfg.layers]
    return p


def from_reference_params(params_np, cfg: ModelConfig, device=None) -> dict:
    """The reference's ``lm.init_params`` tree, as numpy arrays, in the
    port's layout: each group's leaves (decoder and encoder), stacked over
    the layer axis by the reference, are split into per-layer dicts."""
    dev = device_mod.resolve(device)

    def conv(tree, layer=None):
        if isinstance(tree, dict):
            return {k: conv(v, layer) for k, v in tree.items()}
        a = np.asarray(tree)
        return torch.tensor(a if layer is None else a[layer], device=dev)

    groups = {"dec": cfg.layers, "enc": cfg.encoder_layers}
    return {k: ([[conv(g, i) for i in range(s.count)]
                 for g, s in zip(v, groups[k])] if k in groups else conv(v))
            for k, v in params_np.items()}


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed_tokens(p, cfg, tokens, positions):
    """Token embeddings, plus the learned positions where the config has
    them. A position past the table's last row reads the last row: the
    reference's gather clamps an out-of-range index (JAX), where torch
    would raise (on the card, a device-side assert), so the port clamps
    it explicitly — a decode past ``decoder_len`` gives the reference's
    logits."""
    x = p["embed"][tokens.to(torch.int64)]  # (B, S, D)
    if cfg.learned_pos_embed:
        last = p["pos_embed"].shape[0] - 1
        x = x + p["pos_embed"][positions.to(torch.int64).clamp(max=last)]
    return x.to(dtype_of(cfg.activation_dtype))


def _blend_patches(x, patch_embeds):
    """The vision frontend's stub: precomputed patch embeddings (B, P, D)
    replace the first P positions of the sequence (prefix-image layout).
    A sequence shorter than P raises ``ValueError``: the blend would
    outgrow its positions."""
    n, s = patch_embeds.shape[1], x.shape[1]
    if s < n:
        raise ValueError(f"a sequence of {s} tokens is shorter than its {n} "
                         f"patch embeddings")
    return torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)


def _frontend(p, cfg, batch, positions):
    """The decoder's input: embedded tokens, the patch prefix blended in
    where the config has the vision frontend."""
    x = _embed_tokens(p, cfg, batch["tokens"], positions)
    if cfg.frontend == "vision_patches":
        x = _blend_patches(x, batch["patch_embeds"])
    return x


def _head(p, cfg, x):
    """Final norm, then the tied embedding (or the LM head): float32
    logits, soft-capped when the config says so."""
    x = apply_norm(p["final_norm"], x, cfg.norm_eps, cfg.use_layernorm)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    logits = (x @ w).to(torch.float32)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _run_layers(groups, specs, cfg, x, positions, cache_groups=None,
                flash=False, enc_out=None):
    """Every layer of ``groups`` (``p["dec"]`` or ``p["enc"]``), whose
    specs are ``specs`` (``cfg.layers`` or ``cfg.encoder_layers``), in
    order; returns (x, new cache groups or None, the MoE layers' aux
    losses summed, or None without MoE). ``enc_out``: the encoder's
    states, for cross-attention layers without a cache.

    Under ``cfg.remat``, while autograd records and no cache is written,
    each layer runs through ``torch.utils.checkpoint`` (non-reentrant):
    its activations are dropped after the forward and recomputed in the
    backward, the reference's ``jax.checkpoint`` of the layer body."""
    layer = blocks.block_forward
    if cfg.remat and cache_groups is None and torch.is_grad_enabled():
        layer = functools.partial(checkpoint, layer, use_reentrant=False)
    new_groups, aux = [], None
    for gi, (gp, spec) in enumerate(zip(groups, specs)):
        windows = spec.window_list()
        new_layers = []
        for li, lp in enumerate(gp):
            lc = None if cache_groups is None else cache_groups[gi][li]
            x, lc, a = layer(lp, spec, cfg, x, positions, cache=lc,
                             window=windows[li], flash=flash,
                             enc_out=enc_out)
            if a is not None:
                aux = a if aux is None else aux + a
            new_layers.append(lc)
        new_groups.append(new_layers)
    return x, (None if cache_groups is None else new_groups), aux


# ---------------------------------------------------------------------------
# Encoder (the audio frontend's stub: the batch carries frame embeddings)
# ---------------------------------------------------------------------------

def encode(p, cfg: ModelConfig, frames, *, use_kernel: bool = True):
    """frames: (B, S_enc, D) precomputed frame embeddings. The sinusoidal
    table added, then the encoder groups (non-causal self-attention, on
    the ``flash_attention`` kernel unless ``use_kernel=False``), then
    ``enc_norm``: (B, S_enc, D)."""
    x = frames.to(dtype_of(cfg.activation_dtype))
    x = x + sinusoidal_pos(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    positions = _positions(*x.shape[:2], x.device)
    x, _, _ = _run_layers(p["enc"], cfg.encoder_layers, cfg, x, positions,
                          flash=use_kernel)
    return apply_norm(p["enc_norm"], x, cfg.norm_eps, cfg.use_layernorm)


# ---------------------------------------------------------------------------
# Forward / caches / prefill / decode
# ---------------------------------------------------------------------------

def forward(p, cfg: ModelConfig, batch: dict, *, use_kernel: bool = True):
    """batch: tokens (B,S) [+ frames (B,S_enc,D) | patch_embeds (B,P,D)].
    Returns (logits (B,S,V) float32, aux loss: the MoE layers'
    load-balancing losses summed, 0 without MoE)."""
    tokens = batch["tokens"]
    positions = _positions(*tokens.shape, tokens.device)
    x = _frontend(p, cfg, batch, positions)
    enc_out = (encode(p, cfg, batch["frames"], use_kernel=use_kernel)
               if cfg.is_encoder_decoder else None)
    x, _, aux = _run_layers(p["dec"], cfg.layers, cfg, x, positions,
                            flash=use_kernel, enc_out=enc_out)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(p, cfg, x), aux


def group_kv_len(spec: LayerSpec, kv_len: int) -> int:
    """Per-group cache depth: a purely sliding-window group only ever needs
    its largest window (rolling cache); any full-attention layer in the
    group forces the full length."""
    ws = spec.window_list()
    if any(w == 0 for w in ws):
        return kv_len
    return min(max(ws), kv_len)


def init_cache(cfg: ModelConfig, batch: int, kv_len: int, device=None, *,
               enc_len: int = 0):
    """Per-layer caches on ``device`` (the CUDA card unless given) — a KV
    cache for attention, an ``ssm.SSMState`` for the SSD scan, and for a
    cross-attention layer the encoder's K/V over ``enc_len`` frames,
    filled at prefill — and the global position, a Python int."""
    dev = device_mod.resolve(device)
    dtype = dtype_of(cfg.activation_dtype)
    return {
        "pos": 0,
        "groups": [[blocks.init_layer_cache(s, cfg, batch,
                                            group_kv_len(s, kv_len), dtype,
                                            dev, enc_len)
                    for _ in range(s.count)] for s in cfg.layers],
    }


def _precompute_cross(p, cfg, cache, enc_out):
    """Fill every cross-attention layer's ``cross_k`` / ``cross_v`` in
    place from the encoder's states (once, at prefill): enc_out · wk + bk
    and enc_out · wv + bv."""
    for gp, spec, gc in zip(p["dec"], cfg.layers, cache["groups"]):
        if not spec.cross_attn:
            continue
        for lp, lc in zip(gp, gc):
            if lc["cross_k"].shape[1] != enc_out.shape[1]:
                raise ValueError(f"the cache holds {lc['cross_k'].shape[1]} "
                                 f"encoder positions, the encoder gave "
                                 f"{enc_out.shape[1]}")
            cp = lp["cross"]
            k = attn_mod._project(enc_out, cp["wk"])
            v = attn_mod._project(enc_out, cp["wv"])
            if "bk" in cp:
                k, v = k + cp["bk"], v + cp["bv"]
            lc["cross_k"].copy_(k)
            lc["cross_v"].copy_(v)
    return cache


def prefill(p, cfg: ModelConfig, batch: dict, cache, *,
            use_kernel: bool = True):
    """Run the prompt through the decoder, writing caches (an
    encoder-decoder model first encodes ``batch["frames"]`` and writes the
    cross-attention K/V). Returns (logits of the last position (B,V),
    cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    if cfg.is_encoder_decoder:
        enc_out = encode(p, cfg, batch["frames"], use_kernel=use_kernel)
        cache = _precompute_cross(p, cfg, cache, enc_out)
    x = _frontend(p, cfg, batch, positions)
    x, groups, _ = _run_layers(p["dec"], cfg.layers, cfg, x, positions,
                               cache["groups"], flash=use_kernel)
    logits = _head(p, cfg, x[:, -1:])[:, 0]
    return logits, {"pos": s, "groups": groups}


def decode_step(p, cfg: ModelConfig, token, cache):
    """token: (B,) integer. Returns (logits (B,V), cache)."""
    b = token.shape[0]
    pos = cache["pos"]
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=token.device)
    x = _embed_tokens(p, cfg, token[:, None], positions)
    x, groups, _ = _run_layers(p["dec"], cfg.layers, cfg, x, positions,
                               cache["groups"])
    logits = _head(p, cfg, x)[:, 0]
    return logits, {"pos": pos + 1, "groups": groups}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(p, cfg: ModelConfig, batch: dict, aux_weight: float = 0.01, *,
            use_kernel: bool = True):
    """Causal-LM cross-entropy. Returns (loss, metrics): masked
    log-sum-exp minus the gold logit, averaged over the labelled tokens
    (labels < 0 are masked), plus ``aux_weight`` times the MoE layers'
    load-balancing loss (0 without MoE). metrics carries
    ``per_example_nll`` (B,) — the interestingness hook — and the token
    count."""
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
