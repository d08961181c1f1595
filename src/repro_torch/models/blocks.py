"""Layer blocks: (mixer → residual) → (cross-attention → residual) →
(FFN → residual), pre-norm — the port of the reference's
``models.blocks``. The mixer is attention (``attn``), the SSD scan
(``ssm``), the mean of both, each behind its own pre-norm
(``attn_ssm_parallel``), or nothing (``none``); a decoder layer of an
encoder-decoder model then attends to the encoder's states
(``cross_attn``); the FFN is dense or the Mixture-of-Experts (``moe``),
whose load-balancing loss the block returns. Attention is grouped-query,
or MLA where ``cfg.use_mla`` says so. One ``block_forward`` serves the
forward, prefill and decode; a layer's cache holds ``kv`` (or ``mla``)
and/or ``ssm``, and ``cross_k`` / ``cross_v`` with cross-attention."""
from __future__ import annotations

import torch

from . import attention as attn
from . import ffn as ffn_mod
from . import ssm as ssm_mod
from .common import apply_norm, norm_params


def _has_attn(spec) -> bool:
    return spec.mixer in ("attn", "attn_ssm_parallel")


def _has_ssm(spec) -> bool:
    return spec.mixer in ("ssm", "attn_ssm_parallel")


def block_shapes(spec, cfg) -> dict:
    norm = {"scale": (cfg.d_model,)}
    if cfg.use_layernorm:
        norm["bias"] = (cfg.d_model,)
    shapes = {}
    if _has_attn(spec):
        shapes.update(attn=(attn.mla_shapes(cfg) if cfg.use_mla
                            else attn.gqa_shapes(cfg)), norm_attn=dict(norm))
    if _has_ssm(spec):
        shapes.update(ssm=ssm_mod.ssm_shapes(cfg), norm_ssm=dict(norm))
    if spec.cross_attn:
        shapes.update(cross=attn.cross_shapes(cfg), norm_cross=dict(norm))
    if spec.ffn == "dense":
        shapes["ffn"] = ffn_mod.dense_shapes(cfg.d_model, cfg.d_ff,
                                             cfg.ffn_act, cfg.ffn_bias)
        shapes["norm_ffn"] = dict(norm)
    elif spec.ffn == "moe":
        shapes["ffn"] = ffn_mod.moe_shapes(cfg)
        shapes["norm_ffn"] = dict(norm)
    return shapes


def block_params(gen, spec, cfg, dtype) -> dict:
    ln = cfg.use_layernorm
    p = {}
    if _has_attn(spec):
        p["attn"] = (attn.mla_params(gen, cfg, dtype) if cfg.use_mla
                     else attn.gqa_params(gen, cfg, dtype))
        p["norm_attn"] = norm_params(cfg.d_model, ln, dtype, gen.device)
    if _has_ssm(spec):
        p["ssm"] = ssm_mod.ssm_params(gen, cfg, dtype)
        p["norm_ssm"] = norm_params(cfg.d_model, ln, dtype, gen.device)
    if spec.cross_attn:
        p["cross"] = attn.cross_params(gen, cfg, dtype)
        p["norm_cross"] = norm_params(cfg.d_model, ln, dtype, gen.device)
    if spec.ffn == "dense":
        p["ffn"] = ffn_mod.dense_params(gen, cfg.d_model, cfg.d_ff,
                                        cfg.ffn_act, cfg.ffn_bias, dtype)
        p["norm_ffn"] = norm_params(cfg.d_model, ln, dtype, gen.device)
    elif spec.ffn == "moe":
        p["ffn"] = ffn_mod.moe_params(gen, cfg, dtype)
        p["norm_ffn"] = norm_params(cfg.d_model, ln, dtype, gen.device)
    return p


def init_layer_cache(spec, cfg, batch, kv_len, dtype, device=None,
                     enc_len=0) -> dict:
    """Cache entry for ONE layer of this spec; with cross-attention, zeroed
    ``cross_k`` / ``cross_v`` of (batch, enc_len, KV, hd) that
    ``lm.prefill`` fills from the encoder."""
    c = {}
    if _has_attn(spec) and cfg.use_mla:
        c["mla"] = attn.init_mla_cache(batch, kv_len, cfg, dtype, device)
    elif _has_attn(spec):
        c["kv"] = attn.init_kv_cache(batch, kv_len, cfg.n_kv_heads,
                                     cfg.head_dim, dtype, device)
    if _has_ssm(spec):
        c["ssm"] = ssm_mod.init_ssm_state(batch, cfg, dtype, device)
    if spec.cross_attn:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def _mla(p, spec, cfg, h, positions, cache, flash):
    """MLA, as the reference branches: without a cache the expanded form;
    one token with a cache the absorbed form over the latent cache; a
    prompt with a cache its latents written, then the expanded form over
    the prompt. Returns (out, latent cache or None)."""
    if cache is None:
        return attn.mla_forward_expanded(p, h, positions, cfg,
                                         causal=spec.causal, flash=flash), None
    if h.shape[1] == 1:
        return attn.mla_forward_absorbed(p, h, positions, cfg, cache,
                                         causal=spec.causal)
    ckv, kr = attn._mla_latent(p, h, positions, cfg)
    cache = attn.cache_write(cache, ckv, kr, positions)
    return attn.mla_forward_expanded(p, h, positions, cfg,
                                     causal=spec.causal, flash=flash), cache


def _mixer(p, spec, cfg, x, positions, cache, window, flash):
    """Returns (mixer_out, new_cache)."""
    new_cache = None if cache is None else dict(cache)
    outs = []
    if _has_attn(spec) and cfg.use_mla:
        h = apply_norm(p["norm_attn"], x, cfg.norm_eps, cfg.use_layernorm)
        out, mla = _mla(p["attn"], spec, cfg, h, positions,
                        None if cache is None else cache["mla"], flash)
        if cache is not None:
            new_cache["mla"] = mla
        outs.append(out)
    elif _has_attn(spec):
        h = apply_norm(p["norm_attn"], x, cfg.norm_eps, cfg.use_layernorm)
        out, kv = attn.gqa_forward(p["attn"], h, positions, cfg,
                                   causal=spec.causal, window=window,
                                   cache=None if cache is None
                                   else cache["kv"], flash=flash)
        if cache is not None:
            new_cache["kv"] = kv
        outs.append(out)
    if _has_ssm(spec):
        h = apply_norm(p["norm_ssm"], x, cfg.norm_eps, cfg.use_layernorm)
        out, st = ssm_mod.ssm_forward(p["ssm"], h, cfg,
                                      None if cache is None else cache["ssm"],
                                      return_state=cache is not None)
        if cache is not None:
            new_cache["ssm"] = st
        outs.append(out)
    if not outs:
        return torch.zeros_like(x), new_cache
    mix = outs[0] if len(outs) == 1 else 0.5 * (outs[0] + outs[1])
    return mix, new_cache


def _cross(p, cfg, x, positions, cache, flash, enc_out):
    """The cross-attention branch's output: over the cached encoder K/V
    when the layer's cache holds them (prefill, decode), else projected
    from ``enc_out`` (the forward, training)."""
    h = apply_norm(p["norm_cross"], x, cfg.norm_eps, cfg.use_layernorm)
    if cache is not None and "cross_k" in cache:
        return attn.cross_forward_cached(p["cross"], h, positions,
                                         cache["cross_k"], cache["cross_v"],
                                         flash=flash)
    out, _ = attn.gqa_forward(p["cross"], h, positions, cfg, causal=False,
                              window=0, flash=flash, kv_source=enc_out)
    return out


def block_forward(p, spec, cfg, x, positions, cache=None, window=0,
                  flash=False, enc_out=None):
    """Returns (x, new_cache, aux_loss): aux is the MoE's load-balancing
    loss, None for other FFNs (no tensor made where none is needed).
    ``flash``: see ``attention.gqa_forward``. ``enc_out`` (B, S_enc, D):
    the encoder's states, which a cross-attention layer without a cache
    attends to."""
    aux = None
    mix, new_cache = _mixer(p, spec, cfg, x, positions, cache, window, flash)
    x = x + mix
    if spec.cross_attn:
        x = x + _cross(p, cfg, x, positions, cache, flash, enc_out)
    if spec.ffn == "dense":
        h = apply_norm(p["norm_ffn"], x, cfg.norm_eps, cfg.use_layernorm)
        x = x + ffn_mod.dense_forward(p["ffn"], h, cfg.ffn_act)
    elif spec.ffn == "moe":
        h = apply_norm(p["norm_ffn"], x, cfg.norm_eps, cfg.use_layernorm)
        y, aux = ffn_mod.moe_forward(p["ffn"], h, cfg)
        x = x + y
    return x, new_cache, aux
