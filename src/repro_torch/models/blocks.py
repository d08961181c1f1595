"""Layer blocks: (attention → residual) → (dense FFN → residual), pre-norm:
the ``attn`` mixer of the reference's ``models.blocks``. One
``block_forward`` serves the forward, prefill and decode; the SSM and
hybrid mixers, cross-attention and MoE are not ported yet (ROADMAP queue 1
item 10)."""
from __future__ import annotations

from . import attention as attn
from . import ffn as ffn_mod
from .common import apply_norm, norm_params


def check_supported(spec) -> None:
    """Raise for the layer kinds the port does not run."""
    if spec.mixer != "attn":
        raise NotImplementedError(f"the {spec.mixer!r} mixer {attn.UNPORTED}")
    if spec.cross_attn:
        raise NotImplementedError(f"cross-attention {attn.UNPORTED}")
    if spec.ffn == "moe":
        raise NotImplementedError(f"the MoE FFN {attn.UNPORTED}")


def block_shapes(spec, cfg) -> dict:
    check_supported(spec)
    norm = {"scale": (cfg.d_model,)}
    if cfg.use_layernorm:
        norm["bias"] = (cfg.d_model,)
    shapes = {"attn": attn.gqa_shapes(cfg), "norm_attn": dict(norm)}
    if spec.ffn == "dense":
        shapes["ffn"] = ffn_mod.dense_shapes(cfg.d_model, cfg.d_ff,
                                             cfg.ffn_act, cfg.ffn_bias)
        shapes["norm_ffn"] = dict(norm)
    return shapes


def block_params(gen, spec, cfg, dtype) -> dict:
    check_supported(spec)
    ln = cfg.use_layernorm
    p = {"attn": attn.gqa_params(gen, cfg, dtype),
         "norm_attn": norm_params(cfg.d_model, ln, dtype, gen.device)}
    if spec.ffn == "dense":
        p["ffn"] = ffn_mod.dense_params(gen, cfg.d_model, cfg.d_ff,
                                        cfg.ffn_act, cfg.ffn_bias, dtype)
        p["norm_ffn"] = norm_params(cfg.d_model, ln, dtype, gen.device)
    return p


def init_layer_cache(spec, cfg, batch, kv_len, dtype, device=None) -> dict:
    """Cache entry for ONE layer of this spec."""
    check_supported(spec)
    return {"kv": attn.init_kv_cache(batch, kv_len, cfg.n_kv_heads,
                                     cfg.head_dim, dtype, device)}


def block_forward(p, spec, cfg, x, positions, cache=None, window=0,
                  flash=False):
    """Returns (x, new_cache). ``flash``: see ``attention.gqa_forward``."""
    h = apply_norm(p["norm_attn"], x, cfg.norm_eps, cfg.use_layernorm)
    out, kv = attn.gqa_forward(p["attn"], h, positions, cfg,
                               causal=spec.causal, window=window,
                               cache=None if cache is None else cache["kv"],
                               flash=flash)
    x = x + out
    if spec.ffn == "dense":
        h = apply_norm(p["norm_ffn"], x, cfg.norm_eps, cfg.use_layernorm)
        x = x + ffn_mod.dense_forward(p["ffn"], h, cfg.ffn_act)
    return x, (None if cache is None else {"kv": kv})
