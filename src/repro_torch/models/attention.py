"""Grouped-query attention (full or sliding-window) with a KV cache: the
GQA part of the reference's ``models.attention``.

Prefill and the cache-less forward attend over keys at the query
positions themselves; with ``flash=True`` (what ``lm`` passes by default)
that attention runs on the ``flash_attention`` kernel, which takes the
place of the reference's dense and chunked pure-JAX paths; a gradient
through it (training) runs the kernel's backward pair. Decode (one
query over a cache with empty slots) stays the plain grouped attention,
as the reference routes it. It serves the ``attn`` mixer and the
attention branch of ``attn_ssm_parallel`` layers (``models.blocks``),
global or sliding-window, over full or rolling caches. MLA,
cross-attention and attention logit soft-capping are not ported yet
(ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops

from .common import apply_rope, init_dense

BIG_NEG = -2.0e9  # mask value safe in bf16/f32

UNPORTED = "is not ported yet (ROADMAP queue 1 item 10)"


def check_supported(cfg) -> None:
    """Raise for the attention variants the port does not run."""
    if cfg.use_mla:
        raise NotImplementedError(f"MLA attention {UNPORTED}")
    if cfg.attn_logit_softcap and cfg.attn_logit_softcap > 0:
        raise NotImplementedError(f"attention logit soft-capping {UNPORTED}")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def gqa_shapes(cfg) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "wo": (h, hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h, hd), bk=(kv, hd), bv=(kv, hd), bo=(d,))
    return shapes


def gqa_params(gen: torch.Generator, cfg, dtype) -> dict:
    check_supported(cfg)
    p = {}
    for name, shape in gqa_shapes(cfg).items():
        if name.startswith("w"):
            p[name] = init_dense(gen, shape, (0, 1) if name == "wo" else (0,),
                                 dtype)
        else:  # biases start at zero
            p[name] = torch.zeros(shape, dtype=dtype, device=gen.device)
    return p


# ---------------------------------------------------------------------------
# Masked softmax attention over grouped heads
# ---------------------------------------------------------------------------

def mask_ok(q_pos, kv_pos, causal: bool, window: int):
    """(..., Sq, Skv) boolean mask. kv_pos < 0 marks invalid cache slots."""
    dq = q_pos[..., :, None]
    dk = kv_pos[..., None, :]
    ok = dk >= 0
    if causal:
        ok = ok & (dk <= dq)
    if window > 0:
        ok = ok & (dk > dq - window)
    return ok


def grouped_attention(q, k, v, q_pos, kv_pos, *, causal, window, scale=None):
    """q: (B,Sq,H,hd) — k,v: (B,Skv,KV,hd), KV | H — returns (B,Sq,H,hd_v).
    The plain dense path: float32 logits over the grouped layout."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale or 1.0 / math.sqrt(hd)
    qg = (q * scale).to(torch.float32).reshape(b, sq, kvh, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    ok = mask_ok(q_pos, kv_pos, causal, window)  # (B, Sq, Skv)
    logits = torch.where(ok[:, None, None], logits, BIG_NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, v.shape[-1])


def attend(q, k, v, q_pos, kv_pos, *, causal, window, scale=None,
           flash: bool = False):
    """Attention of q over (k, v). ``flash`` is the caller's statement that
    the keys sit at the query positions and those run consecutively along
    the sequence (prefill, the cache-less forward); with more than one
    query the ``flash_attention`` kernel then computes it (its masks
    depend only on position differences). Otherwise the plain grouped
    attention does."""
    if flash and q.shape[1] > 1:
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window, scale=scale)
    return grouped_attention(q, k, v, q_pos, kv_pos, causal=causal,
                             window=window, scale=scale)


# ---------------------------------------------------------------------------
# KV cache (full or rolling window) — slot = pos % W
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, W, KV, hd)
    v: torch.Tensor  # (B, W, KV, hd)
    pos: torch.Tensor  # (B, W) int32 key positions, -1 = empty


def init_kv_cache(batch, w, kvh, hd, dtype, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, w, kvh, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, w, kvh, hd), dtype=dtype, device=device),
        pos=torch.full((batch, w), -1, dtype=torch.int32, device=device),
    )


def cache_write(cache: KVCache, k_new, v_new, positions) -> KVCache:
    """Write S_new entries at ``positions`` (B, S_new) into rolling slots,
    in place (the reference returns a new cache; the port updates the
    cache's tensors and returns the same cache). If S_new ≥ W (prefill
    longer than a rolling window) only the last W entries are written —
    earlier ones would be overwritten anyway."""
    w = cache.k.shape[1]
    if k_new.shape[1] >= w:
        k_new, v_new = k_new[:, -w:], v_new[:, -w:]
        positions = positions[:, -w:]
    slots = (positions % w).to(torch.int64)  # (B, S_new)
    bidx = torch.arange(cache.k.shape[0], device=slots.device)[:, None]
    cache.k[bidx, slots] = k_new.to(cache.k.dtype)
    cache.v[bidx, slots] = v_new.to(cache.v.dtype)
    cache.pos[bidx, slots] = positions.to(torch.int32)
    return cache


# ---------------------------------------------------------------------------
# GQA forward (train / prefill / decode in one function)
# ---------------------------------------------------------------------------

def _project(x, w):
    """(B,S,D) · (D,heads,hd) → (B,S,heads,hd)."""
    d, heads, hd = w.shape
    return (x @ w.reshape(d, heads * hd)).reshape(*x.shape[:2], heads, hd)


def gqa_forward(p, x, positions, cfg, *, causal=True, window=0,
                cache: Optional[KVCache] = None, flash: bool = False):
    """x: (B,S,D). positions: (B,S). If ``cache`` is given, new K/V are
    written at ``positions`` and attention runs over the cache (decode) or
    over the prompt (prefill). ``flash``: the positions run consecutively
    along S, so prefill and the cache-less forward may take the
    ``flash_attention`` kernel (see ``attend``)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None and x.shape[1] == 1:
        # decode: attend over the cache
        cache = cache_write(cache, k, v, positions)
        k_all, v_all, kv_pos = cache.k, cache.v, cache.pos
    else:
        # prefill attends over the FULL prompt K/V (a rolling cache may be
        # shorter than the prompt), then persists the tail for decode
        if cache is not None:
            cache = cache_write(cache, k, v, positions)
        k_all, v_all, kv_pos = k, v, positions
    out = attend(q, k_all, v_all, positions, kv_pos, causal=causal,
                 window=window, flash=flash)
    h, hd, d = p["wo"].shape
    y = out.reshape(*out.shape[:2], h * hd) @ p["wo"].reshape(h * hd, d)
    if "bo" in p:
        y = y + p["bo"]
    return y, cache
