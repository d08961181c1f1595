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
global or sliding-window, over full or rolling caches, with the logits
soft-capped where the config says so (grok-1: inside the kernel, before
the mask, as the reference caps). ``chunked_attention`` is the
reference's online-softmax scan over key chunks as a plain function; the
port's prefill does not route to it, since the kernel takes long
prompts, but the kernel's long-key cases are held to it. MLA and cross-attention are not ported yet (ROADMAP queue 1
item 10).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops

from .common import apply_rope, init_dense

BIG_NEG = -2.0e9  # mask value safe in bf16/f32
KV_CHUNK = 1024  # keys a step of chunked_attention's scan

UNPORTED = "is not ported yet (ROADMAP queue 1 item 10)"


def check_supported(cfg) -> None:
    """Raise for the attention variants the port does not run."""
    if cfg.use_mla:
        raise NotImplementedError(f"MLA attention {UNPORTED}")


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


def _softcap(x, cap: float):
    """cap · tanh(x / cap) where cap > 0, else x."""
    if cap and cap > 0:
        return torch.tanh(x / cap) * cap
    return x


def grouped_attention(q, k, v, q_pos, kv_pos, *, causal, window, softcap=0.0,
                      scale=None):
    """q: (B,Sq,H,hd) — k,v: (B,Skv,KV,hd), KV | H — returns (B,Sq,H,hd_v).
    The plain dense path: float32 logits over the grouped layout,
    soft-capped, then masked."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale or 1.0 / math.sqrt(hd)
    qg = (q * scale).to(torch.float32).reshape(b, sq, kvh, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    logits = _softcap(logits, softcap)
    ok = mask_ok(q_pos, kv_pos, causal, window)  # (B, Sq, Skv)
    logits = torch.where(ok[:, None, None], logits, BIG_NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, v.shape[-1])


def chunked_attention(q, k, v, q_pos, kv_pos, *, causal, window,
                      softcap=0.0, scale=None, chunk=KV_CHUNK):
    """The reference's online-softmax scan over key chunks of ``chunk``
    (O(Sq·chunk) live memory), as a Python loop: the keys are padded to
    whole chunks with position −1 (masked), each chunk's logits soft-capped
    and masked, and (max, sum, acc) carried in float32. The plain
    counterpart that the kernel's cases with keys past one chunk are held
    to (tests/test_torch_flash_attention.py, tests/test_torch_cuda.py and
    chip_smoke.py's phase 3); no serving path calls it."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    skv = k.shape[1]
    hdv = v.shape[-1]
    scale = scale or 1.0 / math.sqrt(hd)
    pad = (-skv) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    qg = (q.to(torch.float32) * scale).reshape(b, sq, kvh, g, hd)
    m = torch.full((b, kvh, g, sq), BIG_NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hdv), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kb.to(torch.float32))
        logits = _softcap(logits, softcap)
        ok = mask_ok(q_pos, kv_pos[:, c0:c0 + chunk], causal, window)
        logits = torch.where(ok[:, None, None], logits, BIG_NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, vb.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4)  # (b, sq, kvh, g, hdv)
    return out.reshape(b, sq, h, hdv).to(v.dtype)


def attend(q, k, v, q_pos, kv_pos, *, causal, window, softcap=0.0,
           scale=None, flash: bool = False):
    """Attention of q over (k, v), logits soft-capped at ``softcap`` (0:
    none). ``flash`` is the caller's statement that the keys sit at the
    query positions and those run consecutively along the sequence
    (prefill, the cache-less forward); with more than one query the
    ``flash_attention`` kernel then computes it (its masks depend only on
    position differences). Otherwise the plain grouped attention does."""
    if flash and q.shape[1] > 1:
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window, scale=scale,
                                         softcap=softcap)
    return grouped_attention(q, k, v, q_pos, kv_pos, causal=causal,
                             window=window, softcap=softcap, scale=scale)


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
                 window=window, softcap=cfg.attn_logit_softcap, flash=flash)
    h, hd, d = p["wo"].shape
    y = out.reshape(*out.shape[:2], h * hd) @ p["wo"].reshape(h * hd, d)
    if "bo" in p:
        y = y + p["bo"]
    return y, cache
