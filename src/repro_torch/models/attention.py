"""Attention mixers: grouped-query attention (full or sliding-window) with
a KV cache, cross-attention over encoder states, and DeepSeek-V2's
multi-head latent attention (MLA) with its latent cache — the port of the
reference's ``models.attention``.

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
prompts, but the kernel's long-key cases are held to it.

Cross-attention (whisper's decoder, ``cross_params``): queries from the
decoder states, keys and values projected from the encoder's
(``gqa_forward(kv_source=)``, no RoPE) at positions 0..S_enc−1, or read
from the layer's cache, where ``lm`` writes them once at prefill
(``cross_forward_cached``). Its mask is non-causal with no window, so
it does not depend on positions, and with more than one query it runs
on the kernel too (``attend(cross=True)``); decode's one query attends
plainly over the cached encoder keys.

MLA (``mla_*``): queries through a low-rank ``wq_a`` / ``q_norm`` /
``wq_b`` (or one ``wq``), keys and values from a normed latent of
``kv_lora_rank`` plus one shared RoPE key of ``qk_rope_head_dim``.
Prefill and the cache-less forward (``mla_forward_expanded``) expand the
latent to per-head K = [k_nope | k_rope] (q/k head dim nope + rope) and V
(``v_head_dim``) and attend on the ``flash_attention`` kernel at those
unequal head dims (``flash=True``), in place of the reference's dense and
latent-chunked paths; ``_mla_attend_latent_chunked`` is the reference's
chunked path as a plain function that the kernel's long-key MLA cases are
held to. Decode (``mla_forward_absorbed``) scores the query against the
latent cache through the absorbed ``wkv_b``, as plain float32 tensor
products, as the reference computes it. The KV and latent caches are
written in place (``cache_write``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch.kernels.flash_attention import ops as flash_ops

from .common import apply_rope, init_dense, rmsnorm

BIG_NEG = -2.0e9  # mask value safe in bf16/f32
KV_CHUNK = 1024  # keys a step of chunked_attention's scan
MLA_CHUNK = 1024  # latent positions a step of _mla_attend_latent_chunked


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


def mla_shapes(cfg) -> dict:
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    shapes = {"wkv_a": (d, r + rope), "kv_norm": (r,),
              "wkv_b": (r, h, nope + cfg.v_head_dim),
              "wo": (h, cfg.v_head_dim, d)}
    if cfg.q_lora_rank > 0:
        shapes.update(wq_a=(d, cfg.q_lora_rank), q_norm=(cfg.q_lora_rank,),
                      wq_b=(cfg.q_lora_rank, h, nope + rope))
    else:
        shapes["wq"] = (d, h, nope + rope)
    return shapes


def _init(gen, shapes, dtype) -> dict:
    """Matrices ("w…") fan-in over every axis but the last two for ``wo``
    and the first otherwise, as the reference draws them; norm scales and
    biases start at zero."""
    p = {}
    for name, shape in shapes.items():
        if name.startswith("w"):
            p[name] = init_dense(gen, shape, (0, 1) if name == "wo" else (0,),
                                 dtype)
        else:
            p[name] = torch.zeros(shape, dtype=dtype, device=gen.device)
    return p


def gqa_params(gen: torch.Generator, cfg, dtype) -> dict:
    return _init(gen, gqa_shapes(cfg), dtype)


def mla_params(gen: torch.Generator, cfg, dtype) -> dict:
    return _init(gen, mla_shapes(cfg), dtype)


# cross-attention: Q over the decoder states, K/V over the encoder's, with
# the GQA projections' shapes (whisper's cross-attention)
cross_shapes = gqa_shapes
cross_params = gqa_params


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
           scale=None, flash: bool = False, cross: bool = False):
    """Attention of q over (k, v), logits soft-capped at ``softcap`` (0:
    none). ``flash`` is the caller's statement that the kernel's masks,
    which take query row i at position i + Skv − Sq and key j at j, give
    this attention; with more than one query the ``flash_attention``
    kernel then computes it, otherwise the plain grouped attention does.
    It holds in two cases: the keys sit at the query positions, which run
    consecutively along the sequence (self-attention in prefill and the
    cache-less forward); or, ``cross``, the keys are another sequence
    with every slot valid and the mask is non-causal with no window, so
    that no mask reads a position. A cross call with ``flash`` under a
    causal or windowed mask raises ``ValueError``: the kernel's positions
    would be wrong there."""
    if flash and cross and (causal or window > 0):
        raise ValueError(f"cross-attention runs on the kernel only under a "
                         f"non-causal mask with no window, not causal="
                         f"{causal}, window={window}")
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


def cache_write(cache, *new):
    """Write S_new entries into rolling slots ``positions % W``, in place
    (the reference returns a new cache; the port updates the cache's
    tensors and returns the same cache). ``new``: one (B, S_new, ...)
    tensor for each field of ``cache`` before ``pos`` (K and V of a
    ``KVCache``, the latents and RoPE keys of an ``MLACache``), then the
    positions (B, S_new). If S_new ≥ W (prefill longer than a rolling
    window) only the last W entries are written — earlier ones would be
    overwritten anyway."""
    *new, positions = new
    w = cache.pos.shape[1]
    if positions.shape[1] >= w:
        new = [x[:, -w:] for x in new]
        positions = positions[:, -w:]
    slots = (positions % w).to(torch.int64)  # (B, S_new)
    bidx = torch.arange(cache.pos.shape[0], device=slots.device)[:, None]
    for field, x in zip(cache[:-1], new):
        field[bidx, slots] = x.to(field.dtype)
    cache.pos[bidx, slots] = positions.to(torch.int32)
    return cache


# ---------------------------------------------------------------------------
# GQA forward (train / prefill / decode in one function)
# ---------------------------------------------------------------------------

def _project(x, w):
    """(B,S,D) · (D,heads,hd) → (B,S,heads,hd)."""
    d, heads, hd = w.shape
    return (x @ w.reshape(d, heads * hd)).reshape(*x.shape[:2], heads, hd)


def _out(p, out):
    """(B,S,H,hd) · wo (+ bo) → (B,S,D)."""
    h, hd, d = p["wo"].shape
    y = out.reshape(*out.shape[:2], h * hd) @ p["wo"].reshape(h * hd, d)
    if "bo" in p:
        y = y + p["bo"]
    return y


def _source_positions(src):
    """(B, S_src) int32 positions 0..S_src−1 of a key sequence."""
    return torch.arange(src.shape[1], dtype=torch.int32,
                        device=src.device).expand(*src.shape[:2])


def gqa_forward(p, x, positions, cfg, *, causal=True, window=0,
                cache: Optional[KVCache] = None, flash: bool = False,
                kv_source=None):
    """x: (B,S,D). positions: (B,S). If ``cache`` is given, new K/V are
    written at ``positions`` and attention runs over the cache (decode) or
    over the prompt (prefill). ``flash``: the positions run consecutively
    along S, so prefill and the cache-less forward may take the
    ``flash_attention`` kernel (see ``attend``). ``kv_source`` (B, S_src,
    D) overrides the K/V input (cross-attention): keys at 0..S_src−1, no
    RoPE, no cache."""
    src = x if kv_source is None else kv_source
    q = _project(x, p["wq"])
    k = _project(src, p["wk"])
    v = _project(src, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.use_rope and kv_source is None:
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
        k_all, v_all = k, v
        kv_pos = positions if kv_source is None else _source_positions(src)
    out = attend(q, k_all, v_all, positions, kv_pos, causal=causal,
                 window=window, softcap=cfg.attn_logit_softcap, flash=flash,
                 cross=kv_source is not None)
    return _out(p, out), cache


def cross_forward_cached(p, x, positions, k, v, *, flash: bool = False):
    """Cross-attention over encoder K/V already projected into a layer's
    cache (``cross_k`` / ``cross_v`` (B, S_enc, KV, hd)): q = x·wq + bq
    attends over them at positions 0..S_enc−1, non-causal, with no
    soft-cap (as the reference's cached route passes none), then wo + bo.
    ``flash``: a prompt (prefill) runs on the kernel, one token
    (decode) on the plain grouped attention."""
    q = _project(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    out = attend(q, k, v, positions, _source_positions(k), causal=False,
                 window=0, flash=flash, cross=True)
    return _out(p, out)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): expanded prefill on the kernel, absorbed decode
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    ckv: torch.Tensor  # (B, W, kv_lora)
    krope: torch.Tensor  # (B, W, rope_dim)
    pos: torch.Tensor  # (B, W) int32 key positions, -1 = empty


def init_mla_cache(batch, w, cfg, dtype, device=None) -> MLACache:
    return MLACache(
        ckv=torch.zeros((batch, w, cfg.kv_lora_rank), dtype=dtype,
                        device=device),
        krope=torch.zeros((batch, w, cfg.qk_rope_head_dim), dtype=dtype,
                          device=device),
        pos=torch.full((batch, w), -1, dtype=torch.int32, device=device),
    )


def _mla_q(p, x, positions, cfg):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope)), RoPE applied."""
    if "wq_a" in p:
        qa = rmsnorm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
        q = _project(qa, p["wq_b"])
    else:
        q = _project(x, p["wq"])
    nope = cfg.qk_nope_head_dim
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_latent(p, x, positions, cfg):
    """(c_kv (B,S,kv_lora) normed, k_rope (B,S,rope) with RoPE)."""
    kv = x @ p["wkv_a"]
    r = cfg.kv_lora_rank
    ckv = rmsnorm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    kr = apply_rope(kv[:, :, None, r:], positions, cfg.rope_theta)[:, :, 0]
    return ckv, kr


def _mla_attend_latent_chunked(q, ckv, kr, wkb, positions, cfg, *, causal,
                               scale, chunk=MLA_CHUNK):
    """The reference's flash-MLA dataflow as a plain function: latent
    chunks of ``chunk`` positions (the tail padded with position −1,
    masked), each expanded to per-head K = [k_nope | k_rope] and V in
    float32, and (max, sum, acc) carried over them in float32. q: (B, S,
    H, nope + rope) at ``positions``, which are the keys' too. No serving
    path calls it: the kernel's MLA cases with keys past one chunk are
    held to it."""
    b, s, h, _ = q.shape
    nope, hdv = cfg.qk_nope_head_dim, cfg.v_head_dim
    pad = (-s) % chunk
    kv_pos = positions
    if pad:
        ckv = torch.nn.functional.pad(ckv, (0, 0, 0, pad))
        kr = torch.nn.functional.pad(kr, (0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    qf = q.to(torch.float32) * scale
    wk = wkb[..., :nope].to(torch.float32)
    wv = wkb[..., nope:].to(torch.float32)
    m = torch.full((b, h, s), BIG_NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, hdv), dtype=torch.float32, device=q.device)
    for c0 in range(0, ckv.shape[1], chunk):
        ckv_c = ckv[:, c0:c0 + chunk].to(torch.float32)
        kn = torch.einsum("bcr,rhk->bchk", ckv_c, wk)
        vc = torch.einsum("bcr,rhk->bchk", ckv_c, wv)
        kr_c = kr[:, c0:c0 + chunk].to(torch.float32)
        kc = torch.cat([kn, kr_c[:, :, None].expand(*kn.shape[:3],
                                                    kr_c.shape[-1])], -1)
        logits = torch.einsum("bqhd,bchd->bhqc", qf, kc)
        ok = mask_ok(positions, kv_pos[:, c0:c0 + chunk], causal, 0)
        logits = torch.where(ok[:, None], logits, BIG_NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(logits - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqc,bchd->bhqd", pexp,
                                                    vc)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)  # (b, s, h, hdv)


def mla_forward_expanded(p, x, positions, cfg, *, causal=True,
                         flash: bool = False):
    """Training / prefill form: the latent expanded to per-head K (nope +
    rope) and V (``v_head_dim``), attention over the sequence itself at
    scale 1/√(nope + rope), then ``wo``. ``flash``: as in ``gqa_forward``;
    with more than one query the ``flash_attention`` kernel attends at the
    unequal head dims, else the plain grouped attention."""
    with record_function("mla.expanded"):
        qn, qr = _mla_q(p, x, positions, cfg)
        ckv, kr = _mla_latent(p, x, positions, cfg)
        nope = cfg.qk_nope_head_dim
        kv = _project(ckv, p["wkv_b"])  # (B, S, H, nope + v)
        kr_b = kr[:, :, None, :].expand(*kv.shape[:3], kr.shape[-1])
        q = torch.cat([qn, qr], -1)
        k = torch.cat([kv[..., :nope], kr_b], -1)
        scale = 1.0 / math.sqrt(nope + cfg.qk_rope_head_dim)
        out = attend(q, k, kv[..., nope:], positions, positions,
                     causal=causal, window=0, scale=scale, flash=flash)
        h, hdv, d = p["wo"].shape
        return out.reshape(*out.shape[:2], h * hdv) @ p["wo"].reshape(
            h * hdv, d)


def mla_forward_absorbed(p, x, positions, cfg, cache: MLACache, *,
                         causal=True):
    """Decode form: the new latents written into the cache (in place), then
    the queries scored against the whole latent cache through the
    absorbed ``wkv_b`` (per-head K/V over the context never made), in
    float32: q_lat = q_nope · w_k, logits = (q_lat · c_kv + q_rope ·
    k_rope) · scale, masked, softmax, the context over c_kv, then w_v and
    ``wo`` in x's dtype. Returns (y, cache)."""
    with record_function("mla.absorbed"):
        qn, qr = _mla_q(p, x, positions, cfg)
        ckv_new, kr_new = _mla_latent(p, x, positions, cfg)
        cache = cache_write(cache, ckv_new, kr_new, positions)
        nope = cfg.qk_nope_head_dim
        f32 = torch.float32
        wkb = p["wkv_b"].to(f32)
        q_lat = torch.einsum("bshk,rhk->bshr", qn.to(f32), wkb[..., :nope])
        ckv = cache.ckv.to(f32)
        scale = 1.0 / math.sqrt(nope + cfg.qk_rope_head_dim)
        logits = (torch.einsum("bshr,btr->bhst", q_lat, ckv)
                  + torch.einsum("bshk,btk->bhst", qr.to(f32),
                                 cache.krope.to(f32))) * scale
        ok = mask_ok(positions, cache.pos, causal, 0)
        probs = torch.softmax(torch.where(ok[:, None], logits, BIG_NEG), -1)
        ctx = torch.einsum("bhst,btr->bshr", probs, ckv)
        out = torch.einsum("bshr,rhk->bshk", ctx, wkb[..., nope:])
        h, hdv, d = p["wo"].shape
        y = out.to(x.dtype).reshape(*x.shape[:2], h * hdv) @ p["wo"].reshape(
            h * hdv, d)
        return y, cache
