"""Forward attention with online softmax: the port of the reference's
``kernels.flash_attention.ops.flash_attention``, with grouped KV heads.

q is (B, Sq, H, hd), k and v are (B, Skv, KV, hd) with KV | H: query head
h reads KV head h // (H / KV), and the expanded K/V never exist. With
KV = H it is the reference's function. Query row i sits at position
i + Skv − Sq and key j at position j; causal and sliding-window masks
(``kpos > qpos − window``) come from those positions and use the
reference's −2e9.

The device of the input decides what runs: a CUDA tensor launches the
hand-written kernel (``csrc/flash_attention.cu``) or raises, a CPU tensor
runs the plain PyTorch version ``reference``, which autograd
differentiates. There is no switch between the two.

The gradient: on a CUDA tensor, with grad enabled and an input that
requires it, ``flash_attention`` runs ``FlashAttentionFn``. Its forward is
the same kernel with the row log-sum-exp written beside the output, and
its backward the hand-written backward of the same source: a dQ launch,
then a dK/dV launch, every product on the tensor cores as 3xTF32
``mma.sync`` with P and dS kept in registers and each query tile's dK/dV
products added to the totals in float32 (the tensor cores truncate
inside long sums). ``backward_plan`` picks how many even parts the dK/dV
launch cuts each group of query heads into when its blocks alone cannot
fill the card; each part then writes float32 partials, and a third
launch adds them in part order. No atomics: the
same inputs give the same bits. It is the counterpart of XLA's
derivative of the reference's training attention; the reference has no
Pallas backward. ``reference_lse`` and ``reference_backward`` are the
plain versions the backward is held to.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import build

NEG = -2.0e9  # the reference's mask value
HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernel is compiled for
ROWS = 64  # the fewest query rows a block of the kernel takes
MAX_GRID = 65535  # the kernel's grid: batch and Sq / ROWS each up to this
SMS = 132  # streaming multiprocessors of an H100 SXM
# dK/dV blocks the backward wants before it splits the query-head groups:
# four for each SM
BWD_FILL = 4 * SMS
# warps of a dK/dV block (16 keys each) by head dim, as the kernel is
# compiled (DkdvShape in the .cu): the faster layout at the training
# shapes timed on the card (PERF.md, row 7b)
BWD_WARPS = {16: 4, 32: 4, 64: 4, 128: 8}

# kernel launches made by ``flash_attention`` since the last reset: the
# forward, and the backward (counted once a call, whatever its launches)
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, head_dim)")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{k.shape[2]} KV heads do not divide {h} heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share a device")


def _visible(sq, skv, causal, window, device):
    """(Sq, Skv) mask of the (query, key) pairs the masks leave visible."""
    qpos = torch.arange(sq, device=device) + (skv - sq)
    kpos = torch.arange(skv, device=device)
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def _logits(q, k, causal, window, scale):
    """(B, H, Sq, Skv) float32 logits, scaled and masked with −2e9, and
    the visibility mask; KV heads repeated to the query heads."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    kf = k.to(torch.float32).repeat_interleave(h // k.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) * scale
    ok = _visible(sq, skv, causal, window, q.device)
    return torch.where(ok[None, None], logits, NEG), ok


def reference(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None):
    """Plain PyTorch version, the reference's ``ref.flash_attention``:
    float32 logits scaled after the product, masked with −2e9, softmax,
    float32 product with v, cast to q's dtype; KV heads mapped to query
    heads by repetition."""
    _check(q, k, v)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    g = q.shape[2] // k.shape[2]
    vf = v.to(torch.float32).repeat_interleave(g, dim=2)
    logits, _ = _logits(q, k, causal, window, scale)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def reference_lse(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """Plain version of the forward's second output: (B, H, Sq) float32
    log-sum-exp of each row's scaled, masked logits."""
    _check(q, k, v)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    return torch.logsumexp(_logits(q, k, causal, window, scale)[0], dim=-1)


def reference_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                       window: int = 0, scale: float | None = None):
    """Plain version of the backward: (dq, dk, dv) in the inputs' dtype,
    from the explicit formulas in float32. P = exp(S·scale − lse),
    dP = dO Vᵀ, Delta = rowsum(dO ∘ O), dS = P ∘ (dP − Delta) on visible
    pairs and 0 on masked ones; dQ = dS K · scale, dK = dSᵀ Q · scale
    and dV = Pᵀ dO, summed over the query heads of each KV head. A row
    whose keys are all masked is the uniform average of v in the forward,
    so its P is 1 / Skv and its dS is 0."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale or 1.0 / math.sqrt(hd)
    f32 = lambda x: x.to(torch.float32)  # noqa: E731
    kf = f32(k).repeat_interleave(g, dim=2)
    vf = f32(v).repeat_interleave(g, dim=2)
    qf, of, dof = f32(q), f32(out), f32(dout)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    ok = _visible(sq, skv, causal, window, q.device)
    dead = ~ok.any(dim=1)  # rows with no visible key
    p = torch.where(ok, torch.exp(s - f32(lse)[..., None]), 0.0)
    p = torch.where(dead[:, None], 1.0 / skv, p)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = torch.einsum("bqhd,bqhd->bhq", dof, of)
    ds = torch.where(ok, p * (dp - delta[..., None]), 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    group = lambda x: x.reshape(b, skv, kvh, g, hd).sum(dim=3)  # noqa: E731
    return dq.to(q.dtype), group(dk).to(k.dtype), group(dv).to(v.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    fn = build.library("flash_attention").flash_attention_backward_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def backward_plan(b, h, kvh, sq, skv, hd) -> dict:
    """How the backward launches at this shape: ``warps`` a dK/dV block
    (16 keys each, ``BWD_WARPS``), ``split``, the parts each group of
    ``h // kvh`` query heads is cut into, the dK/dV grid's ``blocks`` and
    the partials' ``scratch_bytes``. A pure function of the shape.

    When ``kvh · b · ⌈Skv / keys⌉`` blocks reach ``BWD_FILL`` the group is
    not split. Otherwise ``split`` is the smallest divisor of the group
    that brings the blocks to ``BWD_FILL`` (the whole group when none
    does), so every part holds as many heads; its float32 dK and dV
    partials take ``split`` times the bytes of float32 dK and dV."""
    warps = BWD_WARPS[hd]
    group, keys = h // kvh, 16 * warps
    blocks = kvh * b * -(-skv // keys)
    per_part = 2 * 4 * b * skv * kvh * hd  # dK and dV partials, float32
    divisors = [d for d in range(1, group + 1) if group % d == 0]
    split = 1
    if 0 < blocks < BWD_FILL:
        split = next((d for d in divisors if d * blocks >= BWD_FILL), group)
    return {"warps": warps, "keys": keys, "split": split,
            "blocks": blocks * split,
            "scratch_bytes": per_part * split if split > 1 else 0}


def backward_info(hd, dtype=torch.float32):
    """{launch: (registers a thread, shared memory bytes a block, blocks
    an SM)} of the backward's three kernels at this head dim and type,
    from the CUDA runtime (needs the card)."""
    fn = build.library("flash_attention").flash_attention_backward_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {}
    for which, name in enumerate(("flash_bwd_dq", "flash_bwd_dkdv",
                                  "flash_bwd_group_sum")):
        info = (ctypes.c_int * 3)()
        err = fn(hd, _DTYPES[dtype], which, info)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        out[name] = tuple(info)
    return out


def _prepare(q, k, v):
    """Checks for a kernel launch; returns q, k, v contiguous and 16-byte
    aligned (the kernel copies 16-byte pieces of rows) and the scale."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v)
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"the flash_attention kernel is built for "
                                  f"head dims {HEAD_DIMS}, not {hd}")
    if b > MAX_GRID or -(-max(sq, skv) // ROWS) > MAX_GRID:
        raise ValueError(f"the flash_attention kernel takes a batch and "
                         f"Sq / {ROWS} and Skv / {ROWS} up to {MAX_GRID}, "
                         f"got {b}, {sq} and {skv}")
    q, k, v = (x.contiguous() for x in (q, k, v))
    return tuple(x.clone() if x.data_ptr() % 16 else x for x in (q, k, v))


def _launch_forward(q, k, v, causal, window, scale, with_lse):
    """The forward kernel on prepared inputs: (out, lse or None)."""
    global launches
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0 or skv == 0:
        return out.zero_(), (None if lse is None else lse.fill_(NEG))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                        b, sq, skv, h, kvh, hd, scale, int(causal),
                        int(window), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out, lse


def _launch_backward(q, k, v, out, lse, dout, causal, window, scale):
    """The backward launches on prepared inputs, as ``backward_plan``
    says: (dq, dk, dv)."""
    global bwd_launches
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dout = dout.to(q.dtype).contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    split = backward_plan(b, h, kvh, sq, skv, hd)["split"]
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    part = (torch.empty((2, split) + tuple(k.shape), dtype=torch.float32,
                        device=q.device) if split > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(),
                            0 if part is None else part.data_ptr(), b, sq,
                            skv, h, kvh, hd, scale, int(causal), int(window),
                            split, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The kernel with its gradient: the forward launch with the row
    log-sum-exp kept, the backward launches on the saved tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        q, k, v = _prepare(q, k, v)
        out, lse = _launch_forward(q, k, v, causal, window, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_backward(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None


def forward_with_lse(q, k, v, *, causal: bool = True, window: int = 0,
                     scale: float | None = None):
    """The forward kernel with the row log-sum-exp written: (out, lse)."""
    q, k, v = _prepare(q, k, v)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    return _launch_forward(q, k, v, causal, window, scale, True)


def backward(q, k, v, out, lse, dout, *, causal: bool = True,
             window: int = 0, scale: float | None = None):
    """The backward launches on CUDA tensors, as ``backward_plan`` says:
    (dq, dk, dv), held to ``reference_backward``."""
    q, k, v = _prepare(q, k, v)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    return _launch_backward(q, k, v, out.contiguous(), lse.contiguous(),
                            dout, causal, window, scale)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q (B, Sq, H, hd), k and v (B, Skv, KV, hd), float32 or bfloat16 →
    (B, Sq, H, hd) in q's dtype. ``scale`` defaults to 1/√hd (0 counts as
    unset, as in the reference). A row whose keys are all masked averages
    v over all Skv keys, as the reference's plain version does.

    CUDA tensors run the kernel, CPU tensors the plain version. On a
    CUDA tensor with grad enabled and an input that requires grad, the
    call runs ``FlashAttentionFn``, whose backward runs the backward
    kernels (``backward``)."""
    if q.device.type == "cpu":
        return reference(q, k, v, causal=causal, window=window, scale=scale)
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale)
    q, k, v = _prepare(q, k, v)
    return _launch_forward(q, k, v, causal, window, scale, False)[0]
