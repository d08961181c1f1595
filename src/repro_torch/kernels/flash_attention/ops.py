"""Forward attention with online softmax: the port of the reference's
``kernels.flash_attention.ops.flash_attention``, with grouped KV heads.

q is (B, Sq, H, hd), k is (B, Skv, KV, hd) and v (B, Skv, KV, hd_v) with
KV | H: query head h reads KV head h // (H / KV), and the expanded K/V
never exist. With KV = H and hd_v = hd it is the reference's function.
The kernel is built for head dims 16, 32, 64 and 128 with hd_v = hd, and
for MLA's (hd, hd_v) of (192, 128) (deepseek-v2) and (24, 16) (its
reduced config), those two uncapped (``HEAD_DIMS``). Query row i sits at
position i + Skv − Sq and key j at position j; causal and sliding-window
masks (``kpos > qpos − window``) come from those positions and use the
reference's −2e9. ``softcap`` c > 0 caps each scaled logit x at
c · tanh(x / c) before the mask, as the reference's model attention
(``models.attention._softcap``) does around its Pallas kernel, which has
no cap; the kernel computes it inside, with the accurate ``tanhf``.

The device of the input decides what runs: a CUDA tensor launches the
hand-written kernel (``csrc/flash_attention.cu``; its backward
``csrc/flash_attention_bwd.cu``) or raises, a CPU tensor
runs the plain PyTorch version ``reference``, which autograd
differentiates. There is no switch between the two. The forward is a
warp-specialised kernel: a producer warpgroup brings the key and value
tiles by TMA and turns them into ``wgmma`` panels (V transposed) in a
ring of shared-memory stages, and two consumer warpgroups of 64 query
rows each run both products on the tensor cores as 3xTF32 ``wgmma``
(``FWD_LAYOUTS``, ``forward_smem``).

The gradient: on a CUDA tensor, with grad enabled and an input that
requires it, ``flash_attention`` runs ``FlashAttentionFn``. Its forward is
the same kernel with the row log-sum-exp written beside the output, and
its backward the hand-written backward of the same source: a dQ launch,
then a dK/dV launch of one warp-specialised kernel body, every product
on the tensor cores as 3xTF32 ``wgmma``, the streamed tiles brought by
TMA into a ring of shared-memory stages (``BWD_LAYOUTS``). The tensor
cores truncate inside long sums, so in the forward and backward alike
each chunk of a product (S and dP over the head dim, O over the keys,
dQ, dK and dV over a tile's rows) is added to its total in float32,
which keeps the float32 gradients as close to a float64 route as the
plain version's. ``backward_plan`` picks how many even parts the dK/dV
launch cuts each group of query heads into when its blocks alone cannot
fill the card; each part then writes float32 partials, and a third
launch adds them in part order. No atomics: the
same inputs give the same bits. It is the counterpart of XLA's
derivative of the reference's training attention; the reference has no
Pallas backward. The backward is built for every pair the forward is:
with ``softcap`` > 0 (equal head dims) both launches recompute the
capped logit with the forward's ``tanhf`` and take dS times 1 − t², and
at MLA's pairs dQ and dK run over the q/k head dim, dV over v's.
``reference_lse`` and ``reference_backward`` are the plain versions the
backward is held to.

Counting the work: each forward and backward call, on the card and on
``meta``, tells the ``observers`` (``launch.op_count.OpCount`` while one
is active) its operations and bytes as ``work`` reckons them: the
products of the visible (query, key) pairs alone, as the kernel computes
them. A ``meta`` tensor takes ``MetaFlashFn``: the kernel's output
shapes, and its backward's, with no launch and no arithmetic, so that a
step traced on ``meta`` passes through the kernel as the card runs it.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from .. import build

NEG = -2.0e9  # the reference's mask value
# (q/k head dim, v head dim) pairs the forward and backward kernels are
# compiled for. MLA's unequal pairs are built uncapped.
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128), (24, 16))
ROWS = 64  # the fewest query rows a block of the kernel takes
MAX_GRID = 65535  # the kernel's grid: batch and Sq / ROWS each up to this
SMS = 132  # streaming multiprocessors of an H100 SXM
# dK/dV blocks the backward wants before it splits the query-head groups:
# four for each SM
BWD_FILL = 4 * SMS
# the backward's launch layouts by launch and q/k head dim, as the kernel
# is compiled (Shape in csrc/flash_attention_bwd.cuh): (streamed rows a
# tile, panel stages, bfloat16's TMA slots (a float32 tile lands in its
# stage), buffers of each hand-off between the two consumer warpgroups). A block holds 64 resident rows (dq: queries;
# dK/dV: keys), a producer warpgroup and two consumers.
BWD_LAYOUTS = {
    "dq": {16: (32, 3, 2, 2), 24: (32, 3, 2, 2), 32: (32, 3, 2, 2),
           64: (32, 3, 2, 2), 128: (32, 2, 1, 2), 192: (32, 2, 1, 2)},
    "dkdv": {16: (32, 3, 2, 2), 24: (32, 3, 2, 2), 32: (32, 3, 2, 2),
             64: (32, 3, 2, 2), 128: (32, 2, 1, 2), 192: (32, 2, 1, 2)}}
SMEM_LIMIT = 232_448  # shared memory a block may have (227 KB)
# the forward's launch layouts by q/k head dim, as the kernel is compiled
# (FwdShape in csrc/flash_attention.cu): (keys a tile, panel stages, TMA
# slots a K and a V tile land in as they lie in memory). A block holds
# two consumer warpgroups of 64 query rows and a producer.
FWD_LAYOUTS = {16: (64, 3, 2), 24: (64, 3, 2), 32: (64, 3, 2),
               64: (64, 2, 2), 128: (32, 2, 2), 192: (32, 2, 1)}


# kernel launches made by ``flash_attention`` since the last reset: the
# forward, and the backward (counted once a call, whatever its launches);
# beside each, the same launches by shape (B, Sq, Skv, H, KV, hd, causal)
launches = 0
bwd_launches = 0
launches_at: collections.Counter = collections.Counter()
bwd_launches_at: collections.Counter = collections.Counter()
# objects with a ``kernel(name, flops, nbytes, shapes)`` method, told of
# each forward and backward call's work (``work``) on the card and on meta
observers: list = []

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's types


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, head_dim)")
    b, _, h, hd = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{k.shape[2]} KV heads do not divide {h} heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16, torch.float64):
        raise ValueError(f"q, k, v must share float32, bfloat16 or (the "
                         f"plain versions) float64, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
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


def _wide(x):
    """The plain versions' working type: float64 for float64 inputs (a
    witness of float32's rounding), float32 otherwise."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _logits(q, k, causal, window, scale, softcap=0.0):
    """(B, H, Sq, Skv) float32 (float64) logits, scaled, soft-capped when
    ``softcap`` > 0 and then masked with −2e9, and the visibility mask;
    KV heads repeated to the query heads."""
    b, sq, h, hd = q.shape
    skv, wide = k.shape[1], _wide(q)
    kf = k.to(wide).repeat_interleave(h // k.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(wide), kf) * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    ok = _visible(sq, skv, causal, window, q.device)
    return torch.where(ok[None, None], logits, NEG), ok


def reference(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None, softcap: float = 0.0):
    """Plain PyTorch version, the reference's ``ref.flash_attention``:
    float32 logits scaled after the product, soft-capped (``softcap`` >
    0), masked with −2e9, softmax, float32 product with v, cast to q's
    dtype; KV heads mapped to query heads by repetition. Any head dims:
    the output takes v's. Float64 inputs run in float64."""
    _check(q, k, v)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    g = q.shape[2] // k.shape[2]
    vf = v.to(_wide(q)).repeat_interleave(g, dim=2)
    logits, _ = _logits(q, k, causal, window, scale, softcap)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def reference_lse(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None, softcap: float = 0.0):
    """Plain version of the forward's second output: (B, H, Sq) float32
    (float64 for float64 inputs) log-sum-exp of each row's scaled,
    soft-capped, masked logits."""
    _check(q, k, v)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    return torch.logsumexp(_logits(q, k, causal, window, scale, softcap)[0],
                           dim=-1)


def reference_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                       window: int = 0, scale: float | None = None,
                       softcap: float = 0.0):
    """Plain version of the backward: (dq, dk, dv) in the inputs' dtype,
    from the explicit formulas in float32 (float64 for float64 inputs).
    With x = S·scale, the logit is y = x, or y = c·t with t = tanh(x / c)
    under ``softcap`` c > 0; P = exp(y − lse), dP = dO Vᵀ, Delta =
    rowsum(dO ∘ O), dS = P ∘ (dP − Delta), times 1 − t² under the cap, on
    visible pairs and 0 on masked ones; dQ = dS K · scale, dK = dSᵀ Q ·
    scale and dV = Pᵀ dO, summed over the query heads of each KV head. dP
    and Delta run over v's head dim, dQ and dK over q's and k's. A row
    whose keys are all masked is the uniform average of v in the forward,
    so its P is 1 / Skv and its dS is 0."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale or 1.0 / math.sqrt(hd)
    wide = _wide(q)
    kf = k.to(wide).repeat_interleave(g, dim=2)
    vf = v.to(wide).repeat_interleave(g, dim=2)
    qf, of, dof = q.to(wide), out.to(wide), dout.to(wide)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = t * softcap
    ok = _visible(sq, skv, causal, window, q.device)
    dead = ~ok.any(dim=1)  # rows with no visible key
    p = torch.where(ok, torch.exp(s - lse.to(wide)[..., None]), 0.0)
    p = torch.where(dead[:, None], 1.0 / skv, p)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = torch.einsum("bqhd,bqhd->bhq", dof, of)
    ds = p * (dp - delta[..., None])
    if softcap > 0:
        ds = ds * (1.0 - t * t)
    ds = torch.where(ok, ds, 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    group = lambda x: x.reshape(b, skv, kvh, g, -1).sum(dim=3)  # noqa: E731
    return dq.to(q.dtype), group(dk).to(k.dtype), group(dv).to(v.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    fn = build.library("flash_attention").flash_attention_backward_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _up(x: int, to: int) -> int:
    return -(-x // to) * to


def forward_smem(hd, hd_v=None, dtype=torch.float32) -> int:
    """Shared-memory bytes a forward block takes at this head-dim pair and
    type, as ``FwdLayout`` in the .cu adds them: the stages, each the key
    tile's float32 panel tile (its rows' hi, and for float32 their lo
    below) and V's transposed one (hd_v rows over the tile's keys, hi and
    lo), each 1024-byte aligned; the TMA slots where a key and a value
    tile land as they lie in memory, each 128-byte aligned; the
    mbarriers (full and empty a stage, one a slot); and 1024 bytes to
    align the base."""
    hd_v = hd_v or hd
    bn, ps, rs = FWD_LAYOUTS[hd]
    item = torch.empty((), dtype=dtype).element_size()
    npan = 2 if dtype == torch.float32 else 1
    stage = _up(npan * bn * hd * 4, 1024) + _up(npan * hd_v * bn * 4, 1024)
    raw = _up(bn * hd * item, 128) + _up(bn * hd_v * item, 128)
    return _up(ps * stage + rs * raw, 8) + 8 * (2 * ps + rs) + 1024


def forward_info(hd, dtype=torch.float32, hd_v=None, softcap=False):
    """(registers a thread, shared memory bytes a block, blocks an SM) of
    the forward kernel at this head-dim pair (v's ``hd_v``, hd unless
    given), type and build (capped or not), from the CUDA runtime (needs
    the card)."""
    fn = build.library("flash_attention").flash_attention_forward_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 3)()
    err = fn(hd, hd_v or hd, int(bool(softcap)), _DTYPES[dtype], info)
    if err:
        raise RuntimeError(f"flash_fwd: CUDA error {err}")
    return tuple(info)


def backward_smem(launch, hd, hd_v=None, dtype=torch.float32) -> int:
    """Shared-memory bytes a block of ``launch`` ("dq" or "dkdv") takes at
    this head-dim pair and type, as ``BwdLayout`` in the .cuh adds them:
    the stages' float32 panel tiles of a streamed tile (its rows' hi, and
    for float32 their lo below); the 64 x tile-rows scratch panels (hi
    and lo) that products read as B (dq: dS, one pair a hand-off buffer;
    dK/dV: P and dS); the hand-off buffers of masked P; for bfloat16 the
    TMA slots a tile lands in as it lies in memory (in dK/dV with its lse
    and Delta; a float32 tile lands in its stage); dK/dV's lse and Delta
    of each stage; the mbarriers; and 1024 bytes to align the base. Each
    panel region is 1024-byte aligned, each TMA destination 128-byte
    aligned."""
    hd_v = hd_v or hd
    bn, ps, rs, nb = BWD_LAYOUTS[launch][hd]
    dkdv, item = launch == "dkdv", torch.empty((), dtype=dtype).element_size()
    npan = 2 if dtype == torch.float32 else 1
    stage = _up(npan * bn * hd * 4, 1024) + _up(npan * bn * hd_v * 4, 1024)
    scr = (4 if dkdv else 2 * nb) * _up(64 * bn * 4, 1024)
    pbuf = nb * 64 * bn * 4
    raw = (_up(bn * hd * item, 128) + _up(bn * hd_v * item, 128)
           + (2 * _up(bn * 4, 128) if dkdv else 0))
    rs = 0 if npan == 2 else rs
    vec = ps * 2 * _up(bn * 4, 128) if dkdv else 0
    used = ps * stage + scr + pbuf + rs * raw
    landed = ps if npan == 2 else rs
    return _up(used + vec, 8) + 8 * (2 * ps + landed + 4 * nb) + 1024


def backward_plan(b, h, kvh, sq, skv, hd, hd_v=None, dtype=torch.float32,
                  softcap=0.0) -> dict:
    """How the backward launches at this shape (v's head dim ``hd_v``, hd
    unless given; ``dtype`` and ``softcap`` as the call's): for each of
    ``dq`` and ``dkdv`` its layout (``BWD_LAYOUTS``: ``rows`` resident a
    block, ``warpgroups`` consumers on them, ``tile_rows`` streamed a
    tile, ``stages``, ``tma_slots``, ``handoffs``), its ``threads``,
    ``grid`` and ``smem_bytes`` (``backward_smem``); ``keys`` a dK/dV
    block; ``split``, the parts each group of ``h // kvh`` query heads is
    cut into, the dK/dV grid's ``blocks`` and the partials'
    ``scratch_bytes``. A pure function of the shape (the cap changes
    nothing of the layout, the type only the shared memory).

    When ``kvh · b · ⌈Skv / keys⌉`` blocks reach ``BWD_FILL`` the group is
    not split. Otherwise ``split`` is the smallest divisor of the group
    that brings the blocks to ``BWD_FILL`` (the whole group when none
    does), so every part holds as many heads; its float32 dK and dV
    partials take ``split`` times the bytes of float32 dK and dV."""
    hd_v = hd_v or hd
    launches = {}
    for launch, n in (("dq", sq), ("dkdv", skv)):
        bn, ps, rs, nb = BWD_LAYOUTS[launch][hd]
        launches[launch] = {
            "rows": 64, "warpgroups": 2, "tile_rows": bn, "stages": ps,
            "tma_slots": rs, "handoffs": nb, "threads": 384,
            "smem_bytes": backward_smem(launch, hd, hd_v, dtype),
            "grid": ((h, b, -(-n // 64)) if launch == "dq"
                     else (kvh, b, -(-n // 64)))}
    group, keys = h // kvh, launches["dkdv"]["rows"]
    blocks = kvh * b * -(-skv // keys)
    per_part = 4 * b * skv * kvh * (hd + hd_v)  # dK and dV, float32
    divisors = [d for d in range(1, group + 1) if group % d == 0]
    split = 1
    if 0 < blocks < BWD_FILL:
        split = next((d for d in divisors if d * blocks >= BWD_FILL), group)
    g = launches["dkdv"]["grid"]
    launches["dkdv"]["grid"] = (g[0] * split, g[1], g[2])
    return {**launches, "keys": keys, "split": split,
            "blocks": blocks * split,
            "scratch_bytes": per_part * split if split > 1 else 0}


def backward_info(hd, dtype=torch.float32, hd_v=None, softcap=False):
    """{launch: (registers a thread, shared memory bytes a block, blocks
    an SM)} of the backward's three kernels at this head-dim pair (v's
    ``hd_v``, hd unless given), type and build (capped or not), from the
    CUDA runtime (needs the card)."""
    fn = build.library("flash_attention").flash_attention_backward_info
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {}
    for which, name in enumerate(("flash_bwd_dq", "flash_bwd_dkdv",
                                  "flash_bwd_group_sum")):
        info = (ctypes.c_int * 3)()
        err = fn(hd, hd_v or hd, int(bool(softcap)), _DTYPES[dtype], which,
                 info)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        out[name] = tuple(info)
    return out


def _ramp(a: int, b: int, cap: int) -> int:
    """Σ max(0, min(x, cap)) over the integers x from a to b."""
    a = max(a, 1)
    top = min(b, cap)
    rise = (a + top) * (top - a + 1) // 2 if top >= a else 0
    return rise + cap * max(0, b - max(a, cap + 1) + 1)


@functools.lru_cache(maxsize=None)
def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks leave visible (``_visible``'s
    count), in closed form. Query row i sits at position p = i + Skv − Sq
    (p0 = Skv − Sq to Skv − 1) and sees the keys from max(0, p − window
    + 1) (0 with no window) to p (causal) or Skv − 1: causal, min(p + 1,
    window) of them; non-causal, min(Skv, Skv + window − 1 − p). Pure
    integer arithmetic, so that no tensor operation runs inside a
    dispatch mode that counts them."""
    p0 = skv - sq
    if causal:
        return _ramp(p0 + 1, skv, window if window > 0 else skv)
    if window <= 0:
        return sq * skv
    return _ramp(window, skv + window - 1 - p0, skv)


def work(b, sq, skv, h, kvh, hd, hd_v, causal, window, itemsize,
         backward=False) -> tuple:
    """(operations, bytes) of one call as the kernel does it, the
    kernel table's reckoning: the forward's two products, 2 · (hd + hd_v)
    a visible pair a query head; the backward's five (S, dP, dV, dQ, dK),
    2 · (3 · hd + 2 · hd_v). Bytes: each input read once, each output
    written once (the forward's q, k, v and out with its float32 row
    log-sum-exp; the backward's q, k, v, out, dout and lse, then dq, dk
    and dv)."""
    pairs = b * h * visible_pairs(sq, skv, causal, window)
    q_el, k_el, v_el = b * sq * h * hd, b * skv * kvh * hd, b * skv * kvh * hd_v
    o_el, lse_b = b * sq * h * hd_v, 4 * b * h * sq
    if backward:
        return (2 * (3 * hd + 2 * hd_v) * pairs,
                2 * (q_el + k_el + v_el) * itemsize + 2 * o_el * itemsize
                + lse_b)
    return (2 * (hd + hd_v) * pairs,
            (q_el + k_el + v_el + o_el) * itemsize + lse_b)


def _notify(q, k, v, causal, window, backward=False) -> None:
    """Tell each observer one call's work (``work``)."""
    if not observers:
        return
    b, sq, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    flops, nbytes = work(b, sq, skv, h, kvh, hd, hd_v, causal, window,
                         q.element_size(), backward)
    name = "flash_attention_bwd" if backward else "flash_attention"
    shapes = (tuple(q.shape), tuple(k.shape), tuple(v.shape))
    for obs in observers:
        obs.kernel(name, flops, nbytes, shapes)


def _check_build(q, k, v, softcap=0.0):
    """The shapes and types the kernel is built for; raises on others."""
    _check(q, k, v)
    if q.dtype not in _DTYPES:
        raise ValueError(f"the flash_attention kernel takes float32 or "
                         f"bfloat16, not {q.dtype}")
    b, sq, h, hd = q.shape
    skv, pair = k.shape[1], (hd, v.shape[3])
    if pair not in HEAD_DIMS:
        raise NotImplementedError(f"the flash_attention kernel is built for "
                                  f"(q/k, v) head dims {HEAD_DIMS}, not "
                                  f"{pair}")
    if softcap > 0 and pair[0] != pair[1]:
        raise NotImplementedError(f"the flash_attention kernel is built "
                                  f"without the soft-cap at head dims {pair}")
    if b > MAX_GRID or -(-max(sq, skv) // ROWS) > MAX_GRID:
        raise ValueError(f"the flash_attention kernel takes a batch and "
                         f"Sq / {ROWS} and Skv / {ROWS} up to {MAX_GRID}, "
                         f"got {b}, {sq} and {skv}")


def _prepare(q, k, v, softcap=0.0):
    """Checks for a kernel launch; returns q, k, v contiguous and 16-byte
    aligned (the TMA reads rows from 16-byte aligned bases)."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_build(q, k, v, softcap)
    q, k, v = (x.contiguous() for x in (q, k, v))
    return tuple(x.clone() if x.data_ptr() % 16 else x for x in (q, k, v))


def _launch_forward(q, k, v, causal, window, scale, with_lse, softcap=0.0):
    """The forward kernel on prepared inputs: (out, lse or None)."""
    global launches
    b, sq, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, sq, h, hd_v), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0 or skv == 0:
        return out.zero_(), (None if lse is None else lse.fill_(NEG))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                        b, sq, skv, h, kvh, hd, hd_v, scale, int(causal),
                        int(window), float(softcap), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    launches_at[(b, sq, skv, h, kvh, hd, bool(causal))] += 1
    _notify(q, k, v, causal, window)
    return out, lse


def _launch_backward(q, k, v, out, lse, dout, causal, window, scale,
                     softcap=0.0):
    """The backward launches on prepared inputs, as ``backward_plan``
    says: (dq, dk, dv)."""
    global bwd_launches
    b, sq, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    dout = dout.to(q.dtype).contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    split = backward_plan(b, h, kvh, sq, skv, hd, hd_v)["split"]
    # the dq launch's copy of lse, then Delta, rows padded to 4 floats
    delta = torch.empty(2 * b * h * (-(-sq // 4) * 4), dtype=torch.float32,
                        device=q.device)
    # dK's partials, then dV's: (split, B, Skv, KV, hd), (split, ..., hd_v)
    part = (torch.empty(split * (k.numel() + v.numel()), dtype=torch.float32,
                        device=q.device) if split > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(),
                            0 if part is None else part.data_ptr(), b, sq,
                            skv, h, kvh, hd, hd_v, scale, int(causal),
                            int(window), float(softcap), split,
                            _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    bwd_launches += 1
    bwd_launches_at[(b, sq, skv, h, kvh, hd, bool(causal))] += 1
    _notify(q, k, v, causal, window, backward=True)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The kernel with its gradient: the forward launch with the row
    log-sum-exp kept, the backward launches on the saved tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, softcap=0.0):
        q, k, v = _prepare(q, k, v, softcap)
        out, lse = _launch_forward(q, k, v, causal, window, scale, True,
                                   softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_backward(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


class MetaFlashFn(torch.autograd.Function):
    """The kernel on ``meta`` tensors: its outputs' shapes and its
    backward's, no launch; each call's work goes to the observers."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        _notify(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window)
        return q.new_empty(q.shape[:3] + v.shape[3:])

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        _notify(q, k, v, *ctx.args, backward=True)
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), None, None)


def forward_with_lse(q, k, v, *, causal: bool = True, window: int = 0,
                     scale: float | None = None, softcap: float = 0.0):
    """The forward kernel with the row log-sum-exp written: (out, lse)."""
    q, k, v = _prepare(q, k, v, softcap)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    return _launch_forward(q, k, v, causal, window, scale, True, softcap)


def backward(q, k, v, out, lse, dout, *, causal: bool = True,
             window: int = 0, scale: float | None = None,
             softcap: float = 0.0):
    """The backward launches on CUDA tensors, as ``backward_plan`` says:
    (dq, dk, dv), held to ``reference_backward`` (``softcap`` the
    forward's)."""
    softcap = float(softcap or 0.0)
    q, k, v = _prepare(q, k, v, softcap)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    return _launch_backward(q, k, v, out.contiguous(), lse.contiguous(),
                            dout, causal, window, scale, softcap)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, softcap: float = 0.0):
    """q (B, Sq, H, hd), k (B, Skv, KV, hd) and v (B, Skv, KV, hd_v),
    float32 or bfloat16 → (B, Sq, H, hd_v) in q's dtype. ``scale``
    defaults to 1/√hd (0 counts as unset, as in the reference);
    ``softcap`` > 0 caps the scaled logits
    (0 or less: no cap, as in the reference). A row whose keys are all
    masked averages v over all Skv keys, as the reference's plain version
    does.

    CUDA tensors run the kernel, CPU tensors the plain version, ``meta``
    tensors ``MetaFlashFn`` (shapes and the work, no arithmetic). On a
    CUDA tensor with grad enabled and an input that requires grad, the
    call runs ``FlashAttentionFn``, whose backward runs the backward
    kernels (``backward``), capped and at MLA's head dims too."""
    softcap = float(softcap or 0.0)
    if q.device.type == "cpu":
        return reference(q, k, v, causal=causal, window=window, scale=scale,
                         softcap=softcap)
    if q.device.type == "meta":
        _check_build(q, k, v, softcap)
        return MetaFlashFn.apply(q, k, v, causal, window)
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale, softcap)
    q, k, v = _prepare(q, k, v, softcap)
    return _launch_forward(q, k, v, causal, window, scale, False, softcap)[0]
