"""Parameter / optimizer / cache / batch sharding rules — the port of the
reference's ``parallel.sharding``.

Policy: tensor-parallel (TP) over ``model`` on the feature axis (attention
heads, FFN hidden, experts, vocab); FSDP over ``data`` on the other large
axis — params *and* fp32 AdamW moments are fully distributed, which is
what lets the 236B/314B-param archs fit. Activations: batch over
``(pod, data)``; caches follow KV-head TP when the head count divides,
else sequence-sharding.

Rules are (leaf-name → logical markers); markers resolve against the mesh
with divisibility fallback (``ctx.resolve``), so one rule table serves
every arch × mesh combination. The rule tables are the reference's.

The port's trees are unstacked: a group under ``dec`` / ``enc`` is a list
of per-layer dicts (``models.lm.param_shapes``) where the reference
stacks the layers on a leading axis, and a cache group a list of
per-layer caches. A layer's spec is therefore the reference's stacked
spec without its leading ``None``, and the per-chip bytes summed over the
layers are the reference's. ``*_specs`` return a tree like their input
with a spec tuple (``ctx.spec``) at each tensor; ``local_shape`` is a
tensor's per-chip shard, and ``local_bytes`` a tree's per-chip bytes.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.optim.adamw import AdamWState

from . import ctx
from .ctx import BATCH, MODEL

FSDP = "data"  # parameter-sharding axis
TP = "model"

# leaf name → markers for the *unstacked* param shape.
_PARAM_RULES: dict[str, tuple] = {
    "embed": (TP, FSDP),
    "lm_head": (FSDP, TP),
    "pos_embed": (None, None),
    # attention
    "wq": (FSDP, TP, None),
    "wk": (FSDP, TP, None),
    "wv": (FSDP, TP, None),
    "wo": (TP, None, FSDP),
    "bq": (TP, None),
    "bk": (TP, None),
    "bv": (TP, None),
    "bo": (None,),
    # MLA
    "wq_a": (FSDP, TP),
    "q_norm": (None,),
    "wq_b": (FSDP, TP, None),
    "wkv_a": (FSDP, None),
    "kv_norm": (None,),
    "wkv_b": (FSDP, TP, None),
    # dense ffn (2D) / moe experts (3D) share names — see _markers
    "w_up": (FSDP, TP),
    "w_gate": (FSDP, TP),
    "w_down": (TP, FSDP),
    "b_up": (TP,),
    "b_down": (None,),
    "router": (FSDP, None),
    # ssm
    "w_in": (FSDP, TP),
    "conv_w": (None, None),
    "conv_b": (None,),
    "a_log": (None,),
    "dt_bias": (None,),
    "d_skip": (None,),
    "out_norm": (None,),
    "w_out": (TP, FSDP),
    # norms
    "scale": (None,),
    "bias": (None,),
}

_EXPERT_RULES = {  # 3D (E, D, F) / (E, F, D) variants
    "w_up": (TP, FSDP, None),
    "w_gate": (TP, FSDP, None),
    "w_down": (TP, None, FSDP),
}
_EXPERT_FALLBACK = {  # E doesn't divide 'model' → TP over the hidden dim
    "w_up": (None, FSDP, TP),
    "w_gate": (None, FSDP, TP),
    "w_down": (None, TP, FSDP),
}


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and named tuples;
    the path holds dict keys, list indices and named-tuple field names."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    return fn(path, tree)


def leaf_name(path) -> str:
    """The last name on a path (a dict key or a named-tuple field)."""
    for e in reversed(path):
        if isinstance(e, str):
            return e
    return ""


def _markers(mesh, name: str, shape, fsdp: bool = True) -> tuple:
    """The logical markers of an (unstacked) parameter of ``shape``."""
    if name in ("w_up", "w_gate", "w_down") and len(shape) == 3:
        tp_size = mesh.shape.get("model", 1)
        rules = _EXPERT_RULES if shape[0] % tp_size == 0 else _EXPERT_FALLBACK
        markers = rules[name]
    elif name in _PARAM_RULES:
        markers = _PARAM_RULES[name]
        if len(markers) != len(shape):
            markers = (None,) * len(shape)
    else:
        markers = (None,) * len(shape)
    if not fsdp:
        # decode mode: FSDP weight-gathers cost a full parameter all-gather
        # per generated token (nothing amortizes them) — weights stay
        # TP/EP-sharded only
        markers = tuple(None if m == FSDP else m for m in markers)
    return markers


def param_specs(mesh, params_tree, fsdp: bool = True) -> Any:
    """Spec tree matching ``params_tree`` (tensors, on ``meta`` or not):
    the counterpart of ``param_shardings``."""
    return map_with_path(
        lambda path, leaf: ctx.spec(
            mesh, _markers(mesh, leaf_name(path), leaf.shape, fsdp),
            leaf.shape),
        params_tree)


def opt_specs(mesh, opt: AdamWState) -> AdamWState:
    """AdamW moments mirror their parameter's sharding; step is
    replicated: the counterpart of ``opt_shardings``."""
    return AdamWState(step=(), m=param_specs(mesh, opt.m),
                      v=param_specs(mesh, opt.v))


# ---------------------------------------------------------------------------
# Batch & cache shardings
# ---------------------------------------------------------------------------

def batch_specs(mesh, batch_tree) -> Any:
    """Batch over the data-parallel axes: the counterpart of
    ``batch_shardings``."""
    return map_with_path(
        lambda _, leaf: ctx.spec(mesh, (BATCH,) + (None,) * (leaf.ndim - 1),
                                 leaf.shape), batch_tree)


def cache_specs(mesh, cache_tree) -> Any:
    """Decode caches, the counterpart of ``cache_shardings``. Layout (B,
    W, heads?, dim?) a layer — prefer B over the dp axes and heads over
    `model`; fall back to sharding the sequence (W) over whatever remains
    (long-context B=1 shards W over data×model). The global position, a
    Python int, is replicated."""
    tp = mesh.shape.get("model", 1)
    dp = ctx.axis_size(mesh, ctx.dp_axes(mesh))

    def f(path, leaf):
        name = leaf_name(path)
        if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
            return ()
        shape = leaf.shape
        if name in ("k", "v", "cross_k", "cross_v"):  # (B,W,KV,hd)
            if shape[2] % tp == 0:
                markers = (BATCH, None, MODEL, None)
            else:
                markers = (BATCH, MODEL, None, None)
            if shape[0] < dp:  # B too small — shard the sequence harder
                markers = (None, ctx.SEQ, None, None)
        elif name in ("ckv", "krope"):  # (B,W,R)
            markers = (BATCH, MODEL, None)
            if shape[0] < dp:
                markers = (None, ctx.SEQ, None)
        elif name == "pos":  # (B,W)
            markers = (BATCH, None)
        elif name == "state":  # (B,H,hd,N)
            markers = (BATCH, MODEL, None, None)
        elif name == "conv":  # (B,K-1,C)
            markers = (BATCH, None, MODEL)
        else:
            markers = (BATCH,) + (None,) * (leaf.ndim - 1)
        return ctx.spec(mesh, markers, shape)

    return map_with_path(f, cache_tree)


# ---------------------------------------------------------------------------
# Per-chip shards
# ---------------------------------------------------------------------------

def local_shape(mesh, spec: tuple, shape) -> tuple:
    """The per-chip shard of a tensor of ``shape`` under ``spec``. The
    rules resolve a dimension onto axes only where it divides them
    (``ctx.resolve``), so there is no padding; an indivisible spec
    raises ``ValueError``."""
    out = []
    for i, n in enumerate(shape):
        s = ctx.axis_size(mesh, spec[i] if i < len(spec) else None)
        if n % s:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"divide its axes {spec[i]} ({s})")
        out.append(n // s)
    return tuple(out)


def _leaves_with_specs(tree, specs):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves_with_specs(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for t, s in zip(tree, specs, strict=True):
            yield from _leaves_with_specs(t, s)
    else:
        yield tree, specs


def local_bytes(mesh, tree, specs) -> int:
    """Per-chip bytes of ``tree`` (tensors, on ``meta`` or not) under
    ``specs`` (a tree from ``*_specs``). A Python int leaf (a cache's
    global position) counts as the int32 scalar the reference carries."""
    total = 0
    for leaf, spec in _leaves_with_specs(tree, specs):
        if isinstance(leaf, torch.Tensor):
            total += (math.prod(local_shape(mesh, spec, leaf.shape))
                      * leaf.element_size())
        elif isinstance(leaf, int):
            total += 4
    return total
