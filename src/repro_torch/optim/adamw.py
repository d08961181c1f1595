"""AdamW as a pure function over the port's parameter tree — the port of
the reference's ``optim.adamw``.

Moments are float32 whatever the parameter dtype. The global-norm clip,
the bias corrections and the update follow the reference's float32
operation order, and weight decay goes on every leaf, as the reference
does. ``torch.optim.AdamW`` is not used: it adds eps to the bias-corrected
root and applies the decay as a separate multiplication, which rounds
differently.

A tree is the port's parameter layout: dicts and lists of tensors
(``models.lm``). ``apply`` returns new tensors and leaves its inputs as
they are, as the reference's ``apply`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict
    v: dict


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, in a tree of the same shape. Leaves are visited in
    ``checkpoint.manager.tree_flatten``'s order (the reference's: dict
    keys sorted, lists in order), so a tree's order does not depend on how
    its dicts were built (a restored checkpoint's are sorted)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs)
                                    for xs in zip(leaves, *others,
                                                  strict=True)])


def tree_leaves(tree) -> list:
    """The tensors of a tree in ``tree_map``'s order."""
    return tree_flatten(tree)[0]


def init(params) -> AdamWState:
    """Zero moments (float32) beside ``params``, step 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = None
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def apply(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
          eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    """One AdamW step. Returns (params, state, gnorm): gnorm is the global
    norm of the float32 gradients before clipping (0 when ``grad_clip`` is
    off). Nothing here reads a value back to the host."""
    step = state.step + 1
    if grad_clip and grad_clip > 0:
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
        scale = 1.0
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        mh = m_new / bc1
        vh = v_new / bc2
        pf = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
        return (pf - lr * delta).to(p.dtype), m_new, v_new

    leaves, treedef = tree_flatten(params)
    out = [upd(*xs) for xs in zip(leaves, tree_leaves(grads),
                                  tree_leaves(state.m), tree_leaves(state.v),
                                  strict=True)]  # (p, m, v) a leaf
    part = lambda i: tree_unflatten(treedef, [o[i] for o in out])  # noqa: E731
    return part(0), AdamWState(step=step, m=part(1), v=part(2)), gnorm
