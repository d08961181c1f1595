"""Distributed-optimization collectives — the port of the reference's
``parallel.collectives``.

``compressed_psum`` — int8 error-feedback all-reduce for the cross-pod
gradient reduction: pods are connected by the slowest links, and
gradients tolerate aggressive quantization when the residual is fed back
(Seide et al.; 1-bit Adam lineage). An int8 payload is a quarter of a
float32 one.

The port is single-controller, as the fleet is (``parallel.fleet``): one
process holds every shard, so where the reference runs inside
``shard_map`` over an axis and ``psum``s, the port takes one tensor per
shard, in a list, and returns one mean and one new error per shard. The
int8 payloads are summed exactly in int32 and the per-shard scales added
in shard order, on the first shard's device; each shard gets the mean on
its own device. ``torch.round`` rounds half to even, as ``jnp.round``
does (the tests hold both at ties).

Usage:
    means, errs = compressed_psum(grads, errors=errs)
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d with d on x's device: on the card a division by a Python
    number multiplies by its float32 reciprocal, which rounds otherwise
    than the division the CPU and the reference do."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_int8(x: torch.Tensor, scale_floor: float = 1e-12):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(_div(amax, 127.0), min=scale_floor)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(xs: Sequence[torch.Tensor],
                    errors: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Error-feedback int8 psum-mean over the shards ``xs``.

    Returns (means, new_errors), one of each per shard. A new error
    carries its shard's quantization residual this round — add it to the
    next round's input (error feedback keeps the long-run bias at zero,
    so convergence matches a float32 all-reduce)."""
    if errors is None:
        errors = [None] * len(xs)
    home = xs[0].device
    qs, scales, new_errors = [], [], []
    for x, err in zip(xs, errors, strict=True):
        xf = x.to(torch.float32)
        if err is not None:
            xf = xf + err
        q, scale = quantize_int8(xf)
        new_errors.append(xf - q.to(torch.float32) * scale)
        qs.append(q)
        scales.append(scale)
    # int32 accumulation of int8 payloads; scales added in shard order
    total = qs[0].to(home, torch.int32)
    sum_scale = scales[0].to(home)
    for q, scale in zip(qs[1:], scales[1:]):
        total = total + q.to(home, torch.int32)
        sum_scale = sum_scale + scale.to(home)
    n = float(len(xs))
    # per-shard scales differ: reconstruct with the mean scale (the error
    # term absorbs the mismatch on the next round)
    mean = _div(total.to(torch.float32) * _div(sum_scale, n), n)
    return [mean.to(x.device, x.dtype) for x in xs], new_errors


def tree_compressed_psum(trees: Sequence, error_trees=None):
    """``compressed_psum`` leaf by leaf over one tree per shard. Returns
    (one mean tree per shard, one error tree per shard)."""
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    n_leaves = len(flat[0][0])
    errs = ([tree_flatten(e)[0] for e in error_trees]
            if error_trees is not None else [[None] * n_leaves] * len(trees))
    outs = [[] for _ in trees]
    new_errs = [[] for _ in trees]
    for i in range(n_leaves):
        means, es = compressed_psum([f[0][i] for f in flat],
                                    [e[i] for e in errs])
        for s in range(len(trees)):
            outs[s].append(means[s])
            new_errs[s].append(es[s])
    return ([tree_unflatten(treedef, o) for o in outs],
            [tree_unflatten(treedef, e) for e in new_errs])
