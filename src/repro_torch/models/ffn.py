"""Feed-forward layers: dense (GLU / plain) and Mixture-of-Experts with
GShard-style capacity routing — the port of the reference's
``models.ffn``.

The MoE routes each group of ``moe_group_size`` tokens (the last group
padded with zero rows, which route and take slots but are dropped from
the output) by a float32 router: softmax, the top-k experts in
``jax.lax.top_k``'s order (ties to the lower expert), renormalised gates
where ``router_scale`` says so, then slots of ``capacity`` per expert
and group handed out choice-major, then token-major, and choices past
capacity dropped. The reference builds one-hot (G, g, E, C) dispatch and
combine tensors and contracts them with einsums; the port moves tokens
into their slots and back by index (exact, as the one-hot products are),
and runs each expert's SiLU-GLU as a batched matrix product over the
expert axis. ``moe_dispatch`` still returns the reference's combine
tensor. Routing is plain tensor operations on any device, as the
reference's is plain ``jnp``. ``moe_forward``'s four parts run inside
``torch.profiler.record_function`` ranges (``moe.router``,
``moe.dispatch``, ``moe.experts``, ``moe.combine``), so a profile names
them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.core.topk import top_k_positions

from .common import ACTIVATIONS, init_dense


def dense_shapes(d_model, d_ff, act: str, bias: bool) -> dict:
    kind, _ = ACTIVATIONS[act]
    shapes = {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}
    if kind == "glu":
        shapes["w_gate"] = (d_model, d_ff)
    if bias:
        shapes.update(b_up=(d_ff,), b_down=(d_model,))
    return shapes


def dense_params(gen: torch.Generator, d_model, d_ff, act: str, bias: bool,
                 dtype) -> dict:
    p = {}
    for name, shape in dense_shapes(d_model, d_ff, act, bias).items():
        if name.startswith("w"):
            p[name] = init_dense(gen, shape, (0,), dtype)
        else:  # biases start at zero
            p[name] = torch.zeros(shape, dtype=dtype, device=gen.device)
    return p


def dense_forward(p, x, act: str):
    kind, fn = ACTIVATIONS[act]
    h = x @ p["w_up"]
    if "b_up" in p:
        h = h + p["b_up"]
    if kind == "glu":
        h = fn(x @ p["w_gate"]) * h
    else:
        h = fn(h)
    y = h @ p["w_down"]
    if "b_down" in p:
        y = y + p["b_down"]
    return y


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_shapes(cfg) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    shapes = {"router": (d, e), "w_up": (e, d, f), "w_gate": (e, d, f),
              "w_down": (e, f, d)}
    if cfg.n_shared_experts > 0:
        shapes["shared"] = dense_shapes(d, cfg.n_shared_experts * f,
                                        "silu_glu", False)
    return shapes


def moe_params(gen: torch.Generator, cfg, dtype) -> dict:
    """The router in float32 whatever ``dtype`` is; each expert's matrices
    drawn with its fan-in axis 1; shared experts a dense SiLU-GLU of width
    ``n_shared_experts · d_ff_expert``."""
    shapes = moe_shapes(cfg)
    p = {"router": init_dense(gen, shapes["router"], (0,), torch.float32)}
    for name in ("w_up", "w_gate", "w_down"):
        p[name] = init_dense(gen, shapes[name], (1,), dtype)
    if cfg.n_shared_experts > 0:
        p["shared"] = dense_params(gen, cfg.d_model,
                                   cfg.n_shared_experts * cfg.d_ff_expert,
                                   "silu_glu", False, dtype)
    return p


def _capacity(group: int, top_k: int, n_experts: int, factor: float) -> int:
    return max(int(math.ceil(group * top_k * factor / n_experts)), top_k)


class Route(NamedTuple):
    """Each token's top-k choices, (G, g, k): the expert, its gate, the
    slot the choice was given in that expert (which may be past
    capacity), and whether it is dispatched (kept and a gate above 0)."""
    experts: torch.Tensor
    gates: torch.Tensor
    slots: torch.Tensor
    sent: torch.Tensor


def moe_route(probs, top_k: int, capacity: int, renorm: bool) -> Route:
    """The router's float32 probabilities (G, g, E) → the tokens' choices.
    Slots are handed out choice-major, then token-major (GShard): choice j
    of a token takes the next slot of its expert after every choice < j of
    the group and the same choice of earlier tokens, whether those were
    kept or not."""
    e = probs.shape[-1]
    experts = top_k_positions(probs, top_k)  # (G, g, k), lax.top_k's order
    gates = torch.gather(probs, -1, experts)
    if renorm:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    counts = torch.zeros(probs.shape[0], e, dtype=torch.int64,
                         device=probs.device)
    slots = []
    for j in range(top_k):
        m = torch.nn.functional.one_hot(experts[..., j], e)  # (G, g, E)
        pos = counts[:, None, :] + torch.cumsum(m, dim=1) - m
        slots.append((pos * m).sum(-1))
        counts = counts + m.sum(dim=1)
    slots = torch.stack(slots, -1)
    # the reference dispatches where combine > 0: a kept choice whose gate
    # is 0 is not sent
    sent = (slots < capacity) & (gates > 0)
    return Route(experts, gates, slots, sent)


def _router_probs(router_logits):
    return torch.softmax(router_logits.to(torch.float32), dim=-1)


def combine_of(route: Route, n_experts: int, capacity: int):
    """The reference's combine tensor (G, g, E, C) float32 of a route: each
    kept choice's gate at its (expert, slot), 0 elsewhere."""
    g_, s_, _ = route.experts.shape
    # a token's choices name distinct experts; dropped ones write a
    # discarded last column
    dest = torch.where(route.slots < capacity,
                       route.experts * capacity + route.slots,
                       n_experts * capacity)
    combine = torch.zeros((g_, s_, n_experts * capacity + 1),
                          dtype=torch.float32, device=route.gates.device)
    combine.scatter_(-1, dest, route.gates)
    return combine[..., :-1].reshape(g_, s_, n_experts, capacity)


def moe_dispatch(router_logits, top_k: int, capacity: int, renorm: bool):
    """router_logits: (G, g, E) → combine (G, g, E, C) float32; the
    dispatch mask is ``combine > 0``."""
    route = moe_route(_router_probs(router_logits), top_k, capacity, renorm)
    return combine_of(route, router_logits.shape[-1], capacity)


def moe_forward(p, x, cfg):
    """x: (B, S, D) or (T, D) → (y, aux). Grouped capacity routing over
    groups of ``cfg.moe_group_size`` tokens (the last padded); the tokens
    sent to an expert gathered into its (G, C) slots, its SiLU-GLU run on
    all of them as one batched product over the expert axis, each token's
    outputs gathered back and weighted by its gates in choice order;
    plus the shared experts; aux is ``load_balance_loss``."""
    orig_shape = x.shape
    d = orig_shape[-1]
    x2 = x.reshape(-1, d)
    t = x2.shape[0]
    g = min(cfg.moe_group_size, t)
    n_groups, rem = divmod(t, g)
    if rem:  # pad to whole groups (padding tokens route but are dropped)
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, g - rem))
        n_groups += 1
    xg = x2.reshape(n_groups, g, d)
    e, k = cfg.n_experts, cfg.top_k_experts
    cap = _capacity(g, k, e, cfg.capacity_factor)
    with record_function("moe.router"):
        logits = xg.to(torch.float32) @ p["router"]  # (G, g, E)
        r = moe_route(_router_probs(logits), k, cap, cfg.router_scale)
        aux = load_balance_loss(logits, k)
    # each sent choice's row among the slots, laid out (E, G, C) so that
    # each expert's slots are one (G·C, D) block; the rest go to a
    # discarded last row. A slot holds at most one choice, so moving the
    # tokens in and out by index is exact, as the reference's one-hot
    # products are.
    n_slots = e * n_groups * cap
    with record_function("moe.dispatch"):
        group = torch.arange(n_groups, device=x.device)[:, None, None]
        flat = ((r.experts * n_groups + group) * cap
                + torch.clamp(r.slots, max=cap - 1))  # (G, g, k)
        xe = x2.new_zeros((n_slots + 1, d))
        xe[torch.where(r.sent, flat, n_slots)] = xg[:, :, None, :].expand(
            n_groups, g, k, d)
        xe = xe[:-1].view(e, n_groups * cap, d)
    with record_function("moe.experts"):
        h = torch.nn.functional.silu(torch.bmm(xe, p["w_gate"]))
        h = h * torch.bmm(xe, p["w_up"])
        ye = torch.bmm(h, p["w_down"]).view(n_slots, d)
        del h
    with record_function("moe.combine"):
        # each token's expert outputs weighted by its gates, in choice
        # order
        w = torch.where(r.sent, r.gates, 0.0).to(x.dtype)  # (G, g, k)
        y = w[..., 0, None] * ye[flat[..., 0]]
        for j in range(1, k):
            y = y + w[..., j, None] * ye[flat[..., j]]
    y = y.reshape(-1, d)[:t].reshape(orig_shape)
    if "shared" in p:
        y = y + dense_forward(p["shared"], x, "silu_glu")
    return y, aux


def load_balance_loss(router_logits, top_k: int):
    """Switch/GShard auxiliary loss: E · Σ_e f_e · p_e, over every routed
    token (padding included, as in the reference)."""
    probs = _router_probs(router_logits)
    e = probs.shape[-1]
    experts = top_k_positions(probs, top_k)
    assign = torch.nn.functional.one_hot(experts, e).sum(-2).to(
        torch.float32)  # (..., E)
    lead = tuple(range(assign.ndim - 1))
    f = assign.mean(dim=lead) / top_k
    pbar = probs.mean(dim=lead)
    return e * torch.sum(f * pbar)
