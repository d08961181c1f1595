"""Dense feed-forward layers (GLU / plain): the dense part of the
reference's ``models.ffn``. Mixture-of-Experts is not ported yet (ROADMAP
queue 1 item 10)."""
from __future__ import annotations

import torch

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
