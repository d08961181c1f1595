"""Mamba-2 SSD (state-space duality) mixer — the port of the reference's
``models.ssm`` (arXiv:2405.21060): the chunked scan for prefill and the
forward, the O(1) recurrence ``s ← a·s + dt·B⊗x`` for decode.

Within a chunk the output is a causal, decay-weighted quadratic form;
across chunks a Python loop carries the (B, H, hd, N) state, where the
reference scans. The quadratic form runs as an elementwise product and a
batched matmul over the key axis, with heads ahead of the chunk's rows
(``(B, nc, H, Q, ·)``), so no tensor wider than (B, nc, H, Q, Q) is built.
Everything is plain tensor operations, as the reference's scan is plain
``jnp``: no kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import init_dense, rmsnorm

# leaves kept in float32 whatever the parameter dtype (reference ssm.py:33-35)
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip")


def conv_dim(cfg) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def ssm_shapes(cfg) -> dict:
    d, di, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads
    n, ng = cfg.ssm_state, cfg.ssm_ngroups
    # w_in's columns: [z (gate), x, B, C, dt]
    return {"w_in": (d, 2 * di + 2 * ng * n + h),
            "conv_w": (cfg.ssm_conv_width, conv_dim(cfg)),
            "conv_b": (conv_dim(cfg),),
            "a_log": (h,), "dt_bias": (h,), "d_skip": (h,),
            "out_norm": (di,), "w_out": (di, d)}


def ssm_params(gen: torch.Generator, cfg, dtype) -> dict:
    """Fan-in matrices from ``gen``; conv bias and the norm scale zero,
    a_log and dt_bias zero and d_skip one, those three in float32."""
    shapes = ssm_shapes(cfg)
    dev = gen.device
    zeros = lambda name, dt: torch.zeros(shapes[name], dtype=dt,  # noqa: E731
                                         device=dev)
    return {"w_in": init_dense(gen, shapes["w_in"], (0,), dtype),
            "conv_w": init_dense(gen, shapes["conv_w"], (0,), dtype),
            "conv_b": zeros("conv_b", dtype),
            "a_log": zeros("a_log", torch.float32),
            "dt_bias": zeros("dt_bias", torch.float32),
            "d_skip": torch.ones(shapes["d_skip"], dtype=torch.float32,
                                 device=dev),
            "out_norm": zeros("out_norm", dtype),
            "w_out": init_dense(gen, shapes["w_out"], (0,), dtype)}


def _split_in(p, x, cfg):
    di, n, ng = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_ngroups
    zxbcdt = x @ p["w_in"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * ng * n]
    dt = zxbcdt[..., 2 * di + 2 * ng * n:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, state=None):
    """Depthwise causal conv, width K. state: (B, K-1, C) carries history."""
    kw = conv_w.shape[0]
    if state is None:
        pad = torch.zeros(xbc.shape[:1] + (kw - 1,) + xbc.shape[2:],
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state
    full = torch.cat([pad, xbc], dim=1)  # (B, K-1+S, C)
    s = xbc.shape[1]
    out = full[:, 0:s] * conv_w[0]
    for i in range(1, kw):
        out = out + full[:, i: i + s] * conv_w[i]
    out = F.silu(out + conv_b)
    new_state = full[:, -(kw - 1):] if kw > 1 else pad
    if full.shape[1] > kw:  # a prompt: copy, or the cache pins ``full``
        new_state = new_state.clone()
    return out, new_state


def _heads(xbc, dt, p, cfg):
    di, h, n, ng = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_ngroups
    lead = xbc.shape[:-1]
    xh = xbc[..., :di].reshape(lead + (h, cfg.ssm_head_dim))
    b = xbc[..., di: di + ng * n].reshape(lead + (ng, n))
    c = xbc[..., di + ng * n:].reshape(lead + (ng, n))
    # broadcast groups over heads
    rep = h // ng
    b = torch.repeat_interleave(b, rep, dim=-2)
    c = torch.repeat_interleave(c, rep, dim=-2)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["a_log"])  # (H,)
    log_decay = dt * a  # (B,S,H) = log of the per-step decay (negative)
    return xh, b, c, dt, log_decay


class SSMState(NamedTuple):
    state: torch.Tensor  # (B, H, hd, N) float32
    conv: torch.Tensor  # (B, K-1, conv_dim), the activation dtype


def init_ssm_state(batch, cfg, dtype, device=None) -> SSMState:
    return SSMState(
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=torch.float32,
                          device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim(cfg)),
                         dtype=dtype, device=device))


def ssd_chunked(xh, b, c, dt, log_decay, chunk: int, init_state=None):
    """Chunked SSD scan. xh: (B,S,H,hd) b,c: (B,S,H,N) dt/log_decay: (B,S,H).
    Returns (y: (B,S,H,hd) float32, final_state: (B,H,hd,N)).

    The tail is padded after the softplus (``_heads``): a padded step has
    dt = 0 and decay 1, so the final state is that of the last real step.
    Above the diagonal ``cs[t] − cs[s]`` is positive and its ``exp`` may
    overflow; it is set to −inf before the ``exp``, so those entries are
    0 and their gradients finite."""
    bsz, s, h, hd = xh.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    if pad:
        xh, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, b, c))
        dt, log_decay = (F.pad(t, (0, 0, 0, pad)) for t in (dt, log_decay))
    nc = xh.shape[1] // chunk

    def rs(t):  # (B, nc*Q, H, ...) -> (B, nc, H, Q, ...)
        t = t.reshape((bsz, nc, chunk) + t.shape[2:])
        return t.transpose(2, 3)

    f32 = torch.float32
    xh, b, c = (rs(t.to(f32)) for t in (xh, b, c))  # (B,nc,H,Q,·)
    dt, ld = rs(dt), rs(log_decay)  # (B,nc,H,Q)
    xdt = xh * dt[..., None]  # dt-weighted input
    cs = torch.cumsum(ld, dim=-1)  # cumulative log decay within the chunk
    total = cs[..., -1]  # (B,nc,H)
    # --- intra-chunk (quadratic, causal, decay-masked) ---
    diff = cs[..., :, None] - cs[..., None, :]  # (B,nc,H,Q,Q): [t, s]
    upper = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=xh.device).triu(1)
    decay = torch.exp(diff.masked_fill(upper, float("-inf")))
    cb = c @ b.transpose(-1, -2)  # (B,nc,H,Q,Q)
    y = (cb * decay) @ xdt  # (B,nc,H,Q,hd)
    # --- chunk states: S_n = Σ_s exp(total - cs[s]) · xdt[s] ⊗ b[s] ---
    w_state = torch.exp(total[..., None] - cs)  # (B,nc,H,Q)
    chunk_states = (xdt * w_state[..., None]).transpose(-1, -2) @ b
    # --- inter-chunk recurrence: the state entering each chunk ---
    st = (torch.zeros((bsz, h, hd, n), dtype=f32, device=xh.device)
          if init_state is None else init_state)
    decay_tot = torch.exp(total)
    entered = []
    for i in range(nc):
        entered.append(st)
        st = decay_tot[:, i, :, None, None] * st + chunk_states[:, i]
    entered = torch.stack(entered, dim=1)  # (B,nc,H,hd,N)
    # --- inter-chunk contribution: y[t] += exp(cs[t]) · C[t] · S_entered ---
    y = y + (c * torch.exp(cs)[..., None]) @ entered.transpose(-1, -2)
    y = y.transpose(2, 3).reshape(bsz, nc * chunk, h, hd)[:, :s]
    return y, st


def ssm_forward(p, x, cfg, state: SSMState | None = None, *,
                return_state: bool = False):
    """Full-sequence forward. x: (B,S,D). If ``state`` is given it is the
    carried recurrence (decode passes S=1). Returns (out, SSMState or
    None)."""
    z, xbc, dt = _split_in(p, x, cfg)
    conv_state = state.conv if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xh, b, c, dt, log_decay = _heads(xbc, dt, p, cfg)
    f32 = torch.float32
    if x.shape[1] == 1 and state is not None:
        # O(1) decode: s ← a·s + dt·B⊗x
        a = torch.exp(log_decay[:, 0])  # (B,H)
        xdt = xh[:, 0].to(f32) * dt[:, 0, :, None]  # (B,H,hd)
        final = (a[:, :, None, None] * state.state
                 + xdt[..., :, None] * b[:, 0].to(f32)[..., None, :])
        y = (final @ c[:, 0].to(f32)[..., None])[..., 0][:, None]
    else:
        init = state.state if state is not None else None
        y, final = ssd_chunked(xh, b, c, dt, log_decay, cfg.ssm_chunk, init)
    y = y + xh.to(f32) * p["d_skip"][:, None]
    y = y.reshape(x.shape[:2] + (cfg.ssm_d_inner,)).to(x.dtype)
    y = rmsnorm(y, p["out_norm"], cfg.norm_eps) * F.silu(z)
    out = y @ p["w_out"]
    if return_state:
        return out, SSMState(state=final, conv=new_conv)
    return out, None
