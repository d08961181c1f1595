"""Learning-rate schedules, pure functions of the step — the port of the
reference's ``optim.schedules``. Each returns a float32 tensor (0-dim for
a scalar step) on the step's device (the CPU for a Python number)."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def cosine(step, *, peak_lr, warmup_steps, total_steps, min_ratio=0.1):
    step = _f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def wsd(step, *, peak_lr, warmup_steps, total_steps, decay_frac=0.1,
        min_ratio=0.0):
    """Warmup-stable-decay."""
    step = _f32(step)
    decay_start = total_steps * (1 - decay_frac)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - decay_start)
                    / max(total_steps - decay_start, 1), 0.0, 1.0)
    dec = peak_lr * (1 - (1 - min_ratio) * t)
    out = torch.where(step < warmup_steps, warm,
                      torch.full_like(step, peak_lr))
    return torch.where(step > decay_start, dec, out)
