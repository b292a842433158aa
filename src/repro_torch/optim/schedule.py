"""LR schedules.

The port of ``repro/optim/schedule.py``.  The schedule computes in a
float32 tensor, as the reference does: a Python-float rate would differ
from the reference's by an f32 rounding, and every parameter update would
carry it.
"""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor_frac·peak_lr`` at ``total``; a float32 0-d tensor on
    ``step``'s device (the host for a Python int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac)
                     * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)
