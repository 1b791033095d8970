"""Learning-rate schedules (the port of the JAX package's
``optim/schedules.py``): ``count`` (an int32 tensor) -> an f32 tensor."""
from __future__ import annotations

import math

import torch


def warmup_linear(peak: float, warmup: int, total: int):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then linear decay
    to 0 at ``total``."""
    def f(count):
        c = torch.as_tensor(count).float()
        warm = peak * c / max(warmup, 1)
        decay = peak * torch.clamp((total - c) / max(total - warmup, 1),
                                   min=0.0)
        return torch.where(c < warmup, warm, decay)
    return f


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warm-up to ``peak``, then a cosine from ``peak`` down to
    ``floor_frac * peak`` at ``total``."""
    def f(count):
        c = torch.as_tensor(count).float()
        warm = peak * c / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac)
                      * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup, warm, cos)
    return f
