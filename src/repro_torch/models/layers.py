"""Shared layers (the port of the JAX package's ``models/layers.py``;
only ``dense_init`` so far)."""
from __future__ import annotations

import math
from typing import Sequence

import torch


def dense_init(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               scale: float = 1.0, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: ``scale / sqrt(fan_in)`` times a
    standard normal truncated to [-2, 2], drawn from ``gen``."""
    std = scale / math.sqrt(shape[in_axis])
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)
