"""Shared layers: init, norms, RoPE, embeddings, dense FFN variants (the
port of the JAX package's ``models/layers.py``; the LM-training losses
``chunked_ce_from_hidden`` and ``cross_entropy`` come with LM training).

Parameters are plain tensors, looked up by the reference's names
(``params["scale"]``, ``params["w_gate"]``, ...).  Every function keeps
the reference's dtype rules: norms and RoPE compute in f32 and return the
input's dtype; projections run in the activation's dtype.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def span(name: str):
    """A profiler label while ``torch.profiler`` records, else nothing
    (``profile_serve`` sums the device time under each label)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def dense_init(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               scale: float = 1.0, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: ``scale / sqrt(fan_in)`` times a
    standard normal truncated to [-2, 2], drawn from ``gen`` (on ``gen``'s
    device unless ``device`` says otherwise)."""
    std = scale / math.sqrt(shape[in_axis])
    t = torch.empty(tuple(shape), dtype=torch.float32,
                    device=gen.device if device is None else device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)


# ---------------------------------------------------------------------------
# Norms
def init_rmsnorm(d: int, dtype: torch.dtype = torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-halves form, angles in f32)
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)    # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
def init_embedding(gen: torch.Generator, cfg: ArchConfig):
    dt = dtype_of(cfg.param_dtype)
    p = {"tok": dense_init(gen, (cfg.padded_vocab, cfg.d_model), in_axis=1,
                           dtype=dt)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype=dt)
    return p


def embed(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = params["tok"][tokens]
    if cfg.name.startswith("gemma"):          # gemma scales embeddings
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x.to(dtype_of(cfg.compute_dtype))


def lm_logits(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    w = params["tok"].t() if cfg.tie_embeddings else params["head"]
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU / GeGLU / GELU); jax.nn.gelu is the tanh form
def init_ffn(gen: torch.Generator, cfg: ArchConfig):
    dt = dtype_of(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn_act in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, (d, f), dtype=dt),
                "w_up": dense_init(gen, (d, f), dtype=dt),
                "w_down": dense_init(gen, (f, d), dtype=dt)}
    return {"w_in": dense_init(gen, (d, f), dtype=dt),
            "w_out": dense_init(gen, (f, d), dtype=dt)}


def gate_act(g: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The gate of a SwiGLU (silu) or GeGLU (tanh gelu) FFN."""
    return F.silu(g) if cfg.ffn_act == "swiglu" else F.gelu(
        g, approximate="tanh")


def ffn(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.ffn_act in ("swiglu", "geglu"):
        g = x @ params["w_gate"].to(x.dtype)
        u = x @ params["w_up"].to(x.dtype)
        return (gate_act(g, cfg) * u) @ params["w_down"].to(x.dtype)
    h = F.gelu(x @ params["w_in"].to(x.dtype), approximate="tanh")
    return h @ params["w_out"].to(x.dtype)
