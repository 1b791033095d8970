"""Distributionally robust optimization pieces (Section IV-A; the port of
the JAX package's ``core/dro.py``).

* Wasserstein-ball radius ``rho_i = eta_i + sigma_i`` (Eq. 7), with
  ``eta_i`` from the Fournier-Guillin concentration rate (Eq. 8).
* Lipschitz surrogates ``G(omega)``, the DRO regularizer of Prop. 1:
  ``spectral`` (product of per-matrix spectral norms by power iteration)
  or ``frobenius`` (mean of Frobenius norms).

The surrogates take a stack of client params (leaves ``(C, ...)``) and
return ``(C,)``: row ``i`` reads only client ``i``'s leaves, so one
backward pass of their sum gives every client's own gradient.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.privacy import sigma_for_eps
from repro_torch.tree import tree_leaves

# Fournier-Guillin constants (Eq. 8's "two positive values")
C1 = 2.0
C2 = 1.0


def eta_radius(n_samples: int, d: int, fed: FedConfig) -> float:
    """eta_i of Eq. (8): concentration radius at confidence 1-gamma."""
    log_term = math.log(C1 / fed.confidence_gamma)
    if n_samples >= log_term / C2:
        expo = 1.0 / max(d, 2)
    else:
        expo = 1.0 / fed.wasserstein_beta
    return (log_term / (C2 * n_samples)) ** expo


def rho(eps: torch.Tensor, n_samples: int, d: int, c3: float,
        fed: FedConfig) -> torch.Tensor:
    """rho_i = eta_i + sigma_i (Eq. 7); sigma floors eps at eps_min."""
    return eta_radius(n_samples, d, fed) + sigma_for_eps(eps, c3,
                                                         fed.eps_min)


def _spectral_norm(w: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Power-iteration estimate of ``||W||_2`` for a stack of matrices
    ``(..., m, n)`` (f32): a fixed start ``1/sqrt(n)`` and ``iters``
    steps, differentiable through every step."""
    w = w.float()
    n = w.shape[-1]
    v = torch.full(w.shape[:-2] + (n,), 1.0 / math.sqrt(n),
                   dtype=torch.float32, device=w.device)
    wt = w.transpose(-1, -2)
    for _ in range(iters):
        u = (w @ v.unsqueeze(-1)).squeeze(-1)
        u = u / torch.clamp_min(
            torch.linalg.vector_norm(u, dim=-1, keepdim=True), 1e-9)
        v = (wt @ u.unsqueeze(-1)).squeeze(-1)
        v = v / torch.clamp_min(
            torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-9)
    return torch.sum(u * (w @ v.unsqueeze(-1)).squeeze(-1), dim=-1)


def lipschitz_surrogate(params: Any, kind: str = "spectral") -> torch.Tensor:
    """G(omega) of each client in a stack: leaves ``(C, ...)`` visited in
    sorted-key order; returns ``(C,)``."""
    leaves = [l for l in tree_leaves(params) if l.ndim >= 2]
    C = leaves[0].shape[0]
    dev = leaves[0].device
    if kind == "frobenius":
        total = torch.zeros((C,), dtype=torch.float32, device=dev)
        for l in leaves:
            # eps-smoothed: differentiable at an all-zero leaf
            sq = torch.sum(torch.square(l.float()),
                           dim=tuple(range(1, l.ndim)))
            total = total + torch.sqrt(sq + 1e-12)
        return total / max(len(leaves), 1)
    if kind != "spectral":
        raise ValueError(f"unknown lipschitz_surrogate: {kind!r}")
    log_prod = torch.zeros((C,), dtype=torch.float32, device=dev)
    for l in leaves:
        if l.ndim == 3:                     # a weight matrix per client
            s = _spectral_norm(l)
            log_prod = log_prod + torch.log(torch.clamp_min(s, 1e-6))
    return torch.exp(torch.clamp(log_prod, -20.0, 20.0))
