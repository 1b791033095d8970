"""Byzantine attack models (Section III; the port of the JAX package's
``core/byzantine.py`` for the dense round).

``apply_attack`` replaces the malicious clients' messages in a stacked
client tree (leading axis C) — what the server sees in Eq. (20)'s sign
sum.  ``poison_batch`` corrupts the malicious clients' training batches
instead (the data attacks).  The deterministic attacks match the
reference exactly; ``gaussian`` draws from a ``torch.Generator``, so its
draws differ from the reference's ``jax.random`` ones.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.ref import fold_weighted_rowsum, true_div
from repro_torch.tree import tree_map

ATTACKS = ("none", "gaussian", "sign_flip", "same_value", "scaled",
           "zero", "label_flip", "alie", "traffic_shift")

# attacks that corrupt the data, not the message (corrupt() is identity)
DATA_ATTACKS = ("label_flip", "traffic_shift")


def corrupt(attack: str, gen: torch.Generator, honest: Any, *,
            scale: float = 10.0) -> Any:
    """Corrupted version of a stacked client message (leading axis C)."""
    if attack == "none" or attack in DATA_ATTACKS:
        return honest
    if attack == "gaussian":
        return tree_map(
            lambda l: (torch.randn(l.shape, generator=gen,
                                   dtype=torch.float32, device=l.device)
                       * scale).to(l.dtype), honest)
    if attack == "sign_flip":
        return tree_map(lambda l: -scale * l, honest)
    if attack == "same_value":
        return tree_map(lambda l: torch.full_like(l, scale), honest)
    if attack == "scaled":
        return tree_map(lambda l: scale * l, honest)
    if attack == "zero":
        return tree_map(torch.zeros_like, honest)
    if attack == "alie":
        # "A Little Is Enough": shift by a small multiple of the
        # cross-client std, hidden inside the honest spread; mean and
        # variance are row-order folds over all C rows
        def f(l):
            lf = l.float()
            ones = torch.ones((l.shape[0],), dtype=torch.float32,
                              device=l.device)
            mu = true_div(fold_weighted_rowsum(lf, ones), l.shape[0])
            var = true_div(fold_weighted_rowsum(torch.square(lf - mu[None]),
                                                ones), l.shape[0])
            row = mu - 1.5 * torch.sqrt(var)
            return row[None].expand(l.shape).to(l.dtype)

        return tree_map(f, honest)
    raise ValueError(f"unknown attack {attack!r}")


def apply_attack(attack: str, gen: torch.Generator, stacked: Any,
                 byz_mask: torch.Tensor, *, scale: float = 10.0) -> Any:
    """Replace the malicious clients' messages.  stacked leaves: (C, ...);
    byz_mask: (C,) bool."""
    if attack == "none" or attack in DATA_ATTACKS \
            or not bool(byz_mask.shape[0]):
        return stacked
    bad = corrupt(attack, gen, stacked, scale=scale)

    def sel(h, b):
        m = byz_mask.reshape((-1,) + (1,) * (h.ndim - 1))
        return torch.where(m, b, h)

    return tree_map(sel, stacked, bad)


def poison_batch(attack: str, batch: Any, byz_rows: torch.Tensor, *,
                 shift: int = 6) -> Any:
    """``traffic_shift`` rolls each malicious row's samples ``shift`` steps
    along the last axis (a diurnal phase shift); leaves with fewer than 2
    axes are untouched.  Every other attack returns ``batch`` unchanged.
    ``batch`` is a tuple of (C, ...) tensors."""
    if attack != "traffic_shift":
        return batch

    def f(l):
        if l.ndim < 2:
            return l
        rolled = torch.roll(l, shift, dims=-1)
        m = byz_rows.reshape((-1,) + (1,) * (l.ndim - 1))
        return torch.where(m, rolled, l)

    return tuple(f(l) for l in batch)


def byz_mask(n_clients: int, n_byzantine: int, device=None) -> torch.Tensor:
    """The last ``n_byzantine`` clients are malicious."""
    return torch.arange(n_clients, device=device) >= (n_clients - n_byzantine)
