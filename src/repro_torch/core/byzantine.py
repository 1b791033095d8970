"""Byzantine attack models (Section III; the port of the JAX package's
``core/byzantine.py`` for the dense round).

``apply_attack`` replaces the malicious clients' messages in a stacked
client tree (leading axis C) — what the server sees in Eq. (20)'s sign
sum.  ``poison_batch`` corrupts the malicious clients' training batches
instead (the data attacks).  The deterministic attacks match the
reference exactly; ``gaussian`` draws from a ``torch.Generator``, so its
draws differ from the reference's ``jax.random`` ones.

Fleet-indexed randomness (the active-subset round): given ``client_ids``,
``gaussian`` draws each row from its own generator, keyed off (round
seed, leaf, client id) through :class:`repro_torch.core.privacy.
RowGenerators`, and ``alie``'s cross-client mean and variance run over
the ``weight > 0`` rows only.  The corruption a client receives then does
not depend on the width or padding of its block, so the full-width masked
round and the gathered round agree bit for bit under every attack.
Without ``client_ids`` (the ``"all"``-scope round) the draws are one block
from the round's generator, as before.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.privacy import RowGenerators
from repro_torch.kernels.ref import fold_weighted_rowsum, true_div
from repro_torch.tree import host_array, tree_leaves, tree_map

ATTACKS = ("none", "gaussian", "sign_flip", "same_value", "scaled",
           "zero", "label_flip", "alie", "traffic_shift")

# attacks that corrupt the data, not the message (corrupt() is identity)
DATA_ATTACKS = ("label_flip", "traffic_shift")

# the row generators' stream tag of the attack draws (privacy.NOISE_STREAM
# is the LDP noise's)
ATTACK_STREAM = 2


def _row_ids(honest: Any, client_ids) -> np.ndarray:
    R = tree_leaves(honest)[0].shape[0]
    ids = host_array(client_ids).astype(np.int64).reshape(-1)
    if ids.shape != (R,):
        raise ValueError(
            f"client_ids shape {ids.shape} != block rows ({R},)")
    return ids


def corrupt(attack: str, gen: torch.Generator, honest: Any, *,
            scale: float = 10.0, client_ids: Optional[Any] = None,
            weight: Optional[torch.Tensor] = None) -> Any:
    """Corrupted version of a stacked client message (leading axis R).

    ``client_ids`` (R,) maps block rows to fleet client ids: ``gaussian``
    then draws row by row, keyed off the client id (see the module
    docstring).  ``weight`` (R,) marks the rows (> 0) whose statistics
    ``alie`` may read (default: every row)."""
    if attack == "none" or attack in DATA_ATTACKS:
        return honest
    if attack == "gaussian":
        if client_ids is None:
            return tree_map(
                lambda l: (torch.randn(l.shape, generator=gen,
                                       dtype=torch.float32, device=l.device)
                           * scale).to(l.dtype), honest)
        ids = _row_ids(honest, client_ids)
        leaves = iter(enumerate(tree_leaves(honest)))

        def draw(_):
            i, l = next(leaves)
            rows = RowGenerators(gen.initial_seed(), ATTACK_STREAM, ids,
                                 l.device)
            return (rows.randn(l.shape[1:], leaf=i) * scale).to(l.dtype)

        return tree_map(draw, honest)
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
        # variance are row-order folds over the weight > 0 rows (all rows
        # without weights), where a zero-weight row adds an exact 0
        def f(l):
            lf = l.float()
            if weight is None:
                wv = torch.ones((l.shape[0],), dtype=torch.float32,
                                device=l.device)

                def div(x):
                    return true_div(x, l.shape[0])
            else:
                wv = weight.float()
                n = torch.clamp_min(torch.sum(wv), 1.0)

                def div(x):
                    return x / n
            mu = div(fold_weighted_rowsum(lf, wv))
            var = div(fold_weighted_rowsum(torch.square(lf - mu[None]), wv))
            row = mu - 1.5 * torch.sqrt(var)
            return row[None].expand(l.shape).to(l.dtype)

        return tree_map(f, honest)
    raise ValueError(f"unknown attack {attack!r}")


def apply_attack(attack: str, gen: torch.Generator, stacked: Any,
                 byz_mask: torch.Tensor, *, scale: float = 10.0,
                 client_ids: Optional[Any] = None,
                 weight: Optional[torch.Tensor] = None) -> Any:
    """Replace the malicious clients' messages.  stacked leaves: (R, ...);
    byz_mask: (R,) bool, row-aligned with the block; ``scale``,
    ``client_ids`` and ``weight`` go to :func:`corrupt`."""
    if attack == "none" or attack in DATA_ATTACKS \
            or not bool(byz_mask.shape[0]):
        return stacked
    bad = corrupt(attack, gen, stacked, scale=scale, client_ids=client_ids,
                  weight=weight)

    def sel(h, b):
        m = byz_mask.reshape((-1,) + (1,) * (h.ndim - 1))
        return torch.where(m, b, h)

    return tree_map(sel, stacked, bad)


def poison_batch(attack: str, batch: Any, byz_rows: torch.Tensor, *,
                 shift: int = 6) -> Any:
    """``traffic_shift`` rolls each malicious row's samples ``shift`` steps
    along the last axis (a diurnal phase shift); leaves with fewer than 2
    axes are untouched.  Every other attack returns ``batch`` unchanged.
    ``batch`` is a tree (a tuple, or an LM's dict) of (C, ...) tensors."""
    if attack != "traffic_shift":
        return batch

    def f(l):
        if l.ndim < 2:
            return l
        rolled = torch.roll(l, shift, dims=-1)
        m = byz_rows.reshape((-1,) + (1,) * (l.ndim - 1))
        return torch.where(m, rolled, l)

    return tree_map(f, batch)


def byz_mask(n_clients: int, n_byzantine: int, device=None) -> torch.Tensor:
    """The last ``n_byzantine`` clients are malicious."""
    return torch.arange(n_clients, device=device) >= (n_clients - n_byzantine)
