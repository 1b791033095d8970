"""Local differential privacy: the Gaussian mechanism of Section III-B
(the port of the JAX package's ``core/privacy.py``).

Each client adds ``v ~ N(0, sigma^2)`` to its training inputs, with
``sigma = c3 / eps_i`` and ``c3 = sqrt(2 d log(1.25/delta)) * Delta``.
The privacy level ``eps_i`` is a decision variable of the optimization,
constrained to ``[eps_min, a]`` (Eq. 3).

Randomness comes from the round's ``torch.Generator``, or, in the
active-subset round, from a :class:`RowGenerators`: one generator per
client row, seeded from the round generator's seed and the client id, so
a client's draw does not depend on the block it sits in (the counterpart
of the reference's ``jax.random.split(key, C)[client]``).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import FedConfig


def gaussian_c3(d: int, delta: float, sensitivity: float) -> float:
    """c3 = sqrt(2 d log(1.25/delta)) * Delta."""
    return math.sqrt(2.0 * d * math.log(1.25 / delta)) * sensitivity


def sigma_for_eps(eps: torch.Tensor, c3: float,
                  eps_min: float = FedConfig.eps_min) -> torch.Tensor:
    """Noise scale ``c3 / max(eps, eps_min)`` — the same floor as the
    feasible set (:func:`eps_feasible`).  Divides a full tensor:
    ``c3 / tensor`` would round twice (reciprocal, then multiply)."""
    e = torch.clamp_min(eps, eps_min)
    return torch.full_like(e, c3) / e


# stream tags of the row generators (core/byzantine.py has its own)
NOISE_STREAM = 1


class RowGenerators:
    """Fleet-indexed randomness for a block of client rows: row ``r``
    draws from its own ``torch.Generator``, seeded from ``(seed, stream,
    leaf, client_ids[r])`` by numpy's ``SeedSequence``.  A client's draw
    is then the same whether its row sits in a full-width block or a
    gathered one, and whatever the padding (duplicate ids draw alike).

    ``seed`` is the round generator's ``initial_seed()``; ``stream`` tells
    the uses of one round apart (the LDP noise, an attack's draws)."""

    def __init__(self, seed: int, stream: int, client_ids: Sequence[int],
                 device) -> None:
        self.seed = int(seed)
        self.stream = int(stream)
        self.client_ids = np.asarray(client_ids, np.int64).reshape(-1)
        self.device = torch.device(device)

    def __len__(self) -> int:
        return int(self.client_ids.size)

    def generator(self, row: int, leaf: int = 0) -> torch.Generator:
        """Row ``row``'s generator for ``leaf``."""
        mixed = int(np.random.SeedSequence(
            [self.seed, self.stream, int(leaf),
             int(self.client_ids[row])]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(mixed)

    def randn(self, shape: Sequence[int], dtype=torch.float32,
              leaf: int = 0) -> torch.Tensor:
        """``(R, *shape)`` standard normals, row ``r`` from its own
        generator."""
        out = torch.empty((len(self),) + tuple(shape), dtype=dtype,
                          device=self.device)
        for r in range(len(self)):
            out[r].normal_(generator=self.generator(r, leaf))
        return out


def perturb_inputs(gen: Union[torch.Generator, RowGenerators],
                   x: torch.Tensor, eps: torch.Tensor, c3: float,
                   eps_min: float = FedConfig.eps_min) -> torch.Tensor:
    """``x + v``, ``v ~ N(0, sigma^2 I)`` drawn from ``gen``: one block
    from a ``torch.Generator``, or row by row (``x``'s leading axis) from
    a :class:`RowGenerators`.  ``eps`` carries the leading (client) axes
    of ``x`` and broadcasts from the left."""
    sigma = sigma_for_eps(eps, c3, eps_min).to(x.dtype)
    if isinstance(gen, RowGenerators):
        if len(gen) != x.shape[0]:
            raise ValueError(f"{len(gen)} row generators for a block of "
                             f"{x.shape[0]} rows")
        noise = gen.randn(x.shape[1:], dtype=x.dtype)
    else:
        noise = torch.randn(x.shape, generator=gen, dtype=x.dtype,
                            device=x.device)
    while sigma.ndim < x.ndim:
        sigma = sigma[..., None]
    return x + noise * sigma


def eps_feasible(eps: torch.Tensor, fed: FedConfig) -> torch.Tensor:
    """Project eps onto the feasible set [eps_min, a] (constraint Eq. 3)."""
    return torch.clamp(eps, fed.eps_min, fed.privacy_budget_a)


def privacy_accountant(eps_history, delta: float) -> Tuple[float, float]:
    """Basic and advanced (Dwork-Roth Thm 3.20, at ``eps_max``)
    composition over T rounds of per-round ``(eps_t, delta)``."""
    eps_history = np.asarray(eps_history, np.float32)
    t = eps_history.shape[0]
    basic = float(np.sum(eps_history))
    emax = float(np.max(eps_history))
    adv = math.sqrt(2 * t * math.log(1 / delta)) * emax \
        + t * emax * (math.exp(emax) - 1)
    return basic, min(basic, adv)


class EpsLedger:
    """Per-delivery privacy accounting: one entry per delivered message,
    composed per client over its own delivery count (a duplicate delivery
    spends budget twice).  Fleet totals report the worst client.  Host
    numpy, a copy of the reference's ledger."""

    def __init__(self, n_clients: int):
        if n_clients <= 0:
            raise ValueError(f"n_clients must be positive, got {n_clients}")
        self.n_clients = int(n_clients)
        self.spent = np.zeros((n_clients,), np.float64)      # sum of eps
        self.deliveries = np.zeros((n_clients,), np.int64)   # message count
        self.eps_max = np.zeros((n_clients,), np.float64)    # worst single eps

    def record(self, client_ids, eps_values) -> None:
        """Record one delivery per entry (duplicates spend budget twice)."""
        ids = np.asarray(client_ids, np.int64).ravel()
        eps = np.asarray(eps_values, np.float64).ravel()
        if ids.shape != eps.shape:
            raise ValueError(
                f"client_ids {ids.shape} != eps_values {eps.shape}")
        if ids.size == 0:
            return
        if ids.min() < 0 or ids.max() >= self.n_clients:
            raise ValueError(
                f"client id out of range [0, {self.n_clients})")
        np.add.at(self.spent, ids, eps)
        np.add.at(self.deliveries, ids, 1)
        np.maximum.at(self.eps_max, ids, eps)

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Checkpointable ledger state."""
        return {"spent": self.spent.copy(),
                "deliveries": self.deliveries.copy(),
                "eps_max": self.eps_max.copy()}

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        """Restore :meth:`state_dict` output (shape-checked)."""
        missing = {"spent", "deliveries", "eps_max"} - set(state)
        if missing:
            raise ValueError(f"ledger state missing keys {sorted(missing)}")
        shape = (self.n_clients,)
        for k, dtype in (("spent", np.float64), ("deliveries", np.int64),
                         ("eps_max", np.float64)):
            arr = np.asarray(state[k], dtype)
            if arr.shape != shape:
                raise ValueError(
                    f"ledger state {k!r} has shape {arr.shape}, expected "
                    f"{shape}")
            setattr(self, k, arr.copy())

    def basic(self) -> np.ndarray:
        """Per-client basic (sequential) composition totals."""
        return self.spent.copy()

    def advanced(self, delta: float) -> np.ndarray:
        """Per-client advanced composition at each client's own delivery
        count, floored by basic composition."""
        n = self.deliveries.astype(np.float64)
        emax = self.eps_max
        with np.errstate(over="ignore"):
            adv = np.sqrt(2.0 * n * math.log(1.0 / delta)) * emax \
                + n * emax * np.expm1(emax)
        return np.where(n > 0, np.minimum(self.spent, adv), 0.0)

    def totals(self, delta: float) -> Dict[str, float]:
        """Worst-client summary + fleet delivery count."""
        return {
            "dp_eps_basic": float(self.basic().max(initial=0.0)),
            "dp_eps_adv": float(self.advanced(delta).max(initial=0.0)),
            "dp_deliveries": int(self.deliveries.sum()),
            "dp_deliveries_max": int(self.deliveries.max(initial=0)),
        }
