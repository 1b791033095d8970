"""Federated baseline trainers (Section V-B; the port of the JAX package's
``core/trainers.py``): FedGRU / Fed-NTP (FedAvg), FedProx, FedAtt, FedDA,
AFL, ASPIRE-EASE (simplified), UDP, NbAFL, RSA, DP-RSA and FedAsync (AFO,
arXiv:1903.03934), all as round functions over stacked client trees that
share one local-update step.

Each trainer: ``round(state, batch, gen, act=None) -> (state, metrics)``
with batch leaves (C, b, ...) and ``gen`` the round's
``torch.Generator``.  ``act`` optionally supplies an external (C,)
participation mask (e.g. a ``Schedule`` row) instead of the internal
uniform sampler.

``loss(W, batch, gen) -> (C,)``: the per-client loss of a stack, row i
reading only row i (as ``bafdp_round``'s ``local_loss``), so the
per-client gradients come from one ``torch.autograd.grad`` of the summed
losses.

Randomness, in draw order from ``gen``: the internal sampler (without
``act``), the upload DP noise (one block per leaf, sorted-key order), the
``gaussian`` attack and NbAFL's downlink noise.  The reported loss uses
a generator of its own, derived from ``gen.initial_seed()``, as the
reference derives its eval key by ``fold_in`` rather than widening the
split.  The aggregation is plain PyTorch, as the reference's is plain XLA:
it reaches no kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import aggregators as agg
from repro_torch.core import byzantine as byz_lib
from repro_torch.core.bafdp import active_mask, staleness_weights
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# loss(W_stack, batch, gen) -> (C,) per-client loss
Loss = Callable[[Any, Any, torch.Generator], torch.Tensor]

# the server state is a plain dict: {"server": params, "t", ...extras}
BaselineState = dict

# the eval generator's stream tag (the reference's fold_in(key, 4))
EVAL_STREAM = 4


def _stream_generator(gen: torch.Generator, stream: int,
                      device) -> torch.Generator:
    """A generator of its own for one use of the round, seeded from the
    round generator's ``initial_seed()`` and ``stream``."""
    mixed = int(np.random.SeedSequence(
        [gen.initial_seed(), stream]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


def _grad(loss: Loss, W: Any, batch: Any, gen: torch.Generator) -> Any:
    """Per-client gradients of a stack: one backward of the summed
    per-client losses."""
    Wg = tree_map(lambda w: w.detach().requires_grad_(True), W)
    with torch.enable_grad():
        flat = torch.autograd.grad(loss(Wg, batch, gen).sum(),
                                   tree_leaves(Wg))
    return tree_unflatten(Wg, flat)


def _local_sgd(loss: Loss, W: Any, batch: Any, gen: torch.Generator,
               lr: float, steps: int, prox: float = 0.0,
               anchor: Any = None) -> Any:
    """``steps`` plain SGD steps of every client of the stack; FedProx adds
    ``prox (w - anchor)`` to the gradient."""
    for _ in range(steps):
        g = _grad(loss, W, batch, gen)
        if prox and anchor is not None:
            g = tree_map(lambda gl, pl, al: gl + prox * (pl.float()
                                                         - al.float()),
                         g, W, anchor)
        W = tree_map(lambda pl, gl: (pl.float() - lr * gl).to(pl.dtype),
                     W, g)
    return W


def _broadcast(server: Any, C: int) -> Any:
    return tree_map(lambda l: l[None].expand((C,) + l.shape), server)


def _noisy(tree: Any, sigma: float, gen: torch.Generator) -> Any:
    """``tree`` plus ``sigma`` N(0, 1) noise, one block per leaf."""
    return tree_map(lambda l: l + (sigma * torch.randn(
        l.shape, generator=gen, dtype=torch.float32, device=l.device)
    ).to(l.dtype), tree)


@dataclasses.dataclass
class BaselineTrainer:
    """Config-driven baseline round."""
    method: str
    loss: Loss
    fed: FedConfig
    lr: float = 1e-2
    local_steps: int = 5
    prox_mu: float = 0.1          # FedProx
    dp_sigma: float = 0.0         # UDP / NbAFL / DP-RSA noise scale
    psi: float = 5e-3             # RSA penalty
    aggregator: str = "fedavg"
    async_alpha: float = 0.6      # FedAsync mixing rate (AFO's alpha)

    def init(self, params: Any) -> BaselineState:
        l0 = tree_leaves(params)[0]
        C = self.fed.n_clients
        st = {"server": params,
              "t": torch.zeros((), dtype=torch.int32, device=l0.device)}
        if self.method in ("afl", "aspire"):
            st["p"] = torch.full((C,), 1.0 / C, device=l0.device)
        if self.method == "fedda":
            st["quasi"] = params
        if self.method == "fedasync":
            st["tau"] = torch.zeros((C,), dtype=torch.int32,
                                    device=l0.device)
        return st

    @torch.no_grad()
    def round(self, st: BaselineState, batch: Any, gen: torch.Generator,
              act: Any = None) -> Tuple[BaselineState,
                                        Dict[str, torch.Tensor]]:
        fed = self.fed
        C = fed.n_clients
        server = st["server"]
        dev = tree_leaves(server)[0].device
        if act is None:
            act = active_mask(gen, C, fed.active_frac, device=dev)
        else:
            act = torch.as_tensor(act, device=dev).bool()
        byz = byz_lib.byz_mask(C, fed.n_byzantine, device=dev)

        W0 = _broadcast(server, C)
        # data-poisoning attacks corrupt the malicious clients' batches
        batch = byz_lib.poison_batch(fed.attack, batch, byz,
                                     shift=fed.traffic_shift_steps)
        prox = self.method == "fedprox"
        W1 = _local_sgd(self.loss, W0, batch, gen, self.lr,
                        self.local_steps,
                        prox=self.prox_mu if prox else 0.0,
                        anchor=W0 if prox else None)
        # inactive clients return nothing: they keep the server's params

        def keep_active(n, o):
            m = act.reshape((-1,) + (1,) * (n.ndim - 1))
            return torch.where(m, n.float(), o.float()).to(o.dtype)

        W1 = tree_map(keep_active, W1, W0)
        # client-side DP noise on the uploads (UDP / NbAFL / DP-RSA)
        if self.dp_sigma > 0:
            W1 = _noisy(W1, self.dp_sigma, gen)
        W_sent = byz_lib.apply_attack(fed.attack, gen, W1, byz,
                                      scale=fed.attack_scale)

        # the loss over the ACTIVE set only (inactive clients hold the
        # server's params), from a generator of its own
        losses = self.loss(W1, batch, _stream_generator(gen, EVAL_STREAM,
                                                        dev))
        act_f = act.float()
        metrics = {"loss": torch.sum(losses * act_f)
                   / torch.clamp_min(torch.sum(act_f), 1.0),
                   "n_active": torch.sum(act)}
        new = dict(st)

        m = self.method
        if m in ("fedavg", "fedprox", "udp", "nbafl"):
            new["server"] = agg.AGGREGATORS[self.aggregator](W_sent) \
                if self.aggregator != "krum" \
                else agg.krum(W_sent, fed.n_byzantine)
            if m == "nbafl":              # downlink perturbation as well
                new["server"] = _noisy(new["server"], 0.5 * self.dp_sigma,
                                       gen)
        elif m == "robust_agg":
            if self.aggregator == "krum":
                new["server"] = agg.krum(W_sent, fed.n_byzantine)
            elif self.aggregator == "centered_clip":
                new["server"] = agg.centered_clip(W_sent, server)
            else:
                new["server"] = agg.AGGREGATORS[self.aggregator](W_sent)
        elif m == "fedatt":
            new["server"] = agg.fedatt(W_sent, server)
        elif m == "fedda":
            new["server"] = agg.fedda(W_sent, server, st["quasi"])
            new["quasi"] = tree_map(
                lambda q, s: (0.9 * q.float() + 0.1 * s.float()).to(q.dtype),
                st["quasi"], new["server"])
        elif m in ("afl", "aspire"):
            # agnostic / DRO weights: exponentiated-gradient ascent on ALL
            # C per-client losses; ASPIRE-EASE also pins p inside a box
            # around the uniform prior (its EASE constraint)
            p = st["p"] * torch.exp(0.5 * (losses - losses.mean()))
            p = p / torch.sum(p)
            if m == "aspire":
                u = 1.0 / C
                p = torch.clamp(p, u * 0.25, u * 4.0)
                p = p / torch.sum(p)
            new["p"] = p
            new["server"] = agg.fedavg(W_sent, weights=p)
        elif m == "fedasync":
            # AFO server: each arriving model mixes into the server at rate
            # alpha s(t - tau_i); simultaneous arrivals are averaged
            stale = (st["t"] - st["tau"]).float()
            a_t = self.async_alpha * staleness_weights(stale, fed) * act_f
            n_act = torch.clamp_min(torch.sum(act), 1).float()

            def mix(s, w):
                a = a_t.reshape((-1,) + (1,) * s.ndim)
                delta = torch.sum(a * (w.float() - s[None].float()), dim=0)
                return (s.float() + delta / n_act).to(s.dtype)

            new["server"] = tree_map(mix, server, W_sent)
            new["tau"] = torch.where(act, st["t"], st["tau"])
        elif m in ("rsa", "dp_rsa"):
            # RSA moves z toward the clients: z <- z - lr psi sum sign(z - w)
            sgn = agg.rsa_sign(W_sent, server)
            new["server"] = tree_map(
                lambda s, g: (s.float() - self.lr * self.psi * g).to(s.dtype),
                server, sgn)
        else:
            raise ValueError(f"unknown baseline method {m!r}")
        new["t"] = st["t"] + 1
        return new, metrics
