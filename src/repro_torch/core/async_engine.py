"""Asynchrony / wall-clock simulator (Section VI-D, Figs. 4-6).

TPU SPMD is bulk-synchronous, and the paper's own experiments simulate the
client fleet too — so wall-clock comparisons of BSFDP (sync) vs BAFDP
(async) come from an event-driven timing model:

* every client has a base compute latency (heterogeneous, lognormal by
  default, optionally Pareto heavy-tailed) plus per-round jitter, a
  communication latency, and optional bursty-straggler spikes;
* clients may drop out of the fleet and rejoin later (``dropout_prob`` /
  ``rejoin_prob``); a dropped client is never activated;
* **sync**: every round waits for the slowest available client
  (the "straggler" effect the paper describes);
* **async**: the server proceeds once S available clients of the round
  have arrived; slower clients keep computing and deliver stale updates at
  their own completion times (Definition 2's t-hat bookkeeping).  The
  quorum S is fixed (``round(C * active_frac)``) or **adaptive** (an EWMA
  of observed arrival counts, bounded by ``s_min``/``s_max``), and the
  winners are the **fastest** S or chosen **age-aware** (clients stale
  beyond a threshold are admitted first, bounding max staleness).

``simulate`` returns a :class:`SimResult` with per-round wall-clock
timestamps, active masks, per-round staleness vectors (``t - tau_i``, 0 on
the round a client participates), and the availability matrix.  The server
loop itself now lives in :mod:`repro_torch.core.schedule` (the federation policy
API: pluggable quorum/selection policies, a FedBuff K-arrivals trigger, and
a sparse ``Schedule`` representation); ``simulate`` is the legacy dense
shim over it.  ``benchmarks/fig456_async_efficiency.py`` builds sparse
schedules through the policy API and trains on them via
``schedule.FederatedRun``, so the loss-vs-wall-clock curves in Figs. 4-6
train on the *same* event-driven schedule that produced their timestamps.

This module is a copy of the JAX package's ``core/async_engine.py`` (host
numpy, no JAX), kept here so the port imports nothing of ``repro``:
every ``RandomState`` stream, and so every schedule, matches the
reference's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DelayModel:
    n_clients: int
    base_compute: float = 1.0        # seconds per local round (mean)
    hetero: float = 0.8              # spread of per-client base latency
    jitter: float = 0.2              # per-round lognormal sigma
    comm: float = 0.3                # up+down communication latency
    seed: int = 0
    # scenario knobs -------------------------------------------------------
    tail: str = "lognormal"          # lognormal | pareto (heavy-tailed jitter)
    pareto_shape: float = 1.5        # smaller = heavier tail (must be > 0)
    burst_prob: float = 0.0          # P(client is a bursty straggler, per round)
    burst_scale: float = 10.0        # latency multiplier during a burst
    dropout_prob: float = 0.0        # P(available client drops, per round)
    rejoin_prob: float = 0.0         # P(dropped client rejoins, per round)
    # latency-lie adaptive attack (arXiv 2404.14389): the last
    # round(C * liar_frac) clients — byzantine.byz_mask's convention, so
    # the liars ARE the message-corrupting clients — REPORT near-zero
    # delays (honest latency × lie_scale), monopolizing FedBuff arrival
    # slots and FastestSelection wins.  Draw-free no-op at liar_frac = 0
    # (pinned schedule digests are untouched).
    liar_frac: float = 0.0           # fraction of clients lying about latency
    lie_scale: float = 1e-3          # multiplier applied to a liar's delay

    def liar_mask(self) -> np.ndarray:
        """(C,) bool — the last ``round(C * liar_frac)`` clients lie."""
        n_liars = int(round(self.n_clients * self.liar_frac))
        return np.arange(self.n_clients) >= (self.n_clients - n_liars)

    def lie_row(self, delays: np.ndarray) -> np.ndarray:
        """Apply the latency lie to one (C,) delay row (no-op when
        ``liar_frac == 0``); shared by the dense matrix builder and the
        streaming row provider so both schedules see the same attack."""
        if self.liar_frac <= 0:
            return delays
        return np.where(self.liar_mask(), delays * self.lie_scale, delays)

    def client_bases(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed)
        return self.base_compute * np.exp(
            self.hetero * rng.randn(self.n_clients))

    def jitter_row(self, rng) -> np.ndarray:
        """One (C,) multiplicative jitter row drawn from ``rng`` — the
        single definition of the latency tail, shared by the dense matrix
        builder below and the streaming row provider in core/schedule
        (numpy fills matrices row-major, so sequential row draws from one
        RandomState reproduce the matrix draw bit-for-bit)."""
        if self.tail == "pareto":
            # heavy-tailed jitter: Lomax bumps (mean 1/(shape-1) for
            # shape > 1, infinite mean for shape <= 1) give rare huge delays
            return 1.0 + rng.pareto(self.pareto_shape, self.n_clients)
        if self.tail == "lognormal":
            return np.exp(self.jitter * rng.randn(self.n_clients))
        raise ValueError(f"unknown tail: {self.tail!r}")

    def burst_row(self, rng, jit: np.ndarray) -> np.ndarray:
        """Apply one (C,) bursty-straggler row from ``rng`` to a jitter
        row (no-op draw-free when burst_prob == 0)."""
        if self.burst_prob <= 0:
            return jit
        burst = rng.rand(self.n_clients) < self.burst_prob
        return np.where(burst, jit * self.burst_scale, jit)

    def round_delays(self, n_rounds: int) -> np.ndarray:
        """(n_rounds, C) per-round completion latencies."""
        if n_rounds == 0:
            return np.zeros((0, self.n_clients))
        rng = np.random.RandomState(self.seed + 1)
        base = self.client_bases()[None, :]
        # all jitter rows are drawn before any burst row — the streaming
        # path therefore matches this bit-for-bit only when burst_prob == 0
        jit = np.stack([self.jitter_row(rng) for _ in range(n_rounds)])
        jit = np.stack([self.burst_row(rng, j) for j in jit])
        d = base * jit + self.comm
        return np.stack([self.lie_row(row) for row in d])

    def avail_step(self, rng, cur: np.ndarray) -> np.ndarray:
        """One dropout/rejoin Markov transition (in place on ``cur``);
        keeps >= 1 client available (the fleet never goes completely
        dark).  Shared by ``availability`` and the streaming provider."""
        u = rng.rand(self.n_clients)
        drop = cur & (u < self.dropout_prob)
        rejoin = ~cur & (u < self.rejoin_prob)
        cur = (cur & ~drop) | rejoin
        if not cur.any():
            cur[rng.randint(self.n_clients)] = True
        return cur

    def availability(self, n_rounds: int) -> np.ndarray:
        """(n_rounds, C) bool — dropout/rejoin Markov chain."""
        C = self.n_clients
        avail = np.ones((n_rounds, C), bool)
        if self.dropout_prob <= 0:
            return avail
        rng = np.random.RandomState(self.seed + 2)
        cur = np.ones(C, bool)
        for r in range(n_rounds):
            cur = self.avail_step(rng, cur)
            avail[r] = cur
        return avail


class SimResult(NamedTuple):
    times: np.ndarray        # (n_rounds,) wall-clock at round close
    active: np.ndarray       # (n_rounds, C) bool participation masks
    staleness: np.ndarray    # (n_rounds, C) int: r - tau_i (0 on participation)
    available: np.ndarray    # (n_rounds, C) bool dropout/rejoin state
    quorum: np.ndarray       # (n_rounds,) int realized per-round quorum S


def simulate(mode: str, n_rounds: int, delays: DelayModel,
             active_frac: float = 0.6, *, quorum: str = "fixed",
             s_min: Optional[int] = None, s_max: Optional[int] = None,
             quorum_beta: float = 0.25, select: str = "fastest",
             age_threshold: Optional[int] = None) -> SimResult:
    """Event-driven schedule for ``n_rounds`` federated rounds.

    .. deprecated:: this kwargs API is a thin shim over the federation
       policy API in :mod:`repro_torch.core.schedule` — prefer composing
       ``build_schedule(n_rounds, delays, QuorumTrigger(...))`` directly
       (which also unlocks the FedBuff K-arrivals trigger and the sparse
       million-client representation).  The shim is kept because the PR-1/
       PR-2 schedule digests are pinned against it bit-for-bit
       (``tests/test_schedule_regression.py``).

    ``quorum`` — per-round S policy (async mode):
      * ``fixed``: S = round(C * active_frac) (:class:`schedule.FixedQuorum`);
      * ``adaptive``: EWMA (rate ``quorum_beta``) of the arrivals observed
        at each round's close, clipped to [``s_min``, ``s_max``]
        (:class:`schedule.AdaptiveQuorum`).

    ``select`` — which S available clients win the round (async mode):
      * ``fastest``: earliest completion times
        (:class:`schedule.FastestSelection`);
      * ``age_aware``: clients whose staleness reached ``age_threshold``
        (default 2 * ceil(C / S)) are admitted first, oldest first,
        bounding max staleness (:class:`schedule.AgeAwareSelection`).
    """
    from repro_torch.core import schedule as sched_lib

    if quorum not in ("fixed", "adaptive"):
        raise ValueError(f"unknown quorum mode: {quorum!r}")
    if select not in ("fastest", "age_aware"):
        raise ValueError(f"unknown selection policy: {select!r}")
    if mode == "sync":
        trigger = sched_lib.SyncTrigger()
    elif mode == "async":
        C = delays.n_clients
        # PR-2 behaviour, kept for compat: the bounds are validated for
        # BOTH quorum modes but only clamp the adaptive one — a fixed
        # quorum ignores s_min/s_max (it is never adapted)
        s_lo = max(1, s_min if s_min is not None else 1)
        s_hi = min(C, s_max if s_max is not None else C)
        if s_lo > s_hi:
            raise ValueError(f"s_min={s_lo} > s_max={s_hi}")
        qp = sched_lib.FixedQuorum() if quorum == "fixed" \
            else sched_lib.AdaptiveQuorum(beta=quorum_beta,
                                          s_min=s_min, s_max=s_max)
        sp = sched_lib.FastestSelection() if select == "fastest" \
            else sched_lib.AgeAwareSelection(age_threshold=age_threshold)
        trigger = sched_lib.QuorumTrigger(active_frac=active_frac,
                                          quorum=qp, selection=sp)
    else:
        raise ValueError(mode)
    return sched_lib.build_schedule(n_rounds, delays, trigger).to_sim()


def speedup_at(loss_sync: np.ndarray, t_sync: np.ndarray,
               loss_async: np.ndarray, t_async: np.ndarray,
               target: float) -> Tuple[float, float]:
    """Wall-clock to first reach ``target`` loss for each mode."""
    def first_time(loss, t):
        idx = np.argmax(loss <= target)
        if loss[idx] > target:
            return float("inf")
        return float(t[idx])
    return first_time(loss_sync, t_sync), first_time(loss_async, t_async)
