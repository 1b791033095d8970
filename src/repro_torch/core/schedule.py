"""Federation policy API: sparse event schedules + pluggable server policies.

The paper's server (Algorithm 1) is an event-driven loop: clients arrive,
the server decides *when to aggregate* and *whom to admit*.  This module
factors that loop into three small policy protocols,

* :class:`QuorumPolicy` — how many admissions close a round
  (:class:`FixedQuorum` = PR-1, :class:`AdaptiveQuorum` = EWMA of observed
  arrivals);
* :class:`SelectionPolicy` — which candidates win the round
  (:class:`FastestSelection` = earliest completions,
  :class:`AgeAwareSelection` = overdue clients first, bounding staleness);
* :class:`AggregationTrigger` — the server mode itself
  (:class:`QuorumTrigger` = quorum-of-S, :class:`SyncTrigger` = wait for
  every available client, :class:`FedBuffTrigger` = FedBuff-style
  K-arrivals buffer, arXiv:2106.06639),

composed by :func:`build_schedule` into a **sparse** :class:`Schedule`:
per-round winner lists plus per-winner admission ages, O(rounds * S)
memory instead of the dense ``(rounds, C)`` masks of
:class:`repro_torch.core.async_engine.SimResult`.  ``Schedule.to_sim()`` /
``Schedule.from_sim()`` convert losslessly to/from the dense form, and the
legacy ``async_engine.simulate(...)`` kwargs API is now a thin shim over
this module (the PR-1/PR-2 schedule digests are pinned bit-for-bit by
``tests/test_schedule_regression.py``).

:class:`FederatedRun` (the port's own) walks a ``Schedule`` (or a
per-round kwargs hook), feeds each round's rows into a round function
with the round's ``torch.Generator``, and collects metric histories.

Million-client fleets: pass ``stream=True`` to :func:`build_schedule` to
draw latency/availability rows one round at a time — nothing of shape
``(rounds, C)`` is ever allocated.  Streaming is bit-identical to the
dense path except when ``burst_prob > 0`` (the dense path draws the whole
jitter matrix before the burst matrix; streaming gives bursts their own
RNG stream, ``seed + 3``).

Device realism: ``build_schedule`` also accepts a
:class:`repro_torch.core.devices.DeviceModel` wrapping a ``DelayModel`` — the
device layer (diurnal participation windows, battery/network-conditioned
latency, correlated regional outages, flash-crowd surges) applies its
row-sequential state machines on top of the base rows in BOTH providers,
so device fleets stream at C=1M and keep dense/stream parity whenever the
base model does.

Schedules are horizon-**prefix-stable**: a shorter build equals the first
rounds of a longer one (burst-free dense, or any streaming build), so a
checkpointed run can resume against a re-built longer schedule without
diverging from the uninterrupted run.

Everything above :class:`FederatedRun` is a copy of the JAX package's
``core/schedule.py`` (host numpy, no JAX), so the port's schedules
equal the reference's array for array.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Protocol,
    Tuple,
    runtime_checkable,
)

import numpy as np
import torch

from repro_torch.core.async_engine import DelayModel, SimResult
from repro_torch.core.devices import DeviceModel, split_model
from repro_torch.distributed.data_parallel import is_split
from repro_torch.tree import host_array, resolve_device


# ===========================================================================
# sparse schedule
# ===========================================================================
# eq=False: the hand-written array-aware __eq__ below is the comparison,
# and it keeps the class explicitly unhashable (the generated frozen-
# dataclass __hash__ would TypeError on the ndarray fields at call time)
@dataclasses.dataclass(frozen=True, eq=False)
class Schedule:
    """Sparse event-driven schedule: per-round winner lists (CSR layout).

    ``winner_ids[offsets[r]:offsets[r+1]]`` are round ``r``'s admitted
    updates in admission order; ``winner_ages`` holds each winner's age at
    admission (Definition 2's ``d = r - tau_i``, with ``tau_i`` the last
    round the client participated in, 0 before first participation).
    FedBuff rounds may admit the same client twice (it delivered two
    updates into one buffer); dense conversion collapses duplicates into
    the bool mask.  Ages are stamped per *arrival* event, not per drain:
    a duplicate FedBuff delivery was computed after the client's earlier
    delivery into the same buffer, so it carries age 0 while the first
    occurrence carries the client's full absence length.
    ``unavailable_ids``/``unavailable_offsets`` record the dropout state
    sparsely (empty = the whole fleet was up).
    """
    n_clients: int
    times: np.ndarray               # (R,) wall-clock at round close
    winner_ids: np.ndarray          # (E,) concatenated per-round winners
    winner_ages: np.ndarray         # (E,) admission age of each winner
    offsets: np.ndarray             # (R+1,) CSR offsets into winner_*
    unavailable_ids: np.ndarray     # (U,) concatenated unavailable clients
    unavailable_offsets: np.ndarray  # (R+1,) CSR offsets into unavailable_ids

    @property
    def n_rounds(self) -> int:
        return self.times.shape[0]

    @property
    def arrivals(self) -> np.ndarray:
        """(R,) admitted updates per round (counts duplicate FedBuff
        deliveries; == the realized buffer size K in FedBuff mode)."""
        return np.diff(self.offsets)

    @property
    def quorum(self) -> np.ndarray:
        """(R,) distinct participating clients per round (matches
        ``SimResult.quorum``; <= ``arrivals`` under FedBuff)."""
        return np.asarray([np.unique(self.round_winners(r)).size
                           for r in range(self.n_rounds)], np.int64)

    @property
    def s_max(self) -> int:
        """Max admitted updates in any round — the static pad width of
        :meth:`padded_rows` (>= 1 so an empty schedule still shapes)."""
        arr = self.arrivals
        return int(arr.max()) if arr.size else 1

    def round_winners(self, r: int) -> np.ndarray:
        return self.winner_ids[self.offsets[r]:self.offsets[r + 1]]

    def round_unavailable(self, r: int) -> np.ndarray:
        return self.unavailable_ids[
            self.unavailable_offsets[r]:self.unavailable_offsets[r + 1]]

    def rows(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield per-round ``(active (C,) bool, staleness (C,) int)`` —
        exactly the rows of ``SimResult.active`` / ``.staleness``, computed
        incrementally so no dense ``(R, C)`` matrix ever materializes."""
        last = np.zeros(self.n_clients, np.int64)
        for r in range(self.n_rounds):
            w = self.round_winners(r)
            act = np.zeros(self.n_clients, bool)
            act[w] = True
            last[w] = r
            yield act, r - last

    def padded_rows(self, s_max: Optional[int] = None
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield per-round ``(idx, stale, weight)`` rows in the padded
        active-subset format ``repro_torch.core.bafdp.bafdp_round_sparse``
        consumes — the O(S) counterpart of :meth:`rows`:

        * ``idx`` (S_max,) int32 — the round's admitted client ids in
          admission order, padded with the sentinel ``n_clients``;
        * ``stale`` (S_max,) float32 — each delivery's admission age
          (``winner_ages``: Definition 2's ``d``, stamped per *arrival*
          event, so a duplicate FedBuff delivery carries age 0);
        * ``weight`` (S_max,) float32 — 1 for a real delivery, 0 for
          padding.  ``weight.sum()`` is the round's realized arrivals
          count K (duplicate deliveries included).

        ``s_max`` defaults to :attr:`s_max`; the width is static so a
        jitted sparse round compiles once for the whole schedule.  Note
        the ``stale`` row carries the *admission* ages, which the dense
        ``rows()`` path cannot represent (its per-client staleness vector
        zeroes the winners); densify with ``stale_c[idx] = stale`` when
        driving the dense round as the bit-parity oracle.
        """
        S = s_max if s_max is not None else self.s_max
        for r in range(self.n_rounds):
            w = self.round_winners(r)
            if w.size > S:
                raise ValueError(
                    f"round {r} admits {w.size} updates > s_max={S}; pass "
                    "padded_rows(s_max=) at least Schedule.s_max")
            idx = np.full(S, self.n_clients, np.int32)
            idx[:w.size] = w
            stale = np.zeros(S, np.float32)
            stale[:w.size] = self.winner_ages[
                self.offsets[r]:self.offsets[r + 1]]
            weight = np.zeros(S, np.float32)
            weight[:w.size] = 1.0
            yield idx, stale, weight

    def to_sim(self) -> SimResult:
        """Dense ``SimResult`` — lossless except that duplicate FedBuff
        deliveries collapse into the bool participation mask."""
        R, C = self.n_rounds, self.n_clients
        active = np.zeros((R, C), bool)
        staleness = np.zeros((R, C), np.int64)
        available = np.ones((R, C), bool)
        for r, (act, stale) in enumerate(self.rows()):
            active[r] = act
            staleness[r] = stale
            available[r, self.round_unavailable(r)] = False
        return SimResult(self.times.copy(), active, staleness, available,
                         active.sum(axis=1).astype(np.int64))

    def canonical(self) -> "Schedule":
        """Winners re-sorted by client id within each round (admission
        order dropped).  ``from_sim(to_sim(s)) == s.canonical()`` for any
        duplicate-free (quorum/sync) schedule — the round-trip is lossless
        up to admission order, which the dense form does not represent."""
        ids: List[np.ndarray] = []
        ages: List[np.ndarray] = []
        for r in range(self.n_rounds):
            w = self.round_winners(r)
            a = self.winner_ages[self.offsets[r]:self.offsets[r + 1]]
            o = np.argsort(w, kind="stable")
            ids.append(w[o])
            ages.append(a[o])
        return dataclasses.replace(self, winner_ids=_cat(ids),
                                   winner_ages=_cat(ages))

    @classmethod
    def from_sim(cls, sim: SimResult) -> "Schedule":
        """Sparsify a dense ``SimResult`` (admission ages reconstructed
        from the participation history)."""
        active = np.asarray(sim.active, bool)
        available = np.asarray(sim.available, bool)
        R, C = active.shape
        ids: List[np.ndarray] = []
        ages: List[np.ndarray] = []
        offsets = np.zeros(R + 1, np.int64)
        un_ids: List[np.ndarray] = []
        un_offsets = np.zeros(R + 1, np.int64)
        last = np.zeros(C, np.int64)
        for r in range(R):
            w = np.flatnonzero(active[r])
            ids.append(w)
            ages.append(r - last[w])
            last[w] = r
            offsets[r + 1] = offsets[r] + w.size
            u = np.flatnonzero(~available[r])
            un_ids.append(u)
            un_offsets[r + 1] = un_offsets[r] + u.size
        return cls(
            n_clients=C, times=np.asarray(sim.times, np.float64).copy(),
            winner_ids=_cat(ids), winner_ages=_cat(ages), offsets=offsets,
            unavailable_ids=_cat(un_ids), unavailable_offsets=un_offsets)

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Schedule):
            return NotImplemented
        return (self.n_clients == other.n_clients
                and np.array_equal(self.times, other.times)
                and np.array_equal(self.winner_ids, other.winner_ids)
                and np.array_equal(self.winner_ages, other.winner_ages)
                and np.array_equal(self.offsets, other.offsets)
                and np.array_equal(self.unavailable_ids, other.unavailable_ids)
                and np.array_equal(self.unavailable_offsets,
                                   other.unavailable_offsets))


def _cat(chunks: List[np.ndarray]) -> np.ndarray:
    if not chunks:
        return np.zeros(0, np.int64)
    return np.concatenate([np.asarray(c, np.int64) for c in chunks])


def _arrival_ages(r: int, last_part: np.ndarray,
                  winners: np.ndarray) -> np.ndarray:
    """Per-arrival admission ages for round ``r``'s winners (in admission
    order).  The first delivery of client ``i`` carries Definition 2's
    ``d = r - tau_i``; any later delivery by the same client *within the
    same round* (a fast client refilling a FedBuff buffer) was computed
    after its earlier delivery and therefore carries age 0 — stamping
    every occurrence at the drain round would give both deliveries the
    same stale age.  Duplicate-free rounds (quorum/sync triggers) are
    unchanged."""
    ages = r - last_part[winners]
    if winners.size:
        _, first = np.unique(winners, return_index=True)
        repeat = np.ones(winners.size, bool)
        repeat[first] = False
        ages[repeat] = 0
    return ages


# ===========================================================================
# delay/availability row providers
# ===========================================================================
class _DenseRows:
    """Materializes the full (R, C) latency/availability matrices — the
    PR-1/PR-2 RNG consumption order, bit-compatible with the digest pins.

    A :class:`~repro_torch.core.devices.DeviceModel` layers its per-client
    latency multipliers / availability masks row-by-row over the base
    matrices: the device machines are strictly row-sequential (their own
    RNG streams), so this matches :class:`_StreamRows` bit-for-bit
    whenever the base model does (``burst_prob == 0``)."""

    def __init__(self, model, n_rounds: int):
        dm, dev = split_model(model)
        self._d = dm.round_delays(n_rounds)
        self._avail = dm.availability(n_rounds)
        if dev is not None:
            st = dev.state()
            for r in range(n_rounds):
                self._d[r] = st.scale_delays(r, self._d[r])
                self._avail[r] = st.mask_avail(r, self._avail[r])

    def delays(self, r: int) -> np.ndarray:
        return self._d[r]

    def avail(self, r: int) -> np.ndarray:
        return self._avail[r]


class _StreamRows:
    """Row-at-a-time latency/availability draws: O(C) live memory, no
    (R, C) allocation.  Bit-identical to :class:`_DenseRows` whenever
    ``burst_prob == 0`` (numpy fills matrices row-major, so per-row draws
    from the same RandomState reproduce the dense stream); bursty fleets
    get a dedicated burst stream (``seed + 3``) and therefore a different —
    equally valid — schedule.  Rows must be requested in nondecreasing
    order; only the last two delay rows stay cached (round ``r`` touches
    rows ``r`` and ``r + 1``).  A :class:`~repro_torch.core.devices.DeviceModel`
    applies its row-sequential latency multipliers / availability masks on
    top of the base rows — still O(C) live memory."""

    def __init__(self, model, n_rounds: int):
        dm, dev = split_model(model)
        self._dm = dm
        self._dev = dev.state() if dev is not None else None
        self._R = n_rounds
        self._bases = dm.client_bases()
        self._jit_rng = np.random.RandomState(dm.seed + 1)
        self._burst_rng = np.random.RandomState(dm.seed + 3)
        self._avail_rng = np.random.RandomState(dm.seed + 2)
        self._delay_cache: Dict[int, np.ndarray] = {}
        self._next_delay_row = 0
        self._avail_cache: Dict[int, np.ndarray] = {}
        self._next_avail_row = 0
        self._avail_cur = np.ones(dm.n_clients, bool)

    def _gen_delay_row(self, r: int) -> np.ndarray:
        dm = self._dm
        jit = dm.burst_row(self._burst_rng, dm.jitter_row(self._jit_rng))
        # latency-lie attack applied identically to the dense builder's
        # rows (draw-free, so stream/dense parity is unaffected)
        row = dm.lie_row(self._bases * jit + dm.comm)
        if self._dev is not None:
            row = self._dev.scale_delays(r, row)
        return row

    def delays(self, r: int) -> np.ndarray:
        if r >= self._R:
            raise IndexError(r)
        while self._next_delay_row <= r:
            self._delay_cache[self._next_delay_row] = \
                self._gen_delay_row(self._next_delay_row)
            self._next_delay_row += 1
            for old in [k for k in self._delay_cache
                        if k < self._next_delay_row - 2]:
                del self._delay_cache[old]
        if r not in self._delay_cache:
            raise RuntimeError(
                f"streaming delay row {r} already evicted (rows must be "
                f"visited in order; cache holds {sorted(self._delay_cache)})")
        return self._delay_cache[r]

    def avail(self, r: int) -> np.ndarray:
        dm = self._dm
        if dm.dropout_prob <= 0:
            base = np.ones(dm.n_clients, bool)
        else:
            while self._next_avail_row <= r:
                self._avail_cur = dm.avail_step(self._avail_rng,
                                                self._avail_cur)
                self._avail_cache = {
                    self._next_avail_row: self._avail_cur.copy()}
                self._next_avail_row += 1
            base = self._avail_cache[r]
        if self._dev is not None:
            return self._dev.mask_avail(r, base)
        return base


# ===========================================================================
# policies
# ===========================================================================
@runtime_checkable
class QuorumPolicy(Protocol):
    """How many admissions close a round.  ``start`` returns the first
    round's S; ``update`` folds in the arrivals observed at a round's
    close (available clients whose results were in, admitted or not) and
    returns the next round's S."""

    def start(self, s_target: int, n_clients: int) -> int: ...

    def update(self, n_ready: int) -> int: ...


@dataclasses.dataclass
class FixedQuorum:
    """S = round(C * active_frac) every round (the PR-1 server)."""
    _s: int = dataclasses.field(default=1, init=False, repr=False)

    def start(self, s_target: int, n_clients: int) -> int:
        self._s = s_target
        return s_target

    def update(self, n_ready: int) -> int:
        return self._s


@dataclasses.dataclass
class AdaptiveQuorum:
    """Next-round S = EWMA (rate ``beta``) of observed arrival counts,
    clipped to [``s_min``, ``s_max``].  Pile-ups during a stretched round
    grow the quorum; a thinning fleet shrinks it."""
    beta: float = 0.25
    s_min: Optional[int] = None
    s_max: Optional[int] = None
    _lo: int = dataclasses.field(default=1, init=False, repr=False)
    _hi: int = dataclasses.field(default=1, init=False, repr=False)
    _rate: float = dataclasses.field(default=1.0, init=False, repr=False)

    def start(self, s_target: int, n_clients: int) -> int:
        self._lo = max(1, self.s_min if self.s_min is not None else 1)
        self._hi = min(n_clients,
                       self.s_max if self.s_max is not None else n_clients)
        if self._lo > self._hi:
            raise ValueError(f"s_min={self._lo} > s_max={self._hi}")
        s0 = int(np.clip(s_target, self._lo, self._hi))
        self._rate = float(s0)
        return s0

    def update(self, n_ready: int) -> int:
        self._rate = (1.0 - self.beta) * self._rate + self.beta * float(n_ready)
        return int(np.clip(int(round(self._rate)), self._lo, self._hi))


def _stable_topk(values: np.ndarray, k: int) -> np.ndarray:
    """Positions of the ``k`` smallest ``values`` in ascending stable
    order — bit-identical to ``np.argsort(values, kind="stable")[:k]``
    (ties broken by position) but O(n) instead of O(n log n), which is
    what keeps million-client selection cheap."""
    n = values.size
    if k <= 0:
        return np.zeros(0, np.int64)
    if k >= n:
        return np.argsort(values, kind="stable")
    thr = np.partition(values, k - 1)[k - 1]
    take = np.flatnonzero(values < thr)
    tied = np.flatnonzero(values == thr)
    take = np.concatenate([take, tied[:k - take.size]])
    return take[np.argsort(values[take], kind="stable")]


@runtime_checkable
class SelectionPolicy(Protocol):
    """Which candidates win the round: returns the admission order over
    ``cand`` (available client ids); the trigger takes the first S.
    ``k`` is the number of winners the trigger will consume — policies
    may return only that prefix (the ordering contract covers the first
    ``k`` entries)."""

    def start(self, n_clients: int, s_target: int) -> None: ...

    def order(self, cand: np.ndarray, next_done: np.ndarray,
              age: np.ndarray, k: Optional[int] = None) -> np.ndarray: ...


@dataclasses.dataclass
class FastestSelection:
    """Earliest completion times win (PR-1; fast clients win repeatedly
    and the slow tail starves)."""

    def start(self, n_clients: int, s_target: int) -> None:
        pass

    def order(self, cand: np.ndarray, next_done: np.ndarray,
              age: np.ndarray, k: Optional[int] = None) -> np.ndarray:
        nd = next_done[cand]
        if k is None:
            return cand[np.argsort(nd, kind="stable")]
        return cand[_stable_topk(nd, k)]


@dataclasses.dataclass
class AgeAwareSelection:
    """Clients whose age reached ``age_threshold`` are admitted first
    (oldest first, then by completion time), bounding max staleness at
    roughly ``age_threshold + ceil(C / S)`` at some wall-clock cost.
    ``None`` resolves to ``2 * ceil(C / S)`` at build time."""
    age_threshold: Optional[int] = None
    _thr: int = dataclasses.field(default=0, init=False, repr=False)

    def start(self, n_clients: int, s_target: int) -> None:
        self._thr = self.age_threshold if self.age_threshold is not None \
            else 2 * int(np.ceil(n_clients / s_target))

    def order(self, cand: np.ndarray, next_done: np.ndarray,
              age: np.ndarray, k: Optional[int] = None) -> np.ndarray:
        overdue = cand[age[cand] >= self._thr]
        fresh = cand[age[cand] < self._thr]
        # the overdue block is ordered by (-age, completion): a partial
        # selection cannot skip the lexsort, but in a healthy fleet the
        # overdue population stays bounded (that is the whole point of the
        # policy); the fresh tail only needs the slots overdue left open
        overdue = overdue[np.lexsort((next_done[overdue], -age[overdue]))]
        n_fresh = fresh.size if k is None \
            else max(0, min(k, len(cand)) - overdue.size)
        fresh = fresh[_stable_topk(next_done[fresh], n_fresh)] \
            if n_fresh < fresh.size else \
            fresh[np.argsort(next_done[fresh], kind="stable")]
        return np.concatenate([overdue, fresh])


# ===========================================================================
# aggregation triggers (server modes)
# ===========================================================================
class _BuildState:
    """Mutable per-build scratch shared between the loop and the trigger."""

    def __init__(self, n_clients: int, n_rounds: int, rows):
        self.n_clients = n_clients
        self.n_rounds = n_rounds
        self.rows = rows
        self.t = 0.0
        self.next_done = np.asarray(rows.delays(0), np.float64).copy()
        self.last_part = np.zeros(n_clients, np.int64)
        self.avail_row = np.ones(n_clients, bool)


@runtime_checkable
class AggregationTrigger(Protocol):
    """A server mode: decides when a round closes and which updates it
    consumes.  ``run_round`` returns the admitted updates (ids, admission
    order, duplicates allowed) and the round-close wall-clock;
    ``finish_round`` runs after bookkeeping (quorum adaptation, restart of
    the winners' local clocks)."""

    def start(self, n_clients: int, n_rounds: int) -> None: ...

    def run_round(self, r: int, b: _BuildState
                  ) -> Tuple[np.ndarray, float]: ...

    def finish_round(self, r: int, t: float, winners: np.ndarray,
                     b: _BuildState) -> None: ...


@dataclasses.dataclass
class SyncTrigger:
    """BSFDP: every available client participates; the round closes when
    the slowest of them finishes (the straggler effect)."""

    def start(self, n_clients: int, n_rounds: int) -> None:
        pass

    def run_round(self, r: int, b: _BuildState) -> Tuple[np.ndarray, float]:
        winners = np.flatnonzero(b.avail_row)
        t = b.t + b.rows.delays(r)[winners].max()
        return winners, t

    def finish_round(self, r: int, t: float, winners: np.ndarray,
                     b: _BuildState) -> None:
        pass


@dataclasses.dataclass
class QuorumTrigger:
    """Quorum-of-S: the server closes a round once S selected clients have
    arrived; slower clients keep computing and deliver stale updates
    later.  S comes from ``quorum`` and the winners from ``selection``.
    ``s_target`` overrides ``round(C * active_frac)`` when set."""
    active_frac: float = 0.6
    s_target: Optional[int] = None
    quorum: QuorumPolicy = dataclasses.field(default_factory=FixedQuorum)
    selection: SelectionPolicy = dataclasses.field(
        default_factory=FastestSelection)
    _s_cur: int = dataclasses.field(default=1, init=False, repr=False)

    def start(self, n_clients: int, n_rounds: int) -> None:
        if self.s_target is not None and self.s_target < 1:
            raise ValueError(f"s_target must be >= 1, got {self.s_target}")
        s = self.s_target if self.s_target is not None \
            else max(1, int(round(n_clients * self.active_frac)))
        self.selection.start(n_clients, s)
        self._s_cur = self.quorum.start(s, n_clients)

    def run_round(self, r: int, b: _BuildState) -> Tuple[np.ndarray, float]:
        cand = np.flatnonzero(b.avail_row)
        k = min(self._s_cur, cand.size)
        order = self.selection.order(cand, b.next_done, r - b.last_part,
                                     k=k)
        winners = order[:k]
        return winners, max(b.t, b.next_done[winners].max())

    def finish_round(self, r: int, t: float, winners: np.ndarray,
                     b: _BuildState) -> None:
        ready = b.avail_row & (b.next_done <= t)
        self._s_cur = self.quorum.update(int(ready.sum()))
        nxt = b.rows.delays(min(r + 1, b.n_rounds - 1))
        b.next_done[winners] = t + nxt[winners]


@dataclasses.dataclass
class FedBuffTrigger:
    """FedBuff-style buffered asynchrony (arXiv:2106.06639): arrivals are
    buffered in completion order and the server aggregates exactly when
    ``buffer_k`` updates have accumulated, then drains the buffer.  Each
    arriving client restarts its next local round immediately, so a fast
    client can deliver several updates into one buffer (duplicate winner
    ids; dense conversion collapses them; each delivery's admission age is
    stamped at its *arrival* event — the repeat delivery carries age 0, see
    :func:`_arrival_ages`).  There is no selection step —
    every arrival is consumed — which makes the buffer size, not a quorum,
    the aggregation trigger.

    Restarts draw from the latency row of the round the delivery landed in
    (row ``r``, not ``r + 1``): the restart must never index past the
    current round, so a FedBuff build is a *prefix* of any longer build —
    ``FederatedRun(start=...)`` can resume against a re-built, longer
    schedule without diverging from the uninterrupted run (modulo the
    dense-mode burst caveat in the module docstring)."""
    buffer_k: int = 4

    def start(self, n_clients: int, n_rounds: int) -> None:
        if self.buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {self.buffer_k}")

    def run_round(self, r: int, b: _BuildState) -> Tuple[np.ndarray, float]:
        nxt = b.rows.delays(r)
        # one O(C) scan seeds a K-entry heap with the K earliest pending
        # completions — any client outside that seed has K events ahead of
        # it and can never reach this round's buffer.  Restarts are pushed
        # back, so a fast client re-arriving mid-buffer is still seen.
        # (value, client-id) tuples reproduce argmin's lowest-id tie-break.
        nd = np.where(b.avail_row, b.next_done, np.inf)
        heap = [(float(nd[i]), int(i))
                for i in _stable_topk(nd, min(self.buffer_k, nd.size))]
        heapq.heapify(heap)
        buf = np.empty(self.buffer_k, np.int64)
        t = b.t
        for j in range(self.buffer_k):
            t_arr, i = heapq.heappop(heap)
            t = max(t, t_arr)
            buf[j] = i
            # the client restarts immediately on delivery — not at the
            # round close like QuorumTrigger winners
            b.next_done[i] = t_arr + nxt[i]
            heapq.heappush(heap, (float(b.next_done[i]), i))
        return buf, t

    def finish_round(self, r: int, t: float, winners: np.ndarray,
                     b: _BuildState) -> None:
        pass


# ===========================================================================
# builder
# ===========================================================================
def build_schedule(n_rounds: int, delays: "DelayModel | DeviceModel",
                   trigger: Optional[AggregationTrigger] = None, *,
                   stream: bool = False) -> Schedule:
    """Run the event-driven server loop for ``n_rounds`` rounds under
    ``trigger`` (default: fixed-quorum / fastest-selection, the PR-1
    server) and return the sparse :class:`Schedule`.

    ``delays`` is a :class:`DelayModel` or a
    :class:`~repro_torch.core.devices.DeviceModel` wrapping one — the device
    layer (diurnal windows, battery/network latency state, regional
    outages, flash crowds) composes row-by-row over the base model in
    both row providers.

    ``stream=True`` draws latency/availability rows one round at a time
    (O(C) live memory — required for million-client fleets, where the
    dense ``(rounds, C)`` matrices of the default path do not fit)."""
    C = delays.n_clients
    trigger = trigger if trigger is not None else QuorumTrigger()
    if n_rounds == 0:
        z = np.zeros(0, np.int64)
        return Schedule(n_clients=C, times=np.zeros(0), winner_ids=z,
                        winner_ages=z, offsets=np.zeros(1, np.int64),
                        unavailable_ids=z,
                        unavailable_offsets=np.zeros(1, np.int64))
    rows = _StreamRows(delays, n_rounds) if stream \
        else _DenseRows(delays, n_rounds)
    trigger.start(C, n_rounds)
    b = _BuildState(C, n_rounds, rows)
    times = np.zeros(n_rounds)
    ids: List[np.ndarray] = []
    ages: List[np.ndarray] = []
    offsets = np.zeros(n_rounds + 1, np.int64)
    un_ids: List[np.ndarray] = []
    un_offsets = np.zeros(n_rounds + 1, np.int64)
    was_avail = np.ones(C, bool)
    for r in range(n_rounds):
        b.avail_row = np.asarray(rows.avail(r), bool)
        # a rejoining client starts a fresh local round now — its
        # pre-dropout completion time is void
        rejoined = b.avail_row & ~was_avail
        if rejoined.any():
            b.next_done[rejoined] = b.t + rows.delays(r)[rejoined]
        was_avail = b.avail_row
        winners, t = trigger.run_round(r, b)
        b.t = t
        times[r] = t
        ids.append(winners)
        ages.append(_arrival_ages(r, b.last_part, winners))
        b.last_part[winners] = r
        offsets[r + 1] = offsets[r] + winners.size
        u = np.flatnonzero(~b.avail_row)
        un_ids.append(u)
        un_offsets[r + 1] = un_offsets[r] + u.size
        trigger.finish_round(r, t, winners, b)
    return Schedule(n_clients=C, times=times, winner_ids=_cat(ids),
                    winner_ages=_cat(ages), offsets=offsets,
                    unavailable_ids=_cat(un_ids),
                    unavailable_offsets=un_offsets)


# ===========================================================================
# train-loop driver
# ===========================================================================
def round_generator(seed: int, t: int, device) -> torch.Generator:
    """The round-``t`` generator of a run seeded ``seed`` (the counterpart
    of the reference's ``jax.random.fold_in(key, t)``): a seed mixed from
    ``(seed, t)`` by numpy's ``SeedSequence``."""
    mixed = int(np.random.SeedSequence([seed, t]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


@dataclasses.dataclass
class FederatedRun:
    """One federated train loop: walks a :class:`Schedule` and feeds each
    round into ``step(state, batch, gen, **kw)``, with ``gen`` the round's
    ``torch.Generator``.

    * ``schedule=None`` leaves activation to the round function's internal
      sampler (``FedConfig.internal_select``).
    * ``feed_staleness=False`` withholds ``stale=``.
    * ``feed_arrivals=True`` also feeds each round's admitted-update count
      (``Schedule.arrivals[t]``, duplicate FedBuff deliveries included) as
      ``arrivals=``, the input of ``FedConfig.fedbuff_lr_norm``.
    * ``round_impl``: ``"dense"`` feeds ``act=``/``stale=`` (C,) rows from
      ``Schedule.rows()``; ``"sparse"`` feeds the padded rows of
      ``Schedule.padded_rows()`` as ``idx=``/``stale=``/``weight=``
      (S_max,) numpy arrays — the contract of
      ``bafdp.bafdp_round_sparse`` (per-delivery admission ages as
      ``stale``).  ``"sparse"`` needs a ``schedule=``.
    * ``s_max``: the sparse rows' pad width (default ``schedule.s_max``).
    * ``round_kwargs``: a ``t -> dict`` hook that replaces the
      schedule-derived kwargs (the explicit ``act=``/``stale=`` rows).
    * ``start``: checkpoint-resume — rounds before it are replayed through
      the schedule and skipped.
    * ``key_fn``: ``t -> torch.Generator``; default
      :func:`round_generator` on ``device`` from the ``seed`` given to
      :meth:`run`.
    * ``n_clients``, when set, must equal the schedule's fleet size.
    * ``ledger``: a :class:`repro_torch.core.privacy.EpsLedger` charged
      once per DELIVERY (each sparse row entry with ``weight > 0``, each
      active client of a dense row) with the client's ``state.eps`` before
      the round runs, so a FedBuff duplicate spends budget twice; the
      history gains running worst-client ``dp_eps_basic`` /
      ``dp_eps_adv`` curves (advanced composition at ``ledger_delta``).
      Needs a ``schedule=``; a resume (``start > 0``) past a delivering
      prefix needs the ledger restored from ``EpsLedger.state_dict()``.
    * ``device``: where the default generators live (``None`` = the GPU).
    * ``ranks``: a ``distributed.data_parallel.RankBlock`` of more than
      one rank, fed to every round as ``ranks=`` (the state and the
      batches are this rank's; the schedule's rows stay the fleet's).
      Every rank walks the same schedule and draws the same generators.
      A ledger needs every client's eps and is refused there.
    """
    step: Callable[..., Tuple[Any, Dict[str, Any]]]
    rounds: int
    schedule: Optional[Schedule] = None
    feed_staleness: bool = True
    feed_arrivals: bool = False
    start: int = 0
    key_fn: Optional[Callable[[int], torch.Generator]] = None
    round_kwargs: Optional[Callable[[int], Dict[str, Any]]] = None
    n_clients: Optional[int] = None
    round_impl: str = "dense"
    s_max: Optional[int] = None
    ledger: Optional[Any] = None          # privacy.EpsLedger
    ledger_delta: float = 1e-5
    device: Optional[Any] = None
    ranks: Optional[Any] = None

    def _check(self, seed) -> None:
        """The reference's argument checks, in its order."""
        if self.round_impl not in ("dense", "sparse"):
            raise ValueError(
                f"unknown round_impl: {self.round_impl!r} "
                "(expected 'dense' or 'sparse')")
        if self.round_impl == "sparse" and self.schedule is None:
            raise ValueError(
                "round_impl='sparse' needs a schedule= (the padded "
                "idx/stale/weight rows come from Schedule.padded_rows)")
        if self.schedule is not None and self.round_kwargs is not None:
            raise ValueError("pass either schedule or round_kwargs, not both")
        if self.feed_arrivals and self.schedule is None:
            raise ValueError(
                "feed_arrivals=True needs a sparse schedule= (per-round "
                "arrivals counts are not recoverable from dense masks, "
                "which collapse duplicate FedBuff deliveries)")
        if self.schedule is not None \
                and self.schedule.n_rounds < self.rounds:
            raise ValueError(
                f"Schedule covers {self.schedule.n_rounds} rounds < "
                f"{self.rounds} trained; build_schedule() the full horizon "
                "instead of recycling a schedule")
        if self.schedule is not None and self.n_clients is not None \
                and self.schedule.n_clients != self.n_clients:
            raise ValueError(
                f"Schedule is for {self.schedule.n_clients} clients, the "
                f"run expects {self.n_clients}")
        if self.ledger is not None and is_split(self.ranks):
            raise NotImplementedError(
                "ledger= over several ranks (each holds its clients' eps "
                "only) is not ported (ROADMAP Queue A 7(b))")
        if self.key_fn is None and seed is None:
            raise ValueError("need a base seed (or a key_fn)")
        if self.ledger is not None and self.schedule is None:
            raise ValueError(
                "ledger= needs a schedule= (per-delivery privacy spends "
                "come from the schedule's participation rows; an internal "
                "sampler's picks are invisible to the driver)")
        if self.ledger is not None and self.start > 0 \
                and int(self.schedule.arrivals[:self.start].sum()) > 0 \
                and int(np.asarray(self.ledger.deliveries).sum()) == 0:
            raise ValueError(
                f"start={self.start} resume with an unprimed ledger: the "
                "replayed rounds delivered messages whose spends a fresh "
                "ledger cannot see, so the dp_eps_* curves would "
                "undercount the true privacy cost.  Checkpoint "
                "EpsLedger.state_dict() alongside the model state and "
                "load_state_dict() it before resuming")

    def _charge(self, state, row, sparse: bool) -> None:
        """Record this round's deliveries in the ledger, each at its
        client's current eps (read for those clients only)."""
        eps_now = getattr(state, "eps", None)
        if eps_now is None:
            raise ValueError(
                "ledger= needs a state with a per-client eps vector "
                "(FedState); baseline trainer states have no privacy "
                "decision variable to account")
        if sparse:
            r_idx, _, r_w = row
            ids = host_array(r_idx)[host_array(r_w) > 0]
        else:
            ids = np.flatnonzero(host_array(row[0]))
        if isinstance(eps_now, torch.Tensor):
            eps_ids = host_array(eps_now[torch.as_tensor(
                ids, dtype=torch.long, device=eps_now.device)])
        else:
            eps_ids = np.asarray(eps_now)[ids]
        self.ledger.record(ids, eps_ids)

    def run(self, state, batch_fn: Callable[[int], Any],
            seed: Optional[int] = None, *, collect: Tuple[str, ...] = (),
            derive: Optional[Dict[str, Callable[[Any, Dict], Any]]] = None,
            skip_missing: bool = False,
            on_round: Optional[Callable[[int, Any, Dict], None]] = None):
        """Returns ``(final_state, history)``, ``history[k]`` one entry per
        trained round for every ``k`` in ``collect`` (``derive[k](state,
        m)`` when given, else ``float(m[k])``; NaN for a missing key under
        ``skip_missing``)."""
        self._check(seed)
        key_fn = self.key_fn
        if key_fn is None:
            dev = resolve_device(self.device)

            def key_fn(t):
                return round_generator(seed, t, dev)

        derive = derive or {}
        hist: Dict[str, List[Any]] = {k: [] for k in collect}
        if self.ledger is not None:
            hist["dp_eps_basic"] = []
            hist["dp_eps_adv"] = []
        sparse = self.round_impl == "sparse"
        if self.schedule is None:
            rows = None
        elif sparse:
            rows = self.schedule.padded_rows(self.s_max)
        else:
            rows = self.schedule.rows()
        arrivals = self.schedule.arrivals \
            if self.schedule is not None and self.feed_arrivals else None
        for t in range(self.rounds):
            if rows is not None:
                row = next(rows)
            if t < self.start:
                continue                  # replay keeps staleness honest
            kwargs: Dict[str, Any] = {}
            if self.round_kwargs is not None:
                kwargs.update(self.round_kwargs(t))
            elif rows is not None:
                if sparse:
                    kwargs["idx"], kwargs["stale"], kwargs["weight"] = row
                else:
                    kwargs["act"], kwargs["stale"] = row
                if not self.feed_staleness:
                    del kwargs["stale"]
                if arrivals is not None:
                    kwargs["arrivals"] = np.int32(arrivals[t])
            if is_split(self.ranks):
                kwargs["ranks"] = self.ranks
            if self.ledger is not None:
                self._charge(state, row, sparse)
            state, m = self.step(state, batch_fn(t), key_fn(t), **kwargs)
            if self.ledger is not None:
                tot = self.ledger.totals(self.ledger_delta)
                hist["dp_eps_basic"].append(tot["dp_eps_basic"])
                hist["dp_eps_adv"].append(tot["dp_eps_adv"])
            if on_round is not None:
                on_round(t, state, m)
            for k in collect:
                if k in derive:
                    hist[k].append(derive[k](state, m))
                elif k in m:
                    hist[k].append(float(m[k]))
                elif skip_missing:
                    hist[k].append(float("nan"))
                else:
                    raise KeyError(
                        f"collect key {k!r} not in metrics {sorted(m)}")
        return state, hist
