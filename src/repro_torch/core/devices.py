"""Trace-driven device realism: per-client device state machines under
:func:`repro_torch.core.schedule.build_schedule`.

The three :class:`~repro_torch.core.async_engine.DelayModel` scenario knobs
(Pareto tails, bursty stragglers, dropout flap) are hand-tuned synthetics.
Real federated traffic-forecasting fleets (the mobile-network case study,
arXiv 2412.04081; FLGo's system simulator) are dominated by *device
state*: handsets sleep at night, throttle on low battery, crawl on
cellular links, vanish by the whole region when a base station goes down,
and stampede in together during flash-crowd events.  :class:`DeviceModel`
layers exactly those processes on top of an existing ``DelayModel``:

* **diurnal availability** — client ``i`` participates only inside its
  time-of-day window: awake iff ``(r + phase_i) mod day_rounds`` falls in
  the first ``round(duty_frac * day_rounds)`` slots, with per-client
  phases drawn once at init (``day_rounds = 0`` disables);
* **battery state machine** — a per-client two-state Markov chain
  (charged <-> low-power, rates ``battery_drain``/``battery_charge``);
  a low-power device multiplies its compute latency by ``battery_slow``;
* **network mode machine** — wifi <-> cellular per client
  (``net_drop``/``net_recover``); cellular multiplies latency by
  ``net_slow``;
* **correlated regional dropout** — clients are grouped into
  ``n_regions`` contiguous regions; each region is its own up/down Markov
  chain (``outage_prob``/``outage_recover``) and a down region takes its
  whole population offline at once (the failure mode per-client
  ``dropout_prob`` cannot express);
* **flash-crowd surges** — a global surge process (``surge_prob`` per
  round, lasting ``surge_rounds``): during a surge every client's latency
  divides by ``surge_speedup`` and diurnally-asleep clients wake up
  (users reach for the phone during the event), piling arrivals up — a
  regional outage still wins (a dead base station does not care about the
  news).

**Composition contract.**  The wrapped ``base`` DelayModel draws its
latency/availability rows exactly as before (its RNG streams are
untouched — every pinned schedule digest holds under a plain
``DelayModel``), then the device layer multiplies the delay row by its
per-client latency multiplier and ANDs the availability row with its
device mask.  All device machines are strictly row-sequential with their
own RNG streams (seed offsets off ``seed``), so the dense and streaming
row providers in :mod:`repro_torch.core.schedule` produce bit-identical
schedules whenever the base model itself is stream/dense-exact
(``burst_prob == 0``), and a shorter build is a prefix of a longer one.
Live state is O(C) + O(n_regions): a C=1_000_000 streaming build
allocates nothing of shape ``(rounds, C)``.

If device masks and base availability leave the whole fleet dark for a
round, client ``r mod C`` is forced awake (deterministically, so parity
and prefix stability are unaffected) — the event loop needs at least one
candidate, the same invariant ``DelayModel.avail_step`` keeps.

:data:`SCENARIO_PACK` names four ready-made fleet portfolios
(``diurnal``, ``regional_outage``, ``flash_crowd``, ``battery_tail``) —
:func:`device_scenario` builds one at any fleet size, and
``benchmarks/fig456_async_efficiency.py`` trains each on its own
schedule.

This module is a copy of the JAX package's ``core/devices.py`` (host
numpy, no JAX), kept here so the port imports nothing of ``repro``:
every ``RandomState`` stream, and so every schedule, matches the
reference's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.async_engine import DelayModel

# RNG stream offsets off DeviceModel.seed — one stream per machine, so a
# disabled machine draws nothing and enabling one never shifts another's
# stream (the same discipline DelayModel uses for jitter/avail/burst).
_PHASE_STREAM = 0
_BATTERY_STREAM = 1
_NETWORK_STREAM = 2
_REGION_STREAM = 3
_SURGE_STREAM = 4


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Device-state layer over a :class:`DelayModel` (see module doc).

    All machines default OFF: ``DeviceModel(base=dm)`` reproduces the
    plain ``dm`` schedule bit-for-bit.  ``seed`` defaults to
    ``base.seed + 100`` so a device fleet and its base share one seed
    knob without sharing streams.
    """
    base: DelayModel
    seed: Optional[int] = None
    # diurnal availability -------------------------------------------------
    day_rounds: int = 0              # rounds per simulated day; 0 = off
    duty_frac: float = 0.5           # fraction of the day a client is awake
    # battery state machine ------------------------------------------------
    battery_drain: float = 0.0       # P(charged -> low) per round; 0 = off
    battery_charge: float = 0.3      # P(low -> charged) per round
    battery_slow: float = 4.0        # latency multiplier while low-power
    # network mode machine -------------------------------------------------
    net_drop: float = 0.0            # P(wifi -> cellular) per round; 0 = off
    net_recover: float = 0.3         # P(cellular -> wifi) per round
    net_slow: float = 2.5            # latency multiplier on cellular
    # correlated regional dropout -----------------------------------------
    n_regions: int = 1
    outage_prob: float = 0.0         # P(region up -> down) per round; 0 = off
    outage_recover: float = 0.25     # P(region down -> up) per round
    # flash-crowd surges ---------------------------------------------------
    surge_prob: float = 0.0          # P(surge starts) per quiet round; 0 = off
    surge_rounds: int = 3            # surge duration once started
    surge_speedup: float = 4.0       # latency DIVIDED by this during a surge

    def __post_init__(self):
        if self.day_rounds < 0:
            raise ValueError(f"day_rounds must be >= 0, got {self.day_rounds}")
        if self.day_rounds > 0 and not 0.0 < self.duty_frac <= 1.0:
            raise ValueError(
                f"duty_frac must be in (0, 1], got {self.duty_frac}")
        if self.n_regions < 1:
            raise ValueError(f"n_regions must be >= 1, got {self.n_regions}")
        if self.surge_prob > 0 and self.surge_rounds < 1:
            raise ValueError(
                f"surge_rounds must be >= 1, got {self.surge_rounds}")
        if self.surge_prob > 0 and self.surge_speedup <= 0:
            raise ValueError(
                f"surge_speedup must be > 0, got {self.surge_speedup}")

    # -- pure derived quantities (deterministic in the config) -------------
    @property
    def n_clients(self) -> int:
        return self.base.n_clients

    @property
    def device_seed(self) -> int:
        return self.base.seed + 100 if self.seed is None else self.seed

    @property
    def awake_len(self) -> int:
        """Awake slots per day (>= 1 whenever diurnal is on)."""
        return max(1, int(round(self.duty_frac * self.day_rounds)))

    def phases(self) -> np.ndarray:
        """(C,) per-client diurnal phases, drawn once from the phase
        stream (independent of the horizon, so prefix stability holds)."""
        rng = np.random.RandomState(self.device_seed + _PHASE_STREAM)
        return rng.randint(self.day_rounds, size=self.n_clients) \
            if self.day_rounds > 0 else np.zeros(self.n_clients, np.int64)

    def region_of(self) -> np.ndarray:
        """(C,) region id per client — contiguous blocks, so `region r
        down` maps to one id-range of the fleet."""
        return (np.arange(self.n_clients) * self.n_regions) \
            // self.n_clients

    def awake_mask(self, r: int, phases: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        """(C,) diurnal window mask at round ``r`` (all-True when off)."""
        if self.day_rounds <= 0:
            return np.ones(self.n_clients, bool)
        ph = self.phases() if phases is None else phases
        return (r + ph) % self.day_rounds < self.awake_len

    def state(self) -> "DeviceState":
        """A fresh per-build runtime (row providers call this; one
        ``DeviceState`` per schedule build, never shared)."""
        return DeviceState(self)


class DeviceState:
    """Row-sequential runtime of a :class:`DeviceModel` build.

    ``scale_delays(r, row)`` / ``mask_avail(r, row)`` transform one base
    row each; both pull from :meth:`_row`, which advances every enabled
    Markov machine exactly once per round in round order regardless of
    which transform asks first.  Only the last two rounds' derived rows
    stay cached (the event loop requests delay row ``r + 1`` while
    availability is still at ``r``) — live memory is O(C).
    """

    def __init__(self, dev: DeviceModel):
        self._dev = dev
        C = dev.n_clients
        s = dev.device_seed
        self._phases = dev.phases()
        self._region_of = dev.region_of()
        self._battery_rng = np.random.RandomState(s + _BATTERY_STREAM)
        self._network_rng = np.random.RandomState(s + _NETWORK_STREAM)
        self._region_rng = np.random.RandomState(s + _REGION_STREAM)
        self._surge_rng = np.random.RandomState(s + _SURGE_STREAM)
        self._low = np.zeros(C, bool)          # battery: start charged
        self._cell = np.zeros(C, bool)         # network: start on wifi
        self._region_down = np.zeros(dev.n_regions, bool)
        self._surge_left = 0
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._next = 0

    def _step(self, r: int) -> Tuple[np.ndarray, np.ndarray]:
        """Advance every machine one round; return ``(mult, avail)`` —
        the (C,) latency multiplier and device availability mask."""
        dev = self._dev
        C = dev.n_clients
        mult = np.ones(C)
        if dev.battery_drain > 0:
            u = self._battery_rng.rand(C)
            self._low = np.where(self._low, u >= dev.battery_charge,
                                 u < dev.battery_drain)
            mult = np.where(self._low, mult * dev.battery_slow, mult)
        if dev.net_drop > 0:
            u = self._network_rng.rand(C)
            self._cell = np.where(self._cell, u >= dev.net_recover,
                                  u < dev.net_drop)
            mult = np.where(self._cell, mult * dev.net_slow, mult)
        surging = False
        if dev.surge_prob > 0:
            # one scalar draw per round whether or not a surge is running:
            # the stream stays row-aligned, so a surge ending early or
            # late never reshuffles later draws
            u = float(self._surge_rng.rand())
            if self._surge_left == 0 and u < dev.surge_prob:
                self._surge_left = dev.surge_rounds
            if self._surge_left > 0:
                surging = True
                self._surge_left -= 1
                mult = mult / dev.surge_speedup
        avail = dev.awake_mask(r, self._phases)
        if surging:
            # the crowd wakes diurnally-asleep clients; outages still win
            avail = np.ones(C, bool)
        if dev.outage_prob > 0:
            u = self._region_rng.rand(dev.n_regions)
            self._region_down = np.where(
                self._region_down, u >= dev.outage_recover,
                u < dev.outage_prob)
            avail = avail & ~self._region_down[self._region_of]
        return mult, avail

    def _row(self, r: int) -> Tuple[np.ndarray, np.ndarray]:
        while self._next <= r:
            self._cache[self._next] = self._step(self._next)
            self._next += 1
            for old in [k for k in self._cache if k < self._next - 2]:
                del self._cache[old]
        if r not in self._cache:
            raise RuntimeError(
                f"device row {r} already evicted (rows must be visited in "
                f"nondecreasing order; cache holds {sorted(self._cache)})")
        return self._cache[r]

    def scale_delays(self, r: int, delays: np.ndarray) -> np.ndarray:
        """Apply round ``r``'s per-client latency multiplier."""
        return delays * self._row(r)[0]

    def mask_avail(self, r: int, avail: np.ndarray) -> np.ndarray:
        """AND round ``r``'s device mask into a base availability row,
        keeping >= 1 client available (deterministic fallback: client
        ``r mod C`` — the event loop needs a candidate)."""
        out = avail & self._row(r)[1]
        if not out.any():
            out = out.copy()
            out[r % out.size] = True
        return out


def split_model(model) -> Tuple[DelayModel, Optional[DeviceModel]]:
    """``(base DelayModel, DeviceModel or None)`` from either type —
    the dispatch the row providers in :mod:`repro_torch.core.schedule` use."""
    if isinstance(model, DeviceModel):
        return model.base, model
    return model, None


# ===========================================================================
# named scenario pack
# ===========================================================================
def _base(n_clients: int, seed: int, **kw) -> DelayModel:
    return DelayModel(**{"n_clients": n_clients, "hetero": 1.0,
                         "seed": seed, **kw})


def _diurnal(n_clients: int, seed: int) -> DeviceModel:
    """Day/night fleet: 40% duty cycle, phases spread across the day —
    any round sees only the awake slice, and the age distribution follows
    the clock instead of the latency tail."""
    return DeviceModel(base=_base(n_clients, seed),
                       day_rounds=24, duty_frac=0.4)


def _regional_outage(n_clients: int, seed: int) -> DeviceModel:
    """Four regions with correlated base-station outages: a down region
    drops its whole population at once, so availability moves in blocks
    of C/4 — the failure per-client dropout flap cannot express."""
    return DeviceModel(base=_base(n_clients, seed),
                       n_regions=4, outage_prob=0.08, outage_recover=0.3)


def _flash_crowd(n_clients: int, seed: int) -> DeviceModel:
    """Diurnal fleet hit by flash-crowd events: surges wake the sleeping
    clients and divide everyone's latency by 5 for three rounds, piling
    arrivals into the server's buffers."""
    return DeviceModel(base=_base(n_clients, seed),
                       day_rounds=24, duty_frac=0.5,
                       surge_prob=0.15, surge_rounds=3, surge_speedup=5.0)


def _battery_tail(n_clients: int, seed: int) -> DeviceModel:
    """Device-conditioned latency tail: low-power mode (6x) and cellular
    links (2.5x) compose into a heavy straggler tail that is *stateful* —
    a throttled client stays slow for a stretch, unlike iid jitter."""
    return DeviceModel(base=_base(n_clients, seed),
                       battery_drain=0.15, battery_charge=0.3,
                       battery_slow=6.0,
                       net_drop=0.2, net_recover=0.4, net_slow=2.5)


SCENARIO_PACK: Dict[str, Callable[[int, int], DeviceModel]] = {
    "diurnal": _diurnal,
    "regional_outage": _regional_outage,
    "flash_crowd": _flash_crowd,
    "battery_tail": _battery_tail,
}


def device_scenario(name: str, n_clients: int, seed: int = 0) -> DeviceModel:
    """Build a named scenario-pack :class:`DeviceModel` at any fleet size."""
    if name not in SCENARIO_PACK:
        raise ValueError(
            f"unknown device scenario {name!r} "
            f"(have {sorted(SCENARIO_PACK)})")
    return SCENARIO_PACK[name](n_clients, seed)
