"""A copy of the JAX package's ``data/synthetic_traffic.py`` (numpy only).

Synthetic cellular-traffic generators standing in for the paper's
datasets (repro gate: the real Milano / Trento Harvard-Dataverse dumps and
the private LTE trace are not available offline — DESIGN.md Section 6).

Each generator is calibrated to the published characteristics:

* **Milano** (Telecom Italia big-data challenge): hourly internet CDRs,
  61 days (2013-11-01..2014-01-01), strong diurnal + weekly structure,
  holiday dips, event bursts; magnitudes O(10^2).  Textual side data:
  social-pulse tweet counts and daily-news counts correlated with bursts.
* **Trento**: same schema, smaller magnitudes, different spatial mix.
* **LTE traffic**: 16 days of downlink volume (GB), hourly, values O(0.5).

Per-client non-IID-ness comes from heterogeneous base load, diurnal phase,
weekend ratio and event sensitivity — matching the paper's observation
that FedAvg suffers on these (Section VI-A).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    name: str
    n_hours: int
    scale: float              # magnitude of the mean load
    burstiness: float         # event-burst amplitude (x base)
    noise: float              # relative observation noise
    weekend_dip: float
    start_dow: int = 4        # 2013-11-01 was a Friday
    holidays: Tuple[int, ...] = ()   # day indices with holiday behaviour


MILANO = TrafficSpec("milano", 61 * 24, 250.0, 1.5, 0.10, 0.35,
                     holidays=(30, 54, 55, 60))   # Dec 1, Christmas, NYE
TRENTO = TrafficSpec("trento", 61 * 24, 120.0, 1.2, 0.12, 0.40,
                     holidays=(30, 54, 55, 60))
LTE = TrafficSpec("lte", 16 * 24, 0.55, 0.6, 0.08, 0.20, start_dow=0,
                  holidays=(4, 5))                # Jan 1

DATASETS: Dict[str, TrafficSpec] = {s.name: s for s in (MILANO, TRENTO, LTE)}


def make_dataset(name: str, n_clients: int, seed: int = 0
                 ) -> Dict[str, np.ndarray]:
    """Returns {"traffic": (C, T), "text": (C, T, 4), "meta": (T, 9)}.

    text covariates: tweet count, active users, news count, geo activity.
    meta: one-hot day-of-week (7) + holiday flag + hour-of-day (normalized).
    """
    spec = DATASETS[name]
    # stable per-dataset offset (Python's str hash is salted per process —
    # using it made every run see different data)
    import zlib
    rng = np.random.RandomState(seed + zlib.crc32(name.encode()) % 10_000)
    T, C = spec.n_hours, n_clients
    t = np.arange(T)
    hour = t % 24
    day = t // 24
    dow = (day + spec.start_dow) % 7
    is_weekend = (dow >= 5).astype(float)
    is_holiday = np.isin(day, np.asarray(spec.holidays)).astype(float)

    # client heterogeneity (non-IID)
    base = spec.scale * np.exp(0.6 * rng.randn(C))              # load level
    phase = rng.uniform(-2, 2, C)                               # diurnal phase
    wk_ratio = 1 - spec.weekend_dip * rng.uniform(0.6, 1.4, C)  # weekend mix
    evt_sens = rng.uniform(0.3, 1.7, C)                         # event coupling

    # diurnal: morning ramp, evening peak (two-harmonic fit to CDR data)
    def diurnal(h, ph):
        x = 2 * np.pi * (h - ph) / 24.0
        return 0.55 + 0.35 * np.sin(x - 2.2) + 0.18 * np.sin(2 * x + 0.5)

    # city-wide events (concerts/matches/news days): shared burst process
    n_events = max(3, T // 200)
    evt_times = rng.choice(T, n_events, replace=False)
    events = np.zeros(T)
    for et in evt_times:
        amp = rng.uniform(0.5, 1.0)
        width = rng.uniform(2, 6)
        events += amp * np.exp(-0.5 * ((t - et) / width) ** 2)

    traffic = np.zeros((C, T))
    for c in range(C):
        d = diurnal(hour, phase[c])
        wk = np.where(is_weekend > 0, wk_ratio[c], 1.0)
        hol = np.where(np.isin(day, np.asarray(spec.holidays)), 0.75, 1.0)
        lam = base[c] * d * wk * hol \
            * (1 + spec.burstiness * evt_sens[c] * events)
        traffic[c] = lam * (1 + spec.noise * rng.randn(T))
    traffic = np.maximum(traffic, 0.0)

    # text covariates follow the same social rhythm + bursts
    tweets = (20 + 80 * diurnal(hour, 0)) * (1 + 2.0 * events)
    users = 0.7 * tweets * (1 + 0.1 * rng.randn(T))
    news = np.repeat(5 + 10 * events.reshape(-1, 24).mean(1), 24)[:T]
    geo = (10 + 30 * diurnal(hour, 1.0)) * (1 + events)
    text_city = np.stack([tweets, users, news, geo], axis=-1)   # (T, 4)
    text = np.stack([text_city * (1 + 0.15 * rng.randn(T, 4)) for _ in range(C)])

    meta = np.zeros((T, 9))
    meta[np.arange(T), dow] = 1.0
    meta[:, 7] = np.isin(day, np.asarray(spec.holidays)).astype(float)
    meta[:, 8] = hour / 23.0
    return {"traffic": traffic.astype(np.float32),
            "text": text.astype(np.float32),
            "meta": meta.astype(np.float32)}
