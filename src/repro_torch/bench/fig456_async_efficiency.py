"""Figs. 4-6: synchronous (BSFDP) against asynchronous (BAFDP) training --
loss against simulated wall-clock with heterogeneous client latencies
(the port of ``benchmarks/fig456_async_efficiency.py``).

``core/schedule.build_schedule`` produces one event-driven ``Schedule``
per server mode (wall-clock timestamps and per-round winner lists), and
the same schedule trains through ``train_bafdp(schedule=...)``, so the
loss curves and the timestamps they are read against come from one
schedule.

Beside the sync-against-async headline, :data:`SCENARIOS` runs the
federation policies on the first dataset: a bounded-staleness fleet
(age-aware selection, adaptive quorum, Taylor staleness compensation),
surge arrivals, flapping availability, the FedBuff K-arrivals server on
the int8 sign wire, and the device scenario pack
(``core/devices.SCENARIO_PACK``: diurnal windows, regional outages, flash
crowds, battery and network tails), each trained on its own schedule.

``with_meta=True`` also returns per-dataset metadata: the dense masks,
staleness and quorums of ``Schedule.to_sim()`` and the per-round
``n_active`` the training saw, for tests only; the rows read the sparse
schedule directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.bench import cli, synced_time
from repro_torch.configs import FedConfig
from repro_torch.core.async_engine import DelayModel
from repro_torch.core.devices import device_scenario
from repro_torch.core.schedule import (AdaptiveQuorum, AgeAwareSelection,
                                       FedBuffTrigger, QuorumTrigger,
                                       SyncTrigger, build_schedule)
from repro_torch.train import ROUNDS, train_bafdp

ACTIVE_FRAC = 0.6

# scenario -> (delay/device model spec, trigger factory, FedConfig
# overrides).  The spec is DelayModel kwargs or an ``(n_clients, seed) ->
# DeviceModel`` factory (the device scenario pack).  Every scenario runs an
# asynchronous server with the schedule's staleness fed into training.
SCENARIOS = {
    "age_adaptive": (           # bounded-staleness fleet
        dict(hetero=1.8, jitter=0.1),
        lambda: QuorumTrigger(active_frac=ACTIVE_FRAC,
                              quorum=AdaptiveQuorum(s_min=2),
                              selection=AgeAwareSelection()),
        dict(staleness_decay="poly", staleness_compensation="taylor")),
    "surge": (                  # bursty stragglers pile arrivals up
        dict(burst_prob=0.3, burst_scale=15.0),
        lambda: QuorumTrigger(active_frac=ACTIVE_FRAC,
                              quorum=AdaptiveQuorum(s_min=2)),
        dict(staleness_decay="poly")),
    "flap": (                   # dropout/rejoin availability flapping
        dict(dropout_prob=0.25, rejoin_prob=0.4),
        lambda: QuorumTrigger(active_frac=ACTIVE_FRAC,
                              quorum=AdaptiveQuorum(s_min=1)),
        dict(staleness_decay="hinge")),
    "fedbuff": (                # buffered server: aggregate every K arrivals,
        dict(hetero=1.2),       # K/C-normalized step, int8 sign messages
        lambda: FedBuffTrigger(buffer_k=5),
        dict(staleness_decay="poly", fedbuff_lr_norm=True,
             sign_message="int8")),
    # ---- the device scenario pack (core/devices.py) ---------------------
    "diurnal": (                # day/night windows phase the participation
        lambda n, seed: device_scenario("diurnal", n, seed),
        lambda: QuorumTrigger(active_frac=ACTIVE_FRAC,
                              quorum=AdaptiveQuorum(s_min=1),
                              selection=AgeAwareSelection()),
        dict(staleness_decay="poly", staleness_compensation="taylor")),
    "regional_outage": (        # whole regions go dark together
        lambda n, seed: device_scenario("regional_outage", n, seed),
        lambda: QuorumTrigger(active_frac=ACTIVE_FRAC,
                              quorum=AdaptiveQuorum(s_min=1)),
        dict(staleness_decay="hinge")),
    "flash_crowd": (            # surges flood the FedBuff buffer
        lambda n, seed: device_scenario("flash_crowd", n, seed),
        lambda: FedBuffTrigger(buffer_k=5),
        dict(staleness_decay="poly", fedbuff_lr_norm=True)),
    "battery_tail": (           # stateful low-power/cellular straggler tail
        lambda n, seed: device_scenario("battery_tail", n, seed),
        lambda: QuorumTrigger(active_frac=ACTIVE_FRAC,
                              quorum=AdaptiveQuorum(s_min=2),
                              selection=AgeAwareSelection()),
        dict(staleness_decay="poly")),
}

# the scenario names backed by the device pack
DEVICE_SCENARIOS = ("diurnal", "regional_outage", "flash_crowd",
                    "battery_tail")


def scenario_model(name: str, n: int, seed: int):
    """The scenario's delay/device model at fleet size ``n``."""
    spec = SCENARIOS[name][0]
    if callable(spec):
        return spec(n, seed)
    return DelayModel(**{"n_clients": n, "hetero": 1.0, "seed": seed,
                         **spec})


def scenario_config(name: str, n: int) -> FedConfig:
    """The scenario's FedConfig at fleet size ``n``."""
    return dataclasses.replace(
        FedConfig(n_clients=n, active_frac=ACTIVE_FRAC), **SCENARIOS[name][2])


def run_scenario(name: str, dataset: str, rounds: int, n: int = 8,
                 seed: int = 0, with_meta: bool = False, device=None
                 ) -> Tuple[str, Optional[Dict]]:
    t0 = synced_time(device)
    sched = build_schedule(rounds, scenario_model(name, n, seed),
                           SCENARIOS[name][1]())
    _, _, h = train_bafdp(dataset, 1, scenario_config(name, n), rounds,
                          schedule=sched, collect=("data_loss", "n_active"),
                          device=device)
    loss = np.asarray(h["data_loss"])
    us = (synced_time(device) - t0) * 1e6 / max(rounds, 1)
    # summary stats straight off the sparse schedule: max_stale is the
    # worst admission age any consumed delivery carried, mean_quorum the
    # per-round distinct participants
    row = (f"fig456/{dataset}:{name},{us:.1f},"
           f"t_total_s={sched.times[-1]:.1f};"
           f"max_stale={sched.winner_ages.max(initial=0)};"
           f"mean_quorum={sched.quorum.mean():.2f};"
           f"mean_arrivals={sched.arrivals.mean():.2f};"
           f"final_loss={loss[-1]:.4f}")
    if not with_meta:
        return row, None
    sim = sched.to_sim()       # test-only densification
    meta = {"scenario": name, "masks": sim.active,
            "staleness": sim.staleness, "quorum": sim.quorum,
            "arrivals": sched.arrivals,
            "n_active": np.asarray(h["n_active"])}
    return row, meta


def main(rounds: int = ROUNDS, quick: bool = False, with_meta: bool = False,
         device=None) -> Union[List[str], Tuple[List[str], List[Dict]]]:
    rows, metas = [], []
    datasets = ("milano", "trento", "lte") if not quick else ("milano",)
    for dataset in datasets:
        t0 = synced_time(device)
        n = 8
        dm = DelayModel(n_clients=n, hetero=1.0, seed=0)
        sched_async = build_schedule(
            rounds, dm, QuorumTrigger(active_frac=ACTIVE_FRAC))
        sched_sync = build_schedule(rounds, dm, SyncTrigger())

        # sync = every client active each round; async = S of M; both
        # train on the schedule the simulator timestamped
        fed_async = FedConfig(n_clients=n, active_frac=ACTIVE_FRAC)
        fed_sync = FedConfig(n_clients=n, active_frac=1.0)
        _, _, h_async = train_bafdp(dataset, 1, fed_async, rounds,
                                    schedule=sched_async,
                                    collect=("data_loss", "n_active"),
                                    device=device)
        _, _, h_sync = train_bafdp(dataset, 1, fed_sync, rounds,
                                   schedule=sched_sync,
                                   collect=("data_loss", "n_active"),
                                   device=device)
        la, ls = np.asarray(h_async["data_loss"]), np.asarray(
            h_sync["data_loss"])
        t_async, t_sync = sched_async.times, sched_sync.times
        target = max(np.nanmin(ls), np.nanmin(la)) * 1.1

        def t_to(loss, t):
            idx = np.nonzero(loss <= target)[0]
            return float(t[idx[0]]) if idx.size else float("inf")

        ta, ts = t_to(la, t_async), t_to(ls, t_sync)
        us = (synced_time(device) - t0) * 1e6 / max(rounds, 1)
        rows.append(
            f"fig456/{dataset},{us:.1f},t_async_s={ta:.1f};t_sync_s={ts:.1f};"
            f"speedup={ts / ta if np.isfinite(ta) and ta > 0 else float('nan'):.2f};"
            f"final_loss_async={la[-1]:.4f};final_loss_sync={ls[-1]:.4f}")
        print(rows[-1], flush=True)
        if with_meta:
            sim_async, sim_sync = sched_async.to_sim(), sched_sync.to_sim()
            meta = {
                "dataset": dataset,
                "masks_async": sim_async.active,
                "masks_sync": sim_sync.active,
                "staleness_async": sim_async.staleness,
                "quorum_async": sim_async.quorum,
                "n_active_async": np.asarray(h_async["n_active"]),
                "n_active_sync": np.asarray(h_sync["n_active"]),
                "active_frac": ACTIVE_FRAC,
                "variants": {},
            }
        else:
            meta = {"dataset": dataset, "variants": {}}
        if dataset == datasets[0]:
            for name in sorted(SCENARIOS):
                row, vmeta = run_scenario(name, dataset, rounds, n=n,
                                          with_meta=with_meta, device=device)
                rows.append(row)
                print(row, flush=True)
                if with_meta:
                    meta["variants"][name] = vmeta
        metas.append(meta)
    if with_meta:
        return rows, metas
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
