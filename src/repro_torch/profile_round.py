"""Where a training round's time goes on the GPU.

    python -m repro_torch.profile_round [--rounds 10] [--sign-message f32]
        [--staleness-decay poly] [--clients 10] [--round-impl sparse]

Trains the MLP_H24 forecaster on synthetic Milano traffic through
``train.train_bafdp`` (after a 2-round warm-up) under ``torch.profiler``
and prints: ms per round (host clock, synchronized, profiler on), the
kernels launched per round, beside them each consensus kernel's
launches per round as its wrapper counts them (``sign_agg.LAUNCHES``:
one grouped launch a round of B1/B2 or, with ``--sign-message int8``,
of B3) and the consensus
kernels' device ms per round and share of busy time, the device busy share
(summed kernel time over wall time) and the top operators by device and
by host time.  ``--round-impl sparse`` profiles the O(S) round fed the
padded rows of an event-driven schedule (the quickstart's fleet under
its quorum server; B2 or B3 once a round over the gathered block).  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import train
from repro_torch.configs import FedConfig
from repro_torch.core.async_engine import DelayModel
from repro_torch.core.schedule import build_schedule
from repro_torch.kernels import sign_agg
from repro_torch.tree import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--sign-message", default="f32")
    ap.add_argument("--staleness-decay", default="poly")
    ap.add_argument("--round-impl", default="dense",
                    choices=["dense", "sparse"])
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    fed = FedConfig(n_clients=args.clients, sign_message=args.sign_message,
                    staleness_decay=args.staleness_decay)
    kw = {}
    if args.round_impl == "sparse":
        kw = dict(round_impl="sparse", schedule=build_schedule(
            args.rounds, DelayModel(n_clients=fed.n_clients, hetero=1.0,
                                    seed=0),
            train.make_trigger("quorum", fed.active_frac)))
    train.problem("milano", 24, fed.n_clients, 0)
    train.train_bafdp("milano", 24, fed, rounds=2, device=dev, **kw)
    torch.cuda.synchronize(dev)
    sign_agg.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train.train_bafdp("milano", 24, fed, rounds=args.rounds,
                          collect=("data_loss",), device=dev, **kw)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"card: {torch.cuda.get_device_name(dev)}")
    print(f"config: {vars(args)}")
    print(f"ms_per_round={wall_ms / args.rounds:.3f} (profiler on) "
          f"kernels_per_round={len(kernels) / args.rounds:.1f} "
          f"device_busy_ms_per_round={busy_ms / args.rounds:.4f} "
          f"device_busy_share={busy_ms / wall_ms:.4f}")
    consensus_ms = sum(e.time_range.elapsed_us() for e in kernels
                       if "sign_agg" in e.name) / 1e3
    print("consensus launches_per_round: " + " ".join(
        f"{name}={n / args.rounds:.1f}"
        for name, n in sign_agg.LAUNCHES.items())
        + f" device_ms_per_round={consensus_ms / args.rounds:.4f} "
        f"share_of_busy={consensus_ms / busy_ms:.4f}")
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=12))
    print(averages.table(sort_by="self_cpu_time_total", row_limit=15))


if __name__ == "__main__":
    main()
