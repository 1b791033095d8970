"""Byzantine showdown: every attack against every defence on the traffic
task (the port of ``examples/byzantine_showdown.py``).

Runs a grid of {attack} x {aggregation rule / BAFDP} and prints the final
test RMSE: the paper's core robustness claim (Table IV generalized), and
where plain FedAvg melts down.

    python -m repro_torch.byzantine_showdown [--rounds 80] [--device cpu]

runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from repro_torch.configs import MLP_H1, FedConfig
from repro_torch.core import bafdp
from repro_torch.core.byzantine import byz_mask
from repro_torch.core.fed_state import init_fed_state
from repro_torch.core.privacy import gaussian_c3, perturb_inputs
from repro_torch.core.schedule import round_generator
from repro_torch.core.trainers import BaselineTrainer
from repro_torch.data import build_windows, client_batches, make_dataset
from repro_torch.models.forecasting import init_forecaster, mse_loss
from repro_torch.train import eval_rmse_mae
from repro_torch.tree import resolve_device

CFG = MLP_H1
ATTACKS = ["none", "gaussian", "sign_flip", "same_value", "alie"]
DEFENSES = ["fedavg", "median", "krum", "centered_clip", "rsa", "bafdp"]


def run(defense, attack, train, test, scalers, rounds, device) -> float:
    """Train ``defense`` for ``rounds`` under ``attack`` (30 % Byzantine
    clients); the final test RMSE of the server (BAFDP: consensus)
    model."""
    fed = FedConfig(n_clients=10, byzantine_frac=0.3 if attack != "none"
                    else 0.0, attack=attack, active_frac=1.0)
    rng = np.random.RandomState(0)

    def batch(t):
        x, y = client_batches(rng, train, 32)
        return (torch.from_numpy(x).to(device, torch.float32),
                torch.from_numpy(y).to(device, torch.float32))

    init_gen = torch.Generator(device=device).manual_seed(0)
    if defense == "bafdp":
        c3 = gaussian_c3(CFG.d_x + CFG.d_y, fed.dp_delta, 0.05)

        def local_loss(W, b, gen, eps):
            x, y = b
            return mse_loss(W, perturb_inputs(gen, x, eps, 0.02), y, CFG)

        state = init_fed_state(init_gen,
                               lambda g: init_forecaster(g, CFG, device),
                               fed, device=device)
        step = functools.partial(
            bafdp.bafdp_round, local_loss=local_loss, fed=fed, c3=c3,
            n_samples=train["x"].shape[1], d_dim=CFG.d_x + CFG.d_y,
            byz_mask=byz_mask(fed.n_clients, fed.n_byzantine, device=device))
        for t in range(rounds):
            state, _ = step(state, batch(t), round_generator(0, t, device))
        return eval_rmse_mae(state.z, CFG, test, scalers)[0]

    def loss(W, b, gen):
        x, y = b
        return mse_loss(W, x, y, CFG)

    method = {"fedavg": "fedavg", "rsa": "rsa"}.get(defense, "robust_agg")
    tr = BaselineTrainer(method=method, loss=loss, fed=fed,
                         aggregator=defense if method == "robust_agg"
                         else "fedavg")
    st = tr.init(init_forecaster(init_gen, CFG, device))
    for t in range(rounds):
        st, _ = tr.round(st, batch(t), round_generator(0, t, device))
    return eval_rmse_mae(st["server"], CFG, test, scalers)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=80)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = make_dataset("milano", 10)
    train, test, scalers = build_windows(data, CFG)

    print(f"{'defense':14s}" + "".join(f"{a:>12s}" for a in ATTACKS))
    for d in DEFENSES:
        row = [d.ljust(14)]
        for a in ATTACKS:
            try:
                rmse = run(d, a, train, test, scalers, args.rounds, dev)
                row.append(f"{rmse:12.1f}" if np.isfinite(rmse)
                           else f"{'DIVERGED':>12s}")
            except Exception:  # noqa: BLE001
                row.append(f"{'ERROR':>12s}")
        print("".join(row), flush=True)
    print("\n(30% byzantine clients; RMSE in raw traffic units; "
          "lower is better)")


if __name__ == "__main__":
    main()
