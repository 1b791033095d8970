"""Tables II + III: prediction performance (RMSE/MAE of the consensus
model z) against the privacy budget ``a`` on Milano (a in 10..70) and
Trento (a in 0.1..50), H in {1, 24} (the port of
``benchmarks/table23_privacy_budget.py``)."""
from __future__ import annotations

from typing import List

from repro_torch.bench import cli, synced_time
from repro_torch.configs import FedConfig
from repro_torch.train import ROUNDS, eval_rmse_mae, problem, train_bafdp

MILANO_BUDGETS = (10, 20, 30, 40, 50, 60, 70)
TRENTO_BUDGETS = (0.1, 1, 10, 20, 30, 40, 50)


def budget_config(a: float) -> FedConfig:
    """The sweep's configuration at budget ``a``: the privacy floor
    ``eps_min`` scales down with a small budget."""
    return FedConfig(privacy_budget_a=float(a), eps_min=min(0.01, a / 100))


def main(rounds: int = ROUNDS, quick: bool = False,
         device=None) -> List[str]:
    rows = []
    combos = [("milano", MILANO_BUDGETS), ("trento", TRENTO_BUDGETS)]
    if quick:
        combos = [("milano", (10, 40))]
    horizons = (1,) if quick else (1, 24)
    for dataset, budgets in combos:
        for h in horizons:
            for a in budgets:
                fed = budget_config(a)
                t0 = synced_time(device)
                state, cfg, _ = train_bafdp(dataset, h, fed, rounds,
                                            device=device)
                _, test, scalers = problem(dataset, h, fed.n_clients)
                rmse, mae = eval_rmse_mae(state.z, cfg, test, scalers)
                us = (synced_time(device) - t0) * 1e6 / max(rounds, 1)
                rows.append(f"table23/{dataset}/H{h}/a{a},{us:.1f},"
                            f"rmse={rmse:.4f};mae={mae:.4f}")
                print(rows[-1], flush=True)
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
