"""Table I: prediction RMSE/MAE of 9 methods x 3 datasets x H in {1, 24},
plus each method's average rank (the port of
``benchmarks/table1_prediction.py``; synthetic datasets: the target is
the ordering, BAFDP's rank above all, not Table I's absolute values)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.bench import cli, synced_time
from repro_torch.train import ROUNDS, run_method

DATASETS = ("milano", "trento", "lte")
HORIZONS = (1, 24)
TABLE1_METHODS = ["FedGRU", "Fed-NTP", "FedAtt", "FedDA", "AFL",
                  "ASPIRE-EASE", "UDP", "NbAFL", "BAFDP"]


def main(rounds: int = ROUNDS, quick: bool = False,
         device=None) -> List[str]:
    rows = []
    methods = TABLE1_METHODS if not quick else ["FedGRU", "AFL", "BAFDP"]
    datasets = DATASETS if not quick else ("milano",)
    horizons = HORIZONS if not quick else (1,)
    results: Dict[str, float] = {}
    for m in methods:
        for d in datasets:
            for h in horizons:
                t0 = synced_time(device)
                rmse, mae = run_method(m, d, h, rounds=rounds, device=device)
                us = (synced_time(device) - t0) * 1e6 / max(rounds, 1)
                results[f"{m}|{d}|{h}"] = rmse
                rows.append(f"table1/{m}/{d}/H{h},{us:.1f},"
                            f"rmse={rmse:.4f};mae={mae:.4f}")
                print(rows[-1], flush=True)
    # average rank per method (the paper's summary column)
    ranks: Dict[str, List[int]] = {m: [] for m in methods}
    for d in datasets:
        for h in horizons:
            scored = sorted(methods, key=lambda m: results.get(
                f"{m}|{d}|{h}", float("inf")))
            for i, m in enumerate(scored):
                ranks[m].append(i + 1)
    for m in methods:
        rows.append(f"table1_rank/{m},0.0,avg_rank={np.mean(ranks[m]):.2f}")
        print(rows[-1], flush=True)
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
