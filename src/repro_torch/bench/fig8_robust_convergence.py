"""Fig. 8: training-loss convergence at Byzantine ratios 0.8 / 0.6 / 0.4
/ 0.2 / 0 (convergence speeds up as the honest fraction grows), plus a
trimmed-mean-guarded series (``FedConfig.robust_consensus``) at a high
ratio for contrast (the port of
``benchmarks/fig8_robust_convergence.py``)."""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.bench import cli, synced_time
from repro_torch.configs import FedConfig
from repro_torch.train import ROUNDS, train_bafdp


def main(rounds: int = ROUNDS, quick: bool = False,
         device=None) -> List[str]:
    rows = []
    ratios = (0.8, 0.4, 0.0) if quick else (0.8, 0.6, 0.4, 0.2, 0.0)
    # (ratio, robust_consensus rule): the guarded series shows the robust
    # pre-aggregation recovering convergence the plain sign fold loses
    series = [(r, "none") for r in ratios] + [(0.4, "trimmed_mean")]
    for ratio, rule in series:
        fed = FedConfig(n_clients=10, byzantine_frac=ratio,
                        attack="sign_flip" if ratio else "none",
                        active_frac=1.0, robust_consensus=rule,
                        robust_trim_frac=0.45)
        t0 = synced_time(device)
        _, _, hist = train_bafdp("milano", 1, fed, rounds,
                                 collect=("data_loss",), device=device)
        us = (synced_time(device) - t0) * 1e6 / max(rounds, 1)
        loss = np.asarray(hist["data_loss"])
        target = np.nanmin(loss) * 1.2
        idx = np.nonzero(loss <= target)[0]
        t_conv = int(idx[0]) if idx.size else rounds
        tag = f"fig8/ratio{ratio}" if rule == "none" \
            else f"fig8/ratio{ratio}-tm"
        rows.append(f"{tag},{us:.1f},final={loss[-1]:.4f};"
                    f"rounds_to_1.2xbest={t_conv}")
        print(rows[-1], flush=True)
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
