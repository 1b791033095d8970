"""Fig. 3: evolution of the privacy level eps_i during training on the
three datasets (client 0 of each, H=1), with the clients' spread at the
end (the port of ``benchmarks/fig3_privacy_level.py``)."""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.bench import cli, synced_time
from repro_torch.configs import FedConfig
from repro_torch.train import ROUNDS, train_bafdp

# a faster eps step and a low start, so the level visibly rises
FIG3_KNOBS = dict(alpha_eps=5e-2, eps_init_frac=0.02)


def main(rounds: int = ROUNDS, quick: bool = False,
         device=None) -> List[str]:
    rows = []
    datasets = ("milano", "trento", "lte") if not quick else ("milano",)
    for dataset in datasets:
        fed = FedConfig(**FIG3_KNOBS)
        t0 = synced_time(device)
        _, _, hist = train_bafdp(dataset, 1, fed, rounds,
                                 collect=("eps_all",), device=device)
        us = (synced_time(device) - t0) * 1e6 / max(rounds, 1)
        eps = np.stack(hist["eps_all"])          # (rounds, C)
        client = 0
        final = eps[-1, client]
        drift = eps[-1].std()
        rows.append(
            f"fig3/{dataset},{us:.1f},eps_start={eps[0, client]:.3f};"
            f"eps_final={final:.3f};per_client_spread={drift:.3f}")
        print(rows[-1], flush=True)
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
