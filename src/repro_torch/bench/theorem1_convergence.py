"""Theorem 1: iteration complexity T(Y) ~ O(1/Y^2).  The round at which
the squared consensus-stationarity gap first drops below Y, for a
geometric ladder of Y values, and the log-log slope fitted through them,
which the theorem bounds by ~2 (the port of
``benchmarks/theorem1_convergence.py``)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.bench import cli, synced_time
from repro_torch.configs import FedConfig
from repro_torch.train import ROUNDS, train_bafdp

# faithful SGD dynamics (Theorem 1 analyses the Eq. 18 iteration), every
# client active; the consensus step sizes raised so that the Y-ladder is
# reached within the horizon (the theorem is about the order, not a
# specific alpha)
THEOREM1_KNOBS = dict(n_clients=6, active_frac=1.0, alpha_w=5e-3,
                      psi=5e-2, alpha_z=1e-1, alpha_phi=1e-2)
MIN_ROUNDS = 800


def ladder_slope(gap: np.ndarray, n_rounds: int
                 ) -> Tuple[float, List[int]]:
    """The first round at or below each rung of the Y-ladder (``n_rounds``
    when never reached) and the log-log slope of T against 1/Y."""
    g0 = gap[min(20, len(gap) - 1)]   # post-transient reference
    ladder = [g0 * f for f in (0.5, 0.25, 0.125, 0.0625)]
    ts = []
    for y in ladder:
        idx = np.nonzero(gap <= y)[0]
        ts.append(int(idx[0]) if idx.size else n_rounds)
    ys = np.log(1.0 / np.asarray(ladder))
    tt = np.log(np.maximum(np.asarray(ts, float), 1.0))
    slope = float(np.polyfit(ys, tt, 1)[0]) if len(set(ts)) > 1 else 0.0
    return slope, ts


def main(rounds: int = ROUNDS, quick: bool = False,
         device=None) -> List[str]:
    n_rounds = max(rounds, MIN_ROUNDS) if not quick else rounds
    fed = FedConfig(**THEOREM1_KNOBS)
    t0 = synced_time(device)
    _, _, hist = train_bafdp("milano", 1, fed, n_rounds,
                             collect=("consensus_gap",), optimizer="sgd",
                             device=device)
    us = (synced_time(device) - t0) * 1e6 / max(n_rounds, 1)
    slope, ts = ladder_slope(np.asarray(hist["consensus_gap"]), n_rounds)
    rows = [f"theorem1/slope,{us:.1f},loglog_slope={slope:.2f};"
            f"T_at_ladder={'/'.join(map(str, ts))};bound=2.0"]
    print(rows[-1], flush=True)
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
