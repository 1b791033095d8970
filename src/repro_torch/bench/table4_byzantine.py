"""Table IV: Byzantine robustness on Milano, H in {1, 24}: RSA / DP-RSA
at ratio 0.1 against BAFDP at ratios {0, 0.1, 0.3}, plus BAFDP with the
server-side robust pre-aggregation (``FedConfig.robust_consensus``)
guarding the sign fold at the highest ratio (the port of
``benchmarks/table4_byzantine.py``)."""
from __future__ import annotations

from typing import List

from repro_torch.bench import cli, synced_time
from repro_torch.configs import FedConfig
from repro_torch.train import ROUNDS, run_method


def main(rounds: int = ROUNDS, quick: bool = False,
         device=None) -> List[str]:
    rows = []
    horizons = (1,) if quick else (1, 24)
    # (label, method, byzantine ratio, robust_consensus rule)
    combos = [("RSA", "RSA", 0.1, "none"),
              ("DP-RSA", "DP-RSA", 0.1, "none"),
              ("BAFDP", "BAFDP", 0.0, "none"),
              ("BAFDP", "BAFDP", 0.1, "none"),
              ("BAFDP", "BAFDP", 0.3, "none"),
              ("BAFDP-TM", "BAFDP", 0.3, "trimmed_mean"),
              ("BAFDP-MED", "BAFDP", 0.3, "median")]
    if quick:
        combos = [("RSA", "RSA", 0.1, "none"),
                  ("BAFDP", "BAFDP", 0.1, "none"),
                  ("BAFDP-TM", "BAFDP", 0.3, "trimmed_mean")]
    for h in horizons:
        for label, method, ratio, rule in combos:
            fed = FedConfig(n_clients=10, byzantine_frac=ratio,
                            attack="sign_flip" if ratio else "none",
                            robust_consensus=rule, robust_trim_frac=0.35)
            t0 = synced_time(device)
            rmse, mae = run_method(method, "milano", h, fed=fed,
                                   rounds=rounds, device=device)
            us = (synced_time(device) - t0) * 1e6 / max(rounds, 1)
            rows.append(f"table4/{label}/ratio{ratio}/H{h},{us:.1f},"
                        f"rmse={rmse:.4f};mae={mae:.4f}")
            print(rows[-1], flush=True)
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
