"""Fig. 7: distributiveness -- bytes transferred per training run against
the Byzantine-robustness level (fraction of malicious clients), for the
paper's setting (MLP of ``MODEL_MB``, 10k iterations, 10 clients; each
round moves 2 x model size x participants) plus BAFDP's sign-compressed
variant (1 byte a coordinate upstream).  Arithmetic only: no training, no
device (the port of ``benchmarks/fig7_distributiveness.py``)."""
from __future__ import annotations

from typing import List

from repro_torch.bench import cli

MODEL_MB = 440.0
ITERS = 10_000
CLIENTS = 10


def main(rounds: int = 0, quick: bool = False, device=None) -> List[str]:
    """``rounds``, ``quick`` and ``device`` are accepted and unused."""
    rows = []
    for ratio in (0.2, 0.4, 0.6, 0.8, 1.0):
        honest = int(CLIENTS * (1 - ratio))
        participants = max(honest, 0)
        gb = 2 * MODEL_MB * participants * ITERS / 1024.0
        gb_signed = (MODEL_MB / 4 + MODEL_MB) * participants * ITERS / 1024.0
        rows.append(
            f"fig7/ratio{ratio},0.0,transfer_gb={gb:.0f};"
            f"sign_compressed_gb={gb_signed:.0f};participants={participants}")
        print(rows[-1], flush=True)
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
