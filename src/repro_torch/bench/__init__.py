"""The paper's tables and figures on the port (the counterparts of the
JAX package's ``benchmarks/*.py``).  Each module has ``main(rounds, quick,
device)``, which prints its rows as ``name,us_per_round,derived`` (the
reference's labels) and returns them, and runs as

    python -m repro_torch.bench.<module> [--rounds N] [--quick] [--device cpu]

on the GPU unless ``--device cpu`` is given."""
from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Sequence

from repro_torch.train import ROUNDS


def cli(main: Callable[..., List[str]], doc: str,
        argv: Optional[Sequence[str]] = None) -> List[str]:
    """Parse ``--rounds --quick --device`` and run ``main``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--quick", action="store_true",
                    help="the reference's shrunken grid")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return main(rounds=args.rounds, quick=args.quick, device=args.device)
