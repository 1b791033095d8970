"""The paper's tables and figures on the port (the counterparts of the
JAX package's ``benchmarks/*.py``).  Each module has ``main(rounds, quick,
device)``, which prints its rows as ``name,us_per_round,derived`` (the
reference's labels) and returns them, and runs as

    python -m repro_torch.bench.<module> [--rounds N] [--quick] [--device cpu]

on the GPU unless ``--device cpu`` is given.  ``python -m
repro_torch.bench.run`` runs every suite (``run.SUITES``) and
``python -m repro_torch.bench.summarize_claims`` turns its rows into the
paper's claim verdicts."""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.train import ROUNDS
from repro_torch.tree import resolve_device


def synced_time(device=None) -> float:
    """``time.time()`` once the device's queued work has finished (a
    ``torch.cuda.synchronize`` on the GPU), so a span between two calls is
    the work's time on the card, not the time it took to enqueue it."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.time()


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
