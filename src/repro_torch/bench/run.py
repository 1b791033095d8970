"""Run the paper's suites, one module per table or figure, and print
their rows as ``name,us_per_call,derived`` CSV on stdout (the port of
``benchmarks/run.py``):

    python -m repro_torch.bench.run [--quick] [--only table23,fig3] \
        [--rounds N] [--device cpu] > bench_output.txt

``--rounds`` defaults to ``$BENCH_ROUNDS`` or 150; the suites run on the
GPU unless ``--device cpu`` is given.  stderr gets ``# <suite> done in
Ns`` after each suite and, at the end, the claim verdicts of
:mod:`repro_torch.bench.summarize_claims` over every row.  A suite that
raises prints one ``<suite>/ERROR,0.0,failed`` row (its traceback on
stderr), the others still run, and the exit code is 1."""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback
from typing import List, Optional, Sequence

from repro_torch.bench import (fig3_privacy_level, fig456_async_efficiency,
                               fig7_distributiveness, fig8_robust_convergence,
                               summarize_claims, table1_prediction,
                               table23_privacy_budget, table4_byzantine,
                               theorem1_convergence)
from repro_torch.tree import resolve_device

SUITES = {
    "table1": table1_prediction.main,
    "table23": table23_privacy_budget.main,
    "fig3": fig3_privacy_level.main,
    "fig456": fig456_async_efficiency.main,
    "table4": table4_byzantine.main,
    "fig7": fig7_distributiveness.main,
    "fig8": fig8_robust_convergence.main,
    "theorem1": theorem1_convergence.main,
}
# the reference's two other suites, which the port does not have yet
NOT_PORTED = ("kernels", "roofline")


def suite_names(text: str) -> List[str]:
    """``--only``'s comma-separated names, each a key of :data:`SUITES`."""
    names = [n.strip() for n in text.split(",") if n.strip()]
    for name in names:
        if name in NOT_PORTED:
            raise argparse.ArgumentTypeError(
                f"{name}: not yet ported (ROADMAP Queue A item 8)")
        if name not in SUITES:
            raise argparse.ArgumentTypeError(
                f"unknown suite {name!r} (have {', '.join(SUITES)})")
    return names


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the reference's reduced method/dataset grids")
    ap.add_argument("--only", type=suite_names, default=[],
                    help="comma-separated suite names")
    ap.add_argument("--rounds", type=int,
                    default=int(os.environ.get("BENCH_ROUNDS", "150")))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    print("name,us_per_call,derived", flush=True)
    rows, failures = [], 0
    for name in args.only or list(SUITES):
        t0 = time.time()
        try:          # each suite's main prints its rows as it goes
            rows += SUITES[name](rounds=args.rounds, quick=args.quick,
                                 device=args.device)
        except Exception:  # noqa: BLE001  (reported, then exit code 1)
            failures += 1
            print(f"{name}/ERROR,0.0,failed", flush=True)
            traceback.print_exc(file=sys.stderr)
        print(f"# {name} done in {time.time() - t0:.0f}s", file=sys.stderr,
              flush=True)
    print(summarize_claims.main(rows=rows), file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
