"""fedlint CLI (the port of the JAX package's ``analysis/cli.py``): sweep
the entry-point manifest and report.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.cli               # card
    PYTHONPATH=src python -m repro_torch.analysis.cli --device cpu  # CPU
    PYTHONPATH=src python -m repro_torch.analysis.cli --selftest    # fixtures
    PYTHONPATH=src python -m repro_torch.analysis.cli --only sparse # filter
    PYTHONPATH=src python -m repro_torch.analysis.cli --json -      # JSON
    PYTHONPATH=src python -m repro_torch.analysis.cli --list        # names

The small entries run on ``--device``: the card by default (raising
without one), where the host reads that ``host-sync`` looks for are real
syncs; ``cpu`` where no host read is a sync, so that rule cannot fire
there and its baseline entry is reported stale; ``meta`` for shapes
only.  The C = 1M round runs on meta whatever the device.  Exit status is 1 if any entry has
unsuppressed errors or a trace that stopped (or the selftest finds a rule
that misses its seeded violation), else 0.

Baseline file (``--baseline``, default ``baseline.json`` next to this
module)::

    {"suppressions": {"<fingerprint>": "<written justification>", ...}}

Fingerprints appear in the JSON report and after every finding.  Entries
that fire in no entry point are reported as stale.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List, Optional, Tuple

DEFAULT_BASELINE = pathlib.Path(__file__).parent / "baseline.json"


def load_baseline(path: pathlib.Path) -> Dict[str, str]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    supp = data.get("suppressions", {})
    if not isinstance(supp, dict):
        raise SystemExit(f"malformed baseline {path}: 'suppressions' "
                         f"must be an object")
    return {str(k): str(v) for k, v in supp.items()}


def sweep(entries, baseline: Dict[str, str]) -> Tuple[List, List[str]]:
    """Lint every entry with the baseline applied: the reports (None for a
    trace that raised) and the stale baseline entries (fired nowhere)."""
    from repro_torch.analysis.verify import apply_baseline, lint_jaxpr

    reports = []
    for e in entries:
        try:
            log = e.trace()
        except Exception as exc:  # noqa: BLE001  (a broken trace fails)
            print(f"== {e.name}: TRACE FAILED: {type(exc).__name__}: "
                  f"{exc}")
            reports.append(None)
            continue
        rep = lint_jaxpr(log, e.make_rules(), e.bindings, name=e.name)
        apply_baseline(rep, {fp: why for fp, why in baseline.items()
                             if fp in {f.fingerprint
                                       for f in rep.findings}})
        reports.append(rep)
        print(rep.format_human())
        for f in rep.findings:
            print(f"     fingerprint: {f.fingerprint}")
    fired = {f.fingerprint for rep in reports if rep is not None
             for f, _ in rep.suppressed}
    return reports, [fp for fp in baseline if fp not in fired]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.cli",
        description="fedlint: op-log invariant analyzer for the BAFDP "
                    "round paths")
    ap.add_argument("--selftest", action="store_true",
                    help="run seeded-violation fixtures instead of the "
                         "manifest")
    ap.add_argument("--only", default=None, metavar="SUBSTR",
                    help="only sweep manifest entries whose name contains "
                         "SUBSTR")
    ap.add_argument("--list", action="store_true",
                    help="list manifest entry names and exit")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write a JSON report to PATH ('-' = stdout)")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    metavar="PATH", help="baseline suppression file "
                                         "(default: %(default)s)")
    ap.add_argument("--device", default=None,
                    help="where the small entries run: cuda (default), "
                         "cpu or meta")
    args = ap.parse_args(argv)

    if args.selftest:
        from repro_torch.analysis.fixtures import FIXTURES, run_selftest
        problems = run_selftest()
        if problems:
            for p in problems:
                print(f"SELFTEST FAIL: {p}")
            return 1
        print(f"selftest OK: {len(FIXTURES)} fixtures, every rule "
              f"catches its seeded violation and passes its clean twin")
        return 0

    from repro_torch.analysis.manifest import build_manifest

    baseline = load_baseline(pathlib.Path(args.baseline))
    entries = build_manifest(args.device)
    if args.only:
        entries = [e for e in entries if args.only in e.name]
        if not entries:
            print(f"no manifest entry matches --only {args.only!r}")
            return 1
    if args.list:
        for e in entries:
            print(f"{e.name:32s} {e.description}")
        return 0

    reports, stale = sweep(entries, baseline)
    for fp in stale:
        print(f"WARNING: stale baseline entry (fires nowhere): {fp}")
    failed = [r for r in reports if r is None or not r.ok]
    n_err = sum(len(r.errors) for r in reports if r is not None)
    n_supp = sum(len(r.suppressed) for r in reports if r is not None)
    print(f"-- fedlint: {len(reports)} entrypoint(s), {n_err} error(s), "
          f"{n_supp} baselined, {len(stale)} stale baseline entr"
          f"{'y' if len(stale) == 1 else 'ies'}")

    if args.json:
        payload = {
            "entries": [r.to_dict() for r in reports if r is not None],
            "trace_failures": [e.name for e, r in zip(entries, reports)
                               if r is None],
            "stale_baseline": stale,
            "ok": not failed,
        }
        text = json.dumps(payload, indent=2)
        if args.json == "-":
            print(text)
        else:
            pathlib.Path(args.json).write_text(text + "\n")

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
