"""The roofline table (the port of ``benchmarks/roofline_table.py``): the
dry-run artifacts (``launch.dryrun``, under ``$DRYRUN_DIR`` or
``results/dryrun``) as one row per (arch x shape x mesh): the three
terms, the dominant one, the useful-FLOPs ratio and the bytes per device,
all for one H100.  ``main`` gives them as suite rows, ``format_table`` as
a text table.

    python -m repro_torch.launch.dryrun --all    # write the artifacts
    python -m repro_torch.bench.roofline_table   # print the table
"""
from __future__ import annotations

import glob
import json
import os
from typing import List

OUT_DIR = os.environ.get("DRYRUN_DIR", "results/dryrun")


def rows_from_artifacts(pattern: str = "*.json") -> List[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(OUT_DIR, pattern))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def format_table(rows: List[dict]) -> List[str]:
    out = []
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':8s} {'compute_ms':>10s} "
           f"{'memory_ms':>10s} {'coll_ms':>10s} {'dominant':>10s} "
           f"{'useful':>7s} {'GB/dev':>7s}")
    out.append(hdr)
    for r in rows:
        out.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:8s} "
            f"{r['t_compute_s'] * 1e3:10.2f} {r['t_memory_s'] * 1e3:10.2f} "
            f"{r['t_collective_s'] * 1e3:10.2f} {r['dominant']:>10s} "
            f"{r['useful_ratio']:7.3f} {r['bytes_per_device'] / 1e9:7.2f}")
    return out


def main(rounds: int = 0, quick: bool = False, device=None) -> List[str]:
    """The artifacts as suite rows (``us_per_call`` the dry-run's seconds on
    meta, as the reference's is its compile time); reads no device."""
    csv = []
    for r in rows_from_artifacts():
        csv.append(
            f"roofline/{r['arch']}/{r['shape']}/{r['mesh']},"
            f"{r.get('compile_s', 0) * 1e6:.0f},"
            f"compute_ms={r['t_compute_s'] * 1e3:.2f};"
            f"memory_ms={r['t_memory_s'] * 1e3:.2f};"
            f"collective_ms={r['t_collective_s'] * 1e3:.2f};"
            f"dominant={r['dominant']};useful={r['useful_ratio']:.3f};"
            f"gb_per_dev={r['bytes_per_device'] / 1e9:.2f}")
    if not csv:
        csv = ["roofline/none,0.0,run `python -m repro_torch.launch.dryrun "
               "--all` first"]
    for line in csv:
        print(line, flush=True)
    return csv


if __name__ == "__main__":
    for line in format_table(rows_from_artifacts()):
        print(line)
