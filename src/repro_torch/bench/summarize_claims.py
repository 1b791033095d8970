"""Turn the suite runner's rows (``name,us_per_call,derived``) into the
verdicts on the paper's eight qualitative claims (a copy of
``benchmarks/summarize_claims.py``: the same claims, thresholds and
text).

    python -m repro_torch.bench.summarize_claims [bench_output.txt] [--append]

``--append`` also appends the text to ``EXPERIMENTS.md``.  :func:`main`
takes the rows as a list too (``rows=``), so a caller that has them
summarizes without a file."""
from __future__ import annotations

import sys
from collections import defaultdict
from typing import Dict, Iterable, Optional, Sequence


def parse_lines(lines: Iterable[str]) -> Dict[str, Dict]:
    """{row name: {key: float, or the string where it is none}} of the
    rows among ``lines``; comments, the header and other lines skipped."""
    rows = {}
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#") or line.startswith("name,"):
            continue
        parts = line.split(",", 2)
        if len(parts) != 3:
            continue
        name, _, derived = parts
        kv = {}
        for item in derived.split(";"):
            if "=" in item:
                k, v = item.split("=", 1)
                try:
                    kv[k] = float(v)
                except ValueError:
                    kv[k] = v
        rows[name] = kv
    return rows


def parse(path: str) -> Dict[str, Dict]:
    with open(path) as f:
        return parse_lines(f)


def _ratio(name: str) -> Optional[float]:
    """The Byzantine ratio of a ``fig8/ratio<r>`` row; ``None`` for a
    row with a suffix (``fig8/ratio0.4-tm``)."""
    try:
        return float(name.split("ratio")[1])
    except ValueError:
        return None


def main(path: str = "bench_output.txt",
         rows: Optional[Sequence[str]] = None) -> str:
    """The claims section as markdown, from the rows in ``path`` or, when
    given, from ``rows``."""
    r = parse(path) if rows is None else parse_lines(rows)
    out = ["", "## §Paper-claims — validation against the paper's own claims",
           "",
           "(Synthetic datasets — orderings and qualitative behaviours are "
           "the reproduction target, per DESIGN.md §6.  Full numbers: "
           "`bench_output.txt`.)", ""]

    # Claim 1: Table I — BAFDP best average rank (paper: 1.08)
    ranks = {k.split("/")[1]: v.get("avg_rank")
             for k, v in r.items() if k.startswith("table1_rank/")}
    if ranks:
        ordered = sorted(ranks, key=lambda m: ranks[m])
        bafdp_rank = ranks.get("BAFDP")
        verdict = "CONFIRMED" if ordered[0] == "BAFDP" else (
            "PARTIAL" if bafdp_rank and bafdp_rank <= sorted(
                ranks.values())[2] else "NOT REPRODUCED")
        out.append(f"1. **Table I — BAFDP ranks first** (paper avg rank "
                   f"1.08): measured avg rank {bafdp_rank:.2f}, order "
                   f"{' < '.join(ordered[:4])}… → **{verdict}**.")

    # Claim 2: Table IV — robustness degrades gracefully with ratio
    t4 = {k: v for k, v in r.items() if k.startswith("table4/")}
    if t4:
        b0 = t4.get("table4/BAFDP/ratio0.0/H1", {}).get("rmse")
        b1 = t4.get("table4/BAFDP/ratio0.1/H1", {}).get("rmse")
        b3 = t4.get("table4/BAFDP/ratio0.3/H1", {}).get("rmse")
        rsa = t4.get("table4/RSA/ratio0.1/H1", {}).get("rmse")
        dprsa = t4.get("table4/DP-RSA/ratio0.1/H1", {}).get("rmse")
        if None not in (b0, b1, b3):
            graceful = b0 <= b1 * 1.2 and b1 <= b3 * 1.2
            out.append(
                f"2. **Table IV — graceful degradation with Byzantine "
                f"ratio** (0 ≤ 0.1 ≤ 0.3): BAFDP RMSE {b0:.1f} / {b1:.1f} "
                f"/ {b3:.1f}; RSA@0.1 {rsa:.1f}, DP-RSA@0.1 {dprsa:.1f} → "
                f"**{'CONFIRMED' if graceful else 'PARTIAL'}** "
                f"(paper also shows BAFDP@0.1 ≈ RSA@0.1: "
                f"{'yes' if b1 and rsa and b1 < rsa * 1.3 else 'no'}).")

    # Claim 3: Figs 4-6 — async reaches target loss faster (wall-clock)
    speedups = [v.get("speedup") for k, v in r.items()
                if k.startswith("fig456/")]
    speedups = [s for s in speedups if isinstance(s, float)]
    if speedups:
        ok = all(s > 1.0 for s in speedups)
        out.append(
            f"3. **Figs 4-6 — asynchronous (BAFDP) beats synchronous "
            f"(BSFDP) wall-clock**: speedups "
            f"{', '.join(f'{s:.2f}x' for s in speedups)} across datasets → "
            f"**{'CONFIRMED' if ok else 'PARTIAL'}**.")

    # Claim 4: Fig 3 — eps rises then stabilizes
    fig3 = {k: v for k, v in r.items() if k.startswith("fig3/")}
    if fig3:
        rises = [v["eps_final"] > v["eps_start"] for v in fig3.values()
                 if "eps_final" in v]
        out.append(
            f"4. **Fig 3 — privacy level ε rises from init and spreads "
            f"per-client**: rising on {sum(rises)}/{len(rises)} datasets, "
            f"per-client spread > 0 → "
            f"**{'CONFIRMED' if all(rises) else 'PARTIAL'}**.")

    # Claim 5: Fig 8 — convergence slows as byz ratio grows.  The series
    # is the plain ratios; a guarded row (``fig8/ratio0.4-tm``) is its
    # contrast, not a point of it (the reference's float() raises on it)
    fig8 = sorted(((_ratio(k), v.get('rounds_to_1.2xbest'))
                   for k, v in r.items()
                   if k.startswith("fig8/") and _ratio(k) is not None),
                  key=lambda x: x[0])
    if fig8:
        rounds_seq = [x[1] for x in fig8]
        mono = all(rounds_seq[i] >= rounds_seq[i + 1] - 30
                   for i in range(len(rounds_seq) - 1))
        out.append(
            f"5. **Fig 8 — more honest clients ⇒ faster convergence**: "
            f"rounds-to-target at ratios {[x[0] for x in fig8]} = "
            f"{rounds_seq} → **{'CONFIRMED' if mono else 'PARTIAL'}**.")

    # Claim 6: Theorem 1 order
    th = r.get("theorem1/slope", {})
    if th:
        slope = th.get("loglog_slope")
        out.append(
            f"6. **Theorem 1 — T(Υ) = O(1/Υ²)**: measured log-log slope "
            f"{slope:.2f} ≤ 2.0 bound → "
            f"**{'CONFIRMED' if slope is not None and slope <= 2.2 else 'PARTIAL'}**.")

    # Claim 7: Fig 7 — distributiveness linear in participants
    fig7 = {k: v for k, v in r.items() if k.startswith("fig7/")}
    if fig7:
        out.append(
            "7. **Fig 7 — transfer volume linear in honest participants** "
            "(2 x model x participants x iters): reproduced analytically + "
            "the int8-sign variant cuts upstream bytes 4x (beyond-paper).")

    # Claim 8: privacy budget sweeps have an interior optimum
    t23 = defaultdict(dict)
    for k, v in r.items():
        if k.startswith("table23/"):
            _, ds, h, a = k.split("/")
            t23[(ds, h)][float(a[1:])] = v.get("rmse")
    notes = []
    for (ds, h), sweep in sorted(t23.items()):
        if len(sweep) >= 3:
            budgets = sorted(sweep)
            best = min(budgets, key=lambda b: sweep[b])
            interior = best != budgets[0] and best != budgets[-1]
            notes.append(f"{ds}/{h}: best a={best:g} "
                         f"({'interior' if interior else 'edge'})")
    if notes:
        out.append(
            f"8. **Tables II/III — accuracy is non-monotone in the privacy "
            f"budget** (paper: optimum at a≈40-50 Milano / 10-20 Trento): "
            f"{'; '.join(notes)}.")

    return "\n".join(out) + "\n"


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--append"]
    text = main(args[0] if args else "bench_output.txt")
    print(text)
    if "--append" in sys.argv:
        with open("EXPERIMENTS.md", "a") as f:
            f.write(text)
