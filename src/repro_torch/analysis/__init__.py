"""repro_torch.analysis — fedlint over the aten op log (the port of the
JAX package's ``analysis/``).

The round-path contracts (no dense (C, D) intermediate on the sparse
path, no (S_max, D) block in a streamed fold, no narrow accumulators,
distinct random streams, no host reads, no f64) as rules over the ops a
traced run records, with three exposures:

- :func:`verify` — lint any function over (possibly ``meta``) args;
- :func:`contract` — decorator gating round entry points behind
  ``REPRO_FEDLINT=1``;
- ``python -m repro_torch.analysis.cli`` — sweep the entry-point
  manifest.

This package root imports torch and numpy only; the manifest, which
imports the rounds, is loaded by the CLI.
"""
from repro_torch.analysis.rules import (
    DEFAULT_RULES,
    NARROW_DTYPES,
    AccumulationDtypeRule,
    F64LeakageRule,
    Finding,
    HostSyncRule,
    MemoryContractRule,
    RngDisciplineRule,
    Rule,
    RuleContext,
    default_rules,
)
from repro_torch.analysis.traversal import (
    Eqn,
    OpLog,
    Tracer,
    format_path,
)
from repro_torch.analysis.verify import (
    ENV_FLAG,
    ContractViolation,
    Report,
    apply_baseline,
    contract,
    lint_jaxpr,
    stand_ins,
    trace,
    verify,
)

__all__ = [
    "AccumulationDtypeRule",
    "ContractViolation",
    "DEFAULT_RULES",
    "ENV_FLAG",
    "Eqn",
    "F64LeakageRule",
    "Finding",
    "HostSyncRule",
    "MemoryContractRule",
    "NARROW_DTYPES",
    "OpLog",
    "Report",
    "RngDisciplineRule",
    "Rule",
    "RuleContext",
    "Tracer",
    "apply_baseline",
    "contract",
    "default_rules",
    "format_path",
    "lint_jaxpr",
    "stand_ins",
    "trace",
    "verify",
]
