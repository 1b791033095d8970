"""fedlint's entry points (the port of the JAX package's
``analysis/verify.py``): :func:`trace` runs a function under the op-log
tracer, :func:`lint_jaxpr` runs rules over a log (the reference's name,
kept), :func:`verify` does both, :func:`contract` wraps a round so the
check runs once per abstract signature when ``REPRO_FEDLINT=1``.

Baselines: a finding is suppressed by fingerprint with a written
justification (:func:`apply_baseline`); an entry that matches nothing is
reported as stale.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.analysis.rules import Finding, HostSyncRule, Rule, RuleContext
from repro_torch.analysis.traversal import OpLog, Tracer

ENV_FLAG = "REPRO_FEDLINT"


class ContractViolation(AssertionError):
    """A contract failed (an ``AssertionError``, as the reference's)."""

    def __init__(self, report: "Report"):
        self.report = report
        super().__init__("\n" + report.format_human())


@dataclasses.dataclass
class Report:
    """Findings for one linted entry.  ``aborted``: what stopped its trace
    (then the entry fails, whatever the rules found)."""
    name: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    suppressed: List[Tuple[Finding, str]] = dataclasses.field(
        default_factory=list)
    stale_baseline: List[str] = dataclasses.field(default_factory=list)
    n_eqns: int = 0
    aborted: str = ""

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors and not self.aborted

    def raise_if_failed(self) -> "Report":
        if not self.ok:
            raise ContractViolation(self)
        return self

    def format_human(self) -> str:
        lines = [f"== {self.name}: {len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s), "
                 f"{len(self.suppressed)} baselined "
                 f"({self.n_eqns} ops)"]
        if self.aborted:
            lines.append(f"  trace stopped at its last op: {self.aborted}")
        for f in self.findings:
            lines.append("  " + f.format().replace("\n", "\n  "))
        for f, reason in self.suppressed:
            lines.append(f"  baselined {f.rule} [{f.primitive}] at "
                         f"{f.path}: {reason}")
        for fp in self.stale_baseline:
            lines.append(f"  STALE baseline entry (no longer fires): {fp}")
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "n_eqns": self.n_eqns,
            "ok": self.ok,
            "aborted": self.aborted,
            "findings": [dataclasses.asdict(f) | {"fingerprint":
                                                  f.fingerprint}
                         for f in self.findings],
            "suppressed": [dataclasses.asdict(f)
                           | {"fingerprint": f.fingerprint,
                              "reason": reason}
                           for f, reason in self.suppressed],
            "stale_baseline": list(self.stale_baseline),
        }


def lint_jaxpr(log: OpLog, rules: Sequence[Rule],
               bindings: Optional[Mapping[str, int]] = None,
               name: str = "<ops>") -> Report:
    """Run ``rules`` over a traced run's op log (the reference lints a
    jaxpr here)."""
    report = Report(name=name, n_eqns=len(log.eqns), aborted=log.aborted)
    for rule in rules:
        ctx = RuleContext(bindings=dict(bindings or {}))
        report.findings.extend(rule.analyze(log, ctx))
    return report


def trace(fn: Callable, *args, **kwargs) -> OpLog:
    """Run ``fn(*args, **kwargs)`` under the tracer and return its op log.
    Give ``meta`` tensors for abstract shapes: nothing is allocated.  An
    op that reads a value the run cannot give (a host read of a ``meta``
    tensor) stops the run: the log ends at that op and says so in
    ``aborted``; any other exception is raised."""
    tracer = Tracer()
    try:
        with tracer:
            fn(*args, **kwargs)
    except (RuntimeError, NotImplementedError) as exc:
        last = tracer.log.eqns[-1] if tracer.log.eqns else None
        if last is None or not HostSyncRule().check(last, RuleContext()):
            raise
        tracer.log.aborted = f"{type(exc).__name__}: {exc}"
    return tracer.log


def verify(fn: Callable, *args, rules: Sequence[Rule],
           bindings: Optional[Mapping[str, int]] = None,
           name: Optional[str] = None, **kwargs) -> Report:
    """Trace ``fn`` and lint its op log.  Returns the :class:`Report`;
    ``.raise_if_failed()`` turns errors into a
    :class:`ContractViolation`."""
    return lint_jaxpr(trace(fn, *args, **kwargs), rules, bindings,
                      name=name or getattr(fn, "__name__", "<fn>"))


def apply_baseline(report: Report,
                   baseline: Mapping[str, str]) -> Report:
    """Move baselined findings (fingerprint -> justification) into
    ``report.suppressed``; record entries that no longer fire as stale."""
    remaining: List[Finding] = []
    hit = set()
    for f in report.findings:
        if f.fingerprint in baseline:
            report.suppressed.append((f, baseline[f.fingerprint]))
            hit.add(f.fingerprint)
        else:
            remaining.append(f)
    report.findings = remaining
    report.stale_baseline.extend(fp for fp in baseline if fp not in hit)
    return report


def contract_enabled(enabled: Optional[bool] = None) -> bool:
    if enabled is not None:
        return enabled
    return os.environ.get(ENV_FLAG, "") not in ("", "0", "false", "off")


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tensors(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def stand_ins(tree):
    """``tree`` with every tensor replaced by a ``meta`` tensor of its
    shape and dtype: a check on it allocates nothing and writes nothing
    the caller holds.  Host arrays and other values stay."""
    return _map_tensors(lambda t: torch.empty_like(t, device="meta"), tree)


def _abstract_signature(args, kwargs) -> Any:
    sig = []

    def note(x):
        if isinstance(x, torch.Tensor):
            sig.append(("t", tuple(x.shape), str(x.dtype), x.device.type))
        elif isinstance(x, np.ndarray):
            sig.append(("n", x.shape, str(x.dtype)))
        else:
            try:
                hash(x)
                sig.append(("s", x))
            except TypeError:
                sig.append(("r", repr(x)))
        return x

    def walk(tree):
        if isinstance(tree, dict):
            sig.append(("{", tuple(tree)))
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            sig.append(("(", type(tree).__name__, len(tree)))
            for v in tree:
                walk(v)
        else:
            note(tree)

    walk((args, kwargs))
    return tuple(sig)


def contract(*, rules: Union[Sequence[Rule],
                             Callable[[Mapping[str, int]], Sequence[Rule]]],
             bindings: Optional[Union[Mapping[str, int],
                                      Callable[..., Mapping[str, int]]]]
             = None,
             enabled: Optional[bool] = None,
             name: Optional[str] = None,
             host_args: Sequence[str] = ()) -> Callable:
    """Decorator: lint the wrapped function once per abstract signature
    before running it.

    Off by default (then a call costs one flag check and no dispatch
    mode); on with ``REPRO_FEDLINT=1`` or ``enabled=True``.  The check
    runs the function on :func:`stand_ins` of its arguments (``meta``
    tensors), so it allocates nothing and writes nothing the caller
    holds; the keyword arguments named in ``host_args``, which the
    function reads on the host (a round's rows), are given to it as host
    arrays instead (the port's addition: a stand-in has no values to
    read).  ``bindings`` may be a dict or a callable of the call's
    arguments, ``rules`` a callable of the bindings.
    ``wrapped.fedlint(*args, **kwargs)`` runs the check whatever the
    flag and returns the report."""

    def deco(fn: Callable) -> Callable:
        checked: Dict[Any, bool] = {}

        def run_check(args, kwargs) -> Report:
            b = (bindings(*args, **kwargs) if callable(bindings)
                 else dict(bindings or {}))
            rs = rules(b) if callable(rules) else rules
            kw = {k: (v.detach().cpu().numpy() if k in host_args
                      and isinstance(v, torch.Tensor) else v)
                  for k, v in kwargs.items()}
            return verify(fn, *stand_ins(args), rules=rs, bindings=b,
                          name=name or fn.__name__, **stand_ins(kw))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if contract_enabled(enabled):
                sig = _abstract_signature(args, kwargs)
                if sig not in checked:
                    run_check(args, kwargs).raise_if_failed()
                    checked[sig] = True
            return fn(*args, **kwargs)

        wrapper.fedlint = lambda *a, **k: run_check(a, k)
        return wrapper

    return deco
