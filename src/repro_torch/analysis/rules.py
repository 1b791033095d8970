"""fedlint's rules over the op log (the port of the JAX package's
``analysis/rules.py``): ``Rule.check(eqn, ctx) -> [Finding]`` and the five
built-in rules, with the reference's ids, severities and fingerprints
(``rule|primitive|path|detail``).

``memory-contract``
    No op output whose leading dim is a bound dimension symbol (``C``,
    ``S_max``) with a non-trivial inner size: no dense (C, D) intermediate
    on the sparse path, no (S_max, D) block in a streamed fold.  Views
    allocate nothing and are skipped; the sanctioned producers are the
    sparse round's in-place state writes (``index_copy_``,
    ``index_put_``).
``accumulation-dtype``
    No reduction or product accumulating in int8, uint8, f16 or bf16, and
    no narrow loop carry: an in-place add into one narrow storage
    repeated, or a chain of narrow adds each feeding the next (the
    pre-fix int8 sign sum that wrapped at C >= 128).
``rng-discipline``
    "One key consumed twice" is two ``torch.Generator`` s seeded alike
    and both drawn from (their streams are the same stream); "duplicate
    ``fold_in``" is one seed tuple of ``privacy.RowGenerators`` derived
    twice and drawn from twice.
``host-sync``
    No read of a device value on the host inside a round:
    ``_local_scalar_dense`` (``.item()``, ``float(t)``), ``nonzero``,
    ``masked_select``, ``equal``, ``is_nonzero``, a copy from the device
    to the CPU.  On ``meta`` these raise: the trace stops at that op,
    which this rule then reports; no value is made up.
``f64-leakage``
    No float64 / complex128 values (``torch.from_numpy`` of a float64
    array promotes everything it touches).

Rules read the op log only; they run nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.analysis.traversal import (DRAW, Eqn, OpLog,
                                           format_path)

# dtypes that are wire/storage formats, never safe accumulators
NARROW_DTYPES = ("int8", "uint8", "float16", "bfloat16")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, locatable and baseline-able."""
    rule: str                 # rule id, e.g. "memory-contract"
    severity: str             # "error" | "warning"
    message: str              # human sentence
    path: str                 # the op's path (traversal.format_path)
    primitive: str            # offending op ("" for global)
    detail: str = ""          # stable specifics (shape/dtype/seed)
    hint: str = ""            # how to fix it

    @property
    def fingerprint(self) -> str:
        """Stable identity used by the baseline file: path and primitive
        pin the location, ``detail`` the shape/dtype, so a new violation
        at an old location is not absorbed."""
        return f"{self.rule}|{self.primitive}|{self.path}|{self.detail}"

    def format(self) -> str:
        loc = f" at {self.path}" if self.path else ""
        prim = f" [{self.primitive}]" if self.primitive else ""
        hint = f"\n      hint: {self.hint}" if self.hint else ""
        det = f" ({self.detail})" if self.detail else ""
        return (f"{self.severity.upper():7s} {self.rule}{prim}{loc}: "
                f"{self.message}{det}{hint}")


@dataclasses.dataclass
class RuleContext:
    """``bindings`` maps dimension symbols to this entry's sizes (e.g.
    ``{"C": 1_000_000}``); ``path`` is the current op's path."""
    bindings: Mapping[str, int] = dataclasses.field(default_factory=dict)
    path: Tuple[str, ...] = ()

    def dim(self, symbol: str) -> Optional[int]:
        v = self.bindings.get(symbol)
        return int(v) if v is not None else None


class Rule:
    """Base rule: implement ``check(eqn, ctx)`` (called for every op) or
    override ``analyze`` for a rule over the whole log."""
    rule_id: str = "rule"
    severity: str = "error"
    hint: str = ""

    def analyze(self, log: OpLog, ctx: RuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for eqn in log.eqns:
            ctx.path = eqn.path
            findings.extend(self.check(eqn, ctx))
        return findings

    def check(self, eqn: Eqn, ctx: RuleContext) -> List[Finding]:
        return []

    def finding(self, ctx: RuleContext, message: str, *, primitive: str = "",
                detail: str = "", severity: Optional[str] = None,
                path: Optional[str] = None) -> Finding:
        return Finding(rule=self.rule_id,
                       severity=severity or self.severity,
                       message=message,
                       path=format_path(ctx.path) if path is None else path,
                       primitive=primitive, detail=detail, hint=self.hint)


def _itemsize(dtype: str) -> int:
    import torch

    return getattr(torch, dtype).itemsize


# ---------------------------------------------------------------------------
class MemoryContractRule(Rule):
    """No op output of shape ``(dim, inner...)`` with ``prod(inner) >=
    min_inner_elems``, ``dim`` a symbol bound in the context.
    ``allow_primitives`` exempts the sanctioned producers, ``dtypes``
    restricts the rule to some dtypes, ``max_bytes`` adds a per-output
    byte budget that needs no binding.  An unbound ``dim`` skips the
    dimension check.  Views allocate nothing and are skipped."""
    rule_id = "memory-contract"
    hint = ("gather the S active rows before computing (fed_state."
            "gather_clients) and write results back in place "
            "(scatter_clients); never materialize the full fleet-width "
            "intermediate")

    def __init__(self, dim: str, *, allow_primitives: Sequence[str] = (),
                 min_inner_elems: int = 1,
                 dtypes: Optional[Sequence[str]] = None,
                 max_bytes: Optional[int] = None,
                 severity: str = "error"):
        self.dim = dim
        self.allow = frozenset(allow_primitives)
        self.min_inner = int(min_inner_elems)
        self.dtypes = frozenset(dtypes) if dtypes is not None else None
        self.max_bytes = max_bytes
        self.severity = severity

    def check(self, eqn: Eqn, ctx: RuleContext) -> List[Finding]:
        if eqn.is_view or eqn.primitive in self.allow:
            return []
        bound = ctx.dim(self.dim)
        findings: List[Finding] = []
        for shape, dt in eqn.outs:
            if not shape:
                continue
            detail = f"shape={tuple(shape)} dtype={dt}"
            if (bound is not None and len(shape) >= 2 and shape[0] == bound
                    and math.prod(shape[1:]) >= self.min_inner
                    and (self.dtypes is None or dt in self.dtypes)):
                findings.append(self.finding(
                    ctx, f"({self.dim}, ...) intermediate materialized "
                         f"({self.dim}={bound})",
                    primitive=eqn.primitive, detail=detail))
            nbytes = math.prod(shape) * _itemsize(dt)
            if self.max_bytes is not None and nbytes > self.max_bytes:
                findings.append(self.finding(
                    ctx, f"output exceeds the {self.max_bytes}-byte "
                         f"budget ({nbytes} bytes)",
                    primitive=eqn.primitive, detail=detail))
        return findings


# ---------------------------------------------------------------------------
class AccumulationDtypeRule(Rule):
    """No reduction or product with a narrow output, and no narrow loop
    carry (in place: one narrow storage added into twice or more; out of
    place: a chain of three or more narrow adds, each reading the one
    before).  A narrow value added once, or carried without arithmetic,
    is not flagged."""
    rule_id = "accumulation-dtype"
    hint = ("accumulate in int32/float32 and convert to the wire dtype "
            "only at the encode boundary (see kernels/ref.int8_sign_sum)")

    REDUCE_PRIMS = frozenset((
        "sum", "nansum", "prod", "cumsum", "cumprod", "mean", "mm", "bmm",
        "addmm", "baddbmm", "dot", "mv", "addmv", "matmul", "einsum",
    ))
    ARITH_PRIMS = frozenset(("add", "sub", "mul", "add_", "sub_", "mul_",
                             "rsub"))
    CHAIN = 3

    def __init__(self, narrow: Sequence[str] = NARROW_DTYPES):
        self.narrow = frozenset(narrow)

    def analyze(self, log: OpLog, ctx: RuleContext) -> List[Finding]:
        findings: List[Finding] = []
        depth: Dict[int, int] = {}        # value number -> chain length
        inplace: Dict[int, int] = {}      # value number -> narrow adds into it
        flagged = set()
        for eqn in log.eqns:
            ctx.path = eqn.path
            narrow = [dt for _, dt in eqn.outs if dt in self.narrow]
            if eqn.primitive in self.REDUCE_PRIMS and narrow:
                for shape, dt in eqn.outs:
                    findings.append(self.finding(
                        ctx, f"reduction accumulates in the wire dtype {dt}",
                        primitive=eqn.primitive,
                        detail=f"shape={tuple(shape)} dtype={dt}"))
            if eqn.primitive not in self.ARITH_PRIMS or not narrow:
                continue
            dt = narrow[0]
            if eqn.is_inplace:
                vn = eqn.out_vns[0]
                inplace[vn] = inplace.get(vn, 0) + 1
                hit = inplace[vn] >= 2
            else:
                d = 1 + max((depth.get(v, 0) for v in eqn.in_vns), default=0)
                for v in eqn.out_vns:
                    depth[v] = d
                hit = d >= self.CHAIN
            key = (eqn.path, eqn.primitive, dt)
            if hit and key not in flagged:
                flagged.add(key)
                findings.append(self.finding(
                    ctx, f"loop carries a {dt} accumulator updated by "
                         f"'{eqn.primitive}': wraps/rounds silently (the "
                         f"int8 sign-sum class)",
                    primitive=eqn.primitive,
                    detail=f"carry_dtype={dt} via {eqn.primitive}"))
        return findings


# ---------------------------------------------------------------------------
class RngDisciplineRule(Rule):
    """Every stream drawn from must be a distinct one.

    * Two distinct ``torch.Generator`` objects with one seed on one
      device, each drawn from: ERROR, the streams are one stream (the
      counterpart of one key consumed by two bit-generating ops).  One
      ``privacy.RowGenerators`` seed tuple derived twice (the counterpart
      of a duplicate ``fold_in``) is this case: both generators carry the
      same mixed seed.
    * Generators derived from distinct seed tuples (per leaf, per client
      id) are clean, as is one generator drawn from many times (its
      stream advances).
    """
    rule_id = "rng-discipline"
    hint = ("derive one generator per consumer: privacy.RowGenerators "
            "with a distinct (seed, stream, leaf, client id) per use, or "
            "one generator drawn from in turn")

    def analyze(self, log: OpLog, ctx: RuleContext) -> List[Finding]:
        drawn: Dict[Tuple[str, int], Dict[int, str]] = {}
        for eqn in log.eqns:
            if eqn.generator is not None and eqn.primitive.startswith(DRAW):
                dev, seed, gid = eqn.generator
                drawn.setdefault((dev, seed), {}).setdefault(
                    gid, format_path(eqn.path))
        return [Finding(
            rule=self.rule_id, severity="error",
            message=f"{len(gens)} generators seeded alike on {dev} and "
                    "drawn from: the streams overlap",
            path=list(gens.values())[1], primitive="random",
            detail=f"seed={seed}", hint=self.hint)
            for (dev, seed), gens in drawn.items() if len(gens) >= 2]


# ---------------------------------------------------------------------------
class HostSyncRule(Rule):
    """No read of a device value on the host: a value on the card, or on
    ``meta``, which stands for it (a CPU tensor read on the CPU is no
    sync)."""
    rule_id = "host-sync"
    hint = ("keep metrics as device values and read them after the round; "
            "feed host-side rows (idx, stale, weight) as host arrays")

    SYNC_PRIMS = frozenset(("_local_scalar_dense", "nonzero",
                            "masked_select", "equal", "is_nonzero"))
    COPY_PRIMS = frozenset(("_to_copy", "copy_", "to", "_copy_from"))

    DEVICES = frozenset(("cuda", "meta"))

    def __init__(self, allow: Sequence[str] = ()):
        self.allow = frozenset(allow)

    def check(self, eqn: Eqn, ctx: RuleContext) -> List[Finding]:
        prim = eqn.primitive
        if prim in self.allow:
            return []
        on_device = [i for i, d in enumerate(eqn.in_devices)
                     if d in self.DEVICES]
        if not on_device:
            return []
        sync = prim in self.SYNC_PRIMS
        if prim in self.COPY_PRIMS:
            # a copy whose result lands on the CPU (an aborted copy has no
            # output: it is the op the trace stopped at)
            sync = "cpu" in eqn.out_devices or not eqn.outs
        if not sync:
            return []
        shape, dt = eqn.in_shapes[on_device[0]]
        return [self.finding(
            ctx, "device value read on the host inside a round",
            primitive=prim, detail=f"shape={tuple(shape)} dtype={dt}")]


# ---------------------------------------------------------------------------
class F64LeakageRule(Rule):
    """No float64/complex128 op outputs (a stray f64 doubles the wire and
    memory cost of what it touches; the card's f64 rate is far below)."""
    rule_id = "f64-leakage"
    hint = ("keep numpy arrays and literals in float32 "
            "(np.asarray(x, np.float32)) at the boundary")

    WIDE = frozenset(("float64", "complex128"))

    def check(self, eqn: Eqn, ctx: RuleContext) -> List[Finding]:
        return [self.finding(
            ctx, f"{dt} value", primitive=eqn.primitive,
            detail=f"shape={tuple(shape)} dtype={dt}")
            for shape, dt in eqn.outs if dt in self.WIDE]


DEFAULT_RULES = (AccumulationDtypeRule, RngDisciplineRule, HostSyncRule,
                 F64LeakageRule)


def default_rules() -> List[Rule]:
    """The binding-free built-ins (memory-contract needs a dimension
    symbol, so it is always constructed explicitly)."""
    return [cls() for cls in DEFAULT_RULES]
