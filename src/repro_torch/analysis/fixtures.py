"""Seeded-violation fixtures (the port of the JAX package's
``analysis/fixtures.py``): for every built-in rule, a deliberately broken
function it must catch, paired with a clean twin it must pass.  They run
in ``tests/test_torch_fedlint.py`` and in the CLI's ``--selftest``, so a
rule that stops catching its violation cannot land quietly.  All five
pairs run (the reference's f64 pair needs a jax switch that this jax no
longer has); each is traced on ``meta`` tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.analysis.rules import (
    AccumulationDtypeRule,
    F64LeakageRule,
    HostSyncRule,
    MemoryContractRule,
    RngDisciplineRule,
    Rule,
)

C_FIX = 4096      # fleet width for the memory-contract fixture
D_FIX = 64
S_FIX = 8
SEED = 1234


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# accumulation-dtype: the int8 sign-sum accumulator that wrapped at C >= 128
def int8_wrapping_sign_sum(payload: torch.Tensor) -> torch.Tensor:
    """BROKEN: folds int8 sign messages in an int8 accumulator.  |sum|
    can reach C, int8 stops at 127: past 127 messages the fold wraps."""
    acc = torch.zeros(payload.shape[1:], dtype=torch.int8,
                      device=payload.device)
    for j in range(payload.shape[0]):
        acc = acc + payload[j]                       # int8 + int8 -> int8
    return acc


def int32_sign_sum(payload: torch.Tensor) -> torch.Tensor:
    """CLEAN: widen each message, accumulate in int32."""
    acc = torch.zeros(payload.shape[1:], dtype=torch.int32,
                      device=payload.device)
    for j in range(payload.shape[0]):
        acc = acc + payload[j].to(torch.int32)
    return acc


# ---------------------------------------------------------------------------
# rng-discipline: one stream drawn for two leaves
def key_reusing_corrupt(w: torch.Tensor, b: torch.Tensor) -> tuple:
    """BROKEN: the gaussian attack payload of both leaves from two
    generators seeded alike: the 'random' corruption is the same stream
    twice, perfectly correlated across leaves."""
    gw = torch.Generator().manual_seed(SEED)
    gb = torch.Generator().manual_seed(SEED)
    nw = 10.0 * torch.randn(w.shape, generator=gw, device=w.device)
    nb = 10.0 * torch.randn(b.shape, generator=gb, device=b.device)
    return nw, nb


def fleet_indexed_corrupt(w: torch.Tensor, b: torch.Tensor) -> tuple:
    """CLEAN (the port's convention, ``privacy.RowGenerators``): one
    derived generator per (leaf, client id), same structure otherwise."""
    from repro_torch.core.privacy import RowGenerators

    rows = RowGenerators(SEED, 3, [0], "cpu")
    nw = 10.0 * torch.randn(w.shape, generator=rows.generator(0, leaf=0),
                            device=w.device)
    nb = 10.0 * torch.randn(b.shape, generator=rows.generator(0, leaf=1),
                            device=b.device)
    return nw, nb


# ---------------------------------------------------------------------------
# memory-contract: a densifying 'sparse' fold
def densifying_block_fold(W_all: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """BROKEN: folds an S-row active block by masking the full fleet
    state: a (C, D) intermediate, what the O(S) round forbids (at
    C = 1M a 4 GB allocation)."""
    mask = torch.zeros(W_all.shape[0], device=W_all.device)
    mask = mask.index_put((idx,), torch.ones((), device=W_all.device))
    return torch.sum(W_all * mask[:, None], dim=0)


def gathered_block_fold(W_all: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """CLEAN: gather the S active rows first; every intermediate after
    the gather is (S, D)."""
    return torch.sum(W_all.index_select(0, idx), dim=0)


# ---------------------------------------------------------------------------
# host-sync: a metric read inside the round
def chatty_round_step(z: torch.Tensor) -> torch.Tensor:
    """BROKEN: reads a metric on the host inside the step: every round
    waits for the card."""
    z2 = z * 0.5
    print(f"z mean = {float(z2.mean())}")
    return z2


def quiet_round_step(z: torch.Tensor) -> torch.Tensor:
    """CLEAN: returns the metric as a device value for the driver to
    read after the step."""
    z2 = z * 0.5
    return z2 + 0.0 * z2.mean()


# ---------------------------------------------------------------------------
# f64-leakage: a float64 numpy constant
def f64_promoting_step(z: torch.Tensor) -> torch.Tensor:
    """BROKEN: a float64 numpy array promotes the product to f64."""
    scale = torch.from_numpy(np.full(z.shape, 0.125)).to(z.device)
    return z * scale


def f32_step(z: torch.Tensor) -> torch.Tensor:
    """CLEAN: the constant in float32."""
    scale = torch.from_numpy(np.full(z.shape, 0.125, np.float32))
    return z * scale.to(z.device)


# ---------------------------------------------------------------------------
# fixture registry
@dataclasses.dataclass
class Fixture:
    name: str
    rule_id: str
    make_rule: Callable[[], Rule]
    bindings: Dict[str, int]
    trace_broken: Callable[[], object]   # () -> OpLog
    trace_clean: Callable[[], object]


def _mk(fn, make_args):
    """() -> the op log of ``fn`` on ``make_args()`` (meta tensors)."""
    def run():
        from repro_torch.analysis.verify import trace
        return trace(fn, *make_args())
    return run


FIXTURES: List[Fixture] = [
    Fixture(
        name="int8-accumulating-fold",
        rule_id="accumulation-dtype",
        make_rule=AccumulationDtypeRule,
        bindings={},
        trace_broken=_mk(int8_wrapping_sign_sum,
                         lambda: (_meta(256, D_FIX, dtype=torch.int8),)),
        trace_clean=_mk(int32_sign_sum,
                        lambda: (_meta(256, D_FIX, dtype=torch.int8),)),
    ),
    Fixture(
        name="key-reusing-corrupt",
        rule_id="rng-discipline",
        make_rule=RngDisciplineRule,
        bindings={},
        trace_broken=_mk(key_reusing_corrupt,
                         lambda: (_meta(D_FIX, 4), _meta(4))),
        trace_clean=_mk(fleet_indexed_corrupt,
                        lambda: (_meta(D_FIX, 4), _meta(4))),
    ),
    Fixture(
        name="densifying-block-fold",
        rule_id="memory-contract",
        make_rule=lambda: MemoryContractRule(
            "C", allow_primitives=("index_copy_", "index_put_"),
            min_inner_elems=3),
        bindings={"C": C_FIX},
        trace_broken=_mk(densifying_block_fold,
                         lambda: (_meta(C_FIX, D_FIX),
                                  _meta(S_FIX, dtype=torch.long))),
        trace_clean=_mk(gathered_block_fold,
                        lambda: (_meta(C_FIX, D_FIX),
                                 _meta(S_FIX, dtype=torch.long))),
    ),
    Fixture(
        name="chatty-round-step",
        rule_id="host-sync",
        make_rule=HostSyncRule,
        bindings={},
        trace_broken=_mk(chatty_round_step, lambda: (_meta(D_FIX),)),
        trace_clean=_mk(quiet_round_step, lambda: (_meta(D_FIX),)),
    ),
    Fixture(
        name="f64-promoting-step",
        rule_id="f64-leakage",
        make_rule=F64LeakageRule,
        bindings={},
        trace_broken=_mk(f64_promoting_step, lambda: (_meta(D_FIX),)),
        trace_clean=_mk(f32_step, lambda: (_meta(D_FIX),)),
    ),
]


def run_selftest() -> List[str]:
    """Check every fixture: the broken run must trip its rule, the clean
    twin must not.  Returns the failures (empty: healthy)."""
    from repro_torch.analysis.verify import lint_jaxpr
    problems: List[str] = []
    for fx in FIXTURES:
        broken = lint_jaxpr(fx.trace_broken(), [fx.make_rule()],
                            fx.bindings, name=f"{fx.name}/broken")
        if not [f for f in broken.findings if f.rule == fx.rule_id]:
            problems.append(
                f"{fx.name}: rule '{fx.rule_id}' MISSED its seeded "
                f"violation")
        clean = lint_jaxpr(fx.trace_clean(), [fx.make_rule()],
                           fx.bindings, name=f"{fx.name}/clean")
        false_pos = [f for f in clean.findings
                     if f.rule == fx.rule_id and f.severity == "error"]
        if false_pos or clean.aborted:
            problems.append(
                f"{fx.name}: rule '{fx.rule_id}' false-positives on the "
                f"clean twin: "
                + (false_pos[0].format() if false_pos else clean.aborted))
    return problems
