"""The fedlint entry-point manifest (the port of the JAX package's
``analysis/manifest.py``): every round and fold flavour the port ships,
under the reference's eight entry names, with the rules and dimension
bindings that govern it.  ``python -m repro_torch.analysis.cli`` sweeps
it; a new round variant goes in here.

Each entry builds its problem at the reference's sizes and traces it on
``device``: the card by default (``tree.resolve_device``: raises without
one), where the host reads the rule ``host-sync`` looks for are real
ones; ``"cpu"`` when asked for (a host read of a CPU value is no sync);
``"meta"`` for shapes alone (a host read stops the trace there).  The rows a round reads on the host
(``idx``, ``stale``, ``weight``) are host arrays, as ``FederatedRun``
feeds them.  The C = 1,000,000 entry is always traced on meta: it
allocates nothing.  Kept out of ``analysis/__init__``: it imports the rounds
(``core.bafdp`` imports the analyzer for its contract).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

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
from repro_torch.analysis.verify import trace
from repro_torch.tree import resolve_device


@dataclasses.dataclass
class Entry:
    name: str
    description: str
    make_rules: Callable[[], List[Rule]]
    bindings: Dict[str, int]
    trace: Callable[[], Any]          # () -> OpLog
    round: bool = False               # a whole round (fedlint_cuda's)


def _base_rules() -> List[Rule]:
    """The binding-free rules every entry gets."""
    return [AccumulationDtypeRule(), RngDisciplineRule(), HostSyncRule(),
            F64LeakageRule()]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _on(tree, device: str):
    """Every tensor of ``tree`` (a state, a batch) moved to ``device``:
    for ``meta``, stand-ins of their shapes."""
    from repro_torch.analysis.verify import _map_tensors

    if device == "meta":
        return _map_tensors(lambda t: torch.empty_like(t, device="meta"),
                            tree)
    return _map_tensors(lambda t: t.to(device), tree)


def _randn(g, *shape):
    return torch.randn(shape, generator=g)


# ---------------------------------------------------------------------------
# round-level entries (problems built on the CPU, then moved)
def _mlp_round_problem(fed, device):
    """The tests' small MLP problem: C = fed.n_clients clients of
    MLP_H1, 4 samples each."""
    from repro_torch.configs import MLP_H1
    from repro_torch.core.byzantine import byz_mask
    from repro_torch.core.fed_state import init_fed_state
    from repro_torch.core.privacy import gaussian_c3, perturb_inputs
    from repro_torch.models.forecasting import init_forecaster, mse_loss

    g = torch.Generator().manual_seed(0)
    state = init_fed_state(g, lambda k: init_forecaster(k, MLP_H1), fed,
                           device="cpu")
    X = _randn(g, fed.n_clients, 4, MLP_H1.d_x)
    Y = torch.sum(X[..., :3], -1, keepdim=True) * 0.5
    c3 = gaussian_c3(MLP_H1.d_x + MLP_H1.d_y, fed.dp_delta,
                     fed.dp_sensitivity)

    def local_loss(W, batch, gen, eps):
        x, y = batch
        return mse_loss(W, perturb_inputs(gen, x, eps, 0.02), y, MLP_H1)

    kw = dict(local_loss=local_loss, fed=fed, c3=c3, n_samples=200,
              d_dim=MLP_H1.d_x + MLP_H1.d_y)
    bm = byz_mask(fed.n_clients, fed.n_byzantine)
    return _on(state, device), _on((X, Y), device), _on(bm, device), kw


def _gen(device: str) -> torch.Generator:
    from repro_torch.tree import generator

    return generator(device).manual_seed(2)


def _trace_dense_round(scope: str, device: str):
    from repro_torch.configs import FedConfig
    from repro_torch.core import bafdp

    fed = FedConfig(n_clients=6, active_frac=0.5, consensus_scope=scope,
                    byzantine_frac=1 / 3, attack="gaussian",
                    staleness_decay="hinge",
                    staleness_compensation="taylor",
                    omega_optimizer="adam")
    state, batch, bm, kw = _mlp_round_problem(fed, device)
    return trace(lambda s, b, g, m: bafdp.bafdp_round(s, b, g, byz_mask=m,
                                                      **kw),
                 state, batch, _gen(device), bm)


def _tiny_problem(C, D, fed, bias=True):
    from repro_torch.core.fed_state import init_fed_state

    def init_tiny(g):
        p = {"w": 0.01 * torch.randn((D,), generator=g)}
        if bias:
            p["b"] = torch.zeros(())
        return p

    state = init_fed_state(torch.Generator().manual_seed(0), init_tiny, fed,
                           n_clients=C, device="cpu")

    def local_loss(W, batch, gen, eps):
        x, y = batch
        pred = torch.einsum("sbd,sd->sb", x, W["w"])
        if bias:
            pred = pred + W["b"][:, None]
        return torch.mean((pred - y) ** 2, dim=1)

    return state, local_loss


def _trace_sparse_round(device: str):
    from repro_torch.configs import FedConfig
    from repro_torch.core import bafdp
    from repro_torch.core.byzantine import byz_mask

    C, S, D = 64, 8, 16
    fed = FedConfig(n_clients=C, active_frac=S / C,
                    consensus_scope="active", byzantine_frac=0.25,
                    attack="gaussian", staleness_decay="poly",
                    staleness_compensation="taylor",
                    compensation_scale_mode="per_client",
                    omega_optimizer="sgd")
    state, local_loss = _tiny_problem(C, D, fed)
    g = torch.Generator().manual_seed(1)
    Xg = _randn(g, S, 4, D)
    Yg = torch.sum(Xg[..., :2], -1) * 0.3
    idx = np.asarray([5, 63, 17, 33, 0, 42, 7, 21], np.int32)
    stale = np.asarray([0, 3, 1, 0, 7, 0, 2, 0], np.float32)
    weight = np.ones((S,), np.float32)
    return trace(
        lambda s, b, k, m: bafdp.bafdp_round_sparse(
            s, b, k, local_loss=local_loss, fed=fed, c3=1.0,
            n_samples=100, d_dim=D, byz_mask=m, idx=idx, stale=stale,
            weight=weight),
        _on(state, device), _on((Xg, Yg), device), _gen(device),
        _on(byz_mask(C, fed.n_byzantine), device))


C_BIG = 1_000_000


def _trace_sparse_round_c1m(device: str = "meta"):
    """The C = 1M round from abstract shapes: the state's leaves (built
    as meta tensors of the fleet's shapes) and every fleet-width input are
    meta tensors, nothing O(C) is allocated; the rows are host arrays."""
    from repro_torch.configs import FedConfig
    from repro_torch.core import bafdp

    S, D = 8, 8
    fed = FedConfig(n_clients=C_BIG, active_frac=S / C_BIG,
                    consensus_scope="active", omega_optimizer="sgd")
    from repro_torch.core.fed_state import FedState

    _, local_loss = _tiny_problem(1, D, dataclasses.replace(fed,
                                                            n_clients=1))
    rows = {"b": _meta(C_BIG), "w": _meta(C_BIG, D)}
    state = FedState(
        W=rows, z={"b": _meta(), "w": _meta(D)},
        z_local={k: torch.empty_like(v) for k, v in rows.items()},
        phi={k: torch.empty_like(v) for k, v in rows.items()},
        lam=_meta(C_BIG), eps=_meta(C_BIG), t=_meta(dtype=torch.int32),
        opt=None, tau=_meta(C_BIG, dtype=torch.int32), comp=None)
    batch = (_meta(S, 4, D), _meta(S, 4))
    idx = np.arange(S, dtype=np.int32) * 997
    return trace(
        lambda s, b, k, m: bafdp.bafdp_round_sparse(
            s, b, k, local_loss=local_loss, fed=fed, c3=1.0,
            n_samples=100, d_dim=D, byz_mask=m, idx=idx,
            stale=np.zeros(S, np.float32), weight=np.ones(S, np.float32)),
        state, batch, _gen("meta"), _meta(C_BIG, dtype=torch.bool))


def _trace_streamed_round_int8(device: str):
    from repro_torch.configs import FedConfig
    from repro_torch.core import bafdp

    C, S, D = 64, 8, 512
    fed = FedConfig(n_clients=C, active_frac=S / C,
                    consensus_scope="active", omega_optimizer="sgd",
                    sign_message="int8", dual_message="int8",
                    consensus_streaming=True, consensus_chunk=3)
    state, local_loss = _tiny_problem(C, D, fed, bias=False)
    g = torch.Generator().manual_seed(1)
    Xg = _randn(g, S, 4, D)
    Yg = torch.sum(Xg[..., :2], -1) * 0.3
    return trace(
        lambda s, b, k, m: bafdp.bafdp_round_sparse(
            s, b, k, local_loss=local_loss, fed=fed, c3=1.0,
            n_samples=100, d_dim=D, byz_mask=m,
            idx=np.arange(S, dtype=np.int32)),
        _on(state, device), _on((Xg, Yg), device), _gen(device),
        _on(torch.zeros((C,), dtype=torch.bool), device))


# ---------------------------------------------------------------------------
# op-level entries (the Eq. 20 consensus dispatch and the streamed folds)
def _fold_inputs(S, D, device):
    g = torch.Generator().manual_seed(6)
    X = _randn(g, S, D)
    w = torch.rand((S,), generator=g)
    z = _randn(g, D)
    return _on((X, w, z), device)


def _trace_sign_consensus(message: str, streaming: bool, device: str):
    from repro_torch.kernels import ops as kops

    S, D = 16, 512
    X, w, z = _fold_inputs(S, D, device)
    phi = torch.zeros((D,), device=device)
    return trace(
        lambda z, X, p, w: kops.sign_consensus(
            z, X, p, w, 0.01, 0.01, message=message, impl="torch",
            n_total=64, streaming=streaming, chunk_size=4),
        z, X, phi, w)


def _trace_dual_fold_stream(device: str):
    from repro_torch.kernels import ref as kref

    S, D = 16, 256
    X, w, _ = _fold_inputs(S, D, device)
    return trace(lambda X, w: kref.fold_dual_rowsum(X, w, chunk_size=5),
                 X, w)


# ---------------------------------------------------------------------------
# the manifest
def build_manifest(device: Optional[str] = None) -> List[Entry]:
    """The eight entries, traced on ``device`` (the card unless asked for
    the CPU or meta) when called; the C = 1M round on meta whatever
    ``device``."""
    device = str(resolve_device(device))
    state_writes = ("index_copy_", "index_put_")
    return [
        Entry(
            name="dense-round-all",
            description="bafdp_round, consensus_scope='all' (seed "
                        "semantics): gaussian attack, hinge decay, taylor "
                        "compensation, adam",
            make_rules=_base_rules, bindings={}, round=True,
            trace=lambda: _trace_dense_round("all", device)),
        Entry(
            name="dense-round-active",
            description="bafdp_round, consensus_scope='active': the masked "
                        "full-width oracle that runs the sparse round over "
                        "every row (no C binding: the (C, D) block IS its "
                        "working set)",
            make_rules=_base_rules, bindings={}, round=True,
            trace=lambda: _trace_dense_round("active", device)),
        Entry(
            name="sparse-round",
            description="bafdp_round_sparse, C=64 S=8: gathered O(S) round "
                        "with per-client compensation scale + gaussian "
                        "attack",
            make_rules=lambda: _base_rules() + [MemoryContractRule(
                "C", allow_primitives=state_writes, min_inner_elems=3)],
            bindings={"C": 64}, round=True,
            trace=lambda: _trace_sparse_round(device)),
        Entry(
            name="sparse-round-c1m",
            description="bafdp_round_sparse at C=1,000,000 on meta tensors "
                        "(nothing allocated): the O(S) memory contract at "
                        "fleet scale",
            make_rules=lambda: _base_rules() + [MemoryContractRule(
                "C", allow_primitives=state_writes, min_inner_elems=3)],
            bindings={"C": C_BIG},
            trace=_trace_sparse_round_c1m),
        Entry(
            name="sparse-round-streamed-int8",
            description="streamed arrival-event round, both int8 wire "
                        "formats: no (S_max, D) int8 payload block and no "
                        "dense (C, D) intermediate",
            make_rules=lambda: _base_rules() + [
                MemoryContractRule("C", allow_primitives=state_writes,
                                   min_inner_elems=3),
                MemoryContractRule("S_max", dtypes=("int8",),
                                   min_inner_elems=512)],
            bindings={"C": 64, "S_max": 8}, round=True,
            trace=lambda: _trace_streamed_round_int8(device)),
        Entry(
            name="sign-consensus-f32",
            description="ops.sign_consensus materialized active-subset "
                        "fold, f32 wire (the plain version)",
            make_rules=_base_rules, bindings={},
            trace=lambda: _trace_sign_consensus("f32", False, device)),
        Entry(
            name="sign-consensus-streamed-int8",
            description="ops.sign_consensus streaming int8: the chunked "
                        "fold must hold no (S_max, D) block of ANY dtype",
            make_rules=lambda: _base_rules() + [MemoryContractRule(
                "S_max", min_inner_elems=512)],
            bindings={"S_max": 16},
            trace=lambda: _trace_sign_consensus("int8", True, device)),
        Entry(
            name="dual-fold-streamed-int8",
            description="ref.fold_dual_rowsum chunked: the Eq. 22 dual "
                        "decode exists one chunk at a time",
            make_rules=lambda: _base_rules() + [MemoryContractRule(
                "S_max", min_inner_elems=256)],
            bindings={"S_max": 16},
            trace=lambda: _trace_dual_fold_stream(device)),
    ]
