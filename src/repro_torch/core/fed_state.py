"""Federated training state (the port of the JAX package's
``core/fed_state.py``).  Every per-client quantity carries a leading
client axis ``C``; trees keep the reference's layout (nested dicts, and
an LM's ``unit`` tuple, ``repro_torch.tree``)."""
from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, FedConfig
from repro_torch.models import transformer as tr
from repro_torch.tree import (host_array, resolve_device,
                              tensor_from_numpy, tree_leaves, tree_map)


class FedState(NamedTuple):
    W: Any                 # stacked client params, leaves (C, ...)
    z: Any                 # consensus params, leaves (...)
    z_local: Any           # per-client last-received consensus (C, ...)
    phi: Any               # equality dual, leaves (C, ...)
    lam: torch.Tensor      # (C,) inequality dual (eps <= a)
    eps: torch.Tensor      # (C,) privacy levels
    t: torch.Tensor        # int32 scalar round counter
    opt: Any               # Adam {"m", "v", "count"} or None
    tau: torch.Tensor      # (C,) int32 last-participation round
    comp: Any = None       # per-client EWMA of the update direction
                           # (Taylor compensation), or None


def init_fed_state(gen: torch.Generator, init_params: Callable[[Any], Any],
                   fed: FedConfig, n_clients: Optional[int] = None,
                   device=None) -> FedState:
    """``init_params(gen) -> params`` builds one client's model on
    ``device``; the C clients draw from ``gen`` in turn.  The consensus
    starts at client 0's params, as in the reference."""
    dev = resolve_device(device)
    C = n_clients or fed.n_clients
    clients = [init_params(gen) for _ in range(C)]
    W = tree_map(lambda *ls: torch.stack(ls).to(dev), *clients)
    z = tree_map(lambda l: l[0].clone(), W)
    z_local = tree_map(lambda l: l[None].expand((C,) + l.shape).clone(), z)
    phi = tree_map(torch.zeros_like, W)
    lam = torch.zeros((C,), dtype=torch.float32, device=dev)
    eps = torch.full((C,), max(fed.privacy_budget_a * fed.eps_init_frac,
                               fed.eps_min), dtype=torch.float32, device=dev)
    opt = None
    if fed.omega_optimizer == "adam":
        opt = {"m": tree_map(torch.zeros_like, W),
               "v": tree_map(torch.zeros_like, W),
               "count": torch.zeros((C,), dtype=torch.int32, device=dev)}
    comp = None
    if fed.staleness_compensation != "none":
        comp = tree_map(torch.zeros_like, W)
    return FedState(W=W, z=z, z_local=z_local, phi=phi, lam=lam, eps=eps,
                    t=torch.zeros((), dtype=torch.int32, device=dev),
                    opt=opt, tau=torch.zeros((C,), dtype=torch.int32,
                                             device=dev),
                    comp=comp)


def init_lm_tree(gen: torch.Generator, cfg: ArchConfig,
                 device=None) -> Any:
    """One client's LM (``transformer.init_lm``, drawn from ``gen``) in
    the reference's ``init_lm`` tree layout (``transformer.lm_tree``) on
    ``device``: what :func:`init_fed_state`'s ``init_params`` returns for
    an LM, and what ``transformer.lm_view`` reads one row of."""
    return tr.lm_tree(tr.init_lm(gen, cfg, device), cfg)


def params_from_numpy(params: Any, device=None) -> Any:
    """One model's (or a stack's) nested dict of numpy arrays -> tensors on
    ``device``, dtypes kept (bf16 too), layout kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), params)


def fed_state_from_numpy(arrays: Mapping[str, Any], device=None) -> FedState:
    """The reference's ``FedState`` given as numpy arrays (a mapping of
    its fields: ``W``, ``z``, ``z_local``, ``phi``, ``lam``, ``eps``,
    ``t``, ``tau``, ``opt`` = ``{"m", "v", "count"}`` or None, ``comp``
    or None) -> the port's state on ``device``."""
    dev = resolve_device(device)
    missing = [f for f in FedState._fields
               if f not in ("opt", "comp") and arrays.get(f) is None]
    if missing:
        raise ValueError(f"FedState arrays missing {missing}")

    def conv(tree):
        return None if tree is None else params_from_numpy(tree, dev)

    return FedState(**{name: conv(arrays.get(name))
                       for name in FedState._fields})


def baseline_state_from_numpy(arrays: Mapping[str, Any],
                              device=None) -> dict:
    """The reference's ``BaselineTrainer`` state as numpy arrays (a
    mapping: ``server`` params, ``t``, and per method ``p``, ``quasi``,
    ``tau``) -> the port's dict state on ``device``, dtypes and layout
    kept."""
    dev = resolve_device(device)
    missing = [f for f in ("server", "t") if arrays.get(f) is None]
    if missing:
        raise ValueError(f"baseline state arrays missing {missing}")
    known = ("server", "t", "p", "quasi", "tau")
    unknown = sorted(set(arrays) - set(known))
    if unknown:
        raise ValueError(f"unknown baseline state fields {unknown}")
    return {k: params_from_numpy(arrays[k], dev) for k in known
            if arrays.get(k) is not None}


def gather_clients(tree: Any, idx: torch.Tensor) -> Any:
    """Rows ``idx`` of every (C, ...) leaf as an (S, ...) block.  Indices
    past either end clip to the first or last row, like the reference's
    ``take(mode="clip")``: the padding sentinel ``C`` reads row ``C - 1``,
    so padding rows must be neutralized downstream (weight 0 in every
    reduction, never written back)."""
    def take(l):
        i = torch.clamp(idx.to(l.device, torch.long), 0, l.shape[0] - 1)
        return l.index_select(0, i)

    return tree_map(take, tree)


def scatter_clients(tree: Any, idx: Any, updates: Any) -> Any:
    """Write an (S, ...) block of rows back into the (C, ...) leaves IN
    PLACE, at rows ``idx`` (a numpy array or tensor), cast to each leaf's
    dtype; returns ``tree``, whose leaves now hold the new rows.  Rows whose
    index lies outside ``[0, C)`` (the padding sentinel ``C``) are dropped
    before the copy: ``index_copy_`` has no drop mode.  The in-bounds
    indices must be distinct (``index_copy_`` applies repeated indices in
    no fixed order on CUDA); the active-subset round keeps only each
    client's last delivery.

    Writing into the resident stack is what keeps the round O(S) in
    memory, as XLA's buffer donation does for the reference; a functional
    copy would allocate a (C, ...) tree every round."""
    ids = host_array(idx).astype(np.int64).reshape(-1)
    leaf0 = tree_leaves(tree)[0]
    keep = np.flatnonzero((ids >= 0) & (ids < leaf0.shape[0]))
    if keep.size == 0:
        return tree
    dev = leaf0.device
    rows = None if keep.size == ids.size \
        else torch.from_numpy(keep).to(dev)
    at = torch.from_numpy(ids[keep]).to(dev)

    def put(l, u):
        if rows is not None:
            u = u.index_select(0, rows.to(u.device))
        l.index_copy_(0, at, u.to(l.device, l.dtype).contiguous())
        return l

    return tree_map(put, tree, updates)


def consensus_gap(state: FedState) -> torch.Tensor:
    """mean_i ||z - w_i||^2 / D — convergence diagnostic."""
    sq = torch.zeros((), dtype=torch.float32, device=state.eps.device)
    n = 0
    for z_l, w_l in zip(tree_leaves(state.z), tree_leaves(state.W)):
        diff = z_l[None].float() - w_l.float()
        sq = sq + torch.sum(diff.pow_(2)) / w_l.shape[0]   # one buffer
        n += z_l.numel()
    return sq / float(max(n, 1))
