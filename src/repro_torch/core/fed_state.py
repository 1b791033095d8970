"""Federated training state (the port of the JAX package's
``core/fed_state.py``).  Every per-client quantity carries a leading
client axis ``C``; trees are nested dicts in the reference's layout."""
from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.tree import (host_array, resolve_device, tree_leaves,
                              tree_map)


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


def params_from_numpy(params: Any, device=None) -> Any:
    """One model's (or a stack's) nested dict of numpy arrays -> tensors on
    ``device``, dtypes kept, layout kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), params)


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
        sq = sq + torch.sum(diff ** 2) / w_l.shape[0]
        n += z_l.numel()
    return sq / float(max(n, 1))
