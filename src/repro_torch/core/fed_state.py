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


def consensus_gap(state: FedState, ranks=None) -> torch.Tensor:
    """mean_i ||z - w_i||^2 / D — convergence diagnostic.  ``ranks``: a
    split round's ``data_parallel.RankBlock`` (``state`` holds its rows):
    the local sum of squares, all-reduced over ``"data"``, over the
    fleet's C."""
    from repro_torch.distributed.data_parallel import is_split

    sq = torch.zeros((), dtype=torch.float32, device=state.eps.device)
    n = 0
    split = is_split(ranks)
    for z_l, w_l in zip(tree_leaves(state.z), tree_leaves(state.W)):
        diff = z_l[None].float() - w_l.float()
        if split:
            sq = sq + torch.sum(diff.pow_(2))
        else:
            sq = sq + torch.sum(diff.pow_(2)) / w_l.shape[0]   # one buffer
        n += z_l.numel()
    if split:
        from repro_torch.distributed.collectives import all_reduce_sum
        from repro_torch.kernels.ref import true_div

        sq = true_div(all_reduce_sum(sq, ranks.data), ranks.n_clients)
    return sq / float(max(n, 1))


# the per-client fields of a FedState: a leading (C, ...) axis
CLIENT_FIELDS = ("W", "z_local", "phi", "lam", "eps", "tau", "opt", "comp")


def shard_clients(state: FedState, ranks) -> FedState:
    """This rank's clients of a whole state (``ranks``: a
    ``data_parallel.RankBlock``): rows ``[c0, c1)`` of every per-client
    leaf as storage of their own (a copy: the caller then drops the whole
    state, and no rank holds the fleet's (C, ...) leaves), ``z`` and ``t``
    as they are.  At one rank the state itself (no copy)."""
    from repro_torch.distributed.data_parallel import is_split

    if not is_split(ranks):
        return state
    sl = ranks.clients()
    return state._replace(**{
        f: None if getattr(state, f) is None
        else tree_map(lambda l: l[sl].clone(), getattr(state, f))
        for f in CLIENT_FIELDS})


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bit pattern as int32 (sums of one pattern and zeros are
    exact)."""
    if t.dtype in (torch.float32, torch.int32):
        return t.contiguous().view(torch.int32)
    if t.dtype in (torch.bfloat16, torch.float16, torch.int16):
        return t.contiguous().view(torch.int16).to(torch.int32)
    if t.dtype in (torch.int8, torch.uint8, torch.bool):
        return t.contiguous().view(torch.uint8).to(torch.int32)
    raise TypeError(f"no bit view of {t.dtype}")


def _from_bits(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype in (torch.float32, torch.int32):
        return b.view(dtype)
    if dtype in (torch.bfloat16, torch.float16, torch.int16):
        return b.to(torch.int16).view(dtype)
    return b.to(torch.uint8).view(dtype)


def whole_rows(tree: Any, ranks) -> Any:
    """A tree of this rank's (C_r, ...) client rows as the fleet's
    (C, ...), on every rank: the rows placed at ``[c0, c1)`` of zeros and
    summed over the ``"data"`` ranks (gloo has no ``all_gather`` of CUDA
    tensors).  The sum runs on the bit patterns, one rank's and the
    others' zeros, so the result is the shards' bits exactly (-0.0 and
    NaN included)."""
    from repro_torch.distributed.collectives import all_reduce_sum

    C, sl = ranks.n_clients, ranks.clients()

    def whole(l):
        b = torch.zeros((C,) + tuple(l.shape[1:]), dtype=torch.int32,
                        device=l.device)
        b[sl] = _bits(l)
        return _from_bits(all_reduce_sum(b, ranks.data), l.dtype)

    return tree_map(whole, tree)


def unshard_clients(state: FedState, ranks) -> FedState:
    """The inverse of :func:`shard_clients`, on every rank: every
    per-client leaf whole (:func:`whole_rows`), for evaluation and
    checkpoints.  At one rank the state itself."""
    from repro_torch.distributed.data_parallel import is_split

    if not is_split(ranks):
        return state
    return state._replace(**{
        f: None if getattr(state, f) is None
        else whole_rows(getattr(state, f), ranks) for f in CLIENT_FIELDS})
