"""Mixture-of-Experts FFN with top-k token-choice routing (the port of the
JAX package's ``models/moe.py``).

Two forms, picked by ``cfg.moe_impl`` as in the reference:

* ``"scatter"`` (:func:`moe_ffn`, the configs' default): capacity-bounded
  scatter dispatch into an (E * C, d) buffer, the experts as batched
  products over (E, C, d), a gather back and the gated sum over the k
  slots;
* ``"einsum"`` (:func:`moe_ffn_einsum`): the GShard grouped form, tokens
  in groups of ``GROUP_SIZE``, dispatch and combine as one-hot einsums.

Both route alike (:func:`route`): f32 router logits, softmax, top-k,
the top-k weights renormalised (floor 1e-9); each (token, slot) takes the
next position in its expert in token-major, slot-minor order over the
call's tokens, or within each group (the reference's exclusive one-hot
cumsum; here a stable sort, :func:`positions`), and a slot at or past the
capacity is dropped.  Both return the Switch
load-balance loss plus the router z-loss, ``0.01 lb + 0.001 zloss``.

The reference computes all of this in plain XLA, outside any Pallas
kernel, so the port keeps it in PyTorch (``torch.bmm``, ``torch.einsum``,
gathers) and launches no kernel of its own.  Dtype rules are the
reference's: routing in f32, the dispatch, experts and combine in the
activation's dtype with the f32 weights cast per call; the gate weights
are cast to that dtype before the product, and the k slots are summed in
f32 and rounded once (jax lowers its bf16 ``sum`` so).

The dispatch writes each kept (token, slot) into its own row of the
buffer and every dropped one into a trash row past the E * C rows, which
nothing reads: no scatter-add, so a bf16 buffer sees no rounding and no
atomic order.

``moe_group_shard`` pins the einsum form's token groups to the
``"model"`` mesh axis (the reference's ``with_sharding_constraint``): in
one program (no ``ranks``, whatever the ambient mesh) that changes no
value; under ``ranks`` each ``"model"`` rank computes its contiguous
block of the groups (:func:`moe_ffn_einsum`).  The scatter form does not
read it, as in the reference.

**Tensor-parallel serving** (``ranks=``, ``distributed/tensor_parallel.py``):
each product reads its leaf's spec.  The router is gathered at use, so
every rank routes exactly as world 1 does (a row-parallel f32 sum of the
logits would regroup them, flip a ``top_k`` at a near-tie and, through
the call's capacity positions, every later token's drops).  Expert
leaves split on E (**expert-parallel**): the rank dispatches, runs and
combines only its experts' slots, the gated sum over the k slots in f32,
zero for the others; leaves split on ``d_ff`` (**d_ff-parallel**: the
plan's choice where "model" does not divide E): the whole dispatch on
every rank, its column block of ``w_gate``/``w_up``, its partial of
``w_down`` combined in f32.  Either way the rank's y is summed over
``"model"`` in f32 and rounded once (the rule of every row-parallel
term): one (T, d) all-reduce a layer besides the router's gather.  y
is what travels, not the experts' outputs ye: ye holds E * C >= k * T
rows (Granite's prefill of 4 x 4,096: 40 x 4,096 slots, ~0.5 GB a layer
in bf16) where y holds T (~0.1 GB in f32).  Rows split over ``"data"``
keep world 1's routing too: capacity from the whole call's tokens, and
each (token, slot)'s position offset by the pairs the ``"data"`` ranks
before it routed to its expert in its group (their counts, gathered).

When ``torch.profiler`` is on, the work is labelled ``moe.route``,
``moe.dispatch``, ``moe.cast``, ``moe.experts`` and ``moe.combine``
(``profile_serve`` sums the device time under each).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.layers import dense_init, dtype_of, gate_act
from repro_torch.models.layers import span as _span

GROUP_SIZE = 512
SPANS = ("moe.route", "moe.dispatch", "moe.cast", "moe.experts",
         "moe.combine")


def init_moe(gen: torch.Generator, cfg: ArchConfig):
    """``router`` (d, E) f32; ``w_gate``/``w_up`` (E, d, f) and ``w_down``
    (E, f, d) in ``param_dtype``, each drawn from ``gen`` in that order."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    dt = dtype_of(cfg.param_dtype)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "router": dense_init(gen, (d, e), dtype=torch.float32),
        "w_gate": dense_init(gen, (e, d, f), in_axis=1, dtype=dt),
        "w_up": dense_init(gen, (e, d, f), in_axis=1, dtype=dt),
        "w_down": dense_init(gen, (e, f, d), in_axis=1, dtype=dt),
    }


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for a call over ``n_tokens`` tokens: the
    reference's arithmetic, padded to a multiple of 8 (at least 8)."""
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def einsum_groups(n_tokens: int, cfg: ArchConfig) -> Tuple[int, int, int]:
    """(groups G, group size gs, slots per expert in a group Cg) of the
    einsum form over ``n_tokens`` tokens; raises unless gs divides them."""
    m = cfg.moe
    gs = min(GROUP_SIZE, n_tokens)
    if n_tokens % gs:
        raise ValueError(f"moe_ffn_einsum: {n_tokens} tokens are not a "
                         f"multiple of the group size {gs}")
    cg = max(8, int(math.ceil(gs * m.top_k / m.n_experts
                              * m.capacity_factor) + 7) // 8 * 8)
    return n_tokens // gs, gs, cg


class Routing(NamedTuple):
    """One call's routing over N tokens in token order."""
    logits: torch.Tensor     # (N, E) f32 router logits
    probs: torch.Tensor      # (N, E) f32 softmax
    weights: torch.Tensor    # (N, k) f32 top-k weights, renormalised
    idx: torch.Tensor        # (N, k) int64 experts, by falling probability
    pos: torch.Tensor        # (N, k) int64 position in the expert
    keep: torch.Tensor       # (N, k) bool: pos < capacity
    # (N, k) int64 pairs of the "data" ranks before this one in pos, or
    # None (none: world 1, or this rank's tokens fill whole groups)
    before: Optional[torch.Tensor] = None


def token_range(ranks, B: int, S: int) -> Tuple[int, int]:
    """(the first token, the whole call's tokens) of this rank's B rows of
    S tokens in the call's token order: ``(0, B * S)`` unless the rows
    are split over ``"data"``."""
    if ranks is None or ranks.data.size == 1:
        return 0, B * S
    return ranks.c0 * S, ranks.n_clients * S


def route(params, xf: torch.Tensor, cfg: ArchConfig, cap: int,
          group: int, ranks=None, t0: int = 0) -> Routing:
    """Route the tokens ``xf`` (N, d): positions count within each run of
    ``group`` tokens (the call's tokens for the scatter form, the group
    size for the einsum form), token-major and slot-minor; ``keep`` is
    pos < ``cap``.  ``ranks``: the router gathered at use; ``xf`` the
    call's tokens from token ``t0`` on (a ``"data"`` rank's rows), their
    positions counted after the pairs of the ranks before it."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    router = tp.gather_leaf(params["router"], tp.spec(ranks, "router"),
                            ranks)
    logits = xf.float() @ router
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    pos, before = positions(idx, E, group, t0), None
    if ranks is not None and ranks.data.size > 1 and (
            t0 % group or xf.shape[0] % group):
        before = _before(idx, E, group, t0, ranks)
        pos = pos + before
    return Routing(logits, probs, weights, idx, pos, pos < cap, before)


def _group_of(idx: torch.Tensor, group: int, t0: int) -> torch.Tensor:
    """(N k,) the run of ``group`` tokens each pair's token lies in,
    counted from token 0 of the call (``idx``'s first token is ``t0``)."""
    N, k = idx.shape
    ar = torch.arange(N * k, device=idx.device)
    return torch.div(ar + t0 * k, group * k, rounding_mode="floor")


def positions(idx: torch.Tensor, n_experts: int, group: int,
              t0: int = 0) -> torch.Tensor:
    """(N, k) position of each (token, slot) among the pairs routed to its
    expert before it, in token-major, slot-minor order within its run of
    ``group`` tokens (the runs counted from ``t0`` tokens before
    ``idx``'s first): the reference's exclusive one-hot cumsum over the
    pairs.  Computed as the pair's rank in a stable sort by (group,
    expert) less the start of its (group, expert) run, which needs no
    (N k, E) scan down the token axis."""
    N, k = idx.shape
    ar = torch.arange(N * k, device=idx.device)
    g0 = t0 // group
    key = idx.reshape(-1) + n_experts * (_group_of(idx, group, t0) - g0)
    n_groups = (t0 + N - 1) // group - g0 + 1
    sorted_key, order = torch.sort(key, stable=True)
    start = torch.searchsorted(sorted_key, torch.arange(
        n_groups * n_experts, device=idx.device))
    rank = ar - start[sorted_key]
    return torch.empty_like(rank).scatter_(0, order, rank).reshape(N, k)


def _before(idx: torch.Tensor, n_experts: int, group: int, t0: int,
            ranks) -> torch.Tensor:
    """(N, k) the pairs that the ``"data"`` ranks before this one routed
    to each pair's expert within its run of ``group`` tokens: every
    rank's (runs, experts) counts gathered over ``"data"`` (one small
    exchange), those of the ranks before summed."""
    N, k = idx.shape
    n_runs = ranks.n_clients * N // ranks.rows // group
    key = idx.reshape(-1) + n_experts * _group_of(idx, group, t0)
    counts = torch.zeros(n_runs * n_experts, dtype=torch.int64,
                         device=idx.device).scatter_add_(
        0, key, torch.ones_like(key))
    every = tp.gather_rows(counts[None], ranks)
    return every[:ranks.data.rank].sum(0)[key].reshape(N, k)


def _aux(r: Routing, E: int) -> torch.Tensor:
    """Switch load-balance loss + router z-loss."""
    me = r.probs.mean(dim=0)
    ce = F.one_hot(r.idx[:, 0], E).float().mean(dim=0)
    lb = E * torch.sum(me * ce)
    zloss = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    return 0.01 * lb + 0.001 * zloss


NAMES = ("w_gate", "w_up", "w_down")


def placement(ranks) -> str:
    """How the plan places the expert leaves over ``"model"``:
    ``"experts"`` (each split on E), ``"d_ff"`` (``w_gate``/``w_up`` on
    their output, ``w_down`` on its input: the plan's choice where the
    axis does not divide E), or ``"whole"`` (replicated, at world 1, or
    any other split: gathered at use)."""
    dims = [tp.model_dim(tp.spec(ranks, n), ranks) for n in NAMES]
    if dims == [0, 0, 0]:
        return "experts"
    if dims == [2, 2, 1]:
        return "d_ff"
    return "whole"


def _expert_weights(params, dtype: torch.dtype, ranks=None, form=None):
    """The three expert leaves in ``dtype``: the rank's blocks under
    ``"experts"``/``"d_ff"``, else each whole (gathered at use)."""
    with _span("moe.cast"):
        if form in ("experts", "d_ff"):
            return tuple(params[n].to(dtype) for n in NAMES)
        return tuple(tp.gather_leaf(params[n], tp.spec(ranks, n),
                                    ranks).to(dtype) for n in NAMES)


def _down_partial(h: torch.Tensor, w_down: torch.Tensor, eq=None
                  ) -> torch.Tensor:
    """A rank's d_ff-parallel term of the experts' down product (``eq``
    an einsum, else ``bmm``), in f32 for a half type, so that the sum
    over ranks rounds once."""
    if h.dtype in (torch.bfloat16, torch.float16):
        h, w_down = h.float(), w_down.float()
    return torch.einsum(eq, h, w_down) if eq else torch.bmm(h, w_down)


def moe_ffn(params, x: torch.Tensor, cfg: ArchConfig, ranks=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter form.  x: (B, S, d) -> (y (B, S, d), aux f32 scalar).
    ``ranks``: this rank's rows of the call and its blocks of the leaves
    (the module's docstring); y whole on every ``"model"`` rank."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    t0, n_total = token_range(ranks, B, S)
    C = capacity(n_total, cfg)
    form = placement(ranks)
    e0, e1 = tp.experts(tp.spec(ranks, "w_gate"), ranks, E) \
        if form == "experts" else (0, E)
    xf = x.reshape(T, d)
    with _span("moe.route"):
        r = route(params, xf, cfg, C, n_total, ranks, t0)
        mine = r.keep if form != "experts" else \
            r.keep & (r.idx >= e0) & (r.idx < e1)
        pos, Cl = r.pos, C
        if r.before is not None:
            # this rank's pairs of an expert hold the slots from its
            # "before" count on, fewer than its T tokens: the rank's buffer
            # holds those, not the whole call's C slots an expert
            pos, Cl = r.pos - r.before, min(C, T)
        n_slots = (e1 - e0) * Cl
        slot = torch.where(mine, (r.idx - e0) * Cl + pos, n_slots)  # (T, k)
    with _span("moe.dispatch"):
        buf = x.new_zeros((n_slots + 1, d))     # the last row: the trash row
        buf[slot] = xf[:, None, :].expand(T, k, d)
        xe = buf[:n_slots].view(e1 - e0, Cl, d)
    w_gate, w_up, w_down = _expert_weights(params, x.dtype, ranks, form)
    with _span("moe.experts"):
        g = torch.bmm(xe, w_gate)
        u = torch.bmm(xe, w_up)
        if form == "d_ff":
            ye = _down_partial(gate_act(g, cfg) * u, w_down)
        else:
            ye = torch.bmm(gate_act(g, cfg) * u, w_down)      # (E, C, d)
    with _span("moe.combine"):
        y_rep = ye.reshape(n_slots, d)[slot.clamp(max=n_slots - 1)]
        y_rep = torch.where(mine[..., None], y_rep, 0)        # (T, k, d)
        y_rep = y_rep * r.weights[..., None].to(x.dtype).to(y_rep.dtype)
        y = y_rep.sum(dim=1, dtype=torch.float32)
        if form != "whole":
            y = tp.reduce_sum(y, ranks)
        y = y.to(x.dtype)
    return y.reshape(B, S, d), _aux(r, E)


def moe_ffn_einsum(params, x: torch.Tensor, cfg: ArchConfig, ranks=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GShard grouped one-hot form: groups of ``GROUP_SIZE`` tokens
    (all of them when fewer), each with its own capacity ``Cg``
    (:func:`einsum_groups`); B * S must be a multiple of the group
    size.  ``ranks``: as :func:`moe_ffn` over the (G, E, Cg, d) blocks
    (a ``"data"`` rank computes the groups its rows reach, the other
    ranks' tokens of a shared group as zeros that neither dispatch nor
    combine); with ``moe_group_shard`` the rank's block of the groups
    instead (:func:`_group_shard`)."""
    if cfg.moe_group_shard and tp.active(ranks):
        return _group_shard(params, x, cfg, ranks)
    B, S, d = x.shape
    T = B * S
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    t0, n_total = token_range(ranks, B, S)
    _, gs, Cg = einsum_groups(n_total, cfg)
    form = placement(ranks)
    e0, e1 = tp.experts(tp.spec(ranks, "w_gate"), ranks, E) \
        if form == "experts" else (0, E)
    with _span("moe.route"):
        r = route(params, x.reshape(T, d), cfg, Cg, gs, ranks, t0)
        lead = t0 % gs                      # the group's tokens before ours
        G = (lead + T + gs - 1) // gs
        tail = G * gs - lead - T
        idx, pos, keep, weights, xs = r.idx, r.pos, r.keep, r.weights, \
            x.reshape(T, d)
        if lead or tail:                    # another "data" rank's tokens
            pad = lambda t: torch.cat([t.new_zeros((lead,) + t.shape[1:]),
                                       t, t.new_zeros((tail,) + t.shape[1:])])
            idx, pos, keep, weights, xs = (pad(t) for t in (
                idx, pos, keep, weights, xs))
        onehot = F.one_hot(idx, E).float().view(G, gs, k, E)
        if form == "experts":
            onehot = onehot[..., e0:e1]
        # the capacity slot of each (token, slot) under its own expert;
        # each (g, s, k) is hot at one (e, c) pair at most, so the
        # contractions over k below are exact
        cap_oh = (F.one_hot(pos.clamp(max=Cg - 1), Cg).float()
                  * keep[..., None]).view(G, gs, k, Cg)
    with _span("moe.dispatch"):
        disp = torch.einsum("gske,gskc->gsec", onehot, cap_oh).to(x.dtype)
        xe = torch.einsum("gsec,gsd->gecd", disp, xs.view(G, gs, d))
    w_gate, w_up, w_down = _expert_weights(params, x.dtype, ranks, form)
    with _span("moe.experts"):
        g = torch.einsum("gecd,edf->gecf", xe, w_gate)
        u = torch.einsum("gecd,edf->gecf", xe, w_up)
        if form == "d_ff":
            ye = _down_partial(gate_act(g, cfg) * u, w_down,
                               "gecf,efd->gecd")
        else:
            ye = torch.einsum("gecf,efd->gecd", gate_act(g, cfg) * u,
                              w_down)
    with _span("moe.combine"):
        gated = cap_oh * weights.view(G, gs, k, 1)
        comb = torch.einsum("gske,gskc->gsec", onehot, gated).to(x.dtype)
        if form == "whole":
            y = torch.einsum("gsec,gecd->gsd", comb, ye)
        else:                   # the rank's term in f32, rounded once
            y = tp.reduce_sum(torch.einsum("gsec,gecd->gsd", comb.float(),
                                           ye.float()), ranks).to(x.dtype)
        y = y.reshape(G * gs, d)[lead:lead + T].reshape(B, S, d)
    return y, _aux(r, E)


def _group_shard(params, x: torch.Tensor, cfg: ArchConfig, ranks
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_group_shard`` on this rank: the whole batch's tokens (its
    rows gathered over ``"data"``), cut into world 1's G groups; the
    ``"model"`` rank computes its contiguous block of ceil(G / M) of
    them (past the end none, as GSPMD pads the dim: a decode step's one
    group runs on rank 0) with the router and the expert leaves gathered
    whole at use (the reference: "XLA gathers the (377 MB) expert
    weights per layer"), routing and computing each group as world 1
    does; y is gathered over the groups in rank order and the rank keeps
    its rows.  aux is that of the rank's groups (0 where it has none)."""
    xw = tp.gather_rows(x, ranks)
    B, S, d = xw.shape
    G, gs, _ = einsum_groups(B * S, cfg)
    M, m = ranks.model.size, ranks.model.rank
    per = -(-G // M)
    a, b = min(m * per, G), min((m + 1) * per, G)
    whole = {n: tp.gather_leaf(params[n], tp.spec(ranks, n), ranks)
             for n in ("router",) + NAMES}
    plain = dataclasses.replace(cfg, moe_group_shard=False)
    mine = xw.reshape(G, gs, d)[a:b]
    if b > a:
        y, aux = moe_ffn_einsum(whole, mine.reshape(1, (b - a) * gs, d),
                                plain)
        y = y.reshape(b - a, gs, d)
    else:
        y, aux = mine, torch.zeros((), dtype=torch.float32, device=x.device)
    if b - a < per:
        y = torch.cat([y, y.new_zeros((per - (b - a), gs, d))])
    y = tp.gather(y, ranks, 0)[:G].reshape(B, S, d)
    return y[ranks.clients()], aux
