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
``"model"`` mesh axis (the reference's ``with_sharding_constraint``):
under no ambient mesh (``distributed.context``) or a 1-device
``"model"`` axis that is the identity, as on the reference's host mesh;
over a larger axis it raises ``NotImplementedError`` (multi-device
execution is not yet ported).  The scatter form does not read it, as in
the reference.

When ``torch.profiler`` is on, the work is labelled ``moe.route``,
``moe.dispatch``, ``moe.cast``, ``moe.experts`` and ``moe.combine``
(``profile_serve`` sums the device time under each).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import check_model_axis
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


def route(params, xf: torch.Tensor, cfg: ArchConfig, cap: int,
          group: int) -> Routing:
    """Route the tokens ``xf`` (N, d): positions count within each run of
    ``group`` tokens (N for the scatter form, the group size for the
    einsum form), token-major and slot-minor; ``keep`` is pos < ``cap``."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    logits = xf.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    pos = positions(idx, E, group)
    return Routing(logits, probs, weights, idx, pos, pos < cap)


def positions(idx: torch.Tensor, n_experts: int, group: int) -> torch.Tensor:
    """(N, k) position of each (token, slot) among the pairs routed to its
    expert before it, in token-major, slot-minor order within its run of
    ``group`` tokens: the reference's exclusive one-hot cumsum over the
    pairs.  Computed as the pair's rank in a stable sort by (group,
    expert) less the start of its (group, expert) run, which needs no
    (N k, E) scan down the token axis."""
    N, k = idx.shape
    ar = torch.arange(N * k, device=idx.device)
    key = idx.reshape(-1) + n_experts * torch.div(ar, group * k,
                                                  rounding_mode="floor")
    sorted_key, order = torch.sort(key, stable=True)
    start = torch.searchsorted(sorted_key, torch.arange(
        N // group * n_experts, device=idx.device))
    rank = ar - start[sorted_key]
    return torch.empty_like(rank).scatter_(0, order, rank).reshape(N, k)


def _aux(r: Routing, E: int) -> torch.Tensor:
    """Switch load-balance loss + router z-loss."""
    me = r.probs.mean(dim=0)
    ce = F.one_hot(r.idx[:, 0], E).float().mean(dim=0)
    lb = E * torch.sum(me * ce)
    zloss = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    return 0.01 * lb + 0.001 * zloss


def _expert_weights(params, dtype: torch.dtype):
    with _span("moe.cast"):
        return tuple(params[n].to(dtype)
                     for n in ("w_gate", "w_up", "w_down"))


def moe_ffn(params, x: torch.Tensor, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter form.  x: (B, S, d) -> (y (B, S, d), aux f32 scalar)."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = capacity(T, cfg)
    xf = x.reshape(T, d)
    with _span("moe.route"):
        r = route(params, xf, cfg, C, T)
        slot = torch.where(r.keep, r.idx * C + r.pos, E * C)       # (T, k)
    with _span("moe.dispatch"):
        buf = x.new_zeros((E * C + 1, d))       # row E * C: the trash row
        buf[slot] = xf[:, None, :].expand(T, k, d)
        xe = buf[:E * C].view(E, C, d)
    w_gate, w_up, w_down = _expert_weights(params, x.dtype)
    with _span("moe.experts"):
        g = torch.bmm(xe, w_gate)
        u = torch.bmm(xe, w_up)
        ye = torch.bmm(gate_act(g, cfg) * u, w_down)              # (E, C, d)
    with _span("moe.combine"):
        y_rep = ye.reshape(E * C, d)[slot.clamp(max=E * C - 1)]    # (T, k, d)
        y_rep = torch.where(r.keep[..., None], y_rep, 0)
        y_rep = y_rep * r.weights[..., None].to(x.dtype)
        y = y_rep.sum(dim=1, dtype=torch.float32).to(x.dtype)
    return y.reshape(B, S, d), _aux(r, E)


def moe_ffn_einsum(params, x: torch.Tensor, cfg: ArchConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GShard grouped one-hot form: groups of ``GROUP_SIZE`` tokens
    (all of them when fewer), each with its own capacity ``Cg``
    (:func:`einsum_groups`); B * S must be a multiple of the group
    size.  ``moe_group_shard``: see the module's docstring."""
    if cfg.moe_group_shard:
        check_model_axis("moe_group_shard")
    B, S, d = x.shape
    T = B * S
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    G, gs, Cg = einsum_groups(T, cfg)
    with _span("moe.route"):
        r = route(params, x.reshape(T, d), cfg, Cg, gs)
        onehot = F.one_hot(r.idx, E).float().view(G, gs, k, E)
        # the capacity slot of each (token, slot) under its own expert;
        # each (g, s, k) is hot at one (e, c) pair at most, so the
        # contractions over k below are exact
        cap_oh = (F.one_hot(r.pos.clamp(max=Cg - 1), Cg).float()
                  * r.keep[..., None]).view(G, gs, k, Cg)
    with _span("moe.dispatch"):
        disp = torch.einsum("gske,gskc->gsec", onehot, cap_oh).to(x.dtype)
        xe = torch.einsum("gsec,gsd->gecd", disp, x.reshape(G, gs, d))
    w_gate, w_up, w_down = _expert_weights(params, x.dtype)
    with _span("moe.experts"):
        g = torch.einsum("gecd,edf->gecf", xe, w_gate)
        u = torch.einsum("gecd,edf->gecf", xe, w_up)
        ye = torch.einsum("gecf,efd->gecd", gate_act(g, cfg) * u, w_down)
    with _span("moe.combine"):
        gated = cap_oh * r.weights.view(G, gs, k, 1)
        comb = torch.einsum("gske,gskc->gsec", onehot, gated).to(x.dtype)
        y = torch.einsum("gsec,gecd->gsd", comb, ye).reshape(B, S, d)
    return y, _aux(r, E)
