"""BAFDP — the paper's algorithm (Algorithm 1, Eq. 15-22) as one round
function over stacked client trees; the port of the JAX package's
``core/bafdp.py``: the dense round (:func:`bafdp_round`) and the
active-subset round (:func:`bafdp_round_sparse`).

* Step 1 (active clients): the omega step Eq. (18) — gradient of the local
  DRO objective ``g(w_i) + rho_i G(w_i)`` plus the Lagrangian terms
  ``-phi_i`` and ``psi sign(w_i - z)`` — and the eps step Eq. (19).
* Step 2 (server): the consensus step Eq. (20) over every client's last
  message (Byzantine corruption included), every leaf at once through
  :func:`repro_torch.kernels.ops.sign_consensus_leaves` — the hand-written
  CUDA kernels on the GPU — and the dual step Eq. (21).  With
  ``FedConfig.robust_consensus`` the messages first collapse to one
  robust aggregate, given to every row of that same call.
* Step 3 (active clients): the pairwise dual step Eq. (22), then sync.

Per-client gradients come from ONE backward pass of ``sum_i obj_i`` over
the stacked ``(C, ...)`` leaves: ``obj_i`` reads only row ``i``, so the
gradient of the sum in row ``i`` is client ``i``'s own gradient.

Randomness: the ``"all"``-scope round draws the internal active-set
sampler, the LDP input noise and the ``gaussian`` attack in that order from
the round's ``torch.Generator``.  The active-subset round (and the
``"active"`` scope, which runs it) draws the noise and the attack per
client row instead (``privacy.RowGenerators``, seeded from the round
generator's ``initial_seed()`` and the client id), so a client's draws
do not depend on the block it sits in.  Unknown knob values raise.

:func:`bafdp_round_sparse` is the O(S) round: it gathers the round's S
delivered rows of every per-client leaf, runs the same per-client math
on the (S_max, ...) blocks, and writes the rows back into the state's
(C, ...) leaves in place.  ``bafdp_round`` with
``consensus_scope="active"`` runs it over the full-width block (every
client a row, ``weight`` the activity mask) on a copy of the state; that
masked O(C) round is the bit-for-bit oracle of the gathered one.

Both rounds take ``ranks``, a ``distributed.data_parallel.RankBlock``:
over more than one rank the state holds this rank's clients
(``fed_state.shard_clients``) and every cross-client quantity (the dual
mean, the Eq. (20) sign sums, ``alie``'s moments, the consensus gap, the
metrics) is a local sum all-reduced over the ``"data"`` ranks, the
consensus split into a partial launch, the all-reduce and a finish
launch per dtype group (``kernels.ops.sign_consensus_leaves``).  Every
draw matches the one-rank round's: the active set is drawn over C on
every rank, a block draw is the whole block's narrowed to the rank's
rows (``privacy.BlockGenerator``), the row generators are per client
anyway.  Under ``inner_dp`` (a ``"model"`` axis of more than one rank) a
client's batch is split over ``"model"`` and the loss and every gradient
leaf are all-reduced there before the step.  ``robust_consensus`` needs
every row and raises over several ranks.  Without ``ranks``, or over one
rank, the rounds are the one-rank program.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import (AccumulationDtypeRule, MemoryContractRule,
                                  contract as fedlint_contract)
from repro_torch.configs.base import FedConfig
from repro_torch.core import aggregators as agg_lib
from repro_torch.core import byzantine as byz_lib
from repro_torch.core import dro
from repro_torch.core.aggregators import ROBUST_CONSENSUS_RULES
from repro_torch.core.fed_state import (FedState, consensus_gap,
                                        gather_clients, scatter_clients)
from repro_torch.core.privacy import (NOISE_STREAM, BlockGenerator,
                                      RowGenerators, eps_feasible)
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import all_reduce_sum
from repro_torch.distributed.data_parallel import is_split
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ref import jsign, true_div
from repro_torch.tree import host_array, tree_leaves, tree_map, tree_unflatten

# local_loss(W_stack, batch, gen, eps) -> (R,) per-row data loss; row i may
# read only row i of W_stack, batch and eps.  ``gen`` is the round's
# torch.Generator (the "all"-scope round) or a privacy.RowGenerators (the
# active-subset round), which privacy.perturb_inputs takes either way.
LocalLoss = Callable[[Any, Any, Any, torch.Tensor], torch.Tensor]


def check_ported(fed: FedConfig) -> None:
    """Reject unknown values of the round's knobs rather than ignore
    them."""
    if fed.consensus_scope not in ("all", "active"):
        raise ValueError(f"unknown consensus_scope: {fed.consensus_scope!r} "
                         "(expected 'all' or 'active')")
    if fed.consensus_streaming and fed.consensus_scope != "active":
        raise ValueError(
            "consensus_streaming streams the active-scope left-fold; the "
            "'all' scope reduces by mean — set consensus_scope='active'")
    if fed.robust_consensus not in ROBUST_CONSENSUS_RULES:
        raise ValueError(f"unknown robust_consensus: {fed.robust_consensus!r}"
                         f" (expected one of {ROBUST_CONSENSUS_RULES})")
    if fed.staleness_compensation not in ("none", "taylor"):
        raise ValueError(
            f"unknown staleness_compensation: {fed.staleness_compensation!r}")


def reg_decay(alpha: float, t: torch.Tensor, power: float) -> torch.Tensor:
    """a^t = 1 / (alpha (t+1)^power)  (Setting 1), in f32."""
    return 1.0 / (alpha * torch.pow(t.float() + 1.0, power))


def active_mask(gen: torch.Generator, n_clients: int, active_frac: float,
                device=None) -> torch.Tensor:
    """S-of-M participation: a uniformly random active set."""
    s = max(1, int(round(n_clients * active_frac)))
    perm = torch.randperm(n_clients, generator=gen, device=device)
    return torch.argsort(perm) < s


def default_age_threshold(n_clients: int, active_frac: float) -> int:
    """2 * ceil(C / S)."""
    s = max(1, int(round(n_clients * active_frac)))
    return 2 * math.ceil(n_clients / s)


def active_mask_age_aware(gen: torch.Generator, n_clients: int,
                          active_frac: float, age: torch.Tensor,
                          age_threshold: float) -> torch.Tensor:
    """Age-aware S-of-M sampler: overdue clients (age >= threshold) first,
    oldest first; ties and the remaining slots uniformly at random."""
    s = max(1, int(round(n_clients * active_frac)))
    u = torch.rand((n_clients,), generator=gen, device=age.device)
    agef = age.float()
    prim = torch.where(agef >= age_threshold, agef,
                       torch.full_like(agef, -1.0))
    # lexsort: primary key -prim, secondary key u (two stable sorts)
    by_u = torch.argsort(u, stable=True)
    idx = by_u[torch.argsort(-prim[by_u], stable=True)]
    mask = torch.zeros((n_clients,), dtype=torch.bool, device=age.device)
    mask[idx[:s]] = True
    return mask


def compensate_stale(W_msg: Any, comp: Any, age: torch.Tensor,
                     fed: FedConfig) -> Any:
    """First-order Taylor correction of stale messages (DC-ASGD flavour):
    ``w~_i = w_i - alpha_w * compensation_scale * min(d, clip) * comp_i``,
    optionally damped per client by ``ref / (rms_i + ref)``.  f32 leaves."""
    a = (torch.clamp_max(age.float(), fed.compensation_clip)
         * fed.alpha_w * fed.compensation_scale)
    if fed.compensation_scale_mode == "per_client":
        R = age.shape[0]
        sq = torch.zeros((R,), dtype=torch.float32, device=age.device)
        n_inner = 0
        for c in tree_leaves(comp):
            cf = c.float().reshape(R, -1)
            sq = sq + torch.sum(torch.square(cf), dim=1)
            n_inner += cf.shape[1]
        rms = torch.sqrt(sq / float(max(n_inner, 1)))
        den = rms + fed.compensation_ref
        a = a * (torch.full_like(den, fed.compensation_ref) / den)
    elif fed.compensation_scale_mode != "global":
        raise ValueError(
            f"unknown compensation_scale_mode: "
            f"{fed.compensation_scale_mode!r} "
            "(expected 'global' or 'per_client')")

    def f(w, c):
        al = a.reshape((-1,) + (1,) * (w.ndim - 1))
        return w.float() - al * c

    return tree_map(f, W_msg, comp)


def staleness_weights(stale: torch.Tensor, fed: FedConfig) -> torch.Tensor:
    """FedAsync staleness decay s(d), d = t - tau_i."""
    d = torch.clamp_min(stale.float(), 0.0)
    if fed.staleness_decay == "constant":
        return torch.ones_like(d)
    if fed.staleness_decay == "hinge":
        a, b = fed.staleness_hinge_a, fed.staleness_hinge_b
        return torch.where(d <= b, torch.ones_like(d),
                           1.0 / (a * (d - b) + 1.0))
    if fed.staleness_decay == "poly":
        return torch.pow(d + 1.0, -fed.staleness_poly_a)
    raise ValueError(f"unknown staleness_decay: {fed.staleness_decay!r}")


def _robust_broadcast(W_srv: Any, weight: Optional[torch.Tensor], z: Any,
                      fed: FedConfig) -> Any:
    """``FedConfig.robust_consensus``: collapse the round's consensus
    messages to ONE weight-aware robust aggregate
    (``aggregators.robust_block``) and give it to every block row.  The
    unchanged Eq. (20) fold then computes
    ``z - alpha_z (phi_mean + psi (sum_j s_j) sign(z - w_rob) / C)``, so
    decay, ``fedbuff_lr_norm`` and the int8 wire compose untouched, and the
    round still makes its one consensus launch.  The rows are materialized
    (the kernels take contiguous rows, not a stride-0 view)."""
    w_rob = agg_lib.robust_block(
        fed.robust_consensus, W_srv, weight, z,
        trim_frac=fed.robust_trim_frac, n_byzantine=fed.n_byzantine,
        clip_tau=fed.robust_clip_tau, clip_iters=fed.robust_clip_iters)
    return tree_map(
        lambda w_l, r_l: r_l.float()[None].expand(w_l.shape)
        .to(w_l.dtype).contiguous(), W_srv, w_rob)


def _client_block_updates(W, z_local, phi, eps, lam, opt, comp, batch,
                          gen, cnt_inc, *, local_loss: LocalLoss,
                          fed: FedConfig, c3: float, n_samples: int,
                          d_dim: int, taylor: bool, ranks=None):
    """Steps 1 + 3-prep of Algorithm 1 for every row of the stack:
    gradients of the DP-perturbed DRO objective, optional Adam, the Taylor
    EWMA proposal and the Eq. (19) eps proposal.  Returns ``(W_prop,
    new_opt, comp_prop, eps_prop, loss_i, g_i, G_i)``, unmasked.

    ``ranks`` with a ``"model"`` axis of more than one rank (``inner_dp``:
    ``batch`` holds this rank's rows of each client's batch, weight
    ``ranks.batch_weight`` of it): the loss and every gradient leaf are
    summed over ``"model"`` into the whole batch's before the step, which
    ``dro.rho`` and ``lipschitz_surrogate`` (the same weights on every
    model rank) then read whole.
    """
    Wg = tree_map(lambda w: w.detach().requires_grad_(True), W)
    inner = ranks is not None and ranks.model.size > 1
    with torch.enable_grad():
        g_i = local_loss(Wg, batch, gen, eps)
        G_i = dro.lipschitz_surrogate(Wg, fed.lipschitz_surrogate)
        rho_i = fed.dro_weight * dro.rho(eps, n_samples, d_dim, c3, fed)
        if inner:
            # this rank's share of the batch's data loss; the regularizer
            # once over the model ranks' sum
            g_i = g_i * ranks.batch_weight
            loss_i = g_i + rho_i * G_i / ranks.model.size
        else:
            loss_i = g_i + rho_i * G_i
        grads = list(torch.autograd.grad(loss_i.sum(), tree_leaves(Wg)))
    loss_i, g_i, G_i = loss_i.detach(), g_i.detach(), G_i.detach()
    if inner:
        for g in grads:
            all_reduce_sum(g, ranks.model)
        g_i = all_reduce_sum(g_i.contiguous(), ranks.model)
        loss_i = g_i + rho_i.detach() * G_i

    R = eps.shape[0]
    if fed.grad_clip:
        sq = torch.zeros((R,), dtype=torch.float32, device=eps.device)
        for g in grads:
            sq = sq + torch.sum(torch.square(g.float()),
                                dim=tuple(range(1, g.ndim)))
        norm = torch.clamp_min(torch.sqrt(sq), 1e-9)
        scale = torch.clamp_max(torch.full_like(norm, fed.grad_clip) / norm,
                                1.0)
        for i, g in enumerate(grads):   # each raw leaf freed as it goes
            grads[i] = g * scale.reshape((-1,) + (1,) * (g.ndim - 1)) \
                .to(g.dtype)
        del g

    # Lagrangian pieces of Eq. 18, added OUTSIDE the Adam preconditioner:
    # -phi_i + psi * sign(w_i - z_local_i)
    def lag(w, zl, p):
        return fed.psi * jsign(w.float() - zl.float()) - p.float()

    adam = fed.omega_optimizer == "adam" and opt is not None
    if adam:
        cnt = opt["count"] + cnt_inc.to(torch.int32)
        b1, b2 = fed.adam_b1, fed.adam_b2
        steps = torch.clamp_min(cnt, 1).float()
        bc1 = 1 - torch.pow(b1, steps)
        bc2 = 1 - torch.pow(b2, steps)
        m_l, v_l = tree_leaves(opt["m"]), tree_leaves(opt["v"])
    w_l, zl_l, p_l = tree_leaves(W), tree_leaves(z_local), tree_leaves(phi)
    c_l = tree_leaves(comp) if taylor else None
    cb = fed.compensation_beta
    # one leaf at a time, each gradient dropped once used, so the step holds
    # no (R, ...) tree besides the gradient and the proposals (an LM round
    # at full width would not fit one card otherwise)
    W_prop, m_new, v_new, comp_l = [], [], [], []
    for i, w in enumerate(w_l):
        g, grads[i] = grads[i].float(), None
        lg = lag(w, zl_l[i], p_l[i])
        if adam:
            r = (-1,) + (1,) * (w.ndim - 1)
            m_new.append(b1 * m_l[i] + (1 - b1) * g)
            v_new.append(b2 * v_l[i] + (1 - b2) * torch.square(g))
            upd = (m_new[-1] / bc1.reshape(r)) \
                / (torch.sqrt(v_new[-1] / bc2.reshape(r)) + fed.adam_eps)
            W_prop.append(w.float() - fed.alpha_w * (upd + lg))
            del upd
        full = g + lg
        del g, lg
        if not adam:
            W_prop.append(w.float() - fed.alpha_w * full)
        if taylor:
            comp_l.append(cb * c_l[i] + (1.0 - cb) * full)
        del full
    W_prop = tree_unflatten(W, W_prop)
    new_opt = opt
    if adam:
        new_opt = {"m": tree_unflatten(opt["m"], m_new),
                   "v": tree_unflatten(opt["v"], v_new), "count": cnt}
    comp_prop = tree_unflatten(comp, comp_l) if taylor else None

    # Eq. (19):  d/deps [ (eta + c3/eps) G ] = -c3 G / eps^2
    d_eps = -fed.dro_weight * c3 * G_i \
        / torch.square(torch.clamp_min(eps, fed.eps_min)) + lam
    eps_prop = eps_feasible(eps - fed.alpha_eps * d_eps, fed)
    return W_prop, new_opt, comp_prop, eps_prop, loss_i, g_i, G_i


def _whole_vector(v: torch.Tensor, ranks) -> torch.Tensor:
    """A split round's (C_r,) per-client vector as the fleet's (C,): this
    rank's rows at ``[c0, c1)`` of zeros, summed over ``"data"`` (exact:
    one rank's values and the others' zeros)."""
    out = torch.zeros((ranks.n_clients,), dtype=v.dtype, device=v.device)
    out[ranks.clients()] = v
    return all_reduce_sum(out, ranks.data)


def _split_round_checks(fed: FedConfig, ranks, C: int) -> None:
    if fed.robust_consensus != "none":
        raise NotImplementedError(
            f"robust_consensus={fed.robust_consensus!r} over "
            f"{ranks.data.size} data ranks: a robust rule reads every "
            "client's row, not yet ported (ROADMAP Queue A 7(b))")
    if ranks.n_clients != C:
        raise ValueError(f"ranks split {ranks.n_clients} clients, the round "
                         f"has {C}")


@torch.no_grad()
def bafdp_round(state: FedState, batch: Any, gen: torch.Generator, *,
                local_loss: LocalLoss, fed: FedConfig, c3: float,
                n_samples: int, d_dim: int, byz_mask: torch.Tensor,
                act: Optional[Any] = None, stale: Optional[Any] = None,
                arrivals: Optional[Any] = None, ranks=None
                ) -> Tuple[FedState, Dict[str, torch.Tensor]]:
    """One asynchronous BAFDP round.  ``batch``: a tuple of (C, b, ...)
    tensors on the state's device.

    ``act`` (C,) bool: an externally supplied active set (``None`` draws
    one with the internal sampler, ``fed.internal_select``).  ``stale``
    (C,): the staleness weighting the Eq. (20) sum (default: 0 for active
    clients, ``t - tau_i`` for the frozen params of inactive ones).
    ``arrivals``: the round's consumed-update count, read only by
    ``fed.fedbuff_lr_norm`` (default ``sum(act)``).

    ``fed.consensus_scope="active"`` consumes only this round's delivered
    messages: the round then runs :func:`bafdp_round_sparse` over the
    full-width block (``idx = arange(C)``, ``weight`` = the activity mask)
    on a copy of ``state`` (so ``state`` is left as it was), with that
    round's block metrics.

    ``ranks`` (see the module docstring): over several ranks ``state``
    holds this rank's clients, ``batch`` their (C_r, b_r, ...) rows,
    while ``byz_mask``, ``act`` and ``stale`` stay the fleet's (C,).
    """
    sign_message = fed.resolved_sign_message      # validates the knob
    dual_message = fed.resolved_dual_message      # validates the knob
    check_ported(fed)
    taylor = fed.staleness_compensation == "taylor"
    if taylor and state.comp is None:
        raise ValueError(
            "staleness_compensation='taylor' needs FedState.comp — "
            "init_fed_state with the same FedConfig")
    C = byz_mask.shape[0]
    dev = state.eps.device
    split = is_split(ranks)
    if split:
        _split_round_checks(fed, ranks, C)
    else:
        ranks = None
    if act is None:
        if fed.internal_select == "uniform":
            act = active_mask(gen, C, fed.active_frac, device=dev)
        elif fed.internal_select == "age_aware":
            thr = fed.internal_age_threshold if \
                fed.internal_age_threshold > 0 \
                else default_age_threshold(C, fed.active_frac)
            tau_all = _whole_vector(state.tau, ranks) if split \
                else state.tau
            act = active_mask_age_aware(gen, C, fed.active_frac,
                                        state.t - tau_all, thr)
        else:
            raise ValueError(
                f"unknown internal_select: {fed.internal_select!r}")
    else:
        act = torch.as_tensor(act, device=dev).bool()

    if fed.consensus_scope == "active":
        # the masked O(C) round IS the sparse round over the full-width
        # block: one code path, so the two cannot drift apart
        return bafdp_round_sparse(
            _clone_state(state), batch, gen, local_loss=local_loss, fed=fed,
            c3=c3, n_samples=n_samples, d_dim=d_dim, byz_mask=byz_mask,
            idx=np.arange(C), stale=stale, weight=act.float(),
            arrivals=arrivals, ranks=ranks)

    act_all = act                  # the fleet's, for the counts
    row_gen = attack_gen = gen
    if split:
        # this rank's rows of the fleet's (C,) vectors; the block draws
        # are the whole block's, narrowed
        sl = ranks.clients()
        act = act[sl]
        byz_mask = byz_mask[sl.start:sl.stop]
        if stale is not None:
            stale = torch.as_tensor(stale, device=dev)[sl]
        spans = [(C, ranks.c0, ranks.rows)]
        if ranks.batch is not None:
            b, start, rows, _ = ranks.batch
            spans.append((b, start, rows))
        row_gen = BlockGenerator(gen, spans)
        attack_gen = BlockGenerator(gen, spans[:1])     # the clients' rows
    t = state.t
    tau_new = torch.where(act, t, state.tau)
    stale_v = (t - tau_new).float() if stale is None \
        else torch.as_tensor(stale, device=dev).float()
    s_w = staleness_weights(stale_v, fed)                      # (C,)
    s_w_dual = staleness_weights((t - state.tau).float(), fed)

    # ---------------- Step 1: active clients update (w_i, eps_i) ----------
    batch = byz_lib.poison_batch(fed.attack, batch, byz_mask,
                                 shift=fed.traffic_shift_steps)
    (W_prop, new_opt, comp_prop, eps_prop, loss_i, g_i,
     G_i) = _client_block_updates(
        state.W, state.z_local, state.phi, state.eps, state.lam, state.opt,
        state.comp, batch, row_gen, act, local_loss=local_loss, fed=fed,
        c3=c3, n_samples=n_samples, d_dim=d_dim, taylor=taylor,
        ranks=ranks)

    def mask_leaves(new, old):
        m = act.reshape((-1,) + (1,) * (new.ndim - 1))
        return torch.where(m, new, old.float()).to(old.dtype)

    W_new = tree_map(mask_leaves, W_prop, state.W)
    del W_prop          # the round's (C, ...) trees go as soon as they are used
    if fed.omega_optimizer == "adam" and state.opt is not None:
        new_opt = {"m": tree_map(mask_leaves, new_opt["m"], state.opt["m"]),
                   "v": tree_map(mask_leaves, new_opt["v"], state.opt["v"]),
                   "count": new_opt["count"]}
    new_comp = state.comp
    if taylor:
        new_comp = tree_map(mask_leaves, comp_prop, state.comp)
    eps_new = torch.where(act, eps_prop, state.eps)

    # ---------------- Step 2: server updates (z, lambda) -------------------
    W_sent = byz_lib.apply_attack(fed.attack, attack_gen, W_new, byz_mask,
                                  scale=fed.attack_scale, ranks=ranks)

    def act_mean(x):
        return torch.sum(x * act) / torch.clamp_min(torch.sum(act), 1)

    a1_t = reg_decay(fed.alpha_lambda, t, fed.reg_decay_pow)
    lam_new = torch.clamp_min(state.lam + fed.alpha_lambda * (
        (eps_new - fed.privacy_budget_a) - a1_t * state.lam), 0.0)

    if split:
        # the metrics' sums over the fleet, one all-reduce: loss, data
        # loss, G, eps, lambda, staleness, its weight
        sums = all_reduce_sum(torch.stack([
            torch.sum(loss_i * act), torch.sum(g_i * act), torch.sum(G_i),
            torch.sum(eps_new), torch.sum(lam_new), torch.sum(stale_v),
            torch.sum(s_w)]).float(), ranks.data)
        n_act = torch.clamp_min(torch.sum(act_all), 1)

        def metrics(gap, comp_norm):
            return {"loss": sums[0] / n_act, "data_loss": sums[1] / n_act,
                    "lipschitz": true_div(sums[2], C),
                    "eps_mean": true_div(sums[3], C),
                    "lambda_mean": true_div(sums[4], C),
                    "consensus_gap": gap, "n_active": torch.sum(act_all),
                    "staleness_mean": true_div(sums[5], C),
                    "staleness_weight_mean": true_div(sums[6], C),
                    "compensation_norm": comp_norm}
    else:
        def metrics(gap, comp_norm):
            return {"loss": act_mean(loss_i), "data_loss": act_mean(g_i),
                    "lipschitz": torch.mean(G_i),
                    "eps_mean": torch.mean(eps_new),
                    "lambda_mean": torch.mean(lam_new),
                    "consensus_gap": gap, "n_active": torch.sum(act),
                    "staleness_mean": torch.mean(stale_v),
                    "staleness_weight_mean": torch.mean(s_w),
                    "compensation_norm": comp_norm}

    if fed.local_steps == 0:
        # consensus-free round: no sign all-reduce at all
        new_state = FedState(W=W_new, z=state.z, z_local=state.z_local,
                             phi=state.phi, lam=lam_new, eps=eps_new,
                             t=t + 1, opt=new_opt, tau=tau_new, comp=new_comp)
        zero = torch.zeros((), device=dev)
        return new_state, metrics(zero, zero)

    do_consensus = (t % fed.local_steps) == (fed.local_steps - 1)

    # Taylor-correct the stale messages the server consumes, AFTER the
    # corruption (the server cannot tell honest from malicious)
    comp_norm = torch.zeros((), device=dev)
    W_srv = W_sent
    if taylor:
        W_srv = compensate_stale(W_sent, new_comp, stale_v, fed)
        num = sum(torch.sum(torch.abs(a - b.float()))
                  for a, b in zip(tree_leaves(W_srv), tree_leaves(W_sent)))
        den = float(sum(l.numel() for l in tree_leaves(W_sent)))
        if split:
            num = all_reduce_sum(num.reshape(1), ranks.data)[0]
            den = den * ranks.data.size
        comp_norm = torch.where(do_consensus, num / max(den, 1.0),
                                torch.zeros_like(num))

    # Byzantine-robust pre-aggregation: this scope consumes every client's
    # last message, so every row is valid
    if fed.robust_consensus != "none":
        W_srv = _robust_broadcast(W_srv, None, state.z, fed)

    # Eq. (20): one dispatch for every sign-sum flavour — the CUDA kernels
    # for CUDA tensors.  The decayed sum divides by C, not sum(s_i).
    z_weights = None if fed.staleness_decay == "constant" else s_w
    if fed.fedbuff_lr_norm:
        k_arr = torch.sum(act_all).float() if arrivals is None \
            else torch.as_tensor(arrivals, device=dev).float()
        lr_scale = k_arr / C

    def phi_mean(phi_l):
        if dual_message == "int8":
            # the server averages the DECODED dual uploads
            dec = collectives.decode_dual_message(
                collectives.encode_dual_message(phi_l.reshape(C, -1)))
            return torch.mean(dec, dim=0)
        return torch.mean(phi_l.float(), dim=0).reshape(-1)

    if split:
        phi_means = _split_phi_mean(tree_leaves(state.phi), dual_message,
                                    ranks)
    else:
        phi_means = [phi_mean(phi_l) for phi_l in tree_leaves(state.phi)]
    # one call over every leaf: B1/B2 or B3 launch once a round (over
    # several ranks: a partial and a finish per dtype group)
    z_upd = iter(kops.sign_consensus_leaves(
        [z_l.reshape(-1) for z_l in tree_leaves(state.z)],
        [w_l.reshape(w_l.shape[0], -1) for w_l in tree_leaves(W_srv)],
        phi_means, z_weights, fed.psi, fed.alpha_z, message=sign_message,
        ranks=ranks))
    del W_sent, W_srv, phi_means

    def z_step(z_l):
        zf = z_l.reshape(-1)
        z_u = next(z_upd)
        if fed.fedbuff_lr_norm:
            z_u = (zf.float() + lr_scale * (z_u.float() - zf.float())
                   ).to(z_l.dtype)
        return torch.where(do_consensus, z_u, zf).reshape(z_l.shape)

    z_new = tree_map(z_step, state.z)
    del z_upd
    # taken now, before phi and z_local's new trees exist: its (C, ...)
    # difference would otherwise be the round's peak
    gap = consensus_gap(state._replace(W=W_new, z=z_new), ranks)

    # ---------------- Step 3: active clients update phi, sync z -----------
    a2_t = reg_decay(fed.alpha_phi, t, fed.reg_decay_pow)
    # a client returning after absence d took ONE local step from its
    # stale base, so its remaining lag is d - 1
    W_dual = W_new
    if taylor:
        lag = torch.clamp_min((t - state.tau).float() - 1.0, 0.0)
        W_dual = compensate_stale(W_new, new_comp, lag, fed)

    def phi_step(phi_l, z_l, w_l):
        # the out-of-place form's values, computed in one buffer: the
        # round's end holds the old and the new state, and an LM's largest
        # leaf is gigabytes at full width
        upd = z_l[None].float() - w_l.float()
        upd.sub_(a2_t * phi_l.float())
        if fed.staleness_decay != "constant":
            upd.mul_(s_w_dual.reshape((-1,) + (1,) * (phi_l.ndim - 1)))
        upd.mul_(fed.alpha_phi).add_(phi_l.float())    # phi + alpha upd
        m = act.reshape((-1,) + (1,) * (phi_l.ndim - 1))
        return torch.where(m, upd, phi_l.float(), out=upd).to(phi_l.dtype)

    phi_new = tree_map(phi_step, state.phi, z_new, W_dual)

    def zsync(zl_l, z_l):
        m = act.reshape((-1,) + (1,) * (zl_l.ndim - 1))
        return torch.where(m, z_l[None].float(), zl_l.float()).to(zl_l.dtype)

    z_local_new = tree_map(zsync, state.z_local, z_new)

    new_state = FedState(W=W_new, z=z_new, z_local=z_local_new, phi=phi_new,
                         lam=lam_new, eps=eps_new, t=t + 1, opt=new_opt,
                         tau=tau_new, comp=new_comp)
    return new_state, metrics(gap, comp_norm)


def _split_phi_mean(phi_leaves, dual_message: str, ranks):
    """The dense round's dual mean over several ranks: this rank's sum of
    its rows of every leaf (int8 wire: each row decoded first), in one
    flat f32 buffer, all-reduced over ``"data"``, then divided by C."""
    sums = []
    for phi_l in phi_leaves:
        rows = phi_l.reshape(phi_l.shape[0], -1)
        if dual_message == "int8":
            rows = collectives.decode_dual_message(
                collectives.encode_dual_message(rows))
        sums.append(torch.sum(rows.float(), dim=0))
    flat = all_reduce_sum(torch.cat(sums), ranks.data)
    out, at = [], 0
    for s_l in sums:
        out.append(true_div(flat[at:at + s_l.numel()], ranks.n_clients))
        at += s_l.numel()
    return out


def _clone_state(state: FedState) -> FedState:
    """A copy of every tensor of ``state`` (the sparse round writes into
    the state it is given)."""
    return FedState(*(tree_map(torch.clone, f) if f is not None else None
                      for f in state))


def _canonical_rows(idx, stale, weight, C: int):
    """The padded row contract, normalized on the host: an id outside
    ``[0, C)`` gets weight 0, a row of weight <= 0 becomes the sentinel
    ``C``, and the rows are stably sorted by client id (padding last,
    FedBuff arrival order kept between equal ids).  Returns ``(idx, stale,
    weight, order, write_idx)``: ``order`` the sort permutation and
    ``write_idx`` the ids with every delivery but each client's last one
    (and padding) set to ``C``."""
    idx = host_array(idx).astype(np.int64).reshape(-1)
    S = idx.shape[0]
    w = np.ones(S, np.float32) if weight is None \
        else host_array(weight).astype(np.float32).reshape(-1)
    st = np.zeros(S, np.float32) if stale is None \
        else host_array(stale).astype(np.float32).reshape(-1)
    w = np.where((idx < 0) | (idx >= C), np.float32(0.0), w)
    idx = np.where(w > 0.0, idx, C)
    order = np.argsort(idx, kind="stable")
    idx, st, w = idx[order], st[order], w[order]
    is_last = np.append(idx[:-1] != idx[1:], True)
    write_idx = np.where(is_last, idx, C)
    return idx, st, w, order, write_idx


def _rank_rows(idx, stale, weight, write_idx, ranks):
    """A split round's rows: the canonical rows whose client lies in this
    rank's block, in their order, padded to the same S_max with the local
    sentinel ``C_r`` (weight 0).  Returns ``(idx, stale, weight,
    write_idx, fleet_ids)``, ids local to the block but ``fleet_ids``
    (the fleet's ids, for the row generators and the Byzantine mask;
    ``C`` at padding)."""
    S, C, Cr = idx.shape[0], ranks.n_clients, ranks.rows
    keep = np.flatnonzero((idx >= ranks.c0) & (idx < ranks.c1))
    pad = S - keep.size

    def padded(a, fill, dtype):
        return np.concatenate([a[keep].astype(dtype),
                               np.full(pad, fill, dtype)])

    local = idx[keep] - ranks.c0
    w_local = np.where(write_idx[keep] < C, write_idx[keep] - ranks.c0, Cr)
    return (np.concatenate([local, np.full(pad, Cr, np.int64)]),
            padded(stale, 0.0, np.float32), padded(weight, 0.0, np.float32),
            np.concatenate([w_local, np.full(pad, Cr, np.int64)]),
            padded(idx, C, np.int64))


def _sparse_round_bindings(state, batch, gen, **kw):
    """Call-time dimension bindings of the sparse round's fedlint
    contract.  The dense "active"-scope oracle runs the sparse round over
    the FULL-width block (idx = arange(C)), where a (C, D) gather is the
    working set, so ``C`` is bound only for a genuine sub-fleet block."""
    C = kw["byz_mask"].shape[0]
    S = len(host_array(kw["idx"]).reshape(-1))
    return {"C": int(C)} if S < C else {}


def _sparse_round_rules(bindings):
    rules = [AccumulationDtypeRule()]
    if "C" in bindings:
        # the O(S) contract: no dense (C, D) intermediate; the in-place
        # state writes are the sanctioned O(C)-touching producers, and
        # min_inner_elems=3 exempts (C, 2)-sized bookkeeping
        rules.append(MemoryContractRule(
            "C", allow_primitives=("index_copy_", "index_put_"),
            min_inner_elems=3))
    return rules


@fedlint_contract(rules=_sparse_round_rules, bindings=_sparse_round_bindings,
                  name="bafdp_round_sparse",
                  host_args=("idx", "stale", "weight", "arrivals"))
@torch.no_grad()
def bafdp_round_sparse(state: FedState, batch: Any, gen: torch.Generator, *,
                       local_loss: LocalLoss, fed: FedConfig, c3: float,
                       n_samples: int, d_dim: int, byz_mask: torch.Tensor,
                       idx: Any, stale: Optional[Any] = None,
                       weight: Optional[Any] = None,
                       arrivals: Optional[Any] = None,
                       batch_gathered: Optional[bool] = None, ranks=None
                       ) -> Tuple[FedState, Dict[str, torch.Tensor]]:
    """The active-subset round: one BAFDP round in O(S) compute and memory
    over the per-client leaves.

    It gathers the round's S delivered rows of every per-client leaf
    (``W``, ``z_local``, ``phi``, ``lam``, ``eps``, ``tau``,
    ``opt.{m,v,count}``, ``comp``) into (S_max, ...) blocks, runs the
    per-client math of :func:`bafdp_round` on them, and writes the rows
    back.  **It consumes the state it is given**: the new rows are written
    in place into ``state``'s (C, ...) leaves and (C,) vectors, which the
    returned state shares; only ``z``, ``lam`` and ``t`` are new tensors.
    Keep a copy (``bafdp_round`` with ``consensus_scope="active"`` makes
    one) if the old state is still needed.  Only (C,) vectors are touched
    fleet-wide; no (C, D) intermediate exists: fedlint's contract
    (``analysis.contract``, on with ``REPRO_FEDLINT=1``) checks it once
    per abstract signature on meta stand-ins before the round runs.

    The padded row contract (``Schedule.padded_rows``):

    * ``idx`` (S_max,) int client ids; the sentinel ``C`` (and any id
      outside ``[0, C)``) marks padding;
    * ``stale`` (S_max,) admission age of each delivery (decay ``s(d)``
      and the Taylor extrapolation); ``None`` = all fresh;
    * ``weight`` (S_max,) 1 for a delivery, 0 for padding; ``None`` = all
      real.  Padding adds exact zeros to every reduction and is never
      written back.

    The rows may come in any order: they are stably sorted by client id,
    so the Eq. (20) left-fold visits clients in ascending order whatever
    the block, and the full-width masked round gives the same bits.  A
    FedBuff duplicate delivery (the same id twice) enters the sum with its
    own decay weight, in arrival order; only each client's last delivery
    is written back.  ``batch`` leaves are per client ``(C, b, ...)``
    (gathered here) or pre-gathered ``(S_max, b, ...)`` in ``idx``'s order;
    ``batch_gathered`` forces the reading (``None``: a leading dim of C
    means per client).

    The Eq. (20) step is ONE ``sign_consensus_leaves(..., n_total=C)``
    call over all leaves: B2 (f32 wire) or B3 (int8 wire, weighted) once a
    round on the card; ``fed.consensus_streaming`` folds the messages
    ``consensus_chunk`` rows at a time with the plain streamed fold
    instead.  Metrics: ``loss``, ``data_loss``, ``eps_mean``,
    ``lambda_mean``, ``n_active`` as the dense round; block statistics
    under ``_block`` keys with their divisor ``metrics_k``.

    ``ranks`` (see the module docstring): over several ranks ``state``
    holds this rank's clients and ``batch`` their per-client (C_r, ...)
    rows; each rank keeps the round's rows whose client lies in its block,
    in the canonical order, padded to the same S_max, and writes those
    back.  The dual fold and the Eq. (20) fold are split into a partial
    over these rows, an all-reduce over ``"data"`` and a finish.
    """
    sign_message = fed.resolved_sign_message      # validates the knob
    dual_message = fed.resolved_dual_message      # validates the knob
    if fed.consensus_streaming and fed.consensus_chunk < 1:
        raise ValueError(
            f"consensus_chunk must be >= 1, got {fed.consensus_chunk}")
    if fed.consensus_scope != "active":
        raise ValueError(
            "bafdp_round_sparse needs consensus_scope='active' (the 'all' "
            "scope sums every client's last message — inherently O(C); use "
            "the dense bafdp_round for it)")
    check_ported(fed)
    taylor = fed.staleness_compensation == "taylor"
    if taylor and state.comp is None:
        raise ValueError(
            "staleness_compensation='taylor' needs FedState.comp — "
            "init_fed_state with the same FedConfig")
    C = byz_mask.shape[0]
    dev = state.eps.device
    idx_h, stale_h, w_h, order_h, write_idx = _canonical_rows(
        idx, stale, weight, C)
    S = idx_h.shape[0]
    split = is_split(ranks)
    Cb = C                                  # the state's client rows
    if split:
        _split_round_checks(fed, ranks, C)
        if fed.consensus_streaming or batch_gathered:
            raise NotImplementedError(
                "the streamed fold and pre-gathered batches over several "
                "ranks are not ported (ROADMAP Queue A 7(b))")
        idx_h, stale_h, w_h, write_idx, fleet_h = _rank_rows(
            idx_h, stale_h, w_h, write_idx, ranks)
        Cb = ranks.rows
        fleet_h = np.minimum(fleet_h, ranks.c1 - 1)
    else:
        ranks = None
        fleet_h = np.minimum(idx_h, C - 1)  # padding reads client C - 1
    gid_h = np.minimum(idx_h, Cb - 1)
    gid = torch.from_numpy(gid_h).to(dev)
    w_row = torch.from_numpy(w_h).to(dev)
    stale_v = torch.from_numpy(stale_h).to(dev)

    t = state.t
    s_w = staleness_weights(stale_v, fed) * w_row           # decay + mask
    tau_g = state.tau.index_select(0, gid)
    s_w_dual = staleness_weights((t - tau_g).float(), fed)
    noise_rows = RowGenerators(gen.initial_seed(), NOISE_STREAM, fleet_h,
                               dev)
    fleet = torch.from_numpy(fleet_h)
    byz_g = byz_mask.index_select(0, fleet.to(byz_mask.device)).to(dev) \
        & (w_row > 0.0)

    # ---------------- gather the round's S rows of every big leaf ---------
    W_g = gather_clients(state.W, gid)
    zl_g = gather_clients(state.z_local, gid)
    phi_g = gather_clients(state.phi, gid)
    eps_g = state.eps.index_select(0, gid)
    lam_g = state.lam.index_select(0, gid)
    opt_g = None
    if state.opt is not None:
        opt_g = {"m": gather_clients(state.opt["m"], gid),
                 "v": gather_clients(state.opt["v"], gid),
                 "count": state.opt["count"].index_select(0, gid)}
    comp_g = gather_clients(state.comp, gid) if state.comp is not None \
        else None

    def pick_batch(l):
        if batch_gathered is None:
            per_client = l.shape[0] == Cb          # wins when S == C
            if not per_client and l.shape[0] != S:
                raise ValueError(
                    f"batch leaf leading dim {l.shape[0]} is neither "
                    f"n_clients={Cb} nor the padded block size {S}")
        else:
            per_client = not batch_gathered
            want = Cb if per_client else S
            if l.shape[0] != want:
                raise ValueError(
                    f"batch_gathered={batch_gathered}: expected batch leaf "
                    f"leading dim {want}, got {l.shape[0]}")
        if per_client:
            return l.index_select(0, gid.to(l.device))
        # pre-gathered rows come in idx's order: permute them with the rows
        return l.index_select(0, torch.from_numpy(order_h).to(l.device))

    batch_g = tuple(pick_batch(l) for l in batch)
    batch_g = byz_lib.poison_batch(fed.attack, batch_g, byz_g,
                                   shift=fed.traffic_shift_steps)

    # ---------------- Step 1 on the gathered block ------------------------
    (W_prop, opt_prop, comp_prop, eps_prop, loss_i, g_i,
     G_i) = _client_block_updates(
        W_g, zl_g, phi_g, eps_g, lam_g, opt_g, comp_g, batch_g, noise_rows,
        torch.ones((S,), dtype=torch.int32, device=dev),
        local_loss=local_loss, fed=fed, c3=c3, n_samples=n_samples,
        d_dim=d_dim, taylor=taylor, ranks=ranks)

    # ---------------- write the state's rows back, in place ---------------
    tau_new = scatter_clients(state.tau, write_idx, t.expand(S))
    W_new = scatter_clients(state.W, write_idx, W_prop)
    new_opt = state.opt
    if fed.omega_optimizer == "adam" and state.opt is not None:
        new_opt = {k: scatter_clients(state.opt[k], write_idx, opt_prop[k])
                   for k in ("m", "v", "count")}
    new_comp = state.comp
    comp_blocks = comp_g
    if taylor:
        new_comp = scatter_clients(state.comp, write_idx, comp_prop)
        comp_blocks = comp_prop
    eps_new = scatter_clients(state.eps, write_idx, eps_prop)

    a1_t = reg_decay(fed.alpha_lambda, t, fed.reg_decay_pow)
    lam_new = torch.clamp_min(state.lam + fed.alpha_lambda * (
        (eps_new - fed.privacy_budget_a) - a1_t * state.lam), 0.0)
    if split:
        # the block's sums over every rank's rows, one all-reduce
        sums = all_reduce_sum(torch.stack([
            torch.sum(w_row), torch.sum(loss_i * w_row),
            torch.sum(g_i * w_row), torch.sum(G_i * w_row),
            torch.sum(stale_v * w_row),
            torch.sum(staleness_weights(stale_v, fed) * w_row),
            torch.sum(eps_new), torch.sum(lam_new)]).float(), ranks.data)
        wsum_act = torch.clamp_min(sums[0], 1.0)

        def act_mean(x):
            return all_reduce_sum(torch.sum(x * w_row).reshape(1),
                                  ranks.data)[0] / wsum_act

        block_metrics = {
            "loss": sums[1] / wsum_act, "data_loss": sums[2] / wsum_act,
            "lipschitz_block": sums[3] / wsum_act,
            "eps_mean": true_div(sums[6], C),
            "lambda_mean": true_div(sums[7], C), "n_active": sums[0],
            "staleness_mean_block": sums[4] / wsum_act,
            "staleness_weight_mean_block": sums[5] / wsum_act,
            "metrics_k": wsum_act}
    else:
        wsum_act = torch.clamp_min(torch.sum(w_row), 1.0)

        def act_mean(x):
            return torch.sum(x * w_row) / wsum_act

        block_metrics = {
            "loss": act_mean(loss_i), "data_loss": act_mean(g_i),
            "lipschitz_block": act_mean(G_i),
            "eps_mean": torch.mean(eps_new),
            "lambda_mean": torch.mean(lam_new), "n_active": torch.sum(w_row),
            "staleness_mean_block": act_mean(stale_v),
            "staleness_weight_mean_block": act_mean(
                staleness_weights(stale_v, fed)),
            "metrics_k": wsum_act}

    if fed.local_steps == 0:
        # consensus-free round: no sign all-reduce at all
        new_state = FedState(W=W_new, z=state.z, z_local=state.z_local,
                             phi=state.phi, lam=lam_new, eps=eps_new,
                             t=t + 1, opt=new_opt, tau=tau_new,
                             comp=new_comp)
        zero = torch.zeros((), device=dev)
        return new_state, dict(block_metrics, consensus_gap_block=zero,
                               compensation_norm_block=zero)

    do_consensus = (t % fed.local_steps) == (fed.local_steps - 1)

    # ---------------- Step 2: server consensus over the S messages --------
    # fleet-indexed corruption: each row's draw keys off its client id and
    # alie's statistics read only the delivered rows
    W_sent = byz_lib.apply_attack(fed.attack, gen, W_prop, byz_g,
                                  scale=fed.attack_scale, client_ids=fleet_h,
                                  weight=w_row, ranks=ranks)
    comp_norm = torch.zeros((), device=dev)
    W_srv = W_sent
    if taylor:
        W_srv = compensate_stale(W_sent, comp_blocks, stale_v, fed)
        # delivered-weighted per-element movement (padding drops out)
        per_row = torch.zeros((S,), dtype=torch.float32, device=dev)
        for a, b in zip(tree_leaves(W_srv), tree_leaves(W_sent)):
            per_row = per_row + torch.sum(
                torch.abs(a - b.float()).reshape(S, -1), dim=1)
        den = float(sum(l.numel() for l in tree_leaves(W_sent))) / S
        if split:
            num = act_mean(per_row) / max(den, 1.0)
        else:
            num = torch.sum(per_row * w_row) / (wsum_act * max(den, 1.0))
        comp_norm = torch.where(do_consensus, num, torch.zeros_like(num))

    # Byzantine-robust pre-aggregation over the S delivered messages
    # (padding rows are invisible to the robust statistics)
    if fed.robust_consensus != "none":
        W_srv = _robust_broadcast(W_srv, w_row, state.z, fed)

    if fed.fedbuff_lr_norm:
        # sum(weight) is the realized K, duplicate deliveries included
        k_arr = (block_metrics["n_active"] if split else torch.sum(w_row)) \
            if arrivals is None \
            else torch.as_tensor(arrivals, device=dev).float()
        lr_scale = true_div(k_arr, C)

    # the dual term sum_j w_j phi_j / C, the same left-fold over the block
    chunk = fed.consensus_chunk if fed.consensus_streaming else 0

    def phi_fold(phi_l):
        rows = phi_l.reshape(S, -1)
        if dual_message == "int8":
            return kref.fold_dual_rowsum(rows, w_row, chunk_size=chunk)
        if chunk:
            return kref.fold_weighted_rowsum_stream(rows, w_row, chunk)
        return kref.fold_weighted_rowsum(rows, w_row)

    if split:
        # this rank's folds of every leaf, one all-reduce, then / C
        folds = [phi_fold(phi_l) for phi_l in tree_leaves(phi_g)]
        flat = all_reduce_sum(torch.cat(folds), ranks.data)
        phi_means, at = [], 0
        for f in folds:
            phi_means.append(true_div(flat[at:at + f.numel()], C))
            at += f.numel()
        del folds, flat
    else:
        phi_means = [true_div(phi_fold(phi_l), C)
                     for phi_l in tree_leaves(phi_g)]

    # one call over every leaf: B2 or B3 launch once a round (over several
    # ranks: a partial and a finish per dtype group)
    z_upd = iter(kops.sign_consensus_leaves(
        [z_l.reshape(-1) for z_l in tree_leaves(state.z)],
        [w_l.reshape(S, -1) for w_l in tree_leaves(W_srv)],
        phi_means, s_w, fed.psi, fed.alpha_z, message=sign_message,
        n_total=C, streaming=fed.consensus_streaming,
        chunk_size=fed.consensus_chunk,
        ranks=ranks))
    del phi_means

    def z_step(z_l):
        zf = z_l.reshape(-1)
        z_u = next(z_upd)
        if fed.fedbuff_lr_norm:
            z_u = (zf.float() + lr_scale * (z_u.float() - zf.float())
                   ).to(z_l.dtype)
        return torch.where(do_consensus, z_u, zf).reshape(z_l.shape)

    z_new = tree_map(z_step, state.z)

    # ---------------- Step 3: delivered clients update phi, sync z --------
    a2_t = reg_decay(fed.alpha_phi, t, fed.reg_decay_pow)
    W_dual = W_prop
    if taylor:
        lag = torch.clamp_min((t - tau_g).float() - 1.0, 0.0)
        W_dual = compensate_stale(W_prop, comp_blocks, lag, fed)

    def phi_step(phi_l, z_l, w_l):
        upd = (z_l[None].float() - w_l.float()) - a2_t * phi_l.float()
        if fed.staleness_decay != "constant":
            upd = upd * s_w_dual.reshape((-1,) + (1,) * (phi_l.ndim - 1))
        return phi_l.float() + fed.alpha_phi * upd

    phi_new = scatter_clients(state.phi, write_idx,
                              tree_map(phi_step, phi_g, z_new, W_dual))
    z_local_new = scatter_clients(
        state.z_local, write_idx,
        tree_map(lambda z_l: z_l[None].float().expand((S,) + z_l.shape),
                 z_new))

    new_state = FedState(W=W_new, z=z_new, z_local=z_local_new, phi=phi_new,
                         lam=lam_new, eps=eps_new, t=t + 1, opt=new_opt,
                         tau=tau_new, comp=new_comp)

    # mean ||z - w_i||^2 / D over the delivered block
    sq, n = torch.zeros((), device=dev), 0
    for z_l, w_l in zip(tree_leaves(z_new), tree_leaves(W_prop)):
        diff = z_l[None].float() - w_l.float()
        d = torch.sum(torch.square(diff), dim=tuple(range(1, w_l.ndim)))
        sq = sq + (torch.sum(d * w_row) if split else act_mean(d))
        n += z_l.numel()
    if split:
        sq = all_reduce_sum(sq.reshape(1), ranks.data)[0] / wsum_act
    return new_state, dict(block_metrics,
                           consensus_gap_block=sq / float(max(n, 1)),
                           compensation_norm_block=comp_norm)
