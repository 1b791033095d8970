"""Robust aggregation rules (the related-work baselines of Section II-C)
and the attention-based aggregation of FedAtt / FedDA; the port of the
JAX package's ``core/aggregators.py``.

All rules take a stacked client tree (leading axis C, nested dicts) and
return the aggregated tree.  Distance-based rules flatten clients to
(C, D) once, leaves in sorted-key order (``repro_torch.tree``).

:func:`robust_block` is the weight-aware, padding-safe family the round
paths use (``FedConfig.robust_consensus``): the same rules over a padded
block whose rows may be padding (``weight == 0``), built so the aggregate
depends only on the valid rows and their order.  The mechanisms:
a finite ``_BIG`` sentinel pushes invalid entries past every sort
(``0 * _BIG`` is an exact +0.0, where an ``inf`` sentinel would give
NaN), counts are exact 0/1 sums, rank masks are functions of the valid
count K, and every cross-row reduction is the row-order left-fold
:func:`repro_torch.kernels.ref.fold_weighted_rowsum` (a zero-weight row
adds an exact zero).  The reductions over the feature axis are not
built that way: row norms are one ``sum(dim=1)`` over the (R, D) block,
and krum's distances one such sum per row of pairs.  Each row's sum then
follows torch's reduction plan for an (R, D) block.  On the CPU that
plan reduces every contiguous row alike for any R, so the dense-active
and sparse rounds agree bit for bit (tested); on CUDA nothing promises
it, and the two are held to a drift rule there.

Two differences from the obvious torch calls, both kept on purpose:
``torch.median`` returns the lower of the two middle values where
``jnp.median`` averages them (:func:`_sorted_median` does the latter),
and a Python scalar divided by a tensor is a reciprocal and a product in
torch (``tau / nrm`` is written as a tensor division).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels.ref import fold_weighted_rowsum, jsign
from repro_torch.tree import tree_leaves, tree_map

# finite padding sentinel: larger than any real message coordinate, small
# enough that rank-mask folds stay finite (0 * _BIG == +0.0 exactly)
_BIG = 1e30

ROBUST_CONSENSUS_RULES = ("none", "trimmed_mean", "median", "krum",
                          "centered_clip")


def flat_stack(stacked: Any) -> torch.Tensor:
    """(C, D) f32 matrix of a stacked client tree."""
    leaves = tree_leaves(stacked)
    C = leaves[0].shape[0]
    return torch.cat([l.reshape(C, -1).float() for l in leaves], dim=1)


def unflatten_like(vec: torch.Tensor, template: Any) -> Any:
    """Inverse of :func:`flat_stack` for one (D,) vector, in the
    template's shapes and dtypes."""
    offset = [0]

    def take(l):
        n = l.numel()
        out = vec[offset[0]:offset[0] + n].reshape(l.shape).to(l.dtype)
        offset[0] += n
        return out

    return tree_map(take, template)


def _flat_one(tree: Any) -> torch.Tensor:
    """(D,) f32 vector of one (unstacked) tree."""
    return flat_stack(tree_map(lambda l: l[None], tree))[0]


def _row_norms(X: torch.Tensor) -> torch.Tensor:
    """``||X_i||_2`` per row."""
    return torch.sqrt(torch.sum(torch.square(X), dim=1))


def _weighted_mean(stacked: Any, w: torch.Tensor) -> Any:
    w = w.float()
    w = w / torch.clamp_min(torch.sum(w), 1e-9)

    def f(l):
        wl = w.reshape((-1,) + (1,) * (l.ndim - 1))
        return torch.sum(l.float() * wl, dim=0).to(l.dtype)

    return tree_map(f, stacked)


def _sorted_median(S: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of sorted rows: the mean of the two middle rows."""
    R = S.shape[0]
    return 0.5 * (S[(R - 1) // 2] + S[R // 2])


# ---------------------------------------------------------------------------
def fedavg(stacked: Any, weights: Optional[torch.Tensor] = None) -> Any:
    l0 = tree_leaves(stacked)[0]
    w = torch.ones((l0.shape[0],), device=l0.device) if weights is None \
        else weights
    return _weighted_mean(stacked, w)


def median(stacked: Any) -> Any:
    """Coordinate-wise median; an even count averages the middle two."""
    return tree_map(
        lambda l: _sorted_median(torch.sort(l.float(), dim=0).values
                                 ).to(l.dtype), stacked)


def _trim_k(C: int, trim_frac: float) -> int:
    """Per-side trim count: at least 1 whenever trimming is requested and
    the block can afford it, never so many that nothing is kept."""
    if trim_frac <= 0:
        return 0
    return min(max(int(C * trim_frac), 1), (C - 1) // 2)


def trimmed_mean(stacked: Any, trim_frac: float = 0.2) -> Any:
    def f(l):
        C = l.shape[0]
        k = _trim_k(C, trim_frac)
        s = torch.sort(l.float(), dim=0).values
        return torch.mean(s[k:C - k], dim=0).to(l.dtype)

    return tree_map(f, stacked)


def _pair_sq_dists(X: torch.Tensor) -> torch.Tensor:
    """(R, R) squared distances ``sum_d (X_i - X_j)^2``, the difference
    form (the Gram form cancels), one row of pairs at a time: never an
    (R, R, D) tensor.  Each row of pairs is one ``sum(dim=1)`` over an
    (R, D) block (see the module docstring on width invariance)."""
    return torch.stack([torch.sum(torch.square(X[i][None] - X), dim=1)
                        for i in range(X.shape[0])])


def krum(stacked: Any, n_byzantine: int, multi: int = 1) -> Any:
    """Krum / multi-Krum (Blanchard et al. 2017, ref [19])."""
    X = flat_stack(stacked)
    C = X.shape[0]
    d2 = _pair_sq_dists(X) + torch.eye(C, device=X.device) * 1e18
    k = max(C - n_byzantine - 2, 1)
    nearest = torch.sort(d2, dim=1).values[:, :k]
    scores = torch.sum(nearest, dim=1)
    if multi <= 1:
        w = torch.zeros((C,), device=X.device)
        w[torch.argmin(scores)] = 1.0
    else:
        idx = torch.topk(-scores, multi).indices
        w = torch.zeros((C,), device=X.device)
        w[idx] = 1.0
    return _weighted_mean(stacked, w)


def geomed(stacked: Any, iters: int = 64) -> Any:
    """Geometric median by Weiszfeld iterations (GeoMed, ref [53]),
    started at the coordinate-wise median."""
    X = flat_stack(stacked)
    y = _sorted_median(torch.sort(X, dim=0).values)
    for _ in range(iters):
        dist = torch.clamp_min(_row_norms(X - y), 1e-8)
        w = 1.0 / dist
        y = torch.sum(X * w[:, None], dim=0) / torch.sum(w)
    return unflatten_like(y, tree_map(lambda l: l[0], stacked))


def centered_clip(stacked: Any, center: Any, tau: float = 10.0,
                  iters: int = 3) -> Any:
    """Centered clipping (Karimireddy et al. 2021, ref [55])."""
    X = flat_stack(stacked)
    v = _flat_one(center)
    for _ in range(iters):
        diff = X - v
        nrm = torch.clamp_min(_row_norms(diff), 1e-9)[:, None]
        clipped = diff * torch.clamp_max(torch.full_like(nrm, tau) / nrm, 1.0)
        v = v + torch.mean(clipped, dim=0)
    return unflatten_like(v, center)


def fedatt_update(stacked: Any, server: Any, att: torch.Tensor,
                  stepsize: float) -> Any:
    delta = _weighted_mean(tree_map(lambda l, sv: l - sv[None].float(),
                                    stacked, server), att)
    return tree_map(lambda sv, d: (sv.float() + stepsize * d).to(sv.dtype),
                    server, delta)


def fedatt(stacked: Any, server: Any, stepsize: float = 1.0,
           temp: float = 1.0) -> Any:
    """FedAtt (Ji et al. 2019, ref [35]): attention weights from the
    distance between the server and each client model."""
    dist = _row_norms(flat_stack(stacked) - _flat_one(server))
    att = torch.softmax(-dist / temp, dim=0)
    return fedatt_update(stacked, server, att, stepsize)


def fedda(stacked: Any, server: Any, quasi_global: Any,
          stepsize: float = 1.0) -> Any:
    """FedDA (Zhang et al. 2021, ref [36]): dual attention against the
    server model and a quasi-global (momentum) model."""
    X = flat_stack(stacked)
    att_s = torch.softmax(-_row_norms(X - _flat_one(server)), dim=0)
    att_q = torch.softmax(-_row_norms(X - _flat_one(quasi_global)), dim=0)
    return fedatt_update(stacked, server, 0.5 * (att_s + att_q), stepsize)


def rsa_sign(stacked: Any, server: Any) -> Any:
    """RSA's server-side sign sum ``sum_i sign(z - w_i)`` (Li et al. 2019,
    ref [22]); plain PyTorch, as the reference's is plain XLA."""
    return tree_map(lambda z, w: torch.sum(jsign(z[None].float() - w.float()),
                                           dim=0), server, stacked)


AGGREGATORS = {
    "fedavg": fedavg,
    "median": median,
    "trimmed_mean": trimmed_mean,
    "krum": krum,
    "geomed": geomed,
    "centered_clip": centered_clip,
}


# ===========================================================================
# weight-aware, padding-safe block rules (FedConfig.robust_consensus)
# ===========================================================================
def _flat_valid(stacked: Any, weight: Optional[torch.Tensor]):
    """(R, D) f32 matrix, (R,) validity mask and the exact valid count K
    (a 0/1 sum, exact in f32 in any order)."""
    X = flat_stack(stacked)
    R = X.shape[0]
    w = torch.ones((R,), device=X.device) if weight is None \
        else torch.as_tensor(weight, device=X.device).float()
    valid = w > 0.0
    return X, valid, torch.sum(valid.float())


def _sorted_valid_first(X: torch.Tensor, valid: torch.Tensor
                        ) -> torch.Tensor:
    """Column-wise ascending sort with the invalid rows past every real
    value: the first K sorted rows are the sorted valid values."""
    big = torch.full_like(X, _BIG)
    return torch.sort(torch.where(valid[:, None], X, big), dim=0).values


def _block_trimmed_mean(X, valid, K, trim_frac: float) -> torch.Tensor:
    S = _sorted_valid_first(X, valid)
    k = torch.floor(K * trim_frac)
    if trim_frac > 0:
        k = torch.clamp_min(k, 1.0)           # trim at least one per side
    k = torch.clamp_min(torch.minimum(k, torch.floor((K - 1.0) / 2.0)), 0.0)
    j = torch.arange(S.shape[0], dtype=torch.float32, device=X.device)
    m = ((j >= k) & (j < K - k)).float()
    # rank-mask left-fold: rows past K carry _BIG but weight 0
    return fold_weighted_rowsum(S, m) / torch.clamp_min(K - 2.0 * k, 1.0)


def _block_median(X, valid, K) -> torch.Tensor:
    S = _sorted_valid_first(X, valid)
    R = S.shape[0]
    lo = torch.clamp(torch.floor((K - 1.0) / 2.0), 0, R - 1).long()
    hi = torch.clamp(torch.floor(K / 2.0), 0, R - 1).long()
    return 0.5 * (S.index_select(0, lo.reshape(1))[0]
                  + S.index_select(0, hi.reshape(1))[0])


def _block_krum(X, valid, K, n_byzantine: int) -> torch.Tensor:
    Xz = torch.where(valid[:, None], X, torch.zeros_like(X))
    d2 = _pair_sq_dists(Xz)
    R = X.shape[0]
    eye = torch.eye(R, dtype=torch.bool, device=X.device)
    pair_ok = valid[:, None] & valid[None, :] & ~eye
    d2 = torch.where(pair_ok, d2, torch.full_like(d2, _BIG))
    nearest = torch.sort(d2, dim=1).values
    # k nearest neighbours: K - b - 2 of the K - 1 valid distances, >= 1
    k_nn = torch.clamp(K - float(n_byzantine) - 2.0, min=1.0)
    k_nn = torch.minimum(k_nn, torch.clamp_min(K - 1.0, 1.0))
    j = torch.arange(R, dtype=torch.float32, device=X.device)
    scores = fold_weighted_rowsum(nearest.T, (j < k_nn).float())
    # invalid rows never win, even when every valid score is _BIG-sized
    # (K == 1): the mask is +inf, not _BIG; argmin takes the first minimum
    scores = torch.where(valid, scores, torch.full_like(scores,
                                                        float("inf")))
    return X.index_select(0, torch.argmin(scores).reshape(1))[0]


def _block_centered_clip(X, valid, K, center: torch.Tensor, tau: float,
                         iters: int) -> torch.Tensor:
    v = center.float()
    wv = valid.float()
    Kc = torch.clamp_min(K, 1.0)
    for _ in range(iters):
        diff = torch.where(valid[:, None], X - v[None],
                           torch.zeros_like(X))
        nrm = torch.clamp_min(_row_norms(diff), 1e-9)
        fac = torch.clamp_max(torch.full_like(nrm, tau) / nrm, 1.0)
        v = v + fold_weighted_rowsum(diff * fac[:, None], wv) / Kc
    return v


def robust_block(name: str, stacked: Any, weight: Optional[torch.Tensor],
                 center: Optional[Any] = None, *, trim_frac: float = 0.2,
                 n_byzantine: int = 0, clip_tau: float = 10.0,
                 clip_iters: int = 3) -> Any:
    """ONE robust aggregate of a padded message block, the
    ``FedConfig.robust_consensus`` dispatch both round paths share.

    ``stacked`` leaves: (R, ...), the round's consensus messages (R = C in
    the dense round, S_max in the gathered one); ``weight`` (R,) marks the
    valid deliveries (> 0; ``None``: all valid).  ``center`` (one model's
    tree, needed by ``centered_clip``) anchors the clipping at the current
    consensus z.  Returns one un-stacked tree shaped like a row.

    The result depends only on the valid rows and their relative order:
    invalid rows add exact zeros to every reduction.  A duplicate FedBuff
    delivery counts as a message of its own.
    """
    X, valid, K = _flat_valid(stacked, weight)
    if name == "trimmed_mean":
        v = _block_trimmed_mean(X, valid, K, trim_frac)
    elif name == "median":
        v = _block_median(X, valid, K)
    elif name == "krum":
        v = _block_krum(X, valid, K, n_byzantine)
    elif name == "centered_clip":
        if center is None:
            raise ValueError("robust_block('centered_clip') needs center=")
        v = _block_centered_clip(X, valid, K, _flat_one(center), clip_tau,
                                 clip_iters)
    else:
        raise ValueError(
            f"unknown robust_consensus rule {name!r} "
            f"(expected one of {ROBUST_CONSENSUS_RULES[1:]})")
    return unflatten_like(v, tree_map(lambda l: l[0], stacked))
