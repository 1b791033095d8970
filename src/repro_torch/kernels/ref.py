"""Plain PyTorch versions of the Eq. (20) consensus kernels.

Each function here is the plain version of one CUDA kernel in
``csrc/sign_agg.cu``: the CPU path of its wrapper (``kernels/sign_agg.py``)
and the yardstick the kernel is held to on the card.  They mirror the
consensus oracles of the JAX package's ``kernels/ref.py``.

Every cross-client sum adds rows strictly in order (a Python loop of
``acc = acc + w[j] * X[j]`` in f32), never through ``torch.sum``, which
regroups.  The kernels loop rows in the same order with the same
roundings, so they agree with these folds bit for bit.  Divisions by the
client count are true divisions (see :func:`true_div`).
"""
from __future__ import annotations

from typing import Optional

import torch


def jsign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: +-1 off zero, the operand itself at +-0 and NaN.
    (``torch.sign`` maps NaN to 0 and -0.0 to +0.0.)"""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def true_div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` rounded once.  CUDA's tensor-by-Python-scalar division
    multiplies by the reciprocal, which can be 1 ulp off; dividing by a
    full tensor is a true division on every device."""
    return x / torch.full_like(x, float(n))


def fold_weighted_rowsum(X: torch.Tensor, weights: torch.Tensor
                         ) -> torch.Tensor:
    """``sum_j weights[j] * X[j]`` accumulated strictly in row order, in
    f32.  A zero-weight row adds an exact +-0.0, so the masked C-row fold
    equals the fold over just the surviving rows."""
    Xf = X.float()
    wf = weights.float()
    acc = torch.zeros(X.shape[1:], dtype=torch.float32, device=X.device)
    for j in range(X.shape[0]):
        acc = acc + wf[j] * Xf[j]
    return acc


def _epilogue(z: torch.Tensor, phi_mean: torch.Tensor, ssum: torch.Tensor,
              n: int, psi: float, alpha_z: float) -> torch.Tensor:
    """``z - alpha_z * (phi_mean + psi * ssum / n)`` in f32, cast to z's
    dtype — the kernels' epilogue, one rounding per operation."""
    dz = phi_mean.float() + psi * true_div(ssum, n)
    return (z.float() - alpha_z * dz).to(z.dtype)


def sign_agg_ref(z: torch.Tensor, W: torch.Tensor, phi_mean: torch.Tensor,
                 psi: float, alpha_z: float) -> torch.Tensor:
    """B1: ``z - alpha_z * (phi_mean + psi * mean_i sign(z - w_i))``.
    z, phi_mean: (D,); W: (C, D)."""
    zf = z.float()
    Wf = W.float()
    acc = torch.zeros_like(zf)
    for i in range(W.shape[0]):
        acc = acc + jsign(zf - Wf[i])
    return _epilogue(z, phi_mean, acc, W.shape[0], psi, alpha_z)


def sign_agg_fold_ref(z: torch.Tensor, W: torch.Tensor,
                      phi_mean: torch.Tensor, weights: torch.Tensor,
                      psi: float, alpha_z: float,
                      n_total: int) -> torch.Tensor:
    """B2: ``z - alpha_z * (phi_mean + psi * fold_j w_j sign(z - W_j) /
    n_total)`` — the staleness-weighted sum, normalised by ``n_total``."""
    zf = z.float()
    Wf = W.float()
    wf = weights.float()
    acc = torch.zeros_like(zf)
    for j in range(W.shape[0]):
        acc = acc + wf[j] * jsign(zf - Wf[j])
    return _epilogue(z, phi_mean, acc, n_total, psi, alpha_z)


def sign_agg_weighted_ref(z: torch.Tensor, W: torch.Tensor,
                          phi_mean: torch.Tensor, weights: torch.Tensor,
                          psi: float, alpha_z: float) -> torch.Tensor:
    """B2 with the divisor C: ``sum_i s_i sign(z - w_i) / C`` (divided by
    C, not by ``sum(s_i)``); all-ones weights reduce to B1."""
    return sign_agg_fold_ref(z, W, phi_mean, weights, psi, alpha_z,
                             W.shape[0])


def int8_sign_sum(payload: torch.Tensor,
                  scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``sum_i scale_i * payload_i`` from the int8 wire, never in int8:
    an exact int32 sum when unweighted, the f32 row-order fold when
    weighted."""
    if scale is None:
        return payload.to(torch.int32).sum(0, dtype=torch.int32).float()
    return fold_weighted_rowsum(payload, scale)


def sign_agg_int8_fold_ref(z: torch.Tensor, payload: torch.Tensor,
                           scale: Optional[torch.Tensor],
                           phi_mean: torch.Tensor, psi: float,
                           alpha_z: float, n_total: int) -> torch.Tensor:
    """B3: the consensus update read from the int8 wire, divisor
    ``n_total``.  ``payload``: (C, D) int8 signs; ``scale``: (C,) f32 or
    ``None``."""
    return _epilogue(z, phi_mean, int8_sign_sum(payload, scale), n_total,
                     psi, alpha_z)


def sign_agg_int8_ref(z: torch.Tensor, payload: torch.Tensor,
                      scale: Optional[torch.Tensor], phi_mean: torch.Tensor,
                      psi: float, alpha_z: float) -> torch.Tensor:
    """B3 with the divisor C.  Given ``payload = sign(z - w_i)`` and
    ``scale = s`` this equals :func:`sign_agg_weighted_ref` bit for bit
    (a sign message quantizes losslessly)."""
    return sign_agg_int8_fold_ref(z, payload, scale, phi_mean, psi, alpha_z,
                                  payload.shape[0])
