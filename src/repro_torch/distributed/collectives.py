"""Wire formats for the cross-client consensus collectives (Eq. 20 / 22),
ported from the JAX package's ``distributed/collectives.py``.

**Sign messages (Eq. 20) — int8 is lossless.**  The server consumes
``m_i = s(d_i) * sign(z - w_i)``, which takes only the values
``{-s_i, 0, +s_i}``: an int8 payload holding the sign plus one f32 scale
``s_i`` per client reproduces it exactly.

**Dual messages (Eq. 22) — int8 is tolerance-pinned.**  The phi_i uploads
are full-range floats; their int8 format is a row-local absmax quantizer,
payload ``round(phi / s)`` in [-127, 127] with ``s = absmax/127``, whose
per-coordinate decode error is at most ``absmax * DUAL_INT8_REL_ERR``.

Reductions never accumulate in the wire dtype: int8 wraps once
``|sum_i sign_i| >= 128``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.ref import int8_sign_sum, jsign, true_div


class SignMessage(NamedTuple):
    """``payload``: (C, D) int8 signs in {-1, 0, +1}; ``scale``: (C,) f32
    per-client scale ``s(d_i)``, or ``None`` for the unweighted message."""
    payload: torch.Tensor
    scale: Optional[torch.Tensor]


def encode_sign_message(z: torch.Tensor, W: torch.Tensor,
                        weights: Optional[torch.Tensor] = None
                        ) -> SignMessage:
    """Client-side encode of ``s_i * sign(z - w_i)``, computed in f32.
    z: (D,); W: (C, D); weights: (C,) or None."""
    sgn = jsign(z[None, :].float() - W.float())
    scale = None if weights is None else weights.float()
    return SignMessage(payload=sgn.to(torch.int8), scale=scale)


def decode_sign_message(msg: SignMessage) -> torch.Tensor:
    """Dequantize back to the (C, D) f32 message ``s_i * sign(z - w_i)``."""
    m = msg.payload.float()
    if msg.scale is None:
        return m
    return m * msg.scale[:, None]


def sign_sum(msg: SignMessage, n_clients: int) -> torch.Tensor:
    """Server-side reduce ``sum_i s_i sign(z - w_i) / C`` from the wire:
    int32 when unweighted, an f32 row-order fold when weighted."""
    return true_div(int8_sign_sum(msg.payload, msg.scale), n_clients)


def message_bytes(n_clients: int, dim: int, message: str,
                  weighted: bool = True) -> Tuple[int, int]:
    """(bytes across the client axis, per-client side-channel bytes) of
    one consensus round's sign messages."""
    if message == "f32":
        return n_clients * dim * 4, 0
    if message == "int8":
        return n_clients * dim * 1, n_clients * 4 if weighted else 0
    raise ValueError(f"unknown sign message format: {message!r}")


DUAL_INT8_LEVELS = 127
DUAL_INT8_REL_ERR = 0.5 / DUAL_INT8_LEVELS


class DualMessage(NamedTuple):
    """``payload``: (C, D) int8 in [-127, 127]; ``scale``: (C,) f32
    ``absmax(phi_i) / 127`` (1.0 for an all-zero row)."""
    payload: torch.Tensor
    scale: torch.Tensor


def encode_dual_message(phi: torch.Tensor) -> DualMessage:
    """Row-local absmax quantization of the dual uploads ``phi`` (C, D)."""
    phif = phi.float()
    absmax = phif.abs().amax(dim=-1)
    scale = torch.where(absmax > 0.0, true_div(absmax, DUAL_INT8_LEVELS),
                        torch.ones_like(absmax))
    # the f32-rounded scale can sit a ulp low: clip so int8 never wraps
    q = torch.clamp(torch.round(phif / scale[..., None]),
                    -DUAL_INT8_LEVELS, DUAL_INT8_LEVELS)
    return DualMessage(payload=q.to(torch.int8), scale=scale)


def decode_dual_message(msg: DualMessage) -> torch.Tensor:
    """Dequantize back to the (C, D) f32 dual messages."""
    return msg.payload.float() * msg.scale[..., None]


def dual_message_bytes(n_clients: int, dim: int, message: str
                       ) -> Tuple[int, int]:
    """(bytes across the client axis, per-client side-channel bytes) of
    one consensus round's Eq. (22) dual uploads."""
    if message == "f32":
        return n_clients * dim * 4, 0
    if message == "int8":
        return n_clients * dim * 1, n_clients * 4
    raise ValueError(f"unknown dual message format: {message!r}")
