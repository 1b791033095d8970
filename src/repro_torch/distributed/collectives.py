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

**The exchanges between ranks** are two.  A round whose clients are
split over the ``"data"`` ranks, a client's batch over the ``"model"``
ranks (``distributed/data_parallel.py``), makes one, :func:`all_reduce_sum`.
A serving step over the ``"model"`` ranks
(``distributed/tensor_parallel.py``) also makes :func:`all_gather`: a
rank's heads, its block of a split cache's attention, its vocabulary
block of the logits, a norm scale the plan split.  gloo takes CUDA
tensors for both.  Each call over a group of more than one rank adds to
:data:`COLLECTIVES` (calls and bytes per mesh axis: the tensor's bytes
for an all-reduce, this rank's block's for an all-gather) and to the
active ``roofline.cost.CostCounter`` (the same bytes, the group's size
and its stride in the mesh's rank order), which is how the dry-run sees
a collective: on ``meta`` tensors nothing is sent.  A group of one rank
sends and counts nothing.  The int8 sign wire's partial sums travel as
int32: 4 bytes a coordinate, as the f32 wire's.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.ref import int8_sign_sum, jsign, true_div
from repro_torch.roofline import cost

# mesh axis -> {"calls": n, "bytes": b} of the exchanges made
COLLECTIVES: Dict[str, Dict[str, int]] = {}


def reset_collective_counts() -> None:
    COLLECTIVES.clear()


def _count(kind: str, t: torch.Tensor, axis) -> None:
    nbytes = t.numel() * t.element_size()
    rec = COLLECTIVES.setdefault(axis.name, {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += nbytes
    cost.add_collective(kind, axis.name, nbytes, axis.size, axis.stride)


def _group(t: torch.Tensor, axis):
    if axis.group is None:
        raise RuntimeError(f"no process group for the {axis.name!r} axis of "
                           f"{axis.size} ranks")
    return axis.group


def all_reduce_sum(t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` summed over the ranks of ``axis`` (a
    ``data_parallel.Axis``), in place; returns ``t``.  Every rank gets the
    same bits.  Over one rank (or ``axis`` None) nothing moves; on
    ``meta`` the call is counted and nothing moves."""
    if axis is None or axis.size == 1:
        return t
    _count("all_reduce", t, axis)
    if t.device.type == "meta":
        return t
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_group(t, axis))
    return t


def all_gather(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Every rank's ``t`` (alike in shape and dtype) concatenated along
    ``dim`` in the rank order of ``axis`` (a ``data_parallel.Axis``): a
    new tensor, the same bits on every rank.  Over one rank (or ``axis``
    None) ``t`` itself; on ``meta`` the call is counted and the result
    has the gathered shape."""
    if axis is None or axis.size == 1:
        return t
    t = t.contiguous()
    _count("all_gather", t, axis)
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    if t.device.type != "meta":      # on meta: the same buffers, no send
        import torch.distributed as dist

        dist.all_gather(parts, t, group=_group(t, axis))
    return torch.cat(parts, dim=dim)


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
