"""Public dispatch of the port's kernels (the port of the JAX package's
``kernels/ops.py``): the Eq. (20) consensus kernels B1-B3 (one leaf:
:func:`sign_consensus`; every leaf of a tree at once:
:func:`sign_consensus_leaves`), the attention kernels B4 (prefill) and B5
(decode), in the model's layout, and the Mamba recurrence B6.  B4-B6 go
straight to their wrappers, which launch the CUDA kernel for CUDA tensors
and run the plain version for CPU tensors.

``impl`` of the consensus dispatch (B1-B3):
  * ``"auto"``  — the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (the wrappers' own rule);
  * ``"cuda"``  — the CUDA kernel; raises for tensors off the GPU;
  * ``"torch"`` — the plain PyTorch version (``kernels/ref.py``) on any
    device: the yardstick, never chosen by ``"auto"`` for a CUDA tensor.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ref
from repro_torch.kernels import sign_agg as sa_k
from repro_torch.kernels import ssm_scan as ssm_k

IMPLS = ("auto", "cuda", "torch")


def _resolve(impl: str, z: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")
    if impl == "cuda" and z.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {z.device}")
    return impl


def _check_fold(weights, n_total, streaming: bool) -> None:
    if n_total is not None and weights is None:
        raise ValueError("n_total (active-subset reduction) needs weights "
                         "(the padding/activity mask at minimum)")
    if streaming and n_total is None:
        raise ValueError(
            "streaming=True is the chunked active-subset left-fold — "
            "it needs n_total (and weights)")


def sign_consensus(z: torch.Tensor, W: torch.Tensor, phi_mean: torch.Tensor,
                   weights: Optional[torch.Tensor], psi: float,
                   alpha_z: float, message: str = "f32", impl: str = "auto",
                   n_total: Optional[int] = None, streaming: bool = False,
                   chunk_size: int = 8) -> torch.Tensor:
    """The one Eq. (20) dispatch for every sign-sum flavour: plain mean
    (``weights=None``, B1), staleness-decayed (B2), and the int8 wire
    format (B3).

    z: (D,); W: (C, D) stacked client params (corruption and compensation
    already applied); phi_mean: (D,); weights: (C,) f32 or None.
    ``message="int8"`` encodes each client's ``s_i * sign(z - w_i)`` to an
    int8 payload plus per-client f32 scale on the client side (in f32,
    whatever ``impl``) and reduces from the wire.  Returns
    ``z - alpha_z * (phi_mean + psi * sum_i s_i sign(z - w_i) / n)`` with
    ``n = n_total or C``; ``n_total`` (the active-subset divisor) needs
    ``weights``.  ``streaming=True`` (needs ``n_total``) folds
    ``chunk_size`` rows at a time with the plain version on every device
    (see the module docstring); bit-identical to the materialized fold.
    """
    impl = _resolve(impl, z)
    _check_fold(weights, n_total, streaming)
    if streaming:
        return ref.sign_agg_fold_stream_ref(z, W, phi_mean, weights, psi,
                                            alpha_z, n_total, chunk_size,
                                            message=message)
    n = n_total or 0
    if message == "int8":
        msg = collectives.encode_sign_message(z, W, weights)
        if impl == "torch":
            return ref.sign_agg_int8_fold_ref(z, msg.payload, msg.scale,
                                              phi_mean, psi, alpha_z,
                                              n or W.shape[0])
        return sa_k.sign_agg_weighted_int8(z, msg.payload, msg.scale,
                                           phi_mean, psi, alpha_z, n_total=n)
    if message != "f32":
        raise ValueError(f"unknown sign message format: {message!r}")
    if weights is None:
        if impl == "torch":
            return ref.sign_agg_ref(z, W, phi_mean, psi, alpha_z)
        return sa_k.sign_agg(z, W, phi_mean, psi, alpha_z)
    if impl == "torch":
        return ref.sign_agg_fold_ref(z, W, phi_mean, weights, psi, alpha_z,
                                     n or W.shape[0])
    return sa_k.sign_agg_weighted(z, W, phi_mean, weights, psi, alpha_z,
                                  n_total=n)


def sign_consensus_leaves(zs: Sequence[torch.Tensor],
                          Ws: Sequence[torch.Tensor],
                          phis: Sequence[torch.Tensor],
                          weights: Optional[torch.Tensor], psi: float,
                          alpha_z: float, message: str = "f32",
                          impl: str = "auto",
                          n_total: Optional[int] = None,
                          streaming: bool = False, chunk_size: int = 8
                          ) -> List[torch.Tensor]:
    """:func:`sign_consensus` over every leaf of a tree, with the same
    arguments per leaf (``zs[l]``: (D_l,), ``Ws[l]``: (C, D_l),
    ``phis[l]``: (D_l,)) and the same ``impl`` rules: one grouped call
    (one launch) over all leaves.  ``message="f32"`` runs B1/B2;
    ``"int8"`` encodes each leaf on the client side as
    :func:`sign_consensus` does and runs B3 over every payload with the
    round's one scale column.  ``streaming=True`` runs the streamed plain
    fold per leaf instead, launching nothing."""
    impl = _resolve(impl, zs[0])
    _check_fold(weights, n_total, streaming)
    if streaming:
        return [ref.sign_agg_fold_stream_ref(z, W, phi, weights, psi,
                                             alpha_z, n_total, chunk_size,
                                             message=message)
                for z, W, phi in zip(zs, Ws, phis)]
    n = n_total or 0
    if message == "int8":
        msgs = [collectives.encode_sign_message(z, W, weights)
                for z, W in zip(zs, Ws)]
        payloads = [m.payload for m in msgs]
        if impl == "torch":
            return ref.sign_agg_int8_group_ref(zs, payloads, phis,
                                               msgs[0].scale, psi, alpha_z,
                                               n_total=n)
        return sa_k.sign_agg_int8_group(zs, payloads, phis, msgs[0].scale,
                                        psi, alpha_z, n_total=n)
    if message != "f32":
        raise ValueError(f"unknown sign message format: {message!r}")
    if impl == "torch":
        return ref.sign_agg_group_ref(zs, Ws, phis, weights, psi, alpha_z,
                                      n_total=n)
    return sa_k.sign_agg_group(zs, Ws, phis, weights, psi, alpha_z,
                               n_total=n)


def sign_agg(z, W, phi_mean, psi: float, alpha_z: float,
             impl: str = "auto") -> torch.Tensor:
    """B1 through ``impl`` (see the module docstring)."""
    return sign_consensus(z, W, phi_mean, None, psi, alpha_z, impl=impl)


def sign_agg_weighted(z, W, phi_mean, weights, psi: float, alpha_z: float,
                      impl: str = "auto") -> torch.Tensor:
    """B2 through ``impl``; ``weights``: (C,) staleness weights."""
    return sign_consensus(z, W, phi_mean, weights, psi, alpha_z, impl=impl)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """B4.  q: (B, Sq, H, D), k/v: (B, Sk, Hkv, D) — the model's layout,
    which the kernel reads as it is.  Returns (B, Sq, H, D).  Under
    autograd, ``flash_attention.FlashAttentionFn`` (B4 and its backward
    kernel on the card)."""
    return fa_k.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """B5.  q: (B, H, D); k/v: (B, L, Hkv, D) — the model's cache layout;
    length: (B,) int32 valid positions.  Returns (B, H, D)."""
    return dec_k.decode_attention(q, k, v, length)


def ssm_scan(a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B6.  a, b: (B, S, D, N); h0: (B, D, N) f32 or None (zeros).
    Returns hs: (B, S, D, N) f32, ``h_t = a_t * h_{t-1} + b_t``.  Under
    autograd, ``ssm_scan.SsmScanFn`` (B6 and its backward kernel on the
    card)."""
    return ssm_k.ssm_scan(a, b, h0)
