"""Wrapper of the prefill attention CUDA kernel (B4).

Replaces the Pallas TPU kernel ``flash_attention`` of the JAX package
(``kernels/flash_attention.py:84``): GQA softmax attention with a causal
and/or sliding-window mask, in the model's layout — q (B, Sq, H, D), k and
v (B, Sk, Hkv, D), out (B, Sq, H, D) in q's dtype.  Queries are
end-aligned with the keys, as in the plain version
``ref.flash_attention_ref``.

What bounds it on the H100 is operations: ``4*B*H*D`` flops per kept
query-key pair.  ``csrc/flash_attention.cu`` holds two kernels behind one
entry point, by dtype, both on the tensor cores (``mma.sync``): float32 by
3xTF32 (each operand split into two TF32 halves, three TF32 products for
each f32 one, at 494.7 TFLOP/s), so that the output stays within abs/rel
3e-5 of the plain version; bfloat16 (989 TFLOP/s) with P split into two
bf16 halves, so that the output stays within one bf16 rounding of it.
Both run one block per (query tile, head, batch), loop over the key
tiles with the online softmax in registers, and skip key tiles the mask
removes whole.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES["flash_attention"]`` counts launches.  A
``meta`` tensor takes the card's checks, gets ``meta`` outputs and adds
the kernel's work (``roofline.kernel_cost``) to the active
``roofline.cost.CostCounter``; it launches nothing and counts no launch.

Under autograd (grad mode on and q, k or v requiring grad) the call is
:class:`FlashAttentionFn`, whose forward is B4 with its optional f32
log-sum-exp output (either dtype) and whose backward is
``csrc/flash_attention_bwd.cu`` on the tensor cores (three launches a
call: dQ with delta, each query head's dK and dV in f32, their sum over
each KV head's group in a fixed order), f32 (3xTF32) or bf16 at the
forward's head dims (64, 128, 256: a block computes one 64-wide slice of
the head); ``LAUNCHES["flash_attention_bwd"]`` counts the launches of both
dtypes and every head dim.  On the CPU the Function runs the plain
``ref.flash_attention_ref(with_lse=True)`` and
``ref.flash_attention_bwd_ref``.  What the forward refuses raises under
autograd too, on the card and on ``meta``, before anything runs.  Neither
direction falls back to the plain version or to the other device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.roofline import cost, kernel_cost

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = HEAD_DIMS
BWD_LAUNCHES = 3       # launches of one backward call: dq, the per-head
                       # dk/dv partials, their sum
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature."""
    lib = _build.load("flash_attention")
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.repro_flash_attention.argtypes = [i, p, p, p, p, p, i, i, i, i, i,
                                          i, i, i, f, p]
    lib.repro_flash_attention.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    """The backward's library, built at first use, with its C signature."""
    lib = _build.load("flash_attention_bwd")
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.repro_flash_attention_bwd.argtypes = [i, *[p] * 11, *[i] * 8, f, p]
    lib.repro_flash_attention_bwd.restype = ctypes.c_int
    return lib


def check_attention_args(q: torch.Tensor, tensors, D: int, H: int,
                         Hkv: int) -> int:
    """The checks B4 and B5 share: dtype (f32 or bf16, all alike), one
    device, contiguity, 16-byte alignment, the head dim, the GQA group,
    and last that the device is a GPU.  Returns the dtype code."""
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in tensors:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (one of {HEAD_DIMS})")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads do not split into {Hkv} KV "
                         "head groups")
    if q.device.type not in _build.KERNEL_DEVICES:
        raise ValueError(f"the kernel needs CUDA tensors, got {q.device}")
    return DTYPES[q.dtype]


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: int) -> int:
    """Raise on anything the kernel does not take; returns the dtype
    code."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Sq, H, D) and k, v (B, Sk, Hkv, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Sq < 1 or Sk < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match")
    if causal and Sq > Sk:
        raise ValueError(f"causal attention with Sq={Sq} > Sk={Sk} leaves "
                         "query rows without keys")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return check_attention_args(q, (("q", q), ("k", k), ("v", v)), D, H, Hkv)


def _launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: int, lse: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    code = check_args(q, k, v, causal, window)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if q.device.type == "meta":
        cost.add_kernel("flash_attention",
                        kernel_cost.flash_work(q, k, causal, window))
        return out
    err = _lib().repro_flash_attention(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Sk, H, Hkv, D,
        int(causal), window, ref.attention_scale(D), _build.stream_of(q))
    _build.check_launch(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4 with the log-sum-exp of each row's scaled logits: returns
    ``(out, lse)``, lse (B, H, Sq) f32 for f32 and bf16 inputs alike.  The
    kernel writes lse at its flush; ``out`` is the same bit for bit as
    without it."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       with_lse=True)
    B, Sq, H, _ = q.shape
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    return _launch_forward(q, k, v, causal, window, lse), lse


def check_grad_args(q: torch.Tensor) -> None:
    """What B4's backward kernel does not take, checked before the
    forward runs under autograd on the card or on ``meta``: a head dim
    outside BWD_HEAD_DIMS, which are the forward's (both dtypes are
    taken)."""
    if q.shape[-1] not in BWD_HEAD_DIMS:
        raise ValueError(f"B4's backward takes head dim {BWD_HEAD_DIMS}, "
                         f"got {q.shape[-1]}")


def check_bwd_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   causal: bool, window: int) -> None:
    """Raise on anything the backward kernel does not take: besides
    :func:`check_grad_args` and the forward's checks, ``out`` and ``dout``
    in q's shape and dtype, and ``lse`` (B, H, Sq) f32 on q's device,
    contiguous.  Returns the dtype code."""
    check_grad_args(q)
    D = q.shape[-1]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's {tuple(q.shape)}")
    B, Sq, H, _ = q.shape
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {(B, H, Sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous on {q.device}")
    for name, t in (("out", out), ("dout", dout)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q {q.dtype}")
    check_args(q, k, v, causal, window)
    return check_attention_args(q, (("out", out), ("dout", dout)), D, H,
                                k.shape[2])


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B4's gradient: (dq, dk, dv) of ``sum(out * dout)`` from the
    forward's inputs, ``out`` and ``lse``, in q's dtype (f32 or bf16).  A
    CPU tensor goes to ``ref.flash_attention_bwd_ref``; a CUDA tensor
    launches the three kernels of ``csrc/flash_attention_bwd.cu`` or
    raises."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           causal=causal, window=window)
    code = check_bwd_args(q, k, v, out, lse, dout, causal, window)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    # each query head's dK and dV sums, f32, summed per KV head in order
    part = torch.empty((2, B, Sk, H, D), dtype=torch.float32,
                       device=q.device)
    if q.device.type == "meta":
        cost.add_kernel("flash_attention_bwd",
                        kernel_cost.flash_bwd_work(q, k, causal, window),
                        launches=BWD_LAUNCHES)
        return dq, dk, dv
    err = _bwd_lib().repro_flash_attention_bwd(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), part.data_ptr(), B, Sq, Sk, H, Hkv,
        D, int(causal), window, ref.attention_scale(D), _build.stream_of(q))
    _build.check_launch(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += BWD_LAUNCHES
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """B4 under autograd: forward :func:`flash_attention_fwd`, backward
    :func:`flash_attention_bwd`, each on the inputs' device."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # dO comes through ``reshape(B, S, -1) @ wo``'s backward and may
        # be strided; the kernel's checks want it dense
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """B4.  q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D).  Returns (B, Sq, H, D)
    in q's dtype.  ``window`` > 0 keeps keys with ``ki > qi - window``.
    Under autograd, :class:`FlashAttentionFn`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type in _build.KERNEL_DEVICES:
            check_grad_args(q)
        return FlashAttentionFn.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _launch_forward(q, k, v, causal, window, None)
