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
kernel or raises.  ``LAUNCHES["flash_attention"]`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build, ref

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature."""
    lib = _build.load("flash_attention")
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.repro_flash_attention.argtypes = [i, p, p, p, p, i, i, i, i, i, i,
                                          i, i, f, p]
    lib.repro_flash_attention.restype = ctypes.c_int
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
    if q.device.type != "cuda":
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """B4.  q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D).  Returns (B, Sq, H, D)
    in q's dtype.  ``window`` > 0 keeps keys with ``ki > qi - window``."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    code = check_args(q, k, v, causal, window)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _lib().repro_flash_attention(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
        Sq, Sk, H, Hkv, D, int(causal), window, ref.attention_scale(D),
        _build.stream_of(q))
    _build.check_launch(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
