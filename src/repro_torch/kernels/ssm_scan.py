"""Wrapper of the selective-scan CUDA kernel (B6).

Replaces the Pallas TPU kernel ``ssm_scan`` of the JAX package
(``kernels/ssm_scan.py:44``): the diagonal recurrence
``h_t = a_t * h_{t-1} + b_t`` over a, b (B, S, D, N) in f32 or bf16 (read
as f32), returning hs (B, S, D, N) in f32.  The Pallas kernel starts from
``h_0 = 0``; this one also takes ``h0`` (B, D, N) f32, which the model's
chunk loop (``models/ssm.mamba_scan``) carries from chunk to chunk.
``h0=None`` is zeros.  Plain version: ``ref.ssm_scan_ref``.

What bounds it on the H100 is bytes: a and b read once, hs written once
(and h0 read once), over 3.35 TB/s; two flops per element.  The kernel
(``csrc/ssm_scan.cu``) gives each of the B * D * N chains one thread,
which keeps h in a register and walks t with the next steps' loads in
flight; consecutive threads read consecutive (d, n), so every load and
store of a warp is one contiguous segment.  It rounds ``a_t * h`` and
``+ b_t`` separately, as the plain version does, so the two agree bit
for bit.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES["ssm_scan"]`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref

LAUNCHES: Dict[str, int] = {"ssm_scan": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 65535       # the grid's second dimension


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature."""
    lib = _build.load("ssm_scan")
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.repro_ssm_scan.argtypes = [i, p, p, p, p, i, i, ctypes.c_longlong, p]
    lib.repro_ssm_scan.restype = ctypes.c_int
    return lib


def check_args(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor]) -> int:
    """Raise on anything the kernel does not take; returns the dtype code.
    The device is checked last."""
    if a.ndim != 4 or a.shape != b.shape:
        raise ValueError(f"expected a, b (B, S, D, N) of one shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    B, S, D, N = a.shape
    if min(B, S, D, N) < 1 or B > MAX_BATCH:
        raise ValueError(f"shape {tuple(a.shape)} out of range (every size "
                         f">= 1, B <= {MAX_BATCH})")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must both be float32 or bfloat16, got "
                        f"{a.dtype}, {b.dtype}")
    named = [("a", a), ("b", b)]
    if h0 is not None:
        if h0.shape != (B, D, N) or h0.dtype != torch.float32:
            raise ValueError(f"h0 must be float32 {(B, D, N)}, got "
                             f"{h0.dtype} {tuple(h0.shape)}")
        named.append(("h0", h0))
    for name, t in named:
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {a.device}")
    return DTYPES[a.dtype]


def ssm_scan(a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B6.  a, b: (B, S, D, N) f32 or bf16; h0: (B, D, N) f32 or None
    (zeros).  Returns hs: (B, S, D, N) f32."""
    if a.device.type == "cpu":
        return ref.ssm_scan_ref(a, b, h0)
    code = check_args(a, b, h0)
    B, S, D, N = a.shape
    hs = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    err = _lib().repro_ssm_scan(
        code, a.data_ptr(), b.data_ptr(),
        None if h0 is None else h0.data_ptr(), hs.data_ptr(), B, S, D * N,
        _build.stream_of(a))
    _build.check_launch(err, "ssm_scan")
    LAUNCHES["ssm_scan"] += 1
    return hs
