"""Wrapper of the decode attention CUDA kernel (B5).

Replaces the Pallas TPU kernel ``decode_attention`` of the JAX package
(``kernels/decode_attention.py:66``): one query token per head against a
KV cache with a per-row valid ``length``, in the model's layout — q
(B, H, D), the cache k and v (B, L, Hkv, D), length (B,) int32, out
(B, H, D) in q's dtype.  Plain version: ``ref.decode_attention_ref``.

What bounds it on the H100 is bytes: the valid part of the cache, read
once, over 3.35 TB/s.  The kernel (``csrc/decode_attention.cu``) reads
the cache in place, once per KV head for the whole query-head group, and
cuts the cache into at most ``MAX_SPLITS`` splits of ``split_len``
positions, one block each; the splits of one (row, KV head) pair form a
thread-block cluster and merge through its distributed shared memory, so
one call is one launch at every shape.  ``length[b]`` must be >= 1 (the
model's is ``min(step + 1, L)``); nothing at or past it is read.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES["decode_attention"]`` counts kernel
launches, as the C entry point reports them: ``launches_per_call`` (1)
per call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import check_attention_args

LAUNCHES: Dict[str, int] = {"decode_attention": 0}
CHUNK = 64              # splits hold whole chunks of this many positions
BLOCKS_PER_SM = 4       # splits are sized for this many blocks per SM
MAX_SPLITS = 8          # blocks per cluster, the portable cluster size (.cu)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signature."""
    lib = _build.load("decode_attention")
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.repro_decode_attention.argtypes = [i, p, p, p, p, p, i, i, i, i, i,
                                           i, f, p, ctypes.POINTER(i)]
    lib.repro_decode_attention.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_len(B: int, Hkv: int, L: int, n_sm: int) -> int:
    """Positions per split: whole chunks, covering L in at most
    ``MAX_SPLITS`` splits (one cluster per (row, KV head) pair), as few
    as give about ``BLOCKS_PER_SM`` blocks per SM over the B * Hkv pairs,
    and never more splits than chunks."""
    n = min(_cdiv(BLOCKS_PER_SM * n_sm, B * Hkv), _cdiv(L, CHUNK),
            MAX_SPLITS)
    return _cdiv(_cdiv(L, n), CHUNK) * CHUNK


def launches_per_call(B: int, Hkv: int, L: int, n_sm: int) -> int:
    """Kernel launches one call makes on a card of ``n_sm`` SMs: one, at
    every shape (the splits merge inside the launch)."""
    return 1


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length: torch.Tensor) -> int:
    """Raise on anything the kernel does not take; returns the dtype
    code."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, H, D) and k, v (B, L, Hkv, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or L < 1:
        raise ValueError(f"q {tuple(q.shape)} and the cache "
                         f"{tuple(k.shape)} do not match")
    if (length.dtype != torch.int32 or length.shape != (B,)
            or length.device != q.device or not length.is_contiguous()):
        raise ValueError(f"length must be contiguous int32 ({B},) on "
                         f"{q.device}, got {length.dtype} "
                         f"{tuple(length.shape)} on {length.device}")
    return check_attention_args(q, (("q", q), ("k", k), ("v", v)), D, H, Hkv)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """B5.  q: (B, H, D); k, v: (B, L, Hkv, D); length: (B,) int32 on q's
    device.  Returns (B, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, length)
    code = check_args(q, k, v, length)
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    sl = split_len(B, Hkv, L, _sm_count(q.device))
    out = torch.empty_like(q)
    launched = ctypes.c_int(0)
    err = _lib().repro_decode_attention(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), B, L, H, Hkv, D, sl, ref.attention_scale(D),
        _build.stream_of(q), ctypes.byref(launched))
    _build.check_launch(err, "decode_attention")
    LAUNCHES["decode_attention"] += launched.value
    return out
