"""The one count of each kernel's work: operations and bytes of B1-B6 and
of the two backward kernels (B4's and B6's), as functions of the call's
shapes and dtypes, and the least time one H100 SXM could take for them.

The count is the algorithm's, not the implementation's: each input read
once, each output written once, the operations the math needs (B4 counts
the query-key pairs its mask keeps, not Sq x Sk).  So it reads the same
whatever runs the call: ``chip_smoke.py`` holds each kernel's time
against it, the kernel wrappers add it to the active
:class:`~repro_torch.roofline.cost.CostCounter` when they are called on
``meta`` tensors (the dry-run), and ``bench/kernel_bench.py`` prints it
beside each row.

The functions take tensors (on any device, ``meta`` included) and read
only their shapes and dtypes; B5's valid positions are a count.  Each
``*_work`` returns a :class:`Work`; :func:`bound_ms` turns one into the
least time and what bounds it.  The card's constants are NVIDIA's data
sheet for the SXM part, dense rates at the full 700 W power limit.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
HBM_BYTES = 80e9                 # H100 SXM device memory size
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 494.7e12      # H100 SXM tf32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
NVLINK_BYTES_PER_S = 450e9       # H100 SXM NVLink, one direction
# Between nodes: a DGX H100 node has 8 ConnectX-7 ports of 400 Gb/s, one
# per GPU (NVIDIA DGX H100 data sheet): 50 GB/s per GPU, one direction
IB_BYTES_PER_S = 50e9
GPUS_PER_NODE = 8                # one node: 8 GPUs joined by NVLink

# The rate each class of operations runs at.  "tf32x3" is an f32 product
# on the tensor cores by 3xTF32 (B4 in f32 and its backward): three TF32
# products for each f32 one, so its operations run at a third of the
# TF32 rate.  f32 matmuls run without TF32, on the CUDA cores.
RATES = {"f32": F32_FLOPS_PER_S, "tf32x3": TF32_FLOPS_PER_S / 3,
         "bf16": BF16_FLOPS_PER_S}


@dataclasses.dataclass(frozen=True)
class Work:
    """One call's work: ``flops`` operations of the class ``rate`` (a key
    of :data:`RATES`) and ``nbytes`` of device memory moved."""
    flops: float
    nbytes: float
    rate: str

    @property
    def t_ops(self) -> float:
        return self.flops / RATES[self.rate]

    @property
    def t_bytes(self) -> float:
        return self.nbytes / HBM_BYTES_PER_S


def bound_ms(work: Work) -> Tuple[float, str]:
    """The least time the card could take for ``work``, in ms (the larger
    of its two times), and whether ``"bytes"`` or ``"operations"`` bound
    it."""
    t_ops, t_bytes = work.t_ops, work.t_bytes
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _esize(t) -> int:
    return t.element_size()


def _vec_bytes(z) -> int:
    """z read and z' written in z's dtype, phi_mean read in f32 (the
    kernels read it so whatever z's dtype)."""
    return z.numel() * (2 * _esize(z) + 4)


# ---------------------------------------------------------------- B1-B3
def sign_agg_work(z, W, weights=None) -> Work:
    """B1 (``weights`` None) or B2 on one leaf: W (C, D) read once, z and
    phi_mean read, z' written (and the (C,) f32 weights); 2 operations an
    element of W (3 weighted), on the CUDA cores."""
    n = W.numel()
    if weights is None:
        return Work(2 * n, n * _esize(W) + _vec_bytes(z), "f32")
    return Work(3 * n, n * _esize(W) + _vec_bytes(z) + 4 * weights.numel(),
                "f32")


def sign_agg_int8_work(z, payload, scale=None) -> Work:
    """B3 on one leaf: the (C, D) int8 payload read once, z and phi_mean
    read, z' written (and the (C,) f32 scale); 2 operations an element
    weighted, 1 unweighted (an int32 sum)."""
    n = payload.numel()
    if scale is None:
        return Work(n, n + _vec_bytes(z), "f32")
    return Work(2 * n, n + _vec_bytes(z) + 4 * scale.numel(), "f32")


def total(works: Sequence[Work]) -> Work:
    """The work of several calls of one rate class (a grouped call's
    leaves)."""
    return Work(sum(w.flops for w in works), sum(w.nbytes for w in works),
                works[0].rate)


def sign_agg_group_work(zs, Ws, weights=None) -> Work:
    """B1/B2 over every leaf of a grouped call; the weights column is read
    once per leaf."""
    return total([sign_agg_work(z, W, weights) for z, W in zip(zs, Ws)])


def sign_agg_int8_group_work(zs, payloads, scale=None) -> Work:
    """B3 over every leaf of a grouped call."""
    return total([sign_agg_int8_work(z, p, scale)
                  for z, p in zip(zs, payloads)])


# ---------------------------------------------------------------- B4
def sign_sum_group_work(zs, Ws, weights=None) -> Work:
    """B1/B2's partial over every leaf: W (C_r, D) and z read once, the
    f32 sums written (``weights`` read once), C_r D signs and sums."""
    w = sum(W.numel() for W in Ws)
    nbytes = sum(W.numel() * _esize(W) + z.numel() * (_esize(z) + 4)
                 for z, W in zip(zs, Ws))
    if weights is not None:
        nbytes += weights.numel() * 4
    return Work(flops=(3.0 if weights is not None else 2.0) * w,
                nbytes=float(nbytes), rate="f32")


def sign_sum_int8_group_work(zs, payloads, scale=None) -> Work:
    """B3's partial over every leaf: the int8 payload read once, the
    4-byte sums written (``scale`` read once), a sum (and a product)
    an element."""
    w = sum(q.numel() for q in payloads)
    nbytes = w + sum(z.numel() * 4 for z in zs)
    if scale is not None:
        nbytes += scale.numel() * 4
    return Work(flops=(2.0 if scale is not None else 1.0) * w,
                nbytes=float(nbytes), rate="f32")


def sign_finish_group_work(zs, sums) -> Work:
    """The finish over every leaf: the 4-byte sums, z and phi_mean (f32)
    read, z' written; four operations an element."""
    d = sum(z.numel() for z in zs)
    return Work(flops=4.0 * d,
                nbytes=float(sum(_vec_bytes(z) for z in zs) + 4 * d),
                rate="f32")


# ---------------------------------------------------------- collectives
def span_nodes(size: int, stride: int) -> int:
    """The nodes of :data:`GPUS_PER_NODE` GPUs that a group of ``size``
    ranks ``stride`` apart in the mesh's row-major rank order (rank 0's
    group) touches: a 16-wide ``"model"`` group (stride 1) spans two, a
    ``"data"`` group (stride 16) one node a member."""
    return len({(i * stride) // GPUS_PER_NODE for i in range(size)})


def link_bytes_per_s(size: int, stride: int) -> float:
    """The slowest link of such a group: NVLink within a node, the
    InfiniBand port between nodes."""
    return NVLINK_BYTES_PER_S if span_nodes(size, stride) == 1 \
        else IB_BYTES_PER_S


def collective_s(kind: str, nbytes: float, size: int, stride: int) -> float:
    """The least time of one collective over such a group.  A ring
    all-reduce of an ``nbytes`` tensor sends ``2 (n - 1) / n`` of its
    bytes over each link; a ring all-gather of ``nbytes`` from each rank
    (the rank's block; ``collectives.all_gather`` counts it so) sends the
    ``n - 1`` other blocks over each link."""
    if size <= 1:
        return 0.0
    bw = link_bytes_per_s(size, stride)
    if kind == "all_reduce":
        return 2.0 * (size - 1) / size * nbytes / bw
    if kind == "all_gather":
        return (size - 1) * nbytes / bw
    raise ValueError(f"unknown collective {kind!r}")


def kept_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Query-key pairs the mask keeps (queries end-aligned with keys)."""
    qa = np.arange(Sq) + (Sk - Sq)
    hi = np.minimum(qa, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qa - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _tensor_core_class(q) -> str:
    import torch

    return "tf32x3" if q.dtype == torch.float32 else "bf16"


def flash_flops(q, k, causal: bool, window: int) -> int:
    """B4's operations: 4 B H D per kept query-key pair."""
    B, Sq, H, D = q.shape
    return 4 * B * H * D * kept_pairs(Sq, k.shape[1], causal, window)


def flash_work(q, k, causal: bool, window: int) -> Work:
    """B4: :func:`flash_flops` on the tensor cores (f32 by 3xTF32, bf16),
    q, k, v read once and out written once."""
    nbytes = (2 * q.numel() + 2 * k.numel()) * _esize(q)
    return Work(flash_flops(q, k, causal, window), nbytes,
                _tensor_core_class(q))


def bwd_flops(q, k, causal: bool, window: int) -> int:
    """B4 backward's operations: five products (S, dP, dV, dK, dQ) of
    2 B H D flops per kept query-key pair."""
    B, Sq, H, D = q.shape
    return 10 * B * H * D * kept_pairs(Sq, k.shape[1], causal, window)


def flash_bwd_work(q, k, causal: bool, window: int) -> Work:
    """B4's backward: :func:`bwd_flops` on the tensor cores as the
    forward's; q, k, v, out, dout (in their type) and lse (f32) read once,
    dq, dk, dv written once."""
    nbytes = _esize(q) * (4 * q.numel() + 4 * k.numel()) \
        + 4 * (q.numel() // q.shape[-1])
    return Work(bwd_flops(q, k, causal, window), nbytes,
                _tensor_core_class(q))


# ---------------------------------------------------------------- B5
def valid_positions(length, L: int) -> int:
    """The cache positions a B5 call reads: ``length`` clamped to the
    cache's L, summed over the rows.  Reads ``length``'s values (a host
    sync on the card)."""
    return int(length.clamp(max=L).sum())


def decode_work(q, k, valid: int) -> Work:
    """B5 over ``valid`` cache positions in all: their K and V read once,
    q read and out written, the (B,) int32 lengths; 4 H D operations per
    valid position, at the f32 rate for f32 and the bf16 rate for bf16."""
    import torch

    B, H, D = q.shape
    Hkv = k.shape[2]
    nbytes = (2 * valid * Hkv * D + 2 * q.numel()) * _esize(q) + 4 * B
    return Work(4 * H * D * valid, nbytes,
                "f32" if q.dtype == torch.float32 else "bf16")


def decode_partial_work(q, k, valid: int) -> Work:
    """B5's partial over one block of a split cache, ``valid`` positions
    of it in all: their K and V read once, q and the (B,) int32 lengths
    read, out (B, H, D) and lse (B, H) written in f32; 4 H D operations
    per valid position, as :func:`decode_work`."""
    import torch

    B, H, D = q.shape
    Hkv = k.shape[2]
    nbytes = ((2 * valid * Hkv * D + q.numel()) * _esize(q) + 4 * B
              + 4 * (q.numel() + B * H))
    return Work(4 * H * D * valid, nbytes,
                "f32" if q.dtype == torch.float32 else "bf16")


# ---------------------------------------------------------------- B6
def scan_work(a, h0=None) -> Work:
    """B6: a and b read once, hs (f32) written once, h0 read once; two
    operations an element, on the CUDA cores."""
    nbytes = a.numel() * (2 * _esize(a) + 4) + (
        0 if h0 is None else 4 * h0.numel())
    return Work(2 * a.numel(), nbytes, "f32")


def scan_bwd_work(a, h0=None) -> Work:
    """B6's backward: a, hs, dhs (and h0) read once, da, db (and dh0)
    written once; three operations an element."""
    n = a.numel()
    nbytes = n * (3 * _esize(a) + 8) + (0 if h0 is None else 8 * h0.numel())
    return Work(3 * n, nbytes, "f32")
