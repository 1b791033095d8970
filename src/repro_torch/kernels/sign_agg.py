"""Wrappers of the Eq. (20) server-consensus CUDA kernels (B1-B3).

    z' = z - alpha_z * (phi_mean + psi * sum_i s_i sign(z - w_i) / n)

Each wrapper replaces one Pallas TPU kernel of the JAX package's
``kernels/sign_agg.py`` (file:line of the ``pl.pallas_call`` caller):

* :func:`sign_agg_group` — B1 and B2 over every leaf of a parameter tree
  in one launch: ``sign_agg`` (sign_agg.py:58, plain mean, n = C) without
  ``weights``, ``sign_agg_weighted`` (sign_agg.py:100: staleness weights
  ``s_i``, n = ``n_total or C``) with them;
* :func:`sign_agg_int8_group` — B3, ``sign_agg_weighted_int8``
  (sign_agg.py:160), over every leaf in one launch: the int8 wire payload
  with an f32 ``scale`` (or none: an int32 sum), n = ``n_total or C``;
* :func:`sign_agg` / :func:`sign_agg_weighted` /
  :func:`sign_agg_weighted_int8` — B1 / B2 / B3 on one leaf (a one-leaf
  call of the same kernel);
* :func:`sign_sum_group`, :func:`sign_sum_int8_group` and
  :func:`sign_finish_group` — B1-B3 split for a round whose clients sit
  on several ranks: the fused kernels' folds over this rank's rows, their
  column sums written to one flat buffer (f32; int32 for B3's unweighted
  payload), which the caller all-reduces; then the fused kernels'
  epilogue on the reduced sums.  One launch each per dtype group.

What bounds them on the H100 is bytes: reading the message once and z,
phi_mean in, z' out — ``4*C*D + 12*D`` bytes for B1/B2 in f32,
``C*D + 12*D + 4*C`` for B3 — over 3.35 TB/s.  The kernels read
``phi_mean`` in f32 whatever z's dtype, as the Pallas kernels do (the
round's mean of the duals is f32): the wrappers take it in f32 or in z's
dtype, and widen the latter (exactly) first.  A leaf of a forecaster's
round is far smaller than what a launch costs, so the kernels
(``sign_agg_group<T, kWeighted>`` and ``sign_agg_int8_group<T,
kWeighted>`` in ``csrc/sign_agg.cu``) take a table of leaves
(:func:`leaf_table`) and launch once per ``MAX_LEAVES`` leaves.  A thread
owns a vector of message columns where the leaf allows it (one 16-byte
load a row of 4 f32 or 8 bf16 columns; one 8-byte load of 8 int8
columns; else one column) and folds the C rows in order, loading several
rows before it folds them.  Both give the row-order fold of the plain
versions in ``kernels/ref.py``, bit for bit.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  A ``meta`` tensor takes the card's checks, gets
``meta`` outputs and adds the kernel's work (``roofline.kernel_cost``) and
the launches the card would make to the active
``roofline.cost.CostCounter``, launching nothing and leaving ``LAUNCHES``
as it is.  ``LAUNCHES`` counts kernel launches per TPU kernel
(:func:`sign_agg_group` adds to ``sign_agg`` or ``sign_agg_weighted``,
:func:`sign_agg_int8_group` to ``sign_agg_weighted_int8``).
"""
from __future__ import annotations

import array
import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.roofline import cost, kernel_cost

LAUNCHES: Dict[str, int] = {"sign_agg": 0, "sign_agg_weighted": 0,
                            "sign_agg_weighted_int8": 0, "sign_sum": 0,
                            "sign_finish": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p

# The group kernels' constants (csrc/sign_agg.cu: kThreads, kMaxLeaves,
# kTableCols, kVecBytes, kInt8Cols); the C entries refuse a table built
# with others.
THREADS = 256          # threads per block
MAX_LEAVES = 64        # leaves per launch: the table is a kernel parameter
TABLE_COLS = 7         # z, W, phi_mean, out, D, first block, vector flag
VEC_BYTES = 16         # B1/B2: a thread's vector of W, in bytes
INT8_COLS = 8          # B3: a thread's int8 payload columns (8 bytes)


def vec_width(itemsize: int) -> int:
    """Message columns a thread owns on the vector path, for message rows
    of ``itemsize`` bytes: 4 f32, 8 bf16, 8 int8."""
    return INT8_COLS if itemsize == 1 else VEC_BYTES // itemsize


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    lib = _build.load("sign_agg")
    i, ll, f = ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.repro_sign_agg.argtypes = [i, _P, _P, _P, _P, i, ll, f, f, _P]
    lib.repro_sign_agg_weighted.argtypes = [
        i, _P, _P, _P, _P, _P, i, ll, i, f, f, _P]
    lib.repro_sign_agg_int8.argtypes = [
        i, _P, _P, _P, _P, _P, i, ll, i, f, f, _P]
    for fn in (lib.repro_sign_agg_group, lib.repro_sign_agg_int8_group):
        fn.argtypes = [i, i, _P, i, _P, i, f, f, _P, ctypes.POINTER(i)]
    for fn in (lib.repro_sign_sum_group, lib.repro_sign_sum_int8_group):
        fn.argtypes = [i, i, _P, i, _P, _P, ctypes.POINTER(i)]
    lib.repro_sign_finish_group.argtypes = [i, i, i, _P, i, f, f, _P,
                                            ctypes.POINTER(i)]
    for fn in (lib.repro_sign_agg, lib.repro_sign_agg_weighted,
               lib.repro_sign_agg_int8, lib.repro_sign_agg_group,
               lib.repro_sign_agg_int8_group, lib.repro_sign_sum_group,
               lib.repro_sign_sum_int8_group, lib.repro_sign_finish_group):
        fn.restype = ctypes.c_int
    return lib


def leaf_table(leaves: Sequence[Tuple[int, int, int, int, int]],
               itemsize: int) -> List[int]:
    """The group kernels' table, ``TABLE_COLS`` ints per leaf.

    ``leaves``: ``(z, W, phi_mean, out, D)`` per leaf, the first four as
    addresses, W the (C, D) message rows (B3: the int8 payload), whose
    element size is ``itemsize``.  A leaf takes vectors of
    :func:`vec_width` message columns a thread when its four addresses
    are 16-byte aligned and D is a multiple of that width (each row of W
    then starts aligned), else one column a thread; it gets
    ``ceil(D / (THREADS * columns a thread))`` blocks, numbered from 0
    again at every ``MAX_LEAVES``-th leaf, where a new launch starts."""
    width = vec_width(itemsize)
    table: List[int] = []
    first = 0
    for k, (z, W, phi, out, D) in enumerate(leaves):
        if k % MAX_LEAVES == 0:
            first = 0
        vec = int(D % width == 0 and (z | W | phi | out) % 16 == 0)
        table += [z, W, phi, out, D, first, vec]
        first += -(-D // (THREADS * (width if vec else 1)))
    return table


def out_offsets(sizes: Sequence[int], itemsize: int) -> Tuple[List[int],
                                                              int]:
    """Where each leaf's z' (``itemsize`` bytes an element) starts in the
    one output of a grouped call: offsets rounded up to 16 bytes, so every
    leaf whose own inputs allow it takes the vector path; and the total
    size."""
    width = 16 // itemsize
    offs, total = [], 0
    for D in sizes:
        offs.append(total)
        total += -(-D // width) * width
    return offs, total


def _check_vectors(z: torch.Tensor, phi_mean: torch.Tensor,
                   rows: torch.Tensor, rows_dtype: torch.dtype) -> int:
    """Validate the (D,) vectors and the (C, D) rows; returns the dtype
    code of z.  Raises on what the kernels do not take."""
    if z.dtype not in _DTYPES:
        raise TypeError(f"z must be float32 or bfloat16, got {z.dtype}")
    if phi_mean.dtype not in (z.dtype, torch.float32):
        raise TypeError(f"phi_mean dtype {phi_mean.dtype} is neither z's "
                        f"({z.dtype}) nor float32")
    if rows.dtype != rows_dtype:
        raise TypeError(f"message rows must be {rows_dtype}, got "
                        f"{rows.dtype}")
    if z.ndim != 1 or z.shape[0] < 1:
        raise ValueError(f"z must be (D,) with D >= 1, got {tuple(z.shape)}")
    if phi_mean.shape != z.shape:
        raise ValueError(f"phi_mean {tuple(phi_mean.shape)} != z "
                         f"{tuple(z.shape)}")
    if rows.ndim != 2 or rows.shape[1] != z.shape[0] or rows.shape[0] < 1:
        raise ValueError(f"message rows must be (C, {z.shape[0]}) with "
                         f"C >= 1, got {tuple(rows.shape)}")
    for name, t in (("z", z), ("phi_mean", phi_mean), ("rows", rows)):
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if z.device.type not in _build.KERNEL_DEVICES:
        raise ValueError(f"the kernels need CUDA tensors, got {z.device}")
    return _DTYPES[z.dtype]


def _check_column(name: str, col: torch.Tensor, z: torch.Tensor,
                  C: int) -> None:
    if col.dtype != torch.float32 or col.shape != (C,):
        raise ValueError(f"{name} must be float32 ({C},), got {col.dtype} "
                         f"{tuple(col.shape)}")
    if col.device != z.device or not col.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {z.device}")


def _divisor(n_total: int, C: int) -> int:
    if n_total < 0:
        raise ValueError(f"n_total must be >= 0, got {n_total}")
    return n_total or C


def sign_agg(z: torch.Tensor, W: torch.Tensor, phi_mean: torch.Tensor,
             psi: float, alpha_z: float) -> torch.Tensor:
    """B1.  z: (D,); W: (C, D), both f32 or both bf16; phi_mean: (D,) f32
    or in z's dtype.  Returns z' (D,) in z's dtype."""
    if z.device.type == "cpu":
        return ref.sign_agg_ref(z, W, phi_mean, psi, alpha_z)
    code = _check_vectors(z, phi_mean, W, z.dtype)
    phi_mean = phi_mean.float()     # the kernels read f32
    C, D = W.shape
    out = torch.empty_like(z)
    if z.device.type == "meta":
        cost.add_kernel("sign_agg", kernel_cost.sign_agg_work(z, W))
        return out
    err = _lib().repro_sign_agg(code, z.data_ptr(), W.data_ptr(),
                                phi_mean.data_ptr(), out.data_ptr(), C, D,
                                psi, alpha_z, _build.stream_of(z))
    _build.check_launch(err, "sign_agg")
    LAUNCHES["sign_agg"] += 1
    return out


def sign_agg_weighted(z: torch.Tensor, W: torch.Tensor,
                      phi_mean: torch.Tensor, weights: torch.Tensor,
                      psi: float, alpha_z: float, *,
                      n_total: int = 0) -> torch.Tensor:
    """B2.  As :func:`sign_agg` with ``weights``: (C,) f32 staleness
    weights; the sum is divided by ``n_total`` (default: C)."""
    if z.device.type == "cpu":
        return ref.sign_agg_fold_ref(z, W, phi_mean, weights, psi, alpha_z,
                                     _divisor(n_total, W.shape[0]))
    code = _check_vectors(z, phi_mean, W, z.dtype)
    phi_mean = phi_mean.float()     # the kernels read f32
    C, D = W.shape
    _check_column("weights", weights, z, C)
    out = torch.empty_like(z)
    if z.device.type == "meta":
        cost.add_kernel("sign_agg_weighted",
                        kernel_cost.sign_agg_work(z, W, weights))
        return out
    err = _lib().repro_sign_agg_weighted(
        code, z.data_ptr(), W.data_ptr(), phi_mean.data_ptr(),
        weights.data_ptr(), out.data_ptr(), C, D, _divisor(n_total, C), psi,
        alpha_z, _build.stream_of(z))
    _build.check_launch(err, "sign_agg_weighted")
    LAUNCHES["sign_agg_weighted"] += 1
    return out


def _group_launch(entry: str, counter: str, zs: Sequence[torch.Tensor],
                  rows: Sequence[torch.Tensor],
                  phis: Sequence[torch.Tensor],
                  column: Optional[torch.Tensor], column_name: str,
                  rows_dtype: torch.dtype, psi: float, alpha_z: float,
                  n_total: int) -> List[torch.Tensor]:
    """Check the leaves of a grouped call on the card, build its table and
    run the library's C function ``entry`` (``rows_dtype``: the message
    rows' dtype); each leaf's z' is a view of one output.  On ``meta``
    the output is made and the work counted, the table is not built."""
    z0 = zs[0]
    code = _check_vectors(z0, phis[0], rows[0], rows_dtype)
    C = rows[0].shape[0]
    for z, r, phi in zip(zs[1:], rows[1:], phis[1:]):
        _check_vectors(z, phi, r, rows_dtype)
        if z.dtype != z0.dtype:
            raise TypeError(f"every leaf must be {z0.dtype}, got {z.dtype}")
        if r.shape[0] != C or z.device != z0.device:
            raise ValueError(f"every leaf needs C={C} rows on {z0.device}, "
                             f"got {tuple(r.shape)} on {z.device}")
    if column is not None:
        _check_column(column_name, column, z0, C)
    phis = [phi.float() for phi in phis]     # the kernels read f32
    isz = z0.element_size()
    offs, total = out_offsets([z.shape[0] for z in zs], isz)
    out = torch.empty(total, dtype=z0.dtype, device=z0.device)
    views = [out[o:o + z.shape[0]] for z, o in zip(zs, offs)]
    if z0.device.type == "meta":
        work = (kernel_cost.sign_agg_int8_group_work if rows_dtype ==
                torch.int8 else kernel_cost.sign_agg_group_work)
        cost.add_kernel(counter, work(zs, rows, column),
                        launches=-(-len(zs) // MAX_LEAVES))
        return views
    base = out.data_ptr()
    table = array.array("q", leaf_table(
        [(z.data_ptr(), r.data_ptr(), phi.data_ptr(), base + o * isz,
          z.shape[0]) for z, r, phi, o in zip(zs, rows, phis, offs)],
        rows[0].element_size()))
    launched = ctypes.c_int(0)
    err = getattr(_lib(), entry)(code, len(zs), table.buffer_info()[0], C,
                None if column is None else column.data_ptr(),
                _divisor(n_total, C), psi, alpha_z, _build.stream_of(z0),
                ctypes.byref(launched))
    _build.check_launch(err, counter)
    LAUNCHES[counter] += launched.value
    return views


def _check_leaf_counts(zs, rows, phis) -> None:
    if not zs or not (len(zs) == len(rows) == len(phis)):
        raise ValueError(f"need one or more leaves and as many z, message "
                         f"rows and phi_mean: {len(zs)}, {len(rows)}, "
                         f"{len(phis)}")


def sign_agg_group(zs: Sequence[torch.Tensor], Ws: Sequence[torch.Tensor],
                   phis: Sequence[torch.Tensor],
                   weights: Optional[torch.Tensor], psi: float,
                   alpha_z: float, *, n_total: int = 0
                   ) -> List[torch.Tensor]:
    """B1 (``weights=None``) or B2 over every leaf at once.  ``zs[l]``,
    ``phis[l]``: (D_l,) (f32, or in z's dtype); ``Ws[l]``: (C, D_l); one
    dtype (f32 or bf16) of z and W and one C for all leaves; ``weights``: (C,) f32; the sum is divided by
    ``n_total`` (default: C; only with ``weights``).  Returns each leaf's
    z' (D_l,), views of one output.  One launch per ``MAX_LEAVES``
    leaves."""
    _check_leaf_counts(zs, Ws, phis)
    if weights is None and n_total:
        raise ValueError("n_total needs weights")
    if zs[0].device.type == "cpu":
        return ref.sign_agg_group_ref(zs, Ws, phis, weights, psi, alpha_z,
                                      n_total=_divisor(n_total, 0))
    return _group_launch(
        "repro_sign_agg_group",
        "sign_agg" if weights is None else "sign_agg_weighted", zs, Ws,
        phis, weights, "weights", zs[0].dtype, psi, alpha_z, n_total)


def sign_agg_int8_group(zs: Sequence[torch.Tensor],
                        payloads: Sequence[torch.Tensor],
                        phis: Sequence[torch.Tensor],
                        scale: Optional[torch.Tensor], psi: float,
                        alpha_z: float, *, n_total: int = 0
                        ) -> List[torch.Tensor]:
    """B3 over every leaf at once.  ``zs[l]``, ``phis[l]``: (D_l,) f32 or
    bf16, one dtype for all leaves; ``payloads[l]``: (C, D_l) int8 signs,
    one C; ``scale``: the round's (C,) f32 column or ``None`` (the
    unweighted message, summed in int32); the sum is divided by
    ``n_total`` (default: C).  Returns each leaf's z' (D_l,), views of one
    output.  One launch per ``MAX_LEAVES`` leaves."""
    _check_leaf_counts(zs, payloads, phis)
    if zs[0].device.type == "cpu":
        return ref.sign_agg_int8_group_ref(zs, payloads, phis, scale, psi,
                                           alpha_z,
                                           n_total=_divisor(n_total, 0))
    return _group_launch("repro_sign_agg_int8_group",
                         "sign_agg_weighted_int8", zs, payloads, phis, scale,
                         "scale", torch.int8, psi, alpha_z, n_total)


def sign_agg_weighted_int8(z: torch.Tensor, payload: torch.Tensor,
                           scale: Optional[torch.Tensor],
                           phi_mean: torch.Tensor, psi: float,
                           alpha_z: float, *, n_total: int = 0
                           ) -> torch.Tensor:
    """B3.  ``payload``: (C, D) int8 signs; ``scale``: (C,) f32 or ``None``
    (the unweighted message, summed in int32); z, phi_mean: (D,) f32 or
    bf16.  The sum is divided by ``n_total`` (default: C)."""
    if z.device.type == "cpu":
        return ref.sign_agg_int8_fold_ref(z, payload, scale, phi_mean, psi,
                                          alpha_z,
                                          _divisor(n_total, payload.shape[0]))
    code = _check_vectors(z, phi_mean, payload, torch.int8)
    phi_mean = phi_mean.float()     # the kernels read f32
    C, D = payload.shape
    scale_ptr = None
    if scale is not None:
        _check_column("scale", scale, z, C)
        scale_ptr = scale.data_ptr()
    out = torch.empty_like(z)
    if z.device.type == "meta":
        cost.add_kernel("sign_agg_weighted_int8",
                        kernel_cost.sign_agg_int8_work(z, payload, scale))
        return out
    err = _lib().repro_sign_agg_int8(
        code, z.data_ptr(), payload.data_ptr(), phi_mean.data_ptr(),
        scale_ptr, out.data_ptr(), C, D, _divisor(n_total, C), psi, alpha_z,
        _build.stream_of(z))
    _build.check_launch(err, "sign_agg_weighted_int8")
    LAUNCHES["sign_agg_weighted_int8"] += 1
    return out


# ------------------------------------------------ the split over ranks
def sum_offsets(sizes: Sequence[int]) -> Tuple[List[int], int]:
    """Where each leaf's column sums (4 bytes an element) start in the one
    flat buffer of a partial call, and its size: :func:`out_offsets` at 4
    bytes, so every leaf's sums are 16-byte aligned."""
    return out_offsets(sizes, 4)


def flat_sums(parts: Sequence[torch.Tensor], sizes: Sequence[int],
               dtype: torch.dtype, device) -> torch.Tensor:
    """The plain versions' per-leaf sums laid out as the kernels lay them
    out (zeros between the leaves)."""
    offs, total = sum_offsets(sizes)
    flat = torch.zeros(total, dtype=dtype, device=device)
    for p, o, D in zip(parts, offs, sizes):
        flat[o:o + D] = p
    return flat


def _sum_launch(entry: str, zs, rows, column, column_name: str,
                rows_dtype: torch.dtype, sums_dtype: torch.dtype,
                work) -> torch.Tensor:
    """Check a partial call's leaves on the card, build its table (``out``
    of each leaf its place in the flat sums) and run ``entry``."""
    z0 = zs[0]
    code = _check_vectors(z0, z0, rows[0], rows_dtype)
    C = rows[0].shape[0]
    for z, r in zip(zs[1:], rows[1:]):
        _check_vectors(z, z, r, rows_dtype)
        if z.dtype != z0.dtype:
            raise TypeError(f"every leaf must be {z0.dtype}, got {z.dtype}")
        if r.shape[0] != C or z.device != z0.device:
            raise ValueError(f"every leaf needs C={C} rows on {z0.device}, "
                             f"got {tuple(r.shape)} on {z.device}")
    if column is not None:
        _check_column(column_name, column, z0, C)
    sizes = [z.shape[0] for z in zs]
    offs, total = sum_offsets(sizes)
    out = torch.zeros(total, dtype=sums_dtype, device=z0.device)
    if z0.device.type == "meta":
        cost.add_kernel("sign_sum", work(zs, rows, column),
                        launches=-(-len(zs) // MAX_LEAVES))
        return out
    base = out.data_ptr()
    table = array.array("q", leaf_table(
        [(z.data_ptr(), r.data_ptr(), z.data_ptr(), base + o * 4, D)
         for z, r, o, D in zip(zs, rows, offs, sizes)],
        rows[0].element_size()))
    launched = ctypes.c_int(0)
    err = getattr(_lib(), entry)(
        code, len(zs), table.buffer_info()[0], C,
        None if column is None else column.data_ptr(),
        _build.stream_of(z0), ctypes.byref(launched))
    _build.check_launch(err, "sign_sum")
    LAUNCHES["sign_sum"] += launched.value
    return out


def sign_sum_group(zs: Sequence[torch.Tensor], Ws: Sequence[torch.Tensor],
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
    """B1/B2's partial over every leaf at once: ``sum_i s_i sign(z -
    W_i)`` over this rank's rows (``s_i`` 1 without ``weights``), folded
    as the fused kernel folds them, in f32.  ``zs[l]``: (D_l,), ``Ws[l]``:
    (C_r, D_l), one dtype (f32 or bf16); ``weights``: (C_r,) f32 or None.
    Returns the flat f32 sums, leaf ``l`` at ``sum_offsets(...)[0][l]``.
    One launch per ``MAX_LEAVES`` leaves."""
    _check_leaf_counts(zs, Ws, zs)
    if zs[0].device.type == "cpu":
        return flat_sums(ref.sign_sum_group_ref(zs, Ws, weights),
                          [z.shape[0] for z in zs], torch.float32,
                          zs[0].device)
    return _sum_launch("repro_sign_sum_group", zs, Ws, weights, "weights",
                       zs[0].dtype, torch.float32,
                       kernel_cost.sign_sum_group_work)


def sign_sum_int8_group(zs: Sequence[torch.Tensor],
                        payloads: Sequence[torch.Tensor],
                        scale: Optional[torch.Tensor]) -> torch.Tensor:
    """B3's partial over every leaf at once: this rank's (C_r, D_l) int8
    payloads summed, int32 without ``scale``, the f32 row-order fold
    ``acc + s_i q_i`` with it.  ``zs`` give each leaf's D and device (z is
    not read).  Returns the flat sums (int32 or f32), leaf ``l`` at
    ``sum_offsets(...)[0][l]``."""
    _check_leaf_counts(zs, payloads, zs)
    sums_dtype = torch.int32 if scale is None else torch.float32
    if zs[0].device.type == "cpu":
        return flat_sums(ref.sign_sum_int8_group_ref(payloads, scale),
                          [z.shape[0] for z in zs], sums_dtype,
                          zs[0].device)
    return _sum_launch("repro_sign_sum_int8_group", zs, payloads, scale,
                       "scale", torch.int8, sums_dtype,
                       kernel_cost.sign_sum_int8_group_work)


def sign_finish_group(zs: Sequence[torch.Tensor], sums: torch.Tensor,
                      phis: Sequence[torch.Tensor], psi: float,
                      alpha_z: float, n: int) -> List[torch.Tensor]:
    """The fused kernels' epilogue on all-reduced sums, over every leaf at
    once: ``z - alpha_z (phi_mean + psi sum / n)``, one rounding per
    operation.  ``sums``: the flat buffer of :func:`sign_sum_group` or
    :func:`sign_sum_int8_group` (f32 or int32) after the all-reduce;
    ``zs[l]``, ``phis[l]``: (D_l,) (phi_mean f32, or in z's dtype).
    Returns each leaf's z' (D_l,), views of one output."""
    _check_leaf_counts(zs, phis, phis)
    if n < 1:
        raise ValueError(f"the divisor must be >= 1, got {n}")
    sizes = [z.shape[0] for z in zs]
    offs, total = sum_offsets(sizes)
    if sums.ndim != 1 or sums.shape[0] != total \
            or sums.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"sums must be ({total},) float32 or int32, got "
                         f"{sums.dtype} {tuple(sums.shape)}")
    if zs[0].device.type == "cpu":
        return ref.sign_finish_group_ref(
            zs, [sums[o:o + D] for o, D in zip(offs, sizes)], phis, psi,
            alpha_z, n)
    z0 = zs[0]
    code = _check_vectors(z0, phis[0], z0[None], z0.dtype)
    for z, phi in zip(zs[1:], phis[1:]):
        _check_vectors(z, phi, z[None], z0.dtype)
        if z.dtype != z0.dtype or z.device != z0.device:
            raise TypeError(f"every leaf must be {z0.dtype} on {z0.device}, "
                            f"got {z.dtype} on {z.device}")
    if sums.device != z0.device or not sums.is_contiguous():
        raise ValueError(f"sums must be contiguous on {z0.device}")
    phis = [phi.float() for phi in phis]     # the kernel reads f32
    isz = z0.element_size()
    o_offs, o_total = out_offsets(sizes, isz)
    out = torch.empty(o_total, dtype=z0.dtype, device=z0.device)
    views = [out[o:o + D] for o, D in zip(o_offs, sizes)]
    if z0.device.type == "meta":
        cost.add_kernel("sign_finish", kernel_cost.sign_finish_group_work(
            zs, sums), launches=-(-len(zs) // MAX_LEAVES))
        return views
    base, sbase = out.data_ptr(), sums.data_ptr()
    table = array.array("q", leaf_table(
        [(z.data_ptr(), sbase + o * 4, phi.data_ptr(), base + oo * isz, D)
         for z, phi, o, oo, D in zip(zs, phis, offs, o_offs, sizes)], isz))
    launched = ctypes.c_int(0)
    err = _lib().repro_sign_finish_group(
        code, int(sums.dtype == torch.int32), len(zs),
        table.buffer_info()[0], n, psi, alpha_z, _build.stream_of(z0),
        ctypes.byref(launched))
    _build.check_launch(err, "sign_finish")
    LAUNCHES["sign_finish"] += launched.value
    return views
