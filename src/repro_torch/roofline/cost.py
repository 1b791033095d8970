"""What a step costs, counted while it runs on ``meta`` tensors (the
port's counterpart of the reference's ``hlo_parse.py``, which reads a
compiled program's text).

The port's steps are eager Python, so there is no program to parse:
:class:`CostCounter` is a ``TorchDispatchMode`` that sees every aten op
the step runs and counts

* dot FLOPs, ``2 m n k`` per product, of ``mm``, ``bmm``, ``addmm``,
  ``baddbmm`` (``linear`` and ``matmul`` reach the dispatcher as those),
  by the rate class of their dtype (``kernel_cost.RATES``: f32 products
  run without TF32, on the CUDA cores; bf16 and f16 on the tensor cores);
* elementwise FLOPs as the output elements of every other op that
  computes (views and bare allocations count nothing), at the f32 rate;
* per op, operand plus result bytes, as the diagnostic upper bound
  ``hbm_op_bytes`` (it ignores that the card's caching keeps nothing and
  fuses nothing, so it overstates the traffic);
* memory, the counterpart of ``memory_analysis()``: the argument bytes
  (the device storages the step was given), the bytes of the storages
  its outputs hold, and the **peak of the live bytes** of the device
  storages the step made (host tensors, such as a round's rows, hold no
  device memory and are not counted, nor are the ops that make them).
  A storage is counted once however many views it has, in the card's
  allocation size (its bytes rounded up to 512, as the CUDA
  caching allocator rounds), and freed when its last reference dies (a
  weak reference on the storage: autograd's saved tensors keep theirs
  alive), so the count frees at the same points as the card does.

The hand-written kernels are opaque to the dispatcher: each wrapper,
called on ``meta`` tensors, allocates its outputs on ``meta`` (which the
counter sees) and adds its work from ``kernel_cost`` through
:func:`add_kernel`, launching nothing.  So B4 counts the query-key pairs
its mask keeps, where the reference's XLA attention computes all Sq x Sk.

Python loops run once per iteration, so a layer loop is counted
n_layers times by construction: there is no trip-count correction.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from repro_torch.roofline.kernel_cost import Work

aten = torch.ops.aten

ALIGN = 512          # the CUDA caching allocator's block granularity

DOT_OPS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
           aten.baddbmm.default}
# ops that compute nothing: allocation, views, metadata, host reads
FREE_OPS = {aten.empty.memory_format, aten.empty_strided.default,
            aten.empty_like.default, aten.detach.default,
            aten.alias.default, aten._local_scalar_dense.default,
            aten.lift_fresh.default, aten.set_.source_Storage_storage_offset,
            aten.resize_.default}


def alloc_bytes(nbytes: int) -> int:
    """What the caching allocator takes for ``nbytes``: 0 for 0, else a
    multiple of 512."""
    return -(-nbytes // ALIGN) * ALIGN if nbytes else 0


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _dot_flops(func, args, out) -> float:
    """2 m n k of a product: the output's elements times twice the
    contracted size."""
    a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) \
        else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _rate_of(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


@dataclasses.dataclass
class KernelCount:
    """One hand-written kernel's calls in a counted run: the launches the
    card would make and their work, summed."""
    launches: int = 0
    flops: float = 0.0
    nbytes: float = 0.0
    rate: str = "f32"


class CostCounter(TorchDispatchMode):
    """Count a step's FLOPs, bytes and memory while it runs (see the
    module's docstring).  ``args``: the step's arguments, whose storages
    are its argument bytes, never its own.  Use as a ``with`` block around
    the step; read the counts after it."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.flops_by_class: Dict[str, float] = {"f32": 0.0, "tf32x3": 0.0,
                                                 "bf16": 0.0}
        self.dot_flops = 0.0
        self.elem_flops = 0.0
        self.hbm_op_bytes = 0.0
        self.kernels: Dict[str, KernelCount] = {}
        # (kind, mesh axis, bytes, group size, group stride) per exchange
        self.collectives: list = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self.n_ops = 0
        self._known: Dict[int, Any] = {}     # id(storage) -> weakref
        self.argument_bytes = 0
        for t in _tensors(args):
            if t.device.type == "cpu":
                continue
            s = t.untyped_storage()
            if id(s) not in self._known:
                self._known[id(s)] = weakref.ref(s)
                self.argument_bytes += alloc_bytes(s.nbytes())

    # ------------------------------------------------------------ memory
    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "cpu":
            return
        s = t.untyped_storage()
        ref = self._known.get(id(s))
        if ref is not None and ref() is s:
            return
        n = alloc_bytes(s.nbytes())
        self._known[id(s)] = weakref.ref(s)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._free, id(s), n)

    def _free(self, key: int, n: int) -> None:
        self._known.pop(key, None)
        self.live_bytes -= n

    def output_bytes(self, out: Any) -> int:
        """Bytes of the storages the step made that ``out`` (its result)
        still holds; storages it shares with the arguments (a state
        written in place) are not counted."""
        seen, n = set(), 0
        for t in _tensors(out):
            s = t.untyped_storage()
            if id(s) in seen:
                continue
            seen.add(id(s))
            ref = self._known.get(id(s))
            if ref is not None and ref() is s and not self._is_argument(s):
                n += alloc_bytes(s.nbytes())
        return n

    def _is_argument(self, s) -> bool:
        return id(s) in self._argument_ids

    def __enter__(self):
        self._argument_ids = set(self._known)
        return super().__enter__()

    # ------------------------------------------------------------ counts
    def add_flops(self, flops: float, rate: str) -> None:
        self.flops_by_class[rate] += flops

    def add_kernel(self, name: str, work: Work, launches: int = 1) -> None:
        k = self.kernels.setdefault(name, KernelCount(rate=work.rate))
        k.launches += launches
        k.flops += work.flops
        k.nbytes += work.nbytes
        self.add_flops(work.flops, work.rate)
        self.hbm_op_bytes += work.nbytes

    def add_collective(self, kind: str, axis: str, nbytes: int, size: int,
                       stride: int) -> None:
        self.collectives.append((kind, axis, nbytes, size, stride))

    @property
    def kernel_flops(self) -> float:
        return sum(k.flops for k in self.kernels.values())

    @property
    def flops(self) -> float:
        return sum(self.flops_by_class.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.n_ops += 1
        outs = list(_tensors(out))
        for t in outs:
            self._track(t)
        if (func in FREE_OPS or all(t.device.type == "cpu" for t in outs)
                or any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns)):
            return out          # a view, or host work: no device work
        ins = list(_tensors([args, kwargs or {}]))
        self.hbm_op_bytes += sum(t.numel() * t.element_size()
                                 for t in ins + outs)
        if func in DOT_OPS:
            f = _dot_flops(func, args, outs[0])
            self.dot_flops += f
            self.add_flops(f, _rate_of(outs[0].dtype))
        else:
            f = float(sum(t.numel() for t in outs))
            self.elem_flops += f
            self.add_flops(f, "f32")
        return out


def active() -> "CostCounter | None":
    """The innermost :class:`CostCounter` in the dispatch mode stack, or
    None when nothing is being counted."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


def add_kernel(name: str, work: Work, launches: int = 1) -> None:
    """A kernel wrapper's ``meta`` branch: add ``launches`` launches of
    kernel ``name`` doing ``work`` to the active counter, if any."""
    counter = active()
    if counter is not None:
        counter.add_kernel(name, work, launches)


def add_collective(kind: str, axis: str, nbytes: int, size: int,
                   stride: int) -> None:
    """An exchange of ``nbytes`` over a group of ``size`` ranks ``stride``
    apart in the mesh's rank order (``distributed.collectives``), added to
    the active counter, if any."""
    counter = active()
    if counter is not None:
        counter.add_collective(kind, axis, nbytes, size, stride)
