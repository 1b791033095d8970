"""The op log: what fedlint reads in place of the reference's jaxpr.

The port's rounds run eagerly (they normalise rows on the host, write
their state in place and reach the kernels through ``ctypes``), so no
graph of them exists to walk.  :class:`Tracer`, a ``TorchDispatchMode``,
runs the function and records each aten op as an :class:`Eqn`: its name,
its outputs' shapes and dtypes, whether it is a view or writes in place
(the schema's alias info), the devices it read and wrote, the generator
it drew from, and its path, the enclosing ``repro_torch`` functions from
the Python stack (outermost first: the counterpart of a jaxpr path such
as ``pjit(name)/scan/body``).  Tensors are numbered by storage (value
numbers: a view and its base share one), so a rule can follow a value
from the op that made it to the ops that read it.

Given ``meta`` tensors, the run allocates nothing (the C = 1,000,000
entry); given CUDA tensors, it runs on the card and its host reads are
real ones.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import sys
import weakref
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

PACKAGE = Path(__file__).resolve().parents[1]       # src/repro_torch
ANALYSIS = Path(__file__).resolve().parent
DRAW = "draw"                          # the primitive prefix of a draw


@dataclasses.dataclass(frozen=True)
class Eqn:
    """One recorded op.  ``outs``: (shape, dtype) of each tensor output;
    ``in_vns``/``out_vns``: the storages' value numbers.  A draw
    (``draw:<function>``, recorded where the caller's generator object is
    still the caller's, at the torch function) carries ``generator``,
    (device type, initial seed, identity) of its ``torch.Generator``."""
    primitive: str
    outs: Tuple[Tuple[Tuple[int, ...], str], ...]
    path: Tuple[str, ...]
    is_view: bool = False
    is_inplace: bool = False
    in_vns: Tuple[int, ...] = ()
    out_vns: Tuple[int, ...] = ()
    in_devices: Tuple[str, ...] = ()
    out_devices: Tuple[str, ...] = ()
    in_shapes: Tuple[Tuple[Tuple[int, ...], str], ...] = ()
    generator: Optional[Tuple[str, int, int]] = None
    detail: str = ""


@dataclasses.dataclass
class OpLog:
    """A traced run: its equations in order and, if the run stopped (an
    op the ``meta`` device cannot run, such as a read of a value on the
    host), what stopped it: the last equation is that op."""
    eqns: List[Eqn] = dataclasses.field(default_factory=list)
    aborted: str = ""


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _generator_in(args, kwargs) -> Optional[torch.Generator]:
    gen = kwargs.get("generator")
    if isinstance(gen, torch.Generator):
        return gen
    return next((a for a in args if isinstance(a, torch.Generator)), None)


@functools.lru_cache(maxsize=None)
def _module_of(filename: str) -> Optional[str]:
    """A ``repro_torch`` source file's module stem, None for any other
    file (this package's own included); ``filename`` as Python holds it,
    maybe unresolved (``tests/../src/...``)."""
    path = Path(os.path.abspath(filename))
    if path.is_relative_to(PACKAGE) and not path.is_relative_to(ANALYSIS):
        return path.stem
    return None


def current_path() -> Tuple[str, ...]:
    """The ``repro_torch`` functions on the Python stack, outermost first
    (``module.function``), this package's own frames left out."""
    out = []
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_name
        module = _module_of(f.f_code.co_filename)
        if module is not None and not name.startswith("<"):
            out.append(f"{module}.{name}")
        f = f.f_back
    return tuple(reversed(out))


class _Draws(TorchFunctionMode):
    """The torch functions called with a generator, recorded into the
    tracer's log (the dispatcher sees a new wrapper of the generator at
    every op, so its identity is taken here)."""

    def __init__(self, tracer: "Tracer"):
        super().__init__()
        self.tracer = tracer

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        gen = _generator_in(args, kwargs)
        if gen is not None:
            self.tracer.record(Eqn(
                primitive=f"{DRAW}:{getattr(func, '__name__', func)}",
                outs=(), path=current_path(),
                generator=self.tracer.identify(gen)))
        return func(*args, **kwargs)


class Tracer(TorchDispatchMode):
    """Record every aten op run inside the block into :attr:`log`, and
    every draw from a generator (``with tracer:`` enters both)."""

    def __init__(self):
        super().__init__()
        self.log = OpLog()
        self._vns: Dict[int, Tuple[Any, int]] = {}
        self._next = 0
        self._gens: List[torch.Generator] = []   # kept: their ids stay theirs
        self._draws = _Draws(self)

    def __enter__(self):
        self._draws.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._draws.__exit__(*exc)

    def identify(self, gen: torch.Generator) -> Tuple[str, int, int]:
        """(device type, initial seed, identity) of ``gen``; the generator
        is kept alive for the trace, so no other takes its identity."""
        self._gens.append(gen)
        return (gen.device.type, int(gen.initial_seed()), id(gen))

    def _vn(self, t: torch.Tensor) -> int:
        s = t.untyped_storage()
        hit = self._vns.get(id(s))
        if hit is not None and hit[0]() is s:
            return hit[1]
        self._next += 1
        self._vns[id(s)] = (weakref.ref(s), self._next)
        weakref.finalize(s, self._vns.pop, id(s), None)
        return self._next

    def record(self, eqn: Eqn) -> None:
        self.log.eqns.append(eqn)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = list(_tensors([args, kwargs]))
        returns = func._schema.returns
        eqn = dict(
            primitive=func.overloadpacket.__name__, path=current_path(),
            is_view=any(r.alias_info is not None and not r.alias_info.is_write
                        for r in returns),
            is_inplace=any(r.alias_info is not None and r.alias_info.is_write
                           for r in returns),
            in_vns=tuple(self._vn(t) for t in ins),
            in_devices=tuple(t.device.type for t in ins),
            in_shapes=tuple((tuple(t.shape), dtype_name(t.dtype))
                            for t in ins))
        # a device fetch of an output (``copy_`` into a host tensor)
        # shows in its output's device: record first, so an op that the
        # meta device refuses is the log's last equation
        pending = Eqn(outs=(), **eqn)
        at = len(self.log.eqns)
        self.record(pending)
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        self.log.eqns[at] = dataclasses.replace(
            pending,
            outs=tuple((tuple(t.shape), dtype_name(t.dtype)) for t in outs),
            out_vns=tuple(self._vn(t) for t in outs),
            out_devices=tuple(t.device.type for t in outs))
        return out


def format_path(path: Tuple[str, ...]) -> str:
    return "/".join(path) if path else "<top>"

