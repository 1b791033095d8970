"""npz checkpoints of trees of tensors with step management (the port of
the JAX package's ``checkpoint/checkpointer.py``), in the reference's
archive: ``np.savez_compressed`` of one array per leaf, keyed by the
leaf's path, ``step_%06d.npz`` beside ``step_%06d.npz.meta.json``.  A
checkpoint written by either package restores in the other.

A path joins its entries with ``/``: a NamedTuple's field by name (a
``FedState``'s ``W``, ``opt``, ...), a dict key as it is, a tuple's or
list's entry by position (an LM's ``unit``); a ``None`` subtree has no
entry.  bf16 leaves are written as f32 (numpy has no bf16) and cast back
to the template's dtype on restore; every leaf is restored onto its
template leaf's device and dtype.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import host_array


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _items(tree: Any, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """``(path key, leaf)`` in the reference's pytree order: a dict's
    entries by sorted key, a NamedTuple's fields and a tuple's or list's
    entries in order; ``None`` yields nothing."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _items(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _items(t, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _rebuild(like: Any, leaves: Iterator[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in
    :func:`_items` order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, n), leaves)
                            for n in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(t, leaves) for t in like)
    return next(leaves)


def save_pytree(path: str, tree: Any, step: Optional[int] = None) -> str:
    """Write every leaf of ``tree`` to ``path`` (``np.savez_compressed``),
    and ``{"step": step}`` to ``path + ".meta.json"`` when ``step`` is
    given.  Returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: host_array(l) for k, l in _items(tree)})
    if step is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump({"step": step}, f)
    return path


def restore_pytree(path: str, template: Any) -> Any:
    """The tree saved at ``path`` in ``template``'s structure, each leaf
    cast to its template leaf's dtype on that leaf's device.  A leaf whose
    shape differs from its template's fails the reference's assertion."""
    data = np.load(path if path.endswith(".npz") else path + ".npz",
                   allow_pickle=False)
    leaves: List[torch.Tensor] = []
    for key, leaf in _items(template):
        arr = data[key]
        assert arr.shape == tuple(leaf.shape), (key, arr.shape,
                                                tuple(leaf.shape))
        leaves.append(torch.from_numpy(np.array(arr)).to(
            device=leaf.device, dtype=leaf.dtype))
    return _rebuild(template, iter(leaves))


class Checkpointer:
    """Rolling step checkpoints ``ckpt_dir/step_000123.npz``, the newest
    ``keep`` kept."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)

    def _paths(self) -> List[Tuple[int, str]]:
        pat = re.compile(r"step_(\d+)\.npz$")
        entries = []
        for f in os.listdir(self.dir):
            m = pat.match(f)
            if m:
                entries.append((int(m.group(1)), os.path.join(self.dir, f)))
        return sorted(entries)

    def save(self, tree: Any, step: int) -> str:
        path = os.path.join(self.dir, f"step_{step:06d}.npz")
        save_pytree(path, tree, step)
        for _, p in self._paths()[:-self.keep]:
            os.remove(p)
            if os.path.exists(p + ".meta.json"):
                os.remove(p + ".meta.json")
        return path

    def latest_step(self) -> Optional[int]:
        entries = self._paths()
        return entries[-1][0] if entries else None

    def restore_latest(self, template: Any):
        """``(tree, step)`` of the newest checkpoint, or ``(None, None)``."""
        entries = self._paths()
        if not entries:
            return None, None
        step, path = entries[-1]
        return restore_pytree(path, template), step
