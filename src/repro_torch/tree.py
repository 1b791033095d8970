"""Parameter trees and the device rule shared by the port.

Parameters and per-client state keep the reference's nested layout: dicts
(``{"l0": {"b", "w"}, ...}``) and, in an LM's tree, tuples and lists (its
``unit`` is a tuple of per-sublayer dicts).  Leaves are visited in JAX's
pytree order: a dict's entries in sorted-key order (``b`` before ``w``;
``l0, l1, l10, l2, ...``), a tuple's or list's by position — which
``dro.lipschitz_surrogate`` and the attacks' per-leaf draws depend on.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of nested dicts (sorted-key order), tuples and lists (by
    position); ``None`` is empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_map(f: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``f`` over matching leaves of one or more trees of the same
    structure; a tuple stays a tuple and a list a list."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(f, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return f(tree, *rest)


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_unstack(tree: Any) -> List[Any]:
    """The slices along the leading axis of a tree whose leaves share it:
    a list of trees of views (``torch.unbind``), so a gradient taken
    through the slices lands in the stacked leaves, one ``stack`` per
    leaf."""
    leaves = tree_leaves(tree)
    cols = [l.unbind(0) for l in leaves]
    return [tree_unflatten(tree, [c[i] for c in cols])
            for i in range(len(cols[0]))]


def host_array(x: Any) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array on the
    host: the rows of a schedule, client ids, weights."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """``None`` -> the GPU.  Raises when no GPU is present rather than
    running on the CPU: a CPU run must be asked for (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
