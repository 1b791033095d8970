"""Nested-dict parameter trees and the device rule shared by the port.

Parameters and per-client state keep the reference's nested layout
(``{"l0": {"b", "w"}, ...}``).  Leaves are visited in sorted-key order —
JAX's pytree order (``b`` before ``w``; ``l0, l1, l10, l2, ...``) — which
``dro.lipschitz_surrogate`` and the attacks' per-leaf draws depend on.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a nested dict in sorted-key order; ``None`` is empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out: List[Any] = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [tree]


def tree_map(f: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``f`` over matching leaves of one or more nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return f(tree, *rest)


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
