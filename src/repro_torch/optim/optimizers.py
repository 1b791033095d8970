"""Optimizers over the port's trees of tensors (the port of the JAX
package's ``optim/optimizers.py``, whose API mirrors optax):

    opt = adam(lr); state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Moments and updates are f32 whatever the parameters' dtype;
``apply_updates`` adds in f32 and casts back to each parameter's dtype.
``count`` is an int32 scalar tensor on the parameters' device; ``lr`` is a
number or a schedule ``count -> lr`` (``optim/schedules.py``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def _lr_at(lr: Schedule, count: torch.Tensor):
    return lr(count) if callable(lr) else lr


def _zeros32(leaf: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(leaf, dtype=torch.float32)


def _count0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, added in f32 and cast back to
    each parameter's dtype."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / max(norm, 1e-9)), norm)`` with ``norm``
    the f32 global L2 norm over every leaf.  The scaled leaves are f32, as
    the reference's product with its f32 scale promotes them."""
    g2 = sum(torch.sum(torch.square(l.float())) for l in tree_leaves(grads))
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda l: l.float() * scale, grads), norm


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"mu": tree_map(_zeros32, params),
                    "count": _count0(params)}
        return {"count": _count0(params)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        step = _lr_at(lr, count)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.float(),
                          state["mu"], grads)
            upd = tree_map(lambda m: -step * m, mu)
            return upd, {"mu": mu, "count": count}
        upd = tree_map(lambda g: -step * g.float(), grads)
        return upd, {"count": count}

    return Optimizer(init, update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros32, params),
                "v": tree_map(_zeros32, params), "count": _count0(params)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        step = _lr_at(lr, count)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                     * torch.square(g.float()), state["v"], grads)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()

        def u(m_, v_, p=None):
            upd = -step * (m_ / c1) / (torch.sqrt(v_ / c2) + eps)
            if weight_decay and p is not None:
                upd = upd - step * weight_decay * p.float()
            return upd

        if weight_decay and params is not None:
            upd = tree_map(u, m, v, params)
        else:
            upd = tree_map(u, m, v)
        return upd, {"m": m, "v": v, "count": count}

    return Optimizer(init, update)
