"""The port's optimizers and LR schedules (``repro_torch.optim``) against
the JAX package's (``repro.optim``) on the CPU: the same numpy parameter
and gradient trees (nested dicts with a tuple, as an LM's ``unit``, f32
and bf16 leaves) through ``STEPS`` updates each.

Tolerances: f32 parameters and moments within rtol 2e-6, atol 1e-9 (the
packages round ``b ** count`` and the other f32 ops independently; the
measured worst is one or two ulps); bf16 parameters within one bf16 ulp
(an f32 sum a few ulps apart may round to either neighbour); counts and
schedule steps exactly or within rtol 1e-6.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch import optim as port
from repro_torch.tree import tree_leaves, tree_map

STEPS = 5
RTOL, ATOL = 2e-6, 1e-9


@pytest.fixture(scope="module")
def joptim():
    """The reference's ``repro.optim`` (it imports without the alias)."""
    return importlib.import_module("repro.optim")


def _tree(rng, scale=1.0):
    """Numpy leaves: a dict with a nested dict and a tuple of dicts."""
    r = lambda *s: (rng.randn(*s) * scale).astype(np.float32)
    return {"b": r(7), "unit": ({"w": r(3, 5)}, {"w": r(4)}),
            "w": {"k": r(2, 3, 4), "q": r(6)}}


def _torch(tree, bf16=()):
    return tree_map(lambda a: torch.from_numpy(a.copy()), tree) if not bf16 \
        else {k: (tree_map(lambda a: torch.from_numpy(a.copy()).to(
            torch.bfloat16), v) if k in bf16 else
                  tree_map(lambda a: torch.from_numpy(a.copy()), v))
              for k, v in tree.items()}


def _jax(tree, bf16=()):
    import jax
    import jax.numpy as jnp
    return {k: jax.tree.map(lambda a: jnp.asarray(
        a, jnp.bfloat16 if k in bf16 else jnp.float32), v)
        for k, v in tree.items()}


def _close(got, want):
    """Leaf for leaf in tree order: f32 within (RTOL, ATOL), bf16 within
    one bf16 ulp of the reference, integers exactly."""
    import jax
    g = tree_leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.bfloat16:
            assert str(b.dtype) == "bfloat16"
            a, b = a.float().numpy(), b.astype(np.float32)
            np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=0)
        elif a.dtype == torch.int32:
            assert b.dtype == np.int32 and np.array_equal(a.numpy(), b)
        else:
            assert b.dtype == np.float32
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)


OPTIMIZERS = {
    "sgd": lambda o, lr: o.sgd(lr),
    "sgd-momentum": lambda o, lr: o.sgd(lr, momentum=0.9),
    "adam": lambda o, lr: o.adam(lr),
    "adam-wd": lambda o, lr: o.adam(lr, weight_decay=0.01),
}
LRS = {
    "const": lambda o: 3e-2,
    "warmup_linear": lambda o: o.warmup_linear(5e-2, 2, 8),
    "cosine": lambda o: o.cosine_schedule(5e-2, 2, 8),
}


def _run(joptim, port, name, lr, clip=None):
    rng = np.random.RandomState(0)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.5) for _ in range(STEPS)]
    jopt = OPTIMIZERS[name](joptim, LRS[lr](joptim))
    opt = OPTIMIZERS[name](port, LRS[lr](port))
    jp, p = _jax(p0, bf16=("w",)), _torch(p0, bf16=("w",))
    jst, st = jopt.init(jp), opt.init(p)
    _close(st, jst)
    for g_np in grads:
        jg, g = _jax(g_np), _torch(g_np)
        if clip is not None:
            jg, jn = joptim.clip_by_global_norm(jg, clip)
            g, n = port.clip_by_global_norm(g, clip)
            np.testing.assert_allclose(float(n), float(jn), rtol=RTOL)
        jupd, jst = jopt.update(jg, jst, jp)
        upd, st = opt.update(g, st, p)
        _close(upd, jupd)
        _close(st, jst)
        jp, p = joptim.apply_updates(jp, jupd), port.apply_updates(p, upd)
        _close(p, jp)
    assert int(st["count"]) == STEPS and st["count"].dtype == torch.int32
    return p


@pytest.mark.parametrize("lr", sorted(LRS))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(joptim, name, lr):
    """``STEPS`` updates of f32 and bf16 (``w``) parameters from the same
    gradients: the updates, the optimizer state and the parameters after
    ``apply_updates`` match the reference's every step; bf16 parameters
    stay bf16."""
    p = _run(joptim, port, name, lr)
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(p["w"]))
    assert p["b"].dtype == torch.float32


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(joptim, max_norm):
    """Clipped (0.5, below the gradients' norm) and untouched (1e3)
    gradients feed adam; the norm matches every step."""
    _run(joptim, port, "adam", "const", clip=max_norm)
    g = _torch(_tree(np.random.RandomState(1)))
    clipped, norm = port.clip_by_global_norm(g, max_norm)
    want = torch.sqrt(sum((l.double() ** 2).sum() for l in tree_leaves(g)))
    assert abs(float(norm) / float(want) - 1) < 1e-6
    got = torch.sqrt(sum((l.double() ** 2).sum()
                         for l in tree_leaves(clipped)))
    assert abs(float(got) - min(max_norm, float(want))) < 1e-5 * float(want)


@pytest.mark.parametrize("name", ["warmup_linear", "cosine"])
def test_schedules_match_reference(joptim, name):
    """Every count from 0 past ``total``, as an int32 tensor."""
    import jax.numpy as jnp

    f, jf = LRS[name](port), LRS[name](joptim)
    for c in range(12):
        got = f(torch.tensor(c, dtype=torch.int32))
        want = jf(jnp.asarray(c, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=0)
