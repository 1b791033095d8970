"""``long_500k``'s decode at its last positions for the served families not
held in ``test_torch_lm.py`` (Gemma-7B and Phi3-medium are held there),
on the CPU at the smoke size, against the reference.  This file holds
the attention-only families (SmolLM-360M, LLaVA-NeXT-Mistral-7B,
SeamlessM4T-medium) and the body, :func:`check_long_500k`, that
``test_torch_long_shapes_moe.py`` (Granite-MoE, OLMoE) and
``test_torch_long_shapes_recurrent.py`` (Hymba-1.5B, xLSTM-1.3B) call
too: three files, so that ``--dist loadfile`` spreads them over workers.

Each family's smoke model runs ``make_decode_step`` at the 8 absolute
steps 524,284-524,291 (RoPE angles near 2^19 rad, the ring's wrap at
524,288 in the middle; ``test_torch_lm.py`` runs 524,280-524,295, and 8
steps keep these cases under ~15 s each on a loaded worker) from a
decode state whose every leaf was first filled with
seeded normal values in both packages: the K/V rings, Hymba's Mamba
state (``h``, ``conv``), xLSTM's mLSTM (``C``, ``n``, ``m``) and sLSTM
(``h``, ``c``, ``n``, ``m``) states, and SeamlessM4T's encoder memory
(so its cross-attention reads non-zero K/V).  The families with a
sliding window decode through a ring of 8 slots (``long_500k``'s ring at
a smoke window): each step writes slot ``step % 8`` of every ring and
nothing else.  xLSTM has no window (``launch.steps.decode_window`` gives
0): its state is recurrent, and it must move every step.  Every step's
logits and, at the end, every leaf of the state are held to the
reference's at ``test_torch_lm``'s 2e-5 abs/rel.  The reference runs op
by op (``jax.disable_jit``), the mode whose RoPE frequencies the port
follows (ROADMAP Queue C, trap AJ).  Torch runs on one thread: the smoke
models are thousands of small ops.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import INPUT_SHAPES
from repro_torch.launch.steps import decode_window, make_decode_step
from repro_torch.models import transformer as tr
from repro_torch.tree import tree_leaves_with_path
from test_torch_lm import _both, _close, jref  # noqa: F401
from test_torch_reference import one_thread

LONG_STEPS = range(524_284, 524_292)      # crosses the wrap at 524,288
RING = 8
CASES = [("smollm-360m", RING), ("llava-next-mistral-7b", RING),
         ("seamless-m4t-medium", RING)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def _fill(port: dict, ref: dict, g: int, rng) -> None:
    """Every tensor leaf of one layer's port state (a dict, nested for the
    recurrent states) and slice ``g`` of the reference's stacked leaf
    under the same keys, set to one seeded normal draw, in sorted key
    order."""
    import jax.numpy as jnp

    for name in sorted(port):
        if isinstance(port[name], dict):
            _fill(port[name], ref[name], g, rng)
            continue
        fill = rng.randn(*port[name].shape).astype(np.float32)
        port[name].copy_(torch.from_numpy(fill))
        ref[name] = ref[name].at[g].set(jnp.asarray(fill,
                                                    ref[name].dtype))


def _ref_leaf(layer: dict, path: tuple):
    for key in path:
        layer = layer[key]
    return layer


def check_long_500k(jref, arch: str, window: int) -> None:
    """``arch``'s smoke decode at LONG_STEPS against the reference, from a
    state seeded in both packages, through a ring of ``window`` slots (0:
    none, the state recurrent)."""
    import jax
    import jax.numpy as jnp

    jparams, params, jcfg, cfg = _both(jref, arch)
    assert (decode_window(cfg, INPUT_SHAPES["long_500k"]) > 0) == (window > 0)
    toks = np.random.RandomState(9).randint(0, cfg.vocab_size,
                                            (2, len(LONG_STEPS)))
    jstate = jref.tr.init_decode_state(jcfg, 2, 524_288, jnp.float32,
                                       window=window)
    state = tr.init_decode_state(cfg, 2, 524_288, torch.float32,
                                 window=window, device="cpu")
    rng = np.random.RandomState(10)
    unit = len(jstate["layers"])
    rings = []
    for i, layer in enumerate(state["layers"]):
        if "k" in layer:
            assert layer["k"].shape == (2, window, cfg.n_kv_heads,
                                        cfg.resolved_head_dim)
            rings.append(layer)
        _fill(layer, jstate["layers"][i % unit], i // unit, rng)
    assert bool(rings) == (window > 0)
    if "memory" in state:
        fill = rng.randn(*state["memory"].shape).astype(np.float32)
        state["memory"].copy_(torch.from_numpy(fill))
        jstate["memory"] = jnp.asarray(fill)
    jstep = functools.partial(jref.tr.decode_step, cfg=jcfg, window=window)
    step = make_decode_step(cfg, window)
    for n, t in enumerate(LONG_STEPS):
        before = [{path: leaf.clone()
                   for path, leaf in tree_leaves_with_path(layer)}
                  for layer in state["layers"]]
        with jax.disable_jit():
            want, jstate = jstep(jparams, jstate,
                                 jnp.asarray(toks[:, n:n + 1]),
                                 jnp.asarray(t))
        got, state = step(params, state, torch.from_numpy(toks[:, n:n + 1]),
                          t)
        assert got.shape == (2, 1, cfg.padded_vocab)
        _close(got, want)
        for b, layer in zip(before, state["layers"]):
            for path, new in tree_leaves_with_path(layer):
                if path in (("k",), ("v",)):
                    moved = (b[path] != new).any(dim=(0, 2, 3)).tolist()
                    assert moved == [s == t % window
                                     for s in range(window)], (t, moved)
                else:        # a recurrent state moves every step
                    assert not torch.equal(b[path], new), (t, path)
    for i, layer in enumerate(state["layers"]):
        jlayer = jstate["layers"][i % unit]
        for path, leaf in tree_leaves_with_path(layer):
            _close(leaf, _ref_leaf(jlayer, path)[i // unit])


@pytest.mark.parametrize("arch,window", CASES)
def test_long_500k_decode_across_the_wrap_matches_reference(jref, arch,
                                                           window):
    check_long_500k(jref, arch, window)
