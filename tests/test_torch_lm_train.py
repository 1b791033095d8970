"""Federated LM training of the port against the JAX package on the CPU, at
the smoke size (``reduce_for_smoke``: 2 layers, d 256, vocab 1024):
the token data, the chunked CE, ``loss_fn`` and its gradient for every
architecture, remat, the LDP noise, one BAFDP round over the LM state,
``make_train_step`` and the training CLI.  Both packages get the same
numpy inputs and the reference's own initial weights or state.

Tolerances (f32 on both sides; the frameworks order matmul and reduction
sums differently):
* data: bit for bit (a numpy copy);
* CE and loss values: rtol 1e-5 (measured worst: 1.3e-7 relative);
* gradients: each leaf within 2e-5 of its largest |value| (measured
  worst over the ten architectures: 7.1e-6, SeamlessM4T's encoder);
* federated state and metrics after each of 3 rounds: rtol 2e-5,
  atol 1e-6, as ``test_torch_round.py``, except on a tied coordinate
  (:func:`_compare`).  The consensus starts at client 0's weights, so
  ``sign(z - w_0)`` sits on a tie wherever client 0's first step rounds
  away in one package and not in the other, and the sign (0 or +-1)
  moves that coordinate of z by psi alpha_z / C, then of W by up to
  2 psi alpha_w a round.  ``test_lm_round_matches_reference`` meets
  three such coordinates among 1.44 M.
Bit identity is held only inside the port (remat on vs off).
"""
import dataclasses
import functools
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reference import (  # noqa: F401  (fixture)
    REPO_ROOT, assert_states_close, flat_items, one_thread,
    port_state_arrays, ref_state_arrays, reference)

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch, \
    reduce_for_smoke
from repro_torch.core import bafdp
from repro_torch.core.byzantine import byz_mask
from repro_torch.core.fed_state import (fed_state_from_numpy,
                                        init_fed_state, init_lm_tree,
                                        params_from_numpy)
from repro_torch.core.privacy import gaussian_c3, sigma_for_eps
from repro_torch.data.tokens import lm_batch
from repro_torch.launch import steps
from repro_torch.models import layers
from repro_torch.models import transformer as tr
from repro_torch.tree import tree_leaves, tree_map, tree_unstack

ALL_ARCHS = sorted(ARCHS)
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
RTOL, ATOL = 2e-5, 1e-6
C, B, S, ROUNDS = 2, 2, 32, 3


@pytest.fixture(scope="module")
def jref():
    """The reference's LM modules (they import without the alias)."""
    names = {"configs": "repro.configs", "tr": "repro.models.transformer",
             "layers": "repro.models.layers", "tokens": "repro.data.tokens"}
    return {k: importlib.import_module(v) for k, v in names.items()}


def _cfgs(jref, arch):
    jcfg = jref["configs"].reduce_for_smoke(jref["configs"].get_arch(arch))
    cfg = reduce_for_smoke(get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    jtr = importlib.import_module("repro.models.transformer")
    jconfigs = importlib.import_module("repro.configs")
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_arch(arch))
    return jax.tree.map(np.asarray, jtr.init_lm(jax.random.PRNGKey(0), jcfg))


def _port_batch(batch, dev="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def _leaf_close(got, want, what):
    got = np.zeros_like(want) if got is None else np.asarray(got)
    bound = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max |err| {err:.3e} > {bound:.3e}"


# ---------------------------------------------------------------------------
# trees and data
def test_tree_order_of_dicts_unchanged_and_tuples_by_position(jref):
    """A dict-only tree keeps its sorted-key order (``l10`` before
    ``l2``); an LM tree's leaves follow ``jax.tree.leaves`` (``unit`` a
    tuple, by position) leaf for leaf; ``tree_unstack`` gives views whose
    gradient lands in the stacked leaf."""
    d = {"l2": {"w": 3, "b": 2}, "l10": {"w": 1, "b": 0}, "a": 4}
    assert tree_leaves(d) == [4, 0, 1, 2, 3]
    assert list(tree_map(lambda x: x, d)) == ["a", "l10", "l2"]
    tree = _ref_tree("xlstm-1.3b")
    got = [l.shape for l in tree_leaves(tree)]
    assert got == [l.shape for l in jax.tree.leaves(tree)]
    mapped = tree_map(lambda a: a, tree)
    assert isinstance(mapped["unit"], tuple)
    x = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    rows = tree_unstack({"x": x})
    (sum(r["x"].sum() * (i + 1) for i, r in enumerate(rows))).backward()
    assert torch.equal(x.grad, torch.tensor([[1.0, 1.0], [2.0, 2.0],
                                             [3.0, 3.0]]))


@pytest.mark.parametrize("arch", ["smollm-360m", "llava-next-mistral-7b",
                                  "seamless-m4t-medium"])
def test_lm_batch_is_bit_identical(jref, arch):
    jcfg, cfg = _cfgs(jref, arch)
    want = jref["tokens"].lm_batch(np.random.RandomState(3), jcfg, 3, 48)
    got = lm_batch(np.random.RandomState(3), cfg, 3, 48)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_init_lm_tree_has_the_reference_layout(jref):
    """``init_lm_tree`` gives the reference's ``init_lm`` tree: the same
    leaves in the same order, shapes and dtypes."""
    for arch in ("smollm-360m", "xlstm-1.3b", "seamless-m4t-medium"):
        _, cfg = _cfgs(jref, arch)
        got = init_lm_tree(torch.Generator().manual_seed(0), cfg, "cpu")
        want = _ref_tree(arch)
        assert [p for p, _ in flat_items(got)] == \
            [p for p, _ in flat_items(want)]
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert tuple(g.shape) == w.shape and not g.requires_grad
            assert str(g.dtype).split(".")[1] == str(w.dtype)


# ---------------------------------------------------------------------------
# losses
def test_chunked_ce_matches_cross_entropy_and_reference(jref):
    """Padded vocab (-1e9 on the tail), labels of -1 and a sequence that
    is no multiple of the chunk, in both packages."""
    jcfg, cfg = _cfgs(jref, "smollm-360m")
    jcfg = dataclasses.replace(jcfg, vocab_size=1000)
    cfg = dataclasses.replace(cfg, vocab_size=1000)
    assert cfg.padded_vocab > cfg.vocab_size
    rng = np.random.RandomState(0)
    tok = (0.05 * rng.randn(cfg.padded_vocab, cfg.d_model)).astype(np.float32)
    x = rng.randn(2, 70, cfg.d_model).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, (2, 70)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, 33] = -1
    emb = {"tok": torch.from_numpy(tok)}
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    got = layers.chunked_ce_from_hidden(emb, xt, lt, cfg, chunk=16)
    full = layers.cross_entropy(layers.lm_logits(emb, xt, cfg), lt,
                                cfg.vocab_size)
    jl = jref["layers"]
    want = jl.chunked_ce_from_hidden({"tok": jnp.asarray(tok)},
                                     jnp.asarray(x), jnp.asarray(labels),
                                     jcfg, chunk=16)
    want_full = jl.cross_entropy(
        jl.lm_logits({"tok": jnp.asarray(tok)}, jnp.asarray(x), jcfg),
        jnp.asarray(labels), jcfg.vocab_size)
    for a in (got, full):
        np.testing.assert_allclose(a.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(full.item(), float(want_full), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_fn_and_grads_match_reference(jref, arch):
    """``loss_fn`` on ``lm_view`` of the reference's own weights and its
    gradient in every leaf, against ``jax.value_and_grad`` of the
    reference's ``loss_fn``, as the reference's
    ``test_forward_and_train_step`` takes it."""
    jcfg, cfg = _cfgs(jref, arch)
    tree = _ref_tree(arch)
    batch = jref["tokens"].lm_batch(np.random.RandomState(0), jcfg, B, S)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.value_and_grad(
        lambda p: jref["tr"].loss_fn(p, jbatch, jcfg))(
        jax.tree.map(jnp.asarray, tree))
    W = params_from_numpy(tree, device="cpu")
    leaves = [l.requires_grad_(True) for l in tree_leaves(W)]
    with one_thread():
        loss = tr.loss_fn(tr.lm_view(W, cfg), _port_batch(batch), cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    paths = [p for p, _ in flat_items(tree)]
    for path, g, w in zip(paths, grads, jax.tree.leaves(jgrads)):
        _leaf_close(None if g is None else g.numpy(), np.asarray(w),
                    f"{arch} {path}")


@pytest.mark.parametrize("arch", ["smollm-360m", "xlstm-1.3b",
                                  "seamless-m4t-medium"])
def test_remat_changes_no_value_or_gradient(jref, arch):
    """``cfg.remat`` (checkpointed units; nested per sublayer for xLSTM's
    unit of several, per layer in SeamlessM4T's encoder) gives the same
    loss and gradient bit for bit."""
    _, cfg = _cfgs(jref, arch)
    tree = _ref_tree(arch)
    batch = _port_batch(lm_batch(np.random.RandomState(1), cfg, B, S))
    out = []
    for remat in (False, True):
        W = params_from_numpy(tree, device="cpu")
        leaves = [l.requires_grad_(True) for l in tree_leaves(W)]
        c = dataclasses.replace(cfg, remat=remat)
        with one_thread():
            loss = tr.loss_fn(tr.lm_view(W, c), batch, c)
            out.append((loss, torch.autograd.grad(loss, leaves,
                                                  allow_unused=True)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)


def test_noise_scale_is_sigma_for_eps(monkeypatch):
    """The LDP noise the training step adds to each client's embeddings is
    N(0, sigma_i^2) with sigma_i = sigma_for_eps(eps_i, c3, eps_min),
    statistically (mean and std of 32,768 draws per client)."""
    cfg = reduce_for_smoke(get_arch("smollm-360m"))
    fed = steps.fed_config_for(cfg, C)
    c3 = gaussian_c3(cfg.d_model, fed.dp_delta, fed.dp_sensitivity)
    seen = []
    real = tr._perturb

    def spy(x, gen, sigma):
        y = real(x, gen, sigma)
        seen.append((y - x).detach())
        return y

    monkeypatch.setattr(tr, "_perturb", spy)
    W = tree_map(lambda *ls: torch.stack(ls), *[
        init_lm_tree(torch.Generator().manual_seed(i), cfg, "cpu")
        for i in range(C)])
    batch = _port_batch(lm_batch(np.random.RandomState(0), cfg, C * B, 64))
    batch = {k: v.reshape((C, B) + v.shape[1:]) for k, v in batch.items()}
    eps = torch.tensor([0.5, 4.0])
    with one_thread():
        steps.make_local_loss(cfg, fed, c3)(
            W, batch, torch.Generator().manual_seed(0), eps)
    sig = sigma_for_eps(eps, c3, fed.eps_min)
    assert len(seen) == C
    for r, n in enumerate(seen):
        assert n.numel() == B * 64 * cfg.d_model
        assert abs(n.mean().item()) < 0.02 * sig[r].item()
        assert abs(n.std().item() / sig[r].item() - 1.0) < 0.02


# ---------------------------------------------------------------------------
# the federated round
def _ref_lm_state(r, jcfg, fed):
    jtr = importlib.import_module("repro.models.transformer")
    return r.fed_state.init_fed_state(
        jax.random.PRNGKey(0), lambda k: jtr.init_lm(k, jcfg), fed)


def _batches(cfg, n, seq):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        raw = lm_batch(rng, cfg, C * B, seq)
        out.append({k: v.reshape((C, B) + v.shape[1:])
                    for k, v in raw.items()})
    return out


TIE_ULPS = 4          # |a - b| this many ulps of |a| or less is a tie
MAX_TIES = 8          # tied coordinates allowed over the whole model


def _tied(prev, new, path, pix) -> bool:
    """Whether, in one package, parameter ``path`` at ``pix`` sat on a
    tie of a sign the round takes: ``z`` (before the round) against a
    client's new ``w`` (Eq. 20), or a client's ``w`` against its
    ``z_local`` (both before the round; Eq. 18)."""
    z = dict(flat_items(prev["z"]))[path][pix]
    zl = dict(flat_items(prev["z_local"]))[path]
    w_old = dict(flat_items(prev["W"]))[path]
    w_new = dict(flat_items(new["W"]))[path]
    tol = TIE_ULPS * np.spacing(np.float32(abs(z)))
    return any(abs(float(z) - float(w_new[c][pix])) <= tol
               or abs(float(w_old[c][pix]) - float(zl[c][pix])) <= tol
               for c in range(w_new.shape[0]))


def _compare(init, states, metrics, ref_states, ref_metrics, fed,
             near_zero=None):
    """Every state leaf and metric after every round within (RTOL, ATOL),
    except on tied coordinates.  A coordinate (a parameter leaf and an
    index into it) is tied from the round in which some state element
    there first differs beyond the tolerance, and only if one package
    sat on a tie there (:func:`_tied`).  There, every state leaf may
    differ by 2 psi max(alpha_w, alpha_z) per round since the tie, plus
    ATOL; at most MAX_TIES coordinates are tied.  ``near_zero`` (trap
    AF, xLSTM; ``test_torch_lm_train_families.py``): per round, {path:
    bool mask} of the coordinates with a near-zero gradient so far; a
    departure there gets the same per-round allowance without a tie and
    does not count toward MAX_TIES."""
    params = {p: np.shape(v) for p, v in flat_items(init["z"])}
    since, free = {}, set()
    step = 2 * fed.psi * max(fed.alpha_w, fed.alpha_z)
    for t in range(len(states)):
        prev = (init, init) if t == 0 else (states[t - 1], ref_states[t - 1])
        for key in states[t]:
            if states[t][key] is None:
                continue
            for (path, a), (_, b) in zip(flat_items(states[t][key]),
                                         flat_items(ref_states[t][key])):
                a, b = np.asarray(a), np.asarray(b)
                assert a.shape == b.shape, path
                if key in ("t", "tau"):
                    np.testing.assert_array_equal(a, b, err_msg=key)
                    continue
                for ix in map(tuple, np.argwhere(
                        ~np.isclose(a, b, rtol=RTOL, atol=ATOL))):
                    where = f"round {t} {key}{path}{ix}: {a[ix]} vs {b[ix]}"
                    assert path in params, where
                    tie = (path, ix[len(ix) - len(params[path]):])
                    if tie not in since:
                        if near_zero is not None and \
                                near_zero[t][path][tie[1]]:
                            free.add(tie)
                        else:
                            assert any(_tied(p, n, *tie) for p, n in zip(
                                prev, (states[t], ref_states[t]))), \
                                f"{where}, no tie before it"
                        since[tie] = t
                    bound = (t - since[tie] + 1) * step
                    assert abs(float(a[ix]) - float(b[ix])) <= bound + ATOL, \
                        f"{where}, beyond {bound} since the tie"
        assert len(since) - len(free) <= MAX_TIES, sorted(set(since) - free)
        assert sorted(metrics[t]) == sorted(ref_metrics[t])
        for k in metrics[t]:
            np.testing.assert_allclose(
                metrics[t][k], ref_metrics[t][k], rtol=RTOL, atol=ATOL,
                err_msg=f"round {t} metric {k}")
    return since


FED_KNOBS = dict(byzantine_frac=0.5, attack="sign_flip", alpha_w=2e-2)


def test_lm_round_matches_reference(reference, jref):
    """``bafdp_round`` over the LM state from the reference's initial
    state, C = 2, all clients active, client 1 sign-flipping, a
    ``local_loss`` without noise in both packages, 3 rounds."""
    r = reference
    jcfg, cfg = _cfgs(jref, "smollm-360m")
    jsteps = importlib.import_module("repro.launch.steps")
    fed_j = dataclasses.replace(jsteps.fed_config_for(jcfg, C), **FED_KNOBS)
    fed = dataclasses.replace(steps.fed_config_for(cfg, C), **FED_KNOBS)
    c3 = gaussian_c3(cfg.d_model, fed.dp_delta, fed.dp_sensitivity)
    act = np.ones((C,), bool)
    batches = _batches(cfg, ROUNDS, S)

    state = _ref_lm_state(r, jcfg, fed_j)
    init = ref_state_arrays(state)
    jtr = importlib.import_module("repro.models.transformer")
    jstep = jax.jit(functools.partial(
        r.bafdp.bafdp_round,
        local_loss=lambda p, b, k, e: jtr.loss_fn(p, b, jcfg), fed=fed_j,
        c3=c3, n_samples=steps.N_SAMPLES, d_dim=cfg.d_model,
        byz_mask=r.byzantine.byz_mask(C, fed_j.n_byzantine)))
    ref_states, ref_metrics = [], []
    for t in range(ROUNDS):
        state, m = jstep(state, {k: jnp.asarray(v)
                                 for k, v in batches[t].items()},
                         jax.random.PRNGKey(t), act=jnp.asarray(act))
        ref_states.append(ref_state_arrays(state))
        ref_metrics.append({k: np.asarray(v) for k, v in m.items()})

    def local_loss(W, batch, gen, eps):
        return torch.stack([
            tr.loss_fn(tr.lm_view(w, cfg), {k: v[i] for k, v in
                                            batch.items()}, cfg)
            for i, w in enumerate(tree_unstack(W))])

    pstate = fed_state_from_numpy(init, device="cpu")
    states, metrics = [], []
    with one_thread():
        for t in range(ROUNDS):
            pstate, m = bafdp.bafdp_round(
                pstate, _port_batch(batches[t]),
                torch.Generator().manual_seed(t), local_loss=local_loss,
                fed=fed, c3=c3, n_samples=steps.N_SAMPLES,
                d_dim=cfg.d_model, byz_mask=byz_mask(C, fed.n_byzantine),
                act=act)
            states.append(port_state_arrays(pstate))
            metrics.append({k: v.numpy() for k, v in m.items()})
    since = _compare(init, states, metrics, ref_states, ref_metrics, fed)
    assert 0 < len(since), "these inputs meet ties in round 0"


def test_make_train_step_matches_reference(reference, jref):
    """``make_train_step`` in both packages from the reference's initial
    state, with the LDP noise on but below rounding: with
    ``privacy_budget_a`` = 1e18 the clients start at eps = 5e17 and sigma
    = c3 / eps ~ 5e-19, under half an ulp of every embedding (checked
    first: the perturbed forward equals the clean one bit for bit in both
    packages), so the draws, which the two frameworks cannot share, drop
    out.  All clients active (``active_frac`` = 1), 3 steps."""
    r = reference
    jcfg, cfg = _cfgs(jref, "smollm-360m")
    jsteps = importlib.import_module("repro.launch.steps")
    jtr = importlib.import_module("repro.models.transformer")
    knobs = dict(FED_KNOBS, privacy_budget_a=1e18, active_frac=1.0)
    fed_j = dataclasses.replace(jsteps.fed_config_for(jcfg, C), **knobs)
    fed = dataclasses.replace(steps.fed_config_for(cfg, C), **knobs)
    c3 = gaussian_c3(cfg.d_model, fed.dp_delta, fed.dp_sensitivity)
    batches = _batches(cfg, ROUNDS, S)
    state = _ref_lm_state(r, jcfg, fed_j)
    init = ref_state_arrays(state)

    # the noise is below rounding in both packages
    eps0 = float(init["eps"][0])
    tree = jax.tree.map(lambda l: l[0], init["W"])
    b0 = {k: v[0] for k, v in batches[0].items()}
    jb0 = {k: jnp.asarray(v) for k, v in b0.items()}
    jsig = r.privacy.sigma_for_eps(jnp.asarray(eps0), c3, fed.eps_min)
    jclean, _ = jtr.forward(jax.tree.map(jnp.asarray, tree), jb0, jcfg)
    jnoisy, _ = jtr.forward(jax.tree.map(jnp.asarray, tree), jb0, jcfg,
                            noise=(jax.random.PRNGKey(5), jsig))
    np.testing.assert_array_equal(np.asarray(jnoisy), np.asarray(jclean))
    W0 = tr.lm_view(params_from_numpy(tree, device="cpu"), cfg)
    sig = sigma_for_eps(torch.tensor(eps0), c3, fed.eps_min)
    clean, _ = tr.forward(W0, _port_batch(b0), cfg)
    noisy, _ = tr.forward(W0, _port_batch(b0), cfg,
                          noise=(torch.Generator().manual_seed(5), sig))
    assert sig.item() > 0 and torch.equal(noisy, clean)

    jstep = jax.jit(jsteps.make_train_step(jcfg, fed_j))
    ref_states, ref_metrics = [], []
    for t in range(ROUNDS):
        state, m = jstep(state, {k: jnp.asarray(v)
                                 for k, v in batches[t].items()},
                         jnp.asarray(t))
        ref_states.append(ref_state_arrays(state))
        ref_metrics.append({k: np.asarray(v) for k, v in m.items()})
    step = steps.make_train_step(cfg, fed)
    pstate = fed_state_from_numpy(init, device="cpu")
    states, metrics = [], []
    with one_thread():
        for t in range(ROUNDS):
            pstate, m = step(pstate, _port_batch(batches[t]), t)
            states.append(port_state_arrays(pstate))
            metrics.append({k: v.numpy() for k, v in m.items()})
    _compare(init, states, metrics, ref_states, ref_metrics, fed)


def test_train_step_loss_decreases_smoke():
    """The reference's ``test_train_step_loss_decreases_smoke`` on the
    port: 12 steps on one batch, the loss falls."""
    cfg = reduce_for_smoke(get_arch("smollm-360m"))
    fed = dataclasses.replace(steps.fed_config_for(cfg, 2), alpha_w=2e-2,
                              active_frac=1.0)
    step = steps.make_train_step(cfg, fed)
    state = init_fed_state(torch.Generator().manual_seed(0),
                           lambda g: init_lm_tree(g, cfg, "cpu"), fed,
                           device="cpu")
    raw = lm_batch(np.random.RandomState(0), cfg, 2 * 4, 32)
    batch = {k: torch.from_numpy(v).reshape((2, 4) + v.shape[1:])
             for k, v in raw.items()}
    losses = []
    with one_thread():
        for t in range(12):
            state, m = step(state, batch, t)
            losses.append(float(m["data_loss"]))
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(losses))


def test_fed_state_carries_the_reference_lm_state(reference, jref):
    """``fed_state_from_numpy`` takes the reference's LM ``FedState``
    leaf for leaf (``unit`` a tuple), and ``batch_shapes`` gives the
    reference's ``batch_struct`` shapes."""
    jcfg, cfg = _cfgs(jref, "llava-next-mistral-7b")
    jsteps = importlib.import_module("repro.launch.steps")
    fed_j = jsteps.fed_config_for(jcfg, C)
    init = ref_state_arrays(_ref_lm_state(reference, jcfg, fed_j))
    state = fed_state_from_numpy(init, device="cpu")
    assert isinstance(state.W["unit"], tuple)
    assert_states_close(port_state_arrays(state), init, rtol=0, atol=0)
    shape = INPUT_SHAPES["train_4k"]
    want = jsteps.batch_struct(jcfg, shape, 4)
    got = steps.batch_shapes(cfg, shape, 4)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k][0] == want[k].shape, k
        assert str(got[k][1]).split(".")[1] == str(want[k].dtype), k


def test_train_cli_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--smoke", "--steps", "3", "--log-every", "1",
         "--device", "cpu"], cwd=REPO_ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}, check=True)
    lines = out.stdout.strip().splitlines()
    assert [l.split()[1] for l in lines[:3]] == ["0", "1", "2"]
    assert lines[-1].startswith("done. final loss")
    # --dry runs the dry-run in process (meta tensors, no device) and
    # writes its artifact under the working directory
    dry = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--smoke", "--dry"], cwd=tmp_path,
        capture_output=True, text=True, check=True,
        env={"PYTHONPATH": os.path.join(REPO_ROOT, "src"),
             "PATH": "/usr/bin:/bin"})
    assert "[dryrun] smollm-360m x train_4k on 1x1" in dry.stdout
    assert (tmp_path / "results" / "dryrun"
            / "smollm-360m__train_4k__1x1.json").is_file()
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--smoke", "--device", "cpu", "--variant", "v"],
        cwd=REPO_ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert bad.returncode != 0 and "'v'" in bad.stderr
