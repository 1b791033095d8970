"""Federated LM training of every other family against the JAX package on
the CPU, at the smoke size: ``make_train_step`` for Granite-MoE, OLMoE,
SeamlessM4T, LLaVA, Hymba, Gemma-7B, Phi3-medium and xLSTM, 3 rounds
from the reference's initial state (``test_torch_lm_train.py`` holds
SmolLM the same way); Hymba's ``loss_fn`` gradient in bf16 under the bf16
policy's rule; and the copy of the example's ``scale_cfg`` that
``chip_smoke.py`` trains the ``100m`` families at.

Bounds: ``test_torch_lm_train._compare``'s (every state leaf and metric
within rtol 2e-5, atol 1e-6, but on coordinates tied in round 0 or
later, ROADMAP Queue C trap AC).  xLSTM adds trap AF: its sLSTM bias
gradients sit near zero in many coordinates, where the two packages'
gradients (held to each other within 2e-5 of each leaf's largest) may
differ in sign, and Eq. (18)'s and (20)'s signs turn that into +-psi
alpha_w.  Before every round the port's own gradient of the round's
objective marks those coordinates (|g| <= ``AF_REL`` times the client's
largest |g| in the leaf); a departure there may grow by 2 psi
max(alpha_w, alpha_z) a round, like a tie, without counting toward
``MAX_TIES``; every other element keeps the usual bounds.
"""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_train import (GRAD_TOL, _batches, _cfgs, _compare,
                                 _port_batch, _ref_lm_state, _ref_tree,
                                 FED_KNOBS, C, ROUNDS, jref)  # noqa: F401
from test_torch_reference import (  # noqa: F401  (fixture)
    REPO_ROOT, flat_items, one_thread, port_state_arrays, ref_state_arrays,
    reference)

from repro_torch.configs import ARCHS, get_arch, reduce_for_smoke, scale_cfg
from repro_torch.core import dro
from repro_torch.core.fed_state import fed_state_from_numpy, \
    params_from_numpy
from repro_torch.core.privacy import gaussian_c3
from repro_torch.launch import steps
from repro_torch.models import transformer as tr
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

FAMILIES = ["granite-moe-3b-a800m", "olmoe-1b-7b", "seamless-m4t-medium",
            "llava-next-mistral-7b", "hymba-1.5b", "gemma-7b",
            "phi3-medium-14b", "xlstm-1.3b"]
AF_REL = GRAD_TOL     # below the gradients' parity bound a sign is open
# the bf16 policy's ratio rule (tests/test_torch_bf16_policy.py)
RMS_RATIO, MAX_RATIO = (0.5, 1.25), 1.5


def _near_zero(cfg, fed, c3, state, batch):
    """{parameter path: bool mask} of the coordinates where some client's
    gradient of the round's objective (data loss + rho G, as
    ``bafdp._client_block_updates`` takes it; the LDP noise below
    rounding) is at most ``AF_REL`` times that client's largest |g| in
    the leaf."""
    local_loss = steps.make_local_loss(cfg, fed, c3)
    W = tree_map(lambda w: w.detach().clone().requires_grad_(True), state.W)
    with torch.enable_grad():
        g = local_loss(W, batch, torch.Generator().manual_seed(0), state.eps)
        rho = fed.dro_weight * dro.rho(state.eps, steps.N_SAMPLES,
                                       cfg.d_model, c3, fed)
        G = dro.lipschitz_surrogate(W, fed.lipschitz_surrogate)
        grads = torch.autograd.grad((g + rho * G).sum(), tree_leaves(W))
    out = {}
    for path, gr in flat_items(tree_unflatten(W, list(grads))):
        a = gr.detach().abs().reshape(gr.shape[0], -1)
        small = a <= AF_REL * a.max(dim=1, keepdim=True).values
        out[path] = small.any(0).reshape(gr.shape[1:]).numpy()
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_make_train_step_matches_reference(reference, jref, arch):
    """``make_train_step`` in both packages from the reference's initial
    state, the LDP noise below rounding (``privacy_budget_a`` = 1e18, as
    ``test_torch_lm_train.test_make_train_step_matches_reference``), all
    clients active, client 1 sign-flipping, 3 steps; xLSTM under trap AF
    (module docstring)."""
    _train_step_parity(reference, jref, *_cfgs(jref, arch))


# the families whose own head dim is not the smoke configs' 64
WIDE_HEAD_FAMILIES = ["gemma-7b", "phi3-medium-14b", "olmoe-1b-7b"]


@pytest.mark.parametrize("arch", WIDE_HEAD_FAMILIES)
def test_make_train_step_matches_reference_at_the_familys_head_dim(
        reference, jref, arch):
    """The same at the family's own head dim (256 for Gemma-7B, 128 for
    Phi3-medium and OLMoE), restored in both packages' smoke configs: B4
    and its backward at those head dims under autograd (their plain
    versions on the CPU) against the reference's XLA attention and
    ``jax.grad``."""
    jcfg, cfg = _cfgs(jref, arch)
    hd = get_arch(arch).resolved_head_dim
    jcfg, cfg = (dataclasses.replace(c, head_dim=hd) for c in (jcfg, cfg))
    assert cfg.resolved_head_dim == hd in (128, 256)
    _train_step_parity(reference, jref, jcfg, cfg)


def _train_step_parity(reference, jref, jcfg, cfg):
    r = reference
    arch = cfg.name.replace("-smoke", "")
    jsteps = importlib.import_module("repro.launch.steps")
    knobs = dict(FED_KNOBS, privacy_budget_a=1e18, active_frac=1.0)
    fed_j = dataclasses.replace(jsteps.fed_config_for(jcfg, C), **knobs)
    fed = dataclasses.replace(steps.fed_config_for(cfg, C), **knobs)
    c3 = gaussian_c3(cfg.d_model, fed.dp_delta, fed.dp_sensitivity)
    seq = 32 + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    batches = _batches(cfg, ROUNDS, seq)
    state = _ref_lm_state(r, jcfg, fed_j)
    init = ref_state_arrays(state)

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
    states, metrics, near_zero = [], [], None
    if arch == "xlstm-1.3b":
        near_zero = []
    with one_thread():
        for t in range(ROUNDS):
            batch = _port_batch(batches[t])
            if near_zero is not None:
                marks = _near_zero(cfg, fed, c3, pstate, batch)
                if near_zero:
                    marks = {p: m | near_zero[-1][p]
                             for p, m in marks.items()}
                near_zero.append(marks)
            pstate, m = step(pstate, batch, t)
            states.append(port_state_arrays(pstate))
            metrics.append({k: v.numpy() for k, v in m.items()})
    _compare(init, states, metrics, ref_states, ref_metrics, fed,
             near_zero=near_zero)


def _policy_errors(e_port, e_ref):
    rms = lambda e: float(np.sqrt(np.mean(np.square(e))))
    return (rms(e_port) / rms(e_ref),
            float(np.abs(e_port).max()) / float(np.abs(e_ref).max()))


def test_hymba_bf16_gradient_follows_the_bf16_policy(jref):
    """Hymba's smoke model with ``compute_dtype="bfloat16"`` (B4 and B6
    under autograd, their plain versions on the CPU): each package's
    ``loss_fn`` gradient on the reference's weights against its own f32
    gradient, ``e = g_bf16 - g_f32`` over every leaf (each scaled by its
    f32 gradient's largest |value|, so no leaf drowns the others), held
    by the bf16 policy's rule: 0.5 <= RMS(e_port) / RMS(e_ref) <= 1.25
    and max|e_port| <= 1.5 max|e_ref|."""
    arch = "hymba-1.5b"
    jcfg32, cfg32 = _cfgs(jref, arch)
    tree = _ref_tree(arch)
    batch = jref["tokens"].lm_batch(np.random.RandomState(4), jcfg32, 2, 300)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    port, ref = {}, {}
    for dt in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jcfg32, compute_dtype=dt)
        cfg = dataclasses.replace(cfg32, compute_dtype=dt)
        jg = jax.grad(lambda p: jref["tr"].loss_fn(p, jbatch, jcfg))(
            jax.tree.map(jnp.asarray, tree))
        ref[dt] = [np.asarray(g, np.float32) for g in jax.tree.leaves(jg)]
        W = params_from_numpy(tree, device="cpu")
        leaves = [l.requires_grad_(True) for l in tree_leaves(W)]
        with one_thread():
            loss = tr.loss_fn(tr.lm_view(W, cfg), _port_batch(batch), cfg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        port[dt] = [np.zeros(l.shape, np.float32) if g is None
                    else g.float().numpy() for g, l in zip(grads, leaves)]
    e_port, e_ref = [], []
    for gp, gp32, gr, gr32 in zip(port["bfloat16"], port["float32"],
                                  ref["bfloat16"], ref["float32"]):
        scale = max(float(np.abs(gr32).max()), 1e-30)
        e_port.append(((gp - gp32) / scale).ravel())
        e_ref.append(((gr - gr32) / scale).ravel())
    rms_ratio, max_ratio = _policy_errors(np.concatenate(e_port),
                                          np.concatenate(e_ref))
    assert RMS_RATIO[0] <= rms_ratio <= RMS_RATIO[1], rms_ratio
    assert max_ratio <= MAX_RATIO, max_ratio


def _example():
    """``examples/federated_lm_training.py`` as a module (it imports the
    JAX package, so inside the ``reference`` fixture)."""
    spec = importlib.util.spec_from_file_location(
        "federated_lm_training",
        os.path.join(REPO_ROOT, "examples", "federated_lm_training.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scale_cfg_is_the_examples(reference):
    """``configs.scale_cfg`` equals the example's ``scale_cfg`` field for
    field for every family at both scales, and ``chip_smoke.py``'s
    ``100m`` configs are it, but for xLSTM, whose two-entry smoke
    pattern the chip tiles to 8 layers (the example's own config fails
    its ``pattern()`` check there)."""
    import sys
    sys.path.insert(0, REPO_ROOT)
    import chip_smoke

    ex = _example()
    for arch in sorted(ARCHS):
        for scale in ("smoke", "100m"):
            assert dataclasses.asdict(scale_cfg(arch, scale)) == \
                dataclasses.asdict(ex.scale_cfg(arch, scale)), (arch, scale)
    for arch in chip_smoke.LM_100M_ARCHS:
        want = scale_cfg(arch, "100m")
        got = chip_smoke.lm100m_config(arch)
        if arch == "xlstm-1.3b":
            with pytest.raises(AssertionError):
                want.pattern()
            want = dataclasses.replace(want, block_pattern=want.block_pattern
                                       * 4)
        assert got == want and len(got.pattern()) == 8
        assert got.compute_dtype == "float32" and got.resolved_head_dim == 64
    assert reduce_for_smoke(get_arch("hymba-1.5b")).remat is False
