"""The port's dense BAFDP round (``consensus_scope="all"``) against the
reference's, from the reference's own initial state.

Three rounds with explicit numpy ``act``/``stale`` rows and
``input_sigma=0``, so no ``jax.random`` draw enters the comparison (the
noise is drawn on both sides and multiplied by sigma = 0).  The whole
state and the metrics dict are compared after every round.

Tolerance: rtol 2e-5, atol 1e-6.  The two frameworks order f32 matmul and
reduction sums differently and their pow differs by an ulp, which moves
the state by a few ulp per round: the largest state difference seen over
this grid is 9e-8, the largest metric difference 2e-6 on values of order
1.  The bound leaves room for that drift to grow over three rounds, but
not for a flipped sign(z - w) near a tie, which would move a coordinate by
up to 2 * psi * alpha = 1e-4 / C: these inputs have none.
Bit identity is held only inside the port (the kernel tests)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reference import (  # noqa: F401  (fixture)
    assert_states_close, port_state_arrays, ref_state_arrays, reference)

from repro_torch.configs import FedConfig, ForecastConfig
from repro_torch.core import bafdp
from repro_torch.core.byzantine import byz_mask
from repro_torch.core.fed_state import fed_state_from_numpy
from repro_torch.core.privacy import gaussian_c3, perturb_inputs
from repro_torch.models.forecasting import mse_loss

C, B, ROUNDS = 5, 8, 3
CFG = ForecastConfig(hidden=(16, 8), horizon=2)
RTOL, ATOL = 2e-5, 1e-6

GRID = {
    "constant-f32-sgd": dict(),
    "poly-f32-adam": dict(staleness_decay="poly", omega_optimizer="adam"),
    "poly-int8-adam": dict(staleness_decay="poly", sign_message="int8",
                           omega_optimizer="adam"),
    "hinge-int8-dualint8": dict(staleness_decay="hinge",
                                staleness_hinge_b=0.0, sign_message="int8",
                                dual_message="int8"),
    "taylor-global": dict(staleness_decay="poly",
                          staleness_compensation="taylor",
                          omega_optimizer="adam"),
    "sign_flip-byz0.2": dict(attack="sign_flip", byzantine_frac=0.2,
                             omega_optimizer="adam"),
}


def _rows(seed):
    rng = np.random.RandomState(seed)
    act = rng.rand(ROUNDS, C) < 0.6
    act[:, 0] = True                     # at least one active client
    act[1, 3] = False                    # a client that goes stale...
    stale = rng.randint(0, 4, size=(ROUNDS, C)).astype(np.float32)
    stale[act] = 0.0                     # ...and fresh winners
    batches = [(rng.rand(C, B, CFG.d_x).astype(np.float32),
                rng.rand(C, B, CFG.d_y).astype(np.float32))
               for _ in range(ROUNDS)]
    return act, stale, batches


def _run_reference(r, knobs, act, stale, batches):
    fed = r.configs.FedConfig(n_clients=C, **knobs)
    rcfg = r.configs.ForecastConfig(hidden=CFG.hidden, horizon=CFG.horizon)
    c3 = gaussian_c3(CFG.d_x + CFG.d_y, fed.dp_delta, 0.05)

    def local_loss(p, batch, k, eps):
        x, y = batch
        return r.forecasting.mse_loss(
            p, r.privacy.perturb_inputs(k, x, eps, 0.0, fed.eps_min), y,
            rcfg)

    state = r.fed_state.init_fed_state(
        jax.random.PRNGKey(1),
        lambda k: r.forecasting.init_forecaster(k, rcfg), fed)
    init = ref_state_arrays(state)
    step = jax.jit(functools.partial(
        r.bafdp.bafdp_round, local_loss=local_loss, fed=fed, c3=c3,
        n_samples=100, d_dim=CFG.d_x + CFG.d_y,
        byz_mask=r.byzantine.byz_mask(C, fed.n_byzantine)))
    states, metrics = [], []
    for t in range(ROUNDS):
        state, m = step(state, tuple(map(jnp.asarray, batches[t])),
                        jax.random.PRNGKey(t), act=jnp.asarray(act[t]),
                        stale=None if t == 0 else jnp.asarray(stale[t]))
        states.append(ref_state_arrays(state))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return init, states, metrics


def _run_port(knobs, init, act, stale, batches):
    fed = FedConfig(n_clients=C, **knobs)
    c3 = gaussian_c3(CFG.d_x + CFG.d_y, fed.dp_delta, 0.05)

    def local_loss(W, batch, gen, eps):
        x, y = batch
        return mse_loss(W, perturb_inputs(gen, x, eps, 0.0, fed.eps_min), y,
                        CFG)

    state = fed_state_from_numpy(init, device="cpu")
    step = functools.partial(
        bafdp.bafdp_round, local_loss=local_loss, fed=fed, c3=c3,
        n_samples=100, d_dim=CFG.d_x + CFG.d_y,
        byz_mask=byz_mask(C, fed.n_byzantine))
    states, metrics = [], []
    for t in range(ROUNDS):
        batch = tuple(torch.from_numpy(a) for a in batches[t])
        state, m = step(state, batch, torch.Generator().manual_seed(t),
                        act=act[t], stale=None if t == 0 else stale[t])
        states.append(port_state_arrays(state))
        metrics.append({k: v.numpy() for k, v in m.items()})
    return states, metrics


@pytest.mark.parametrize("name", sorted(GRID))
def test_round_matches_reference(reference, name):
    knobs = GRID[name]
    act, stale, batches = _rows(seed=sorted(GRID).index(name))
    init, ref_states, ref_metrics = _run_reference(reference, knobs, act,
                                                   stale, batches)
    states, metrics = _run_port(knobs, init, act, stale, batches)
    for t in range(ROUNDS):
        assert_states_close(states[t], ref_states[t], rtol=RTOL, atol=ATOL)
        assert sorted(metrics[t]) == sorted(ref_metrics[t])
        for k in metrics[t]:
            np.testing.assert_allclose(
                metrics[t][k], ref_metrics[t][k], rtol=RTOL, atol=ATOL,
                err_msg=f"round {t} metric {k}")


def test_round_is_deterministic_inside_the_port():
    """Same state, rows and generator seed -> bit-identical state."""
    knobs = GRID["poly-int8-adam"]
    act, stale, batches = _rows(seed=0)
    fed = FedConfig(n_clients=C, **knobs)
    gen = torch.Generator().manual_seed(3)
    from repro_torch.core.fed_state import init_fed_state
    from repro_torch.models.forecasting import init_forecaster

    init = port_state_arrays(init_fed_state(
        gen, lambda g: init_forecaster(g, CFG), fed, device="cpu"))
    a, _ = _run_port(knobs, init, act, stale, batches)
    b, _ = _run_port(knobs, init, act, stale, batches)
    assert_states_close(a[-1], b[-1], rtol=0, atol=0)


@pytest.mark.parametrize("knobs,match", [
    (dict(consensus_scope="active", consensus_streaming=True,
          consensus_chunk=0), "consensus_chunk must be >= 1"),
    (dict(consensus_streaming=True), "streams the active-scope left-fold"),
    (dict(robust_consensus="median"), "not yet ported"),
    (dict(robust_consensus="bogus"), "unknown robust_consensus"),
    (dict(consensus_scope="bogus"), "unknown consensus_scope"),
    (dict(sign_message="int4"), "unknown sign_message"),
    (dict(staleness_compensation="bogus"), "unknown staleness_compensation"),
])
def test_unported_and_unknown_knobs_raise(knobs, match):
    fed = dataclasses.replace(FedConfig(n_clients=C), **knobs)
    act, stale, batches = _rows(seed=0)
    from repro_torch.core.fed_state import init_fed_state
    from repro_torch.models.forecasting import init_forecaster

    state = init_fed_state(torch.Generator().manual_seed(0),
                           lambda g: init_forecaster(g, CFG), fed,
                           device="cpu")
    with pytest.raises(ValueError, match=match):
        bafdp.bafdp_round(
            state, tuple(torch.from_numpy(a) for a in batches[0]),
            torch.Generator(), local_loss=lambda *a: None, fed=fed, c3=1.0,
            n_samples=100, d_dim=CFG.d_x + CFG.d_y, byz_mask=byz_mask(C, 0))
