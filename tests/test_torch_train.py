"""The whole slice: the port's ``train_bafdp`` against the reference's
``benchmarks.common.train_bafdp`` — the MLP_H24 forecaster on synthetic
Milano traffic, 4 dense BAFDP rounds with the same explicit activity rows,
the same batches (one numpy RandomState), ``input_sigma=0`` and the same
starting state (the reference's init, carried over).

Tolerance: per-round ``data_loss`` rtol 1e-5; the final per-client RMSE
and MAE (raw traffic units, ~10^2) rtol 1e-5.  The weights drift apart by
a few f32 ulp per round (matmul and reduction order; see
test_torch_round.py) and the losses and errors inherit it: the largest
relative difference seen here is 6e-7."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_reference import ref_state_arrays, reference  # noqa: F401

from repro_torch import train
from repro_torch.configs import FedConfig
from repro_torch.core.async_engine import DelayModel
from repro_torch.core.schedule import SyncTrigger, build_schedule
from repro_torch.core.fed_state import fed_state_from_numpy

C, ROUNDS, SEED = 4, 4, 0
KNOBS = {
    "constant-f32": dict(),
    "poly-int8-byz": dict(staleness_decay="poly", sign_message="int8",
                          attack="scaled", byzantine_frac=0.25),
}


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_train_bafdp_matches_reference(reference, name):
    r = reference
    knobs = KNOBS[name]
    rng = np.random.RandomState(7)
    rows = rng.rand(ROUNDS, C) < 0.6
    rows[:, 1] = True
    rfed = r.configs.FedConfig(n_clients=C, **knobs)
    # the reference's train_bafdp starts from init_fed_state(PRNGKey(seed))
    # under its own optimizer / dro_weight override
    init = r.fed_state.init_fed_state(
        jax.random.PRNGKey(SEED),
        lambda k: r.forecasting.init_forecaster(
            k, r.common.forecast_cfg("mlp", 24)),
        dataclasses.replace(rfed, omega_optimizer="adam", dro_weight=0.01))
    rstate, rcfg, rhist = r.common.train_bafdp(
        "milano", 24, rfed, rounds=ROUNDS, seed=SEED, input_sigma=0.0,
        active_masks=rows, collect=("data_loss", "n_active"))
    _, rtest, rscalers = r.common.problem("milano", 24, C, SEED)
    rmse_ref = r.common.eval_fed_state(rstate, rcfg, rtest, rscalers)

    state, cfg, hist = train.train_bafdp(
        "milano", 24, FedConfig(n_clients=C, **knobs), rounds=ROUNDS,
        seed=SEED, input_sigma=0.0, active_masks=rows,
        collect=("data_loss", "n_active"),
        state=fed_state_from_numpy(ref_state_arrays(init), device="cpu"),
        device="cpu")
    _, test, scalers = train.problem("milano", 24, C, SEED)
    rmse = train.eval_fed_state(state, cfg, test, scalers)

    assert hist["n_active"] == rhist["n_active"]
    np.testing.assert_allclose(hist["data_loss"], rhist["data_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(rmse, rmse_ref, rtol=1e-5)
    assert int(state.t) == ROUNDS


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train_bafdp("milano", 1, FedConfig(n_clients=2), rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--rounds", "1", "--clients", "2"])


@pytest.mark.parametrize("kwargs,match", [
    (dict(schedule=build_schedule(1, DelayModel(n_clients=3),
                                  SyncTrigger())),
     "Schedule is for 3 clients"),
    (dict(round_impl="sparse"), "needs a schedule"),
    (dict(round_impl="bogus"), "unknown round_impl"),
    (dict(fed=FedConfig(n_clients=2, consensus_streaming=True)),
     "streams the active-scope left-fold"),
    (dict(fed=FedConfig(n_clients=2, robust_consensus="median")),
     "not yet ported"),
])
def test_unported_train_options_raise(kwargs, match):
    kwargs = {"fed": FedConfig(n_clients=2), **kwargs}
    with pytest.raises(ValueError, match=match):
        train.train_bafdp("milano", 1, rounds=1, device="cpu", **kwargs)


def test_main_runs_on_the_cpu(capsys):
    """``python -m repro_torch.train --device cpu`` end to end, tiny."""
    train.main(["--rounds", "3", "--clients", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "BAFDP on cpu" in out and "consensus-model test RMSE" in out
