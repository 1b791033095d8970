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
from test_torch_reference import (StandInTraining, one_thread,
                                  ref_state_arrays)
from test_torch_reference import reference  # noqa: F401  (fixture)

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
    # ``geomed`` is an aggregator, not a consensus rule
    pytest.param(dict(fed=FedConfig(n_clients=2, robust_consensus="geomed")),
                 "unknown robust_consensus", id="geomed-unknown-rule"),
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


# ---------------------------------------------------------------------------
# the table / figure entry points and the showdown, on the CPU
# ---------------------------------------------------------------------------
BENCH = ["table1_prediction", "table4_byzantine", "fig8_robust_convergence",
         "table23_privacy_budget", "fig3_privacy_level",
         "fig456_async_efficiency", "fig7_distributiveness",
         "theorem1_convergence"]


def _reference_labels(name, monkeypatch):
    """The row labels of the reference's ``benchmarks/<name>.py`` with
    ``quick=True``: its training and evaluation calls replaced by
    stand-ins (``run_method``; ``train_bafdp`` and ``eval_rmse_mae`` by
    :class:`StandInTraining`, whose histories hold every metric the
    scripts collect), so only the table's layout runs."""
    import importlib

    mod = importlib.import_module(f"benchmarks.{name}")
    if hasattr(mod, "run_method"):
        monkeypatch.setattr(mod, "run_method", lambda *a, **k: (1.0, 1.0))
    StandInTraining().install(mod, monkeypatch)
    return [row.split(",")[0] for row in mod.main(rounds=2, quick=True)]


def row_values(derived: str) -> list:
    """The numbers of a row's ``k=v;...`` part (``T_at_ladder=2/2/2/2``
    gives four)."""
    return [float(x) for kv in derived.split(";")
            for x in kv.split("=")[1].split("/")]


@pytest.mark.parametrize("name", BENCH)
def test_bench_entry_point_prints_the_reference_rows(reference, name,
                                                     capsys, monkeypatch):
    """``main(rounds=2, quick=True, device="cpu")`` prints the reference's
    row labels in its order, each with finite values."""
    import importlib

    want = _reference_labels(name, monkeypatch)
    capsys.readouterr()
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    with one_thread():
        rows = mod.main(rounds=2, quick=True, device="cpu")
    assert capsys.readouterr().out.splitlines() == rows
    assert [row.split(",")[0] for row in rows] == want
    for row in rows:
        _, us, derived = row.split(",")
        assert np.isfinite([float(us)] + row_values(derived)).all(), row


def _load_chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PAPER_SUITES = {"table23": "table23_privacy_budget",
                "fig3": "fig3_privacy_level",
                "fig456": "fig456_async_efficiency",
                "fig7": "fig7_distributiveness",
                "theorem1": "theorem1_convergence",
                "fig8": "fig8_robust_convergence"}


@pytest.mark.parametrize("suite", sorted(PAPER_SUITES))
def test_chip_smoke_holds_the_reference_labels(reference, suite,
                                               monkeypatch):
    """``chip_smoke.py``'s ``paper_runs`` holds each suite's quick rows to
    ``PAPER_LABELS``, the reference's labels; and its ``RecordedRuns``
    sees every run the suite trains, each of ``PAPER_ROUNDS`` rounds and
    with a consensus kernel (wire and decay) to count."""
    import importlib

    smoke = _load_chip_smoke()
    name = PAPER_SUITES[suite]
    assert smoke.PAPER_LABELS[suite] == _reference_labels(name, monkeypatch)
    stand_in = StandInTraining()
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    stand_in.install(mod, monkeypatch)
    with smoke.RecordedRuns(mod) as recorded:
        mod.main(rounds=smoke.PAPER_ROUNDS, quick=True, device="cpu")
    assert [fed for fed, _ in recorded.runs] == stand_in.feds
    assert [r for _, r in recorded.runs] == [smoke.PAPER_ROUNDS] * len(
        stand_in.feds)
    want, by_spec = smoke.expected_launches(smoke.kernel_specs(),
                                            recorded.runs)
    assert sum(want.values()) == sum(by_spec.values()) == (
        smoke.PAPER_ROUNDS * len(stand_in.feds))


def test_bench_cli_takes_rounds_quick_device():
    from repro_torch.bench import cli

    seen = {}
    assert cli(lambda **kw: seen.update(kw) or ["row"], "doc",
               ["--rounds", "3", "--quick", "--device", "cpu"]) == ["row"]
    assert seen == dict(rounds=3, quick=True, device="cpu")
    cli(lambda **kw: seen.update(kw) or [], "doc", [])
    assert seen == dict(rounds=train.ROUNDS, quick=False, device=None)


def test_byzantine_showdown_prints_the_full_grid(capsys):
    """``--rounds 2 --device cpu``: every defence x attack cell holds a
    number (or DIVERGED), none an ERROR."""
    from repro_torch import byzantine_showdown as bs

    with one_thread():
        bs.main(["--rounds", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["defense"] + bs.ATTACKS
    n = len(bs.ATTACKS)
    for d, line in zip(bs.DEFENSES, lines[1:1 + len(bs.DEFENSES)]):
        # fixed-width cells (a large RMSE may fill its cell)
        cells = [line[14 + 12 * i:14 + 12 * (i + 1)].strip()
                 for i in range(n)]
        assert line[:14].strip() == d and len(line) == 14 + 12 * n, line
        for c in cells:
            assert c == "DIVERGED" or np.isfinite(float(c)), line


def test_bench_run_prints_rows_refuses_unported_and_fails_on_error(
        monkeypatch, capsys):
    """``python -m repro_torch.bench.run``: the CSV header, then the rows
    of the ``--only`` suites in order; ``kernels`` and ``roofline``
    refused by argparse; a suite that raises gives one ERROR row, the
    others still run, and the exit code is 1.  The claim summary and each
    suite's seconds go to stderr."""
    from repro_torch.bench import run

    assert list(run.SUITES) == ["table1", "table23", "fig3", "fig456",
                                "table4", "fig7", "fig8", "theorem1"]
    seen = []

    def suite(name):
        def main(rounds, quick, device):
            seen.append((name, rounds, quick, device))
            row = f"stand-in-{name},1.0,x=1"
            print(row)
            return [row]
        return main

    def broken(rounds, quick, device):
        raise RuntimeError("boom")

    monkeypatch.setattr(run, "SUITES", {**{k: suite(k) for k in run.SUITES},
                                        "fig3": broken})
    assert run.main(["--only", "fig7,table23", "--rounds", "3", "--quick",
                     "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines() == ["name,us_per_call,derived",
                                "stand-in-fig7,1.0,x=1",
                                "stand-in-table23,1.0,x=1"]
    assert seen == [("fig7", 3, True, "cpu"), ("table23", 3, True, "cpu")]
    assert "# fig7 done in" in err and "Paper-claims" in err

    seen.clear()
    assert run.main(["--device", "cpu", "--rounds", "2"]) == 1
    out, err = capsys.readouterr()
    assert out.splitlines()[0] == "name,us_per_call,derived"
    assert "fig3/ERROR,0.0,failed" in out.splitlines()
    assert [s[0] for s in seen] == [k for k in run.SUITES if k != "fig3"]
    assert "RuntimeError: boom" in err

    for name in ("kernels", "roofline", "fig7,roofline"):
        with pytest.raises(SystemExit) as exc:
            run.main(["--only", name, "--device", "cpu"])
        assert exc.value.code == 2
        assert "not yet ported (ROADMAP Queue A item 8)" in \
            capsys.readouterr().err
    with pytest.raises(SystemExit):
        run.main(["--only", "table9", "--device", "cpu"])
    assert "unknown suite 'table9'" in capsys.readouterr().err


def test_bench_run_needs_a_gpu_unless_told_the_cpu(capsys):
    """Without ``--device`` the runner runs on the GPU: without one it
    stops before any suite; ``--device cpu`` runs Fig. 7 for real."""
    from repro_torch.bench import run

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.main(["--only", "fig7"])
        assert capsys.readouterr().out == ""
    assert run.main(["--only", "fig7", "--device", "cpu"]) == 0
    rows = capsys.readouterr().out.splitlines()
    assert rows[0] == "name,us_per_call,derived" and len(rows) == 6
    assert rows[1] == ("fig7/ratio0.2,0.0,transfer_gb=68750;"
                       "sign_compressed_gb=42969;participants=8")
