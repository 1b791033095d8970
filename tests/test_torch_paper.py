"""The paper's evaluation scripts on the port (``repro_torch.bench``)
against the reference's (``benchmarks/*.py``).

Training parity: each script's configuration trains in both packages from
the reference's initial state (carried over, as in test_torch_train.py),
4 rounds at ``input_sigma=0`` with explicit rows (numpy activity rows, or
the event-driven schedule both packages build with the same numpy code),
so no ``jax.random`` draw enters the comparison.  Tolerance rtol 1e-5 on
every history and on RMSE/MAE, as test_torch_train.py: the weights drift
apart by a few f32 ulp a round (matmul and reduction order).

Arithmetic: each script's rows from the same stand-in histories
(``StandInTraining``) in both packages, equal as strings but for the
timing column.

Schedules: ``fig456.main(rounds=6, quick=True, with_meta=True)``'s
schedules, row statistics and ``n_active`` equal to the reference's
exactly."""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
from test_torch_reference import (StandInTraining, one_thread,
                                  ref_state_arrays)
from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch import train
from repro_torch.bench import (fig3_privacy_level, fig456_async_efficiency,
                               table23_privacy_budget, theorem1_convergence)
from repro_torch.core.async_engine import DelayModel
from repro_torch.core.fed_state import fed_state_from_numpy
from repro_torch.core.schedule import QuorumTrigger, build_schedule

ROUNDS, SEED, RTOL = 4, 0, 1e-5


def _rows(n_clients, frac=0.6):
    rows = np.random.RandomState(7).rand(ROUNDS, n_clients) < frac
    rows[:, 1] = True
    return rows


def train_both(r, dataset, horizon, fed, ref_fed, *, collect,
               optimizer="adam", rows=None, schedules=(None, None)):
    """``(reference (state, cfg, hist), port (state, cfg, hist))`` of the
    same configuration from the reference's initial state."""
    assert dataclasses.asdict(fed) == dataclasses.asdict(ref_fed)
    init = r.fed_state.init_fed_state(
        jax.random.PRNGKey(SEED),
        lambda k: r.forecasting.init_forecaster(
            k, r.common.forecast_cfg("mlp", horizon)),
        dataclasses.replace(ref_fed, omega_optimizer=optimizer,
                            dro_weight=0.01))
    want = r.common.train_bafdp(
        dataset, horizon, ref_fed, rounds=ROUNDS, seed=SEED,
        input_sigma=0.0, active_masks=rows, schedule=schedules[0],
        collect=collect, optimizer=optimizer)
    with one_thread():
        got = train.train_bafdp(
            dataset, horizon, fed, rounds=ROUNDS, seed=SEED,
            input_sigma=0.0, active_masks=rows, schedule=schedules[1],
            collect=collect, optimizer=optimizer,
            state=fed_state_from_numpy(ref_state_arrays(init), device="cpu"),
            device="cpu")
    return want, got


@pytest.mark.parametrize("dataset,a", [("milano", 10), ("trento", 0.1)])
def test_table23_config_matches_reference(reference, dataset, a):
    """Tables II/III's configuration at Milano's a=10 and at Trento's
    smallest budget a=0.1 (``eps_min`` 0.001): the losses and the
    consensus model's RMSE/MAE, finite in both packages."""
    r = reference
    fed = table23_privacy_budget.budget_config(a)
    ref_fed = r.configs.FedConfig(privacy_budget_a=float(a),
                                  eps_min=min(0.01, a / 100))
    (rs, rcfg, rh), (s, cfg, h) = train_both(
        r, dataset, 1, fed, ref_fed, collect=("data_loss",),
        rows=_rows(fed.n_clients))
    _, rtest, rscalers = r.common.problem(dataset, 1, fed.n_clients)
    _, test, scalers = train.problem(dataset, 1, fed.n_clients)
    want = r.common.eval_rmse_mae(rs.z, rcfg, rtest, rscalers)
    got = train.eval_rmse_mae(s.z, cfg, test, scalers)
    np.testing.assert_allclose(h["data_loss"], rh["data_loss"], rtol=RTOL)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.isfinite(got).all() and np.isfinite(want).all()


def test_fig3_config_matches_reference(reference):
    """Fig. 3's configuration: the (rounds, C) history of eps."""
    r = reference
    fed = dataclasses.replace(train.FedConfig(),
                              **fig3_privacy_level.FIG3_KNOBS)
    ref_fed = r.configs.FedConfig(alpha_eps=5e-2, eps_init_frac=0.02)
    (_, _, rh), (_, _, h) = train_both(
        r, "milano", 1, fed, ref_fed, collect=("eps_all", "data_loss"),
        rows=_rows(fed.n_clients))
    got, want = np.stack(h["eps_all"]), np.stack(rh["eps_all"])
    assert got.shape == (ROUNDS, fed.n_clients)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(h["data_loss"], rh["data_loss"], rtol=RTOL)
    assert not np.allclose(got[-1], got[0])          # eps moves


def test_theorem1_config_matches_reference(reference):
    """Theorem 1's configuration (SGD, C=6, every client active): the
    squared consensus gap, round by round."""
    r = reference
    fed = train.FedConfig(**theorem1_convergence.THEOREM1_KNOBS)
    ref_fed = r.configs.FedConfig(n_clients=6, active_frac=1.0,
                                  alpha_w=5e-3, psi=5e-2, alpha_z=1e-1,
                                  alpha_phi=1e-2)
    (_, _, rh), (_, _, h) = train_both(
        r, "milano", 1, fed, ref_fed, optimizer="sgd",
        collect=("consensus_gap", "data_loss"),
        rows=np.ones((ROUNDS, fed.n_clients), bool))
    np.testing.assert_allclose(h["consensus_gap"], rh["consensus_gap"],
                               rtol=RTOL)
    np.testing.assert_allclose(h["data_loss"], rh["data_loss"], rtol=RTOL)
    assert min(h["consensus_gap"]) > 0


@pytest.mark.parametrize("name", ["headline", "fedbuff"])
def test_fig456_config_matches_reference(reference, name):
    """Figs. 4-6: the headline asynchronous run (S of M on the quorum
    schedule) and the ``fedbuff`` scenario (K=5 arrivals, poly decay,
    ``fedbuff_lr_norm`` fed the schedule's arrivals, the int8 sign wire),
    each on its own schedule: losses at rtol 1e-5, ``n_active`` exactly."""
    r = reference
    ref_mod = importlib.import_module("benchmarks.fig456_async_efficiency")
    f = fig456_async_efficiency
    n = 8
    if name == "headline":
        fed = train.FedConfig(n_clients=n, active_frac=f.ACTIVE_FRAC)
        ref_fed = r.configs.FedConfig(n_clients=n,
                                      active_frac=ref_mod.ACTIVE_FRAC)
        scheds = (r.schedule.build_schedule(
            ROUNDS, ref_mod.DelayModel(n_clients=n, hetero=1.0, seed=0),
            r.schedule.QuorumTrigger(active_frac=ref_mod.ACTIVE_FRAC)),
                  build_schedule(ROUNDS, DelayModel(n_clients=n, hetero=1.0,
                                                    seed=0),
                                 QuorumTrigger(active_frac=f.ACTIVE_FRAC)))
    else:
        fed = f.scenario_config(name, n)
        ref_fed = dataclasses.replace(
            r.configs.FedConfig(n_clients=n, active_frac=ref_mod.ACTIVE_FRAC),
            **ref_mod.SCENARIOS[name][2])
        scheds = (r.schedule.build_schedule(
            ROUNDS, ref_mod.scenario_model(name, n, 0),
            ref_mod.SCENARIOS[name][1]()),
                  build_schedule(ROUNDS, f.scenario_model(name, n, 0),
                                 f.SCENARIOS[name][1]()))
        assert (scheds[1].arrivals > scheds[1].quorum).any()  # K > distinct
    np.testing.assert_array_equal(scheds[1].winner_ids, scheds[0].winner_ids)
    (_, _, rh), (_, _, h) = train_both(
        r, "milano", 1, fed, ref_fed, collect=("data_loss", "n_active"),
        schedules=scheds)
    assert h["n_active"] == rh["n_active"]
    np.testing.assert_allclose(h["data_loss"], rh["data_loss"], rtol=RTOL)


# ---------------------------------------------------------------------------
# the scripts' arithmetic on the same histories
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [
    "table23_privacy_budget", "fig3_privacy_level",
    "fig456_async_efficiency", "fig7_distributiveness",
    "theorem1_convergence"])
def test_rows_match_reference_on_the_same_histories(reference, name,
                                                     monkeypatch, capsys):
    """Every row, timing column aside, equal as a string to the
    reference's, both scripts fed :class:`StandInTraining`'s histories:
    the eps statistics, the Y-ladder and its slope, the time-to-target and
    speedup, the schedule statistics.  Fig. 7 has no training and no
    timing: its rows are equal whole."""
    ref_mod = importlib.import_module(f"benchmarks.{name}")
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    StandInTraining().install(ref_mod, monkeypatch)
    StandInTraining().install(mod, monkeypatch)
    for rounds, quick in ((6, True), (30, False)):
        want = ref_mod.main(rounds=rounds, quick=quick)
        got = mod.main(rounds=rounds, quick=quick, device="cpu")
        assert capsys.readouterr().out.splitlines() == got
        if name == "fig7_distributiveness":
            assert got == want
        drop_us = [(row.split(",")[0], row.split(",")[2]) for row in got]
        assert drop_us == [(row.split(",")[0], row.split(",")[2])
                           for row in want]


def test_theorem1_slope_recovers_a_known_order():
    """A gap that decays as c / t crosses Y at t ~ c / Y: slope 1."""
    gap = 50.0 / np.arange(1, 2001)
    slope, ts = theorem1_convergence.ladder_slope(gap, 2000)
    assert ts == [41, 83, 167, 335]
    assert abs(slope - 1.0) < 0.02      # integer rounds: 1.01


# ---------------------------------------------------------------------------
# fig456's schedules, exactly, and its oracle
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fig456_quick():
    """The port's ``main(rounds=6, quick=True, with_meta=True)``, trained."""
    with one_thread():
        return fig456_async_efficiency.main(rounds=6, quick=True,
                                            with_meta=True, device="cpu")


def test_fig456_schedules_match_reference_exactly(reference, fig456_quick,
                                                   monkeypatch):
    """Every schedule of the quick grid (masks, staleness, quorums,
    arrivals), the rows' schedule statistics and the ``n_active`` the
    port's trainer saw, equal to the reference's.  The reference's
    training is a stand-in here (its ten runs take ~45 s), so its
    ``n_active`` is its schedule's mask row sums, which its own oracle
    (``test_fig456_trains_on_simulator_masks``) holds equal to what its
    trainer reports; the real rounds' ``n_active`` are compared in
    :func:`test_fig456_config_matches_reference`."""
    ref_mod = importlib.import_module("benchmarks.fig456_async_efficiency")
    StandInTraining().install(ref_mod, monkeypatch)
    want_rows, want = ref_mod.main(rounds=6, quick=True, with_meta=True)
    rows, got = fig456_quick

    def schedule_stats(row):
        name, _, derived = row.split(",")
        return name, [kv for kv in derived.split(";")
                      if not kv.startswith(("final_loss", "speedup",
                                            "t_async", "t_sync"))]

    assert [schedule_stats(x) for x in rows] == \
        [schedule_stats(x) for x in want_rows]
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert sorted(g) == sorted(w)
    for key in g:
        if key == "variants":
            assert sorted(g[key]) == sorted(w[key])
            for name in g[key]:
                for k, v in g[key][name].items():
                    np.testing.assert_array_equal(
                        v, w[key][name][k], err_msg=f"{name}/{k}")
        else:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_fig456_trains_on_simulator_masks(fig456_quick):
    """The reference's ``tests/test_benchmark_smoke.py`` oracle on the
    port: the per-round ``n_active`` the trainer observed equals the
    simulator masks' row sums, for the headline runs and every scenario."""
    rows, metas = fig456_quick
    f = fig456_async_efficiency
    assert rows and len(metas) == 1
    for row in rows:
        parts = row.split(",", 2)
        assert len(parts) == 3 and parts[0].startswith("fig456/")
        float(parts[1])
    meta = metas[0]
    masks_a, masks_s = meta["masks_async"], meta["masks_sync"]
    # sync trained on active_frac=1.0 masks, async on S-of-M masks
    assert masks_s.all()
    C = masks_a.shape[1]
    s = max(1, int(round(C * meta["active_frac"])))
    assert (masks_a.sum(1) == s).all() and s < C
    np.testing.assert_array_equal(meta["n_active_async"], masks_a.sum(1))
    np.testing.assert_array_equal(meta["n_active_sync"], masks_s.sum(1))
    assert (meta["staleness_async"][masks_a] == 0).all()
    # scenario variants trained on their own schedules, same consistency
    assert set(meta["variants"]) == set(f.SCENARIOS)
    for name, v in meta["variants"].items():
        np.testing.assert_array_equal(v["n_active"], v["masks"].sum(1),
                                      err_msg=name)
        np.testing.assert_array_equal(v["quorum"], v["masks"].sum(1),
                                      err_msg=name)
        assert (v["staleness"][v["masks"]] == 0).all(), name
