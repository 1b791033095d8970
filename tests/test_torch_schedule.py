"""The port's schedules (``core/async_engine.py``, ``core/devices.py``,
``core/schedule.py``) and the schedule-fed train loop against the
reference.

* ``simulate`` against the schedule digests pinned by the reference's
  ``tests/test_schedule_regression.py`` (copied: they are numpy).
* ``build_schedule`` and ``padded_rows`` equal to the reference's array
  for array, exactly, on those fleets, under every trigger and on every
  ``SCENARIO_PACK`` fleet, dense and streamed.
* ``FederatedRun`` feeds the rows it is given and charges the ledger once
  per delivery, as the reference's does.
* ``train_bafdp(schedule=, round_impl="sparse")`` against the reference's
  at ``input_sigma=0``, from the reference's initial state: per-round
  ``data_loss`` and the final per-client RMSE/MAE within rtol 1e-5, the
  bound of ``test_torch_train.py``.  The state itself is not compared
  there: over 4 full-width MLP_H24 rounds with Adam, a few ulp of matmul
  order can flip an Adam step's direction on a near-zero gradient, which
  moves one weight by up to 2 alpha_w (the round tests hold the state at
  their smaller size).
"""
import dataclasses
import hashlib
import importlib

import jax
import numpy as np
import pytest
import torch
from test_torch_reference import ref_state_arrays, reference  # noqa: F401

from repro_torch import train
from repro_torch.configs import FedConfig
from repro_torch.core import devices, schedule
from repro_torch.core.async_engine import DelayModel, simulate, speedup_at
from repro_torch.core.fed_state import fed_state_from_numpy
from repro_torch.core.privacy import EpsLedger
from repro_torch.tree import tree_leaves


def digest(sim) -> str:
    h = hashlib.sha256()
    h.update(np.round(np.asarray(sim.times, np.float64), 6).tobytes())
    h.update(np.asarray(sim.active, np.uint8).tobytes())
    h.update(np.asarray(sim.staleness, np.int64).tobytes())
    h.update(np.asarray(sim.available, np.uint8).tobytes())
    return h.hexdigest()


def quorum_digest(sim) -> str:
    h = hashlib.sha256()
    h.update(digest(sim).encode())
    h.update(np.asarray(sim.quorum, np.int64).tobytes())
    return h.hexdigest()


# the reference's pinned digests (tests/test_schedule_regression.py)
PR1_CASES = [
    ("async", dict(n_clients=8, hetero=1.0, seed=0), dict(active_frac=0.6),
     "e1384c68ecae81bdd56f11dca59607d67c93f14d485f50266456f864a8466b60"),
    ("sync", dict(n_clients=8, hetero=1.0, seed=0), dict(active_frac=1.0),
     "47e305915d223e30ffc682da09c77f8acc7d7fd9b133a4e36dc8115c967d8059"),
    ("async", dict(n_clients=10, seed=7, dropout_prob=0.3, rejoin_prob=0.2),
     dict(active_frac=0.5),
     "8be6dd9bb856fd16825623c19e23cb24fccf09e3de6069946ac80b3503223562"),
    ("async", dict(n_clients=6, seed=3, tail="pareto", pareto_shape=1.5),
     dict(active_frac=0.5),
     "1c778533682b56c5f0de223709e948a292aee5a30dbf5ad02853f455b2ce8a8e"),
]
NEW_CASES = [
    ("adaptive", dict(n_clients=12, seed=7, dropout_prob=0.4,
                      rejoin_prob=0.1),
     dict(active_frac=0.5, quorum="adaptive", s_min=1, s_max=12),
     "3a79515e0345aecda720ab4ad302559473c8053f140c15d85b4c39e7d02d954f"),
    ("age_aware", dict(n_clients=10, hetero=2.0, jitter=0.05, seed=2),
     dict(active_frac=0.3, select="age_aware"),
     "009aa545d63304a9abefeb6226df80299449d3f47976c0d09f1bd3c1e73e36e0"),
    ("adaptive+age", dict(n_clients=12, hetero=1.5, seed=3, tail="pareto",
                          pareto_shape=1.2),
     dict(active_frac=0.5, quorum="adaptive", s_min=2, s_max=12,
          select="age_aware"),
     "9a9b025911692509b12adbab6b3b7cc1695104bf0b863a367f25dbbd9a10388f"),
]


@pytest.mark.parametrize("mode,dm_kw,sim_kw,want", PR1_CASES,
                         ids=["hetero", "sync", "flap", "pareto"])
def test_pr1_schedules_pinned(mode, dm_kw, sim_kw, want):
    assert digest(simulate(mode, 40, DelayModel(**dm_kw), **sim_kw)) == want


@pytest.mark.parametrize("name,dm_kw,sim_kw,want", NEW_CASES,
                         ids=[c[0] for c in NEW_CASES])
def test_adaptive_schedules_pinned(name, dm_kw, sim_kw, want):
    sim = simulate("async", 60, DelayModel(**dm_kw), **sim_kw)
    assert quorum_digest(sim) == want


def test_simulate_is_pure_and_speedup_reads_the_curves():
    kw = dict(active_frac=0.5, quorum="adaptive", s_min=2,
              select="age_aware")
    dm = dict(n_clients=9, hetero=1.3, seed=11, burst_prob=0.2)
    assert quorum_digest(simulate("async", 50, DelayModel(**dm), **kw)) \
        == quorum_digest(simulate("async", 50, DelayModel(**dm), **kw))
    t = np.arange(4.0)
    assert speedup_at(np.asarray([3, 2, 1, 0.5]), t,
                      np.asarray([3, 0.9, 0.5, 0.1]), t, 1.0) == (2.0, 1.0)


# ---------------------------------------------------------------------------
# build_schedule / padded_rows: array for array against the reference
# ---------------------------------------------------------------------------
def _triggers(mod, frac):
    return {
        "fixed-fastest": mod.QuorumTrigger(active_frac=frac),
        "adaptive-age": mod.QuorumTrigger(
            active_frac=frac, quorum=mod.AdaptiveQuorum(s_min=2),
            selection=mod.AgeAwareSelection()),
        "sync": mod.SyncTrigger(),
        "fedbuff": mod.FedBuffTrigger(buffer_k=3),
    }


def _assert_schedules_equal(got, want, msg):
    for f in ("times", "winner_ids", "winner_ages", "offsets",
              "unavailable_ids", "unavailable_offsets"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{msg}: {f}")
    assert got.n_clients == want.n_clients and got.s_max == want.s_max
    for (a, b) in zip(got.padded_rows(), want.padded_rows()):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype, msg
            np.testing.assert_array_equal(x, y, err_msg=msg)
    for (a, b) in zip(got.rows(), want.rows()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=msg)
    np.testing.assert_array_equal(got.quorum, want.quorum)


FLEETS = [dict(n_clients=8, hetero=1.0, seed=0),
          dict(n_clients=10, seed=7, dropout_prob=0.3, rejoin_prob=0.2),
          dict(n_clients=6, seed=3, tail="pareto", pareto_shape=1.5),
          dict(n_clients=12, hetero=1.5, seed=3, burst_prob=0.2,
               liar_frac=0.25)]


@pytest.mark.parametrize("fleet", range(len(FLEETS)))
def test_build_schedule_equals_reference(reference, fleet):
    ref_sched = reference.schedule
    ref_engine = importlib.import_module("repro.core.async_engine")
    dm = FLEETS[fleet]
    ours, theirs = _triggers(schedule, 0.5), _triggers(ref_sched, 0.5)
    for name in ours:
        for stream in (False, True):
            got = schedule.build_schedule(30, DelayModel(**dm), ours[name],
                                          stream=stream)
            want = ref_sched.build_schedule(30, ref_engine.DelayModel(**dm),
                                            theirs[name], stream=stream)
            _assert_schedules_equal(got, want, f"{dm} {name} {stream}")
    # a duplicate-free schedule survives the dense round trip up to
    # admission order
    quorum = schedule.build_schedule(30, DelayModel(**dm),
                                     ours["adaptive-age"])
    assert schedule.Schedule.from_sim(quorum.to_sim()) == quorum.canonical()


@pytest.mark.parametrize("scenario", sorted(devices.SCENARIO_PACK))
def test_scenario_pack_fleets_equal_reference(reference, scenario):
    ref_sched = reference.schedule
    ref_dev = importlib.import_module("repro.core.devices")
    assert sorted(devices.SCENARIO_PACK) == sorted(ref_dev.SCENARIO_PACK)
    ours, theirs = _triggers(schedule, 0.4), _triggers(ref_sched, 0.4)
    for name in ("adaptive-age", "fedbuff"):
        for stream in (False, True):
            got = schedule.build_schedule(
                40, devices.device_scenario(scenario, 16, seed=1),
                ours[name], stream=stream)
            want = ref_sched.build_schedule(
                40, ref_dev.device_scenario(scenario, 16, seed=1),
                theirs[name], stream=stream)
            _assert_schedules_equal(got, want, f"{scenario} {name}")
    _assert_schedules_equal(got.canonical(), want.canonical(), "canonical")


def test_padded_rows_contract():
    sched = schedule.build_schedule(
        5, DelayModel(n_clients=8, hetero=2.5, seed=3),
        schedule.FedBuffTrigger(buffer_k=5))
    assert sched.s_max == 5
    for r, (idx, stale, weight) in enumerate(sched.padded_rows()):
        k = int(weight.sum())
        assert k == sched.arrivals[r]
        np.testing.assert_array_equal(idx[:k], sched.round_winners(r))
        assert (idx[k:] == 8).all() and (weight[k:] == 0).all()
    idx, _, w = next(iter(sched.padded_rows(9)))
    assert idx.shape == (9,) and int(w.sum()) == sched.arrivals[0]
    with pytest.raises(ValueError, match="s_max"):
        list(sched.padded_rows(2))


# ---------------------------------------------------------------------------
# FederatedRun: the rows it feeds and the ledger
# ---------------------------------------------------------------------------
def test_federated_run_feeds_schedule_rows():
    sched = schedule.build_schedule(4, DelayModel(n_clients=8, seed=0),
                                    schedule.FedBuffTrigger(buffer_k=3))
    seen = []

    def toy(state, batch, gen, **kw):
        seen.append({k: np.asarray(v).copy() for k, v in kw.items()})
        return state, {"loss": torch.tensor(0.0)}

    schedule.FederatedRun(step=toy, rounds=4, schedule=sched,
                          round_impl="sparse", n_clients=8,
                          feed_arrivals=True, device="cpu").run(
        [], lambda t: None, 0)
    for kw, (idx, stale, weight), k in zip(seen, sched.padded_rows(),
                                           sched.arrivals):
        np.testing.assert_array_equal(kw["idx"], idx)
        np.testing.assert_array_equal(kw["stale"], stale)
        np.testing.assert_array_equal(kw["weight"], weight)
        assert int(kw["arrivals"]) == k
    seen.clear()
    schedule.FederatedRun(step=toy, rounds=4, schedule=sched,
                          feed_staleness=False, device="cpu").run(
        [], lambda t: None, 0)
    for kw, (act, _) in zip(seen, sched.rows()):
        assert sorted(kw) == ["act"]
        np.testing.assert_array_equal(kw["act"], act)
    for bad, match in ((dict(round_impl="sparse", schedule=None), "sparse"),
                       (dict(round_impl="csr"), "round_impl"),
                       (dict(rounds=9), "covers 4 rounds"),
                       (dict(n_clients=5), "for 8 clients"),
                       (dict(schedule=None, feed_arrivals=True),
                        "feed_arrivals"),
                       (dict(schedule=None, ledger=EpsLedger(8)), "ledger")):
        kw = {**dict(step=toy, rounds=4, schedule=sched, device="cpu"),
              **bad}
        with pytest.raises(ValueError, match=match):
            schedule.FederatedRun(**kw).run([], None, 0)


def test_federated_run_ledger_matches_reference(reference):
    """One spend per delivery, at the client's eps before the round, as
    the reference's FederatedRun charges it (FedBuff duplicates twice)."""
    ref_sched = reference.schedule
    ref_engine = importlib.import_module("repro.core.async_engine")
    dm = dict(n_clients=6, hetero=2.0, seed=4)
    trig = dict(buffer_k=4)
    sched = schedule.build_schedule(6, DelayModel(**dm),
                                    schedule.FedBuffTrigger(**trig))
    rsched = ref_sched.build_schedule(6, ref_engine.DelayModel(**dm),
                                      ref_sched.FedBuffTrigger(**trig))
    assert int(sched.arrivals.sum()) > int(sched.quorum.sum())   # dups

    class St:
        def __init__(self, eps):
            self.eps = eps

    def step(state, batch, gen, **kw):
        return St(state.eps * 1.25 + 0.5), {}

    out = {}
    for impl in ("dense", "sparse"):
        ours, theirs = EpsLedger(6), reference.privacy.EpsLedger(6)
        _, hist = schedule.FederatedRun(
            step=step, rounds=6, schedule=sched, round_impl=impl,
            ledger=ours, device="cpu").run(St(torch.linspace(1, 2, 6)),
                                           lambda t: None, 0)
        _, rhist = ref_sched.FederatedRun(
            step=step, rounds=6, schedule=rsched, round_impl=impl,
            ledger=theirs, key_fn=lambda t: t).run(
            St(np.linspace(1, 2, 6, dtype=np.float32)), lambda t: None)
        for k in ("spent", "deliveries", "eps_max"):
            np.testing.assert_allclose(getattr(ours, k), getattr(theirs, k),
                                       rtol=1e-6)
        np.testing.assert_allclose(hist["dp_eps_basic"],
                                   rhist["dp_eps_basic"], rtol=1e-6)
        np.testing.assert_allclose(hist["dp_eps_adv"], rhist["dp_eps_adv"],
                                   rtol=1e-6)
        out[impl] = int(ours.deliveries.sum())
    assert out["sparse"] == int(sched.arrivals.sum())
    assert out["dense"] == int(sched.quorum.sum())


# ---------------------------------------------------------------------------
# train_bafdp on a schedule against the reference
# ---------------------------------------------------------------------------
C, ROUNDS, SEED = 6, 4, 0
TRAIN_CASES = {
    "quorum-sparse-poly": (dict(staleness_decay="poly"), "quorum",
                           "sparse"),
    "fedbuff-sparse-int8-lrnorm": (dict(staleness_decay="poly",
                                        sign_message="int8",
                                        fedbuff_lr_norm=True),
                                   "fedbuff", "sparse"),
    "quorum-dense-rows": (dict(staleness_decay="hinge"), "quorum", "dense"),
}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_bafdp_on_a_schedule_matches_reference(reference, name):
    r = reference
    knobs, server, impl = TRAIN_CASES[name]
    ref_engine = importlib.import_module("repro.core.async_engine")
    rfed = r.configs.FedConfig(n_clients=C, **knobs)
    rtrig = {"quorum": r.schedule.QuorumTrigger(
        active_frac=0.5, quorum=r.schedule.AdaptiveQuorum(s_min=2),
        selection=r.schedule.AgeAwareSelection()),
        "fedbuff": r.schedule.FedBuffTrigger(buffer_k=4)}[server]
    rsched = r.schedule.build_schedule(
        ROUNDS, ref_engine.DelayModel(n_clients=C, hetero=1.0, seed=0),
        rtrig)
    sched = schedule.build_schedule(
        ROUNDS, DelayModel(n_clients=C, hetero=1.0, seed=0),
        train.make_trigger(server, 0.5))
    _assert_schedules_equal(sched, rsched, name)
    scope = "active" if impl == "sparse" else "all"
    init = r.fed_state.init_fed_state(
        jax.random.PRNGKey(SEED),
        lambda k: r.forecasting.init_forecaster(
            k, r.common.forecast_cfg("mlp", 24)),
        dataclasses.replace(rfed, omega_optimizer="adam", dro_weight=0.01,
                            consensus_scope=scope))
    collect = ("data_loss", "n_active")
    rledger = r.privacy.EpsLedger(C)
    rstate, rcfg, rhist = r.common.train_bafdp(
        "milano", 24, rfed, rounds=ROUNDS, seed=SEED, input_sigma=0.0,
        schedule=rsched, round_impl=impl, collect=collect, ledger=rledger)
    _, rtest, rscalers = r.common.problem("milano", 24, C, SEED)
    rmse_ref = r.common.eval_fed_state(rstate, rcfg, rtest, rscalers)

    ledger = EpsLedger(C)
    state, cfg, hist = train.train_bafdp(
        "milano", 24, FedConfig(n_clients=C, **knobs), rounds=ROUNDS,
        seed=SEED, input_sigma=0.0, schedule=sched, round_impl=impl,
        collect=collect, ledger=ledger,
        state=fed_state_from_numpy(ref_state_arrays(init), device="cpu"),
        device="cpu")
    _, test, scalers = train.problem("milano", 24, C, SEED)
    rmse = train.eval_fed_state(state, cfg, test, scalers)

    assert hist["n_active"] == rhist["n_active"]
    np.testing.assert_allclose(hist["data_loss"], rhist["data_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(rmse, rmse_ref, rtol=1e-5)
    np.testing.assert_array_equal(ledger.deliveries, rledger.deliveries)
    np.testing.assert_allclose(hist["dp_eps_basic"], rhist["dp_eps_basic"],
                               rtol=1e-6)
    assert int(state.t) == ROUNDS


def test_train_bafdp_sparse_equals_dense_active_rows_bitwise():
    """train_bafdp(round_impl="sparse") on a schedule equals the dense
    active-scope round fed the same deliveries as (C,) rows (admission
    ages scattered into the staleness row), bit for bit, LDP noise on."""
    sched = schedule.build_schedule(
        3, DelayModel(n_clients=8, hetero=1.5, seed=2),
        schedule.QuorumTrigger(active_frac=0.5))
    fed = FedConfig(n_clients=8, active_frac=0.5, staleness_decay="poly")
    sparse, _, _ = train.train_bafdp("milano", 1, fed, 3, schedule=sched,
                                     round_impl="sparse", device="cpu")
    acts = np.zeros((3, 8), bool)
    stales = np.zeros((3, 8), np.float32)
    for r, (idx, stale, weight) in enumerate(sched.padded_rows()):
        k = int(weight.sum())
        acts[r, idx[:k]] = True
        stales[r, idx[:k]] = stale[:k]
    dense, _, _ = train.train_bafdp(
        "milano", 1, dataclasses.replace(fed, consensus_scope="active"), 3,
        active_masks=acts, staleness=stales, device="cpu")
    for f, a, b in zip(dense._fields, dense, sparse):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y), f


def test_train_bafdp_sparse_int8_wire_equals_f32_wire():
    """On a schedule, the int8 sign wire (B3's weighted fold) gives the f32
    wire's (B2's) z bit for bit: the wire loses nothing and the two folds
    add the same products in the same row order."""
    sched = schedule.build_schedule(
        4, DelayModel(n_clients=8, hetero=1.0, seed=0),
        train.make_trigger("quorum", 0.6))
    z = {}
    for wire in ("f32", "int8"):
        fed = FedConfig(n_clients=8, staleness_decay="poly",
                        sign_message=wire)
        state, _, _ = train.train_bafdp("milano", 1, fed, 4, schedule=sched,
                                        round_impl="sparse", device="cpu")
        z[wire] = tree_leaves(state.z)
    for a, b in zip(z["f32"], z["int8"]):
        assert torch.equal(a, b)


def test_main_trains_on_each_server_on_the_cpu(capsys):
    """``python -m repro_torch.train --server ... --device cpu``, tiny, on
    both round paths."""
    for server, impl in (("fedbuff", "sparse"), ("sync", "dense")):
        train.main(["--rounds", "3", "--clients", "4", "--server", server,
                    "--round-impl", impl, "--device", "cpu"])
        out = capsys.readouterr().out
        assert f"server={server}, round={impl}" in out
        assert "schedule: 3 rounds" in out and "per-client models" in out
