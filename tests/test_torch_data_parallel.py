"""The dense BAFDP round with its clients split over 2 and 4 gloo ranks on
the CPU (``distributed.data_parallel``), held to the one-rank round and
to the reference's.

One spawn per world (``dp_ranks.run_ranks``: 2 and 4 processes, a
``FileStore`` under ``tmp_path``, torch on one thread, no JAX in a rank)
runs every case; the one-rank rounds and the reference's run here.  C =
8 clients, 3 rounds, explicit ``act``/``stale`` rows, but for the
internal sampler's case (its draws over C on every rank).

Tolerances, stated before the first run.  Against one rank: the split
round sums the dual mean, the metrics and the consensus gap per rank and
then over ranks, where one rank sums them in one reduction, so they
differ by regrouped f32 roundings: a state element within rtol 1e-6 +
atol 1e-7 of one rank's (the round moves W by alpha_w ~ 1e-2, so a
flipped sign tie would show as ~1e-4), the metrics within rtol 1e-5.  The
Eq. (20) sums themselves are exact: from one state, the all-reduced sign
counts equal one rank's bit for bit (f32 and int32).  Against the
reference (B1 unweighted; B3 weighted with ``alie``'s moments): its own
tolerance for this round (``test_torch_round``: rtol 2e-5, atol 1e-6),
at ``input_sigma`` = 0 and without ``gaussian``, whose draws the two
frameworks cannot share (trap L); the other cases' one-rank rounds are
held to the reference by ``test_torch_round``'s grid.
"""
import numpy as np
import pytest
import torch
from dp_ranks import run_forecaster, run_ranks, sign_counts
from test_torch_reference import (  # noqa: F401  (fixture)
    assert_states_close, flat_items, reference)

from repro_torch.configs import FedConfig, ForecastConfig
from repro_torch.core.fed_state import (fed_state_from_numpy, init_fed_state,
                                        shard_clients, unshard_clients)
from repro_torch.distributed.data_parallel import Axis, RankBlock
from repro_torch.models.forecasting import init_forecaster

C, B, ROUNDS = 8, 4, 3
HIDDEN, HORIZON = (16, 8), 2
CFG = ForecastConfig(hidden=HIDDEN, horizon=HORIZON)
RTOL, ATOL = 1e-6, 1e-7            # against one rank
M_RTOL = 1e-5
REF_RTOL, REF_ATOL = 2e-5, 1e-6    # against the reference
WORLDS = (2, 4)

# name -> (knobs, input sigma, held to the reference)
CASES = {
    "f32-constant-sign_flip": (dict(attack="sign_flip", byzantine_frac=0.25),
                               0.0, True),
    "f32-poly-adam": (dict(staleness_decay="poly", omega_optimizer="adam"),
                      0.0, False),
    "int8-hinge-alie": (dict(sign_message="int8", staleness_decay="hinge",
                             staleness_hinge_b=0.0, attack="alie",
                             byzantine_frac=0.25, attack_scale=3.0),
                        0.0, True),
    "int8-dualint8-constant": (dict(sign_message="int8",
                                    dual_message="int8"), 0.0, False),
    "f32-hinge-gaussian-noise": (dict(staleness_decay="hinge",
                                      attack="gaussian", byzantine_frac=0.25,
                                      attack_scale=0.5), 0.05, False),
    "f32-taylor": (dict(staleness_decay="poly",
                        staleness_compensation="taylor",
                        omega_optimizer="adam"), 0.02, False),
    "internal-sampler-age_aware": (dict(internal_select="age_aware",
                                        active_frac=0.5), 0.02, False),
}


def _case(name: str, seed: int) -> dict:
    knobs, sigma, _ = CASES[name]
    rng = np.random.RandomState(seed)
    act = rng.rand(ROUNDS, C) < 0.6
    act[:, 0] = True
    stale = rng.randint(0, 4, size=(ROUNDS, C)).astype(np.float32)
    stale[act] = 0.0
    batches = [(rng.rand(C, B, CFG.d_x).astype(np.float32),
                rng.rand(C, B, CFG.d_y).astype(np.float32))
               for _ in range(ROUNDS)]
    if name.startswith("internal"):
        rows = [{} for _ in range(ROUNDS)]
    else:
        rows = [{"act": act[t], "stale": None if t == 0 else stale[t]}
                for t in range(ROUNDS)]
    fed = FedConfig(n_clients=C, **knobs)
    init = init_fed_state(torch.Generator().manual_seed(seed),
                          lambda g: init_forecaster(g, CFG), fed,
                          device="cpu")
    from dp_ranks import state_arrays
    return dict(knobs=knobs, sigma=sigma, C=C, hidden=HIDDEN,
                horizon=HORIZON, batches=batches, rows=rows,
                init=state_arrays(init))


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name, 10 + i) for i, name in enumerate(CASES)}


@pytest.fixture(scope="module")
def one_rank(cases):
    return {name: run_forecaster(case) for name, case in cases.items()}


def _count_state(case):
    """(z leaves, W leaves) of the case's initial state, copies, as numpy:
    the sign sums' input."""
    st = case["init"]
    zs = [np.array(v).reshape(-1) for _, v in flat_items(st["z"])]
    Ws = [np.array(v).reshape(C, -1) for _, v in flat_items(st["W"])]
    # a coordinate where every client ties z, and a NaN row entry
    Ws[0][:, 1] = zs[0][1]
    Ws[1][3, 2] = np.nan
    zs[2][0] = -0.0
    Ws[2][:, 0] = 0.0
    return zs, Ws


@pytest.fixture(scope="module")
def ranks_runs(cases, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dense")
    payload = {"cases": cases, "sparse": False,
               "counts": _count_state(cases["f32-constant-sign_flip"])}
    return {R: run_ranks((R, 1), "dp_ranks:forecaster_job", payload, tmp)
            for R in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_round_over_ranks_matches_one_rank(ranks_runs, one_rank,
                                                 world, name):
    want_states, want_metrics, _ = one_rank[name]
    for r, out in enumerate(ranks_runs[world]):
        states, metrics, calls = out[name]
        for t in range(ROUNDS):
            assert_states_close(states[t], want_states[t], rtol=RTOL,
                                atol=ATOL)
            for k in want_metrics[t]:
                np.testing.assert_allclose(
                    metrics[t][k], want_metrics[t][k], rtol=M_RTOL,
                    atol=ATOL, err_msg=f"rank {r} round {t} {k}")
        # one partial and one finish a round (one dtype group)
        assert calls == [(1, 1)] * ROUNDS, calls
    # every rank holds the same consensus
    z0 = ranks_runs[world][0][name][0][-1]["z"]
    for out in ranks_runs[world][1:]:
        for (_, a), (_, b) in zip(flat_items(out[name][0][-1]["z"]),
                                  flat_items(z0)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.fixture(scope="module")
def ref_runs(reference, cases):
    """The reference's rounds of every case it is held to, from the
    case's initial state (computed once, read by both worlds)."""
    import functools

    import jax
    import jax.numpy as jnp
    from test_torch_reference import ref_state_arrays

    from repro_torch.core.privacy import gaussian_c3

    r, out = reference, {}
    rcfg = r.configs.ForecastConfig(hidden=HIDDEN, horizon=HORIZON)

    for name in (n for n in CASES if CASES[n][2]):
        case = cases[name]
        fed = r.configs.FedConfig(n_clients=C, **case["knobs"])

        def local_loss(p, batch, k, eps, eps_min=fed.eps_min):
            x, y = batch
            return r.forecasting.mse_loss(
                p, r.privacy.perturb_inputs(k, x, eps, 0.0, eps_min), y,
                rcfg)

        c3 = gaussian_c3(CFG.d_x + CFG.d_y, fed.dp_delta, 0.05)
        state = r.fed_state.FedState(**{
            k: None if v is None else jax.tree.map(jnp.asarray, v)
            for k, v in case["init"].items()})
        step = jax.jit(functools.partial(
            r.bafdp.bafdp_round, local_loss=local_loss, fed=fed, c3=c3,
            n_samples=100, d_dim=CFG.d_x + CFG.d_y,
            byz_mask=r.byzantine.byz_mask(C, fed.n_byzantine)))
        states, metrics = [], []
        for t in range(ROUNDS):
            row = case["rows"][t]
            state, m = step(
                state, tuple(map(jnp.asarray, case["batches"][t])),
                jax.random.PRNGKey(t), act=jnp.asarray(row["act"]),
                stale=None if row["stale"] is None
                else jnp.asarray(row["stale"]))
            states.append(ref_state_arrays(state))
            metrics.append({k: np.asarray(v) for k, v in m.items()})
        out[name] = states, metrics
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(n for n in CASES if CASES[n][2]))
def test_dense_round_over_ranks_matches_reference(ref_runs, ranks_runs,
                                                  world, name):
    ref_states, ref_metrics = ref_runs[name]
    states, metrics, _ = ranks_runs[world][0][name]
    for t in range(ROUNDS):
        assert_states_close(states[t], ref_states[t], rtol=REF_RTOL,
                            atol=REF_ATOL)
        for k, v in ref_metrics[t].items():
            np.testing.assert_allclose(metrics[t][k], v, rtol=REF_RTOL,
                                       atol=REF_ATOL,
                                       err_msg=f"round {t} metric {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("message", ["f32", "int8"])
def test_all_reduced_sign_counts_equal_one_ranks(cases, ranks_runs, world,
                                                 message):
    """From one state (a tie on every row of a coordinate, a NaN entry,
    -0.0 against +0.0), the Eq. (20) sums over the fleet: the ranks'
    all-reduced partial sums equal one rank's bit for bit, the NaN
    column NaN (trap A)."""
    zs, Ws = _count_state(cases["f32-constant-sign_flip"])
    want = sign_counts([torch.from_numpy(z) for z in zs],
                       [torch.from_numpy(W) for W in Ws], None, message)
    for out in ranks_runs[world]:
        got = out["counts"][message]
        assert got.dtype == want.dtype == (np.int32 if message == "int8"
                                           else np.float32)
        assert got.tobytes() == want.tobytes()
    if message == "f32":
        assert np.isnan(want).any()


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_sum_gives_every_rank_the_sum(ranks_runs, world):
    for out in ranks_runs[world]:
        assert out["all_reduce_sum"] == [float(world * (world - 1) // 2)] * 3


def _one_rank_block():
    return RankBlock(data=Axis("data", None, 1, 0, 1),
                     model=Axis("model", None, 1, 0, 1), n_clients=C)


@pytest.mark.parametrize("name", ["f32-poly-adam", "int8-hinge-alie"])
def test_one_rank_block_is_todays_round(cases, one_rank, name):
    """A one-rank block (the 1 x 1 mesh) runs the fused path: the same
    bits as no block, no split call; and sharding at one rank is the
    state itself (no copy, trap AL)."""
    got, _, calls = run_forecaster(cases[name], _one_rank_block())
    want, _, want_calls = one_rank[name]
    assert calls == want_calls == [(0, 0)] * ROUNDS
    for t in range(ROUNDS):
        for (p, a), (_, b) in zip(flat_items(got[t]), flat_items(want[t])):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), p
    state = fed_state_from_numpy(cases[name]["init"], device="cpu")
    assert shard_clients(state, _one_rank_block()) is state
    assert unshard_clients(state, None) is state


def test_robust_rules_refuse_several_ranks(cases):
    """A robust rule reads every client's row: over several ranks the
    round raises, naming 7(b)."""
    from dp_ranks import forecaster_round

    case = dict(cases["f32-constant-sign_flip"],
                knobs=dict(attack="sign_flip", byzantine_frac=0.25,
                           robust_consensus="trimmed_mean"))
    ranks = RankBlock(data=Axis("data", object(), 2, 0, 1),
                      model=Axis("model", None, 1, 0, 1), n_clients=C)
    for sparse in (False, True):
        step = forecaster_round(case, ranks, sparse)
        state = shard_clients(fed_state_from_numpy(case["init"], "cpu"),
                              ranks)
        x, y = (torch.from_numpy(a)[:C // 2] for a in case["batches"][0])
        kw = ({"idx": np.arange(C), "weight": np.ones(C, np.float32)}
              if sparse else {"act": np.ones(C, bool)})
        with pytest.raises(NotImplementedError, match="7\\(b\\)"):
            step(state, (x, y), torch.Generator().manual_seed(0), **kw)


def test_rank_block_splits_clients_and_batches_evenly():
    """Client ranges, batch rows and their weights; an uneven split
    raises."""
    def block(R, r, M=1, m=0, n=C):
        return RankBlock(data=Axis("data", None, R, r, M),
                         model=Axis("model", None, M, m, 1), n_clients=n)

    assert [(block(4, r).c0, block(4, r).c1) for r in range(4)] == \
        [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="evenly"):
        block(3, 0)
    assert block(1, 0, 2, 1).batch_rows(4) == (2, 2, 0.5)
    assert block(1, 0, 16, 3).batch_rows(8) == (3, 1, 1 / 8)
    assert block(1, 0, 16, 9).batch_rows(8) == (0, 1, 0.0)
    with pytest.raises(ValueError, match="does not split"):
        block(1, 0, 4, 0).batch_rows(6)
