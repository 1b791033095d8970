"""The O(S) BAFDP round (``bafdp_round_sparse``) with its clients split
over 2 and 4 gloo ranks on the CPU, held to the one-rank round and to the
reference's.

Each rank keeps the round's rows whose client lies in its block, in the
canonical order, padded to the same S_max, and writes them back; the dual
fold and the staleness-weighted Eq. (20) fold (B2 on the f32 wire, B3
weighted on the int8 wire) become a partial over those rows, an
all-reduce and a finish.  One spawn per world (``dp_ranks.run_ranks``)
runs every case; C = 8, S_max = 7 with padding, a negative id and (the
fedbuff case) a duplicate delivery, 3 rounds.

Tolerances, stated before the first run: against one rank, rtol 1e-6 +
atol 1e-7 on the state and rtol 1e-5 on the metrics (the weighted folds
regroup their additions across ranks: ``ref.weighted_split_bound`` bounds
a step's z by ~1e-8 here); against the reference, its own tolerance for
this round (``test_torch_sparse_round``: rtol 2e-5, atol 1e-6), at
``input_sigma`` = 0 and without ``gaussian``, for B3 weighted under
``alie`` and B2 with a FedBuff duplicate (the other cases' one-rank
rounds are held to it by ``test_torch_sparse_round``'s grid).  The row
generators are per client, so the gaussian attack's and the noise's
draws are the one-rank round's whatever the block.
"""
import numpy as np
import pytest
import torch
from dp_ranks import run_forecaster, run_ranks, state_arrays
from test_torch_reference import (  # noqa: F401  (fixture)
    assert_states_close, reference)

from repro_torch.configs import FedConfig, ForecastConfig
from repro_torch.core.fed_state import init_fed_state
from repro_torch.models.forecasting import init_forecaster

C, SMAX, B, ROUNDS = 8, 7, 4, 3
HIDDEN, HORIZON = (16, 8), 1
CFG = ForecastConfig(hidden=HIDDEN, horizon=HORIZON)
RTOL, ATOL = 1e-6, 1e-7
M_RTOL = 1e-5
REF_RTOL, REF_ATOL = 2e-5, 1e-6
WORLDS = (2, 4)

# name -> (knobs, input sigma, held to the reference)
CASES = {
    "f32-constant": (dict(), 0.0, False),
    "f32-hinge-sign_flip": (dict(staleness_decay="hinge",
                                 staleness_hinge_b=0.0, attack="sign_flip",
                                 byzantine_frac=0.25), 0.0, False),
    "int8-hinge-alie": (dict(sign_message="int8", staleness_decay="hinge",
                             staleness_hinge_b=0.0, attack="alie",
                             byzantine_frac=0.25, attack_scale=3.0),
                        0.0, True),
    "int8-dualint8-poly": (dict(sign_message="int8", dual_message="int8",
                                staleness_decay="poly"), 0.0, False),
    "fedbuff-dups": (dict(staleness_decay="poly", fedbuff_lr_norm=True),
                     0.0, True),
    "taylor-per_client": (dict(staleness_decay="poly",
                               staleness_compensation="taylor",
                               compensation_scale_mode="per_client",
                               omega_optimizer="adam"), 0.0, False),
    "f32-hinge-gaussian-noise": (dict(staleness_decay="hinge",
                                      attack="gaussian", byzantine_frac=0.25,
                                      attack_scale=0.5), 0.05, False),
}


def _case(name: str, seed: int) -> dict:
    knobs, sigma, _ = CASES[name]
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(ROUNDS):
        ids = list(rng.choice(C, 4, replace=False))
        if name == "fedbuff-dups":
            ids.append(ids[0])                   # a second delivery
        idx = np.asarray(ids + [-1] + [C] * SMAX, np.int32)[:SMAX]
        weight = np.ones(idx.size, np.float32)
        weight[idx == C] = 0.0
        stale = rng.randint(0, 5, idx.size).astype(np.float32)
        p = rng.permutation(idx.size)
        rows.append({"idx": idx[p], "stale": stale[p], "weight": weight[p]})
    batches = [(rng.rand(C, B, CFG.d_x).astype(np.float32),
                rng.rand(C, B, CFG.d_y).astype(np.float32))
               for _ in range(ROUNDS)]
    fed = FedConfig(n_clients=C, consensus_scope="active", **knobs)
    init = init_fed_state(torch.Generator().manual_seed(seed),
                          lambda g: init_forecaster(g, CFG), fed,
                          device="cpu")
    return dict(knobs=knobs, sigma=sigma, C=C, hidden=HIDDEN,
                horizon=HORIZON, batches=batches, rows=rows,
                init=state_arrays(init))


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name, 20 + i) for i, name in enumerate(CASES)}


@pytest.fixture(scope="module")
def one_rank(cases):
    return {name: run_forecaster(case, sparse=True)
            for name, case in cases.items()}


@pytest.fixture(scope="module")
def ranks_runs(cases, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sparse")
    payload = {"cases": cases, "sparse": True}
    return {R: run_ranks((R, 1), "dp_ranks:forecaster_job", payload, tmp)
            for R in WORLDS}


@pytest.fixture(scope="module")
def ref_runs(reference, cases):
    """The reference's sparse rounds of every case it is held to, from
    the case's initial state (once, for both worlds)."""
    import functools

    import jax
    import jax.numpy as jnp
    from test_torch_reference import ref_state_arrays

    from repro_torch.core.privacy import gaussian_c3

    r, out = reference, {}
    rcfg = r.configs.ForecastConfig(hidden=HIDDEN, horizon=HORIZON)
    for name in (n for n in CASES if CASES[n][2]):
        case = cases[name]
        fed = r.configs.FedConfig(n_clients=C, consensus_scope="active",
                                  **case["knobs"])

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
            r.bafdp.bafdp_round_sparse, local_loss=local_loss, fed=fed,
            c3=c3, n_samples=100, d_dim=CFG.d_x + CFG.d_y,
            byz_mask=r.byzantine.byz_mask(C, fed.n_byzantine)))
        states, metrics = [], []
        for t, row in enumerate(case["rows"]):
            state, m = step(
                state, tuple(map(jnp.asarray, case["batches"][t])),
                jax.random.PRNGKey(t),
                **{k: jnp.asarray(v) for k, v in row.items()})
            states.append(ref_state_arrays(state))
            metrics.append({k: np.asarray(v) for k, v in m.items()})
        out[name] = states, metrics
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sparse_round_over_ranks_matches_one_rank(ranks_runs, one_rank,
                                                  world, name):
    want_states, want_metrics, _ = one_rank[name]
    for r, out in enumerate(ranks_runs[world]):
        states, metrics, calls = out[name]
        for t in range(ROUNDS):
            assert_states_close(states[t], want_states[t], rtol=RTOL,
                                atol=ATOL)
            assert sorted(metrics[t]) == sorted(want_metrics[t])
            for k in want_metrics[t]:
                np.testing.assert_allclose(
                    metrics[t][k], want_metrics[t][k], rtol=M_RTOL,
                    atol=ATOL, err_msg=f"rank {r} round {t} {k}")
        # B2 / B3 weighted split: one partial and one finish a round
        assert calls == [(1, 1)] * ROUNDS, calls


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(n for n in CASES if CASES[n][2]))
def test_sparse_round_over_ranks_matches_reference(ref_runs, ranks_runs,
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


def test_rank_rows_keep_the_blocks_clients_in_canonical_order():
    """Each rank's rows: its clients' deliveries in the canonical order,
    local ids, the local sentinel C_r at padding, and only each client's
    last delivery written back."""
    from repro_torch.core.bafdp import _canonical_rows, _rank_rows
    from repro_torch.distributed.data_parallel import Axis, RankBlock

    idx = np.array([5, 1, 8, 5, 6, -1, 2], np.int64)
    ids, st, w, _, wr = _canonical_rows(idx, np.arange(7.0), None, C)
    got = []
    for r in range(2):
        ranks = RankBlock(Axis("data", None, 2, r, 1),
                          Axis("model", None, 1, 0, 1), C)
        got.append(_rank_rows(ids, st, w, wr, ranks))
    l0, _, w0, wr0, f0 = got[0]
    l1, _, w1, wr1, f1 = got[1]
    assert l0.tolist() == [1, 2] + [4] * 5 and f0[:2].tolist() == [1, 2]
    assert l1.tolist() == [1, 1, 2] + [4] * 4
    assert f1[:3].tolist() == [5, 5, 6]
    assert wr1.tolist() == [4, 1, 2] + [4] * 4       # 5's last delivery
    assert w0.sum() + w1.sum() == w.sum()
