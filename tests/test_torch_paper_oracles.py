"""The reference's own oracles of the paper's evaluation, run against the
port on the CPU: ``tests/test_benchmark_smoke.py``'s FedBuff, arrivals
and staleness contracts, ``tests/test_devices.py``'s device-scenario
smoke, ``tests/test_system.py``'s Fig. 3 behaviour, and the claim summary
(``summarize_claims``) returning the reference's text on one row file."""
import functools

import numpy as np
import pytest
import torch
from test_torch_reference import one_thread
from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch import train
from repro_torch.bench import fig456_async_efficiency as fig456
from repro_torch.bench import summarize_claims
from repro_torch.configs import MLP_H1, FedConfig
from repro_torch.core import bafdp
from repro_torch.core.async_engine import DelayModel
from repro_torch.core.byzantine import byz_mask
from repro_torch.core.fed_state import init_fed_state
from repro_torch.core.privacy import gaussian_c3, perturb_inputs
from repro_torch.core.schedule import (FedBuffTrigger, QuorumTrigger,
                                       build_schedule, round_generator)
from repro_torch.data import build_windows, client_batches, make_dataset
from repro_torch.models.forecasting import init_forecaster, mse_loss
from repro_torch.tree import tree_leaves


def test_fedbuff_benchmark_smoke():
    """A FedBuff (K-arrivals) schedule trains end to end through
    ``FederatedRun`` via the fig456 scenario harness: K arrivals a round,
    and the trainer saw exactly the schedule's distinct winners."""
    with one_thread():
        row, meta = fig456.run_scenario("fedbuff", "milano", rounds=4,
                                        with_meta=True, device="cpu")
    parts = row.split(",", 2)
    assert len(parts) == 3 and parts[0] == "fig456/milano:fedbuff"
    float(parts[1])
    assert (meta["arrivals"] == 5).all()
    np.testing.assert_array_equal(meta["n_active"], meta["masks"].sum(1))
    assert (meta["staleness"][meta["masks"]] == 0).all()
    assert np.isfinite(meta["quorum"]).all()


def test_fedbuff_lr_norm_autofeeds_arrivals():
    """``train_bafdp`` couples ``fedbuff_lr_norm`` to the schedule's
    realized per-round K: on a schedule where a fast client delivered twice
    into one buffer (K > distinct actives), the default run differs from
    one forced onto the sum(act) fallback."""
    rounds = 4
    sched = build_schedule(rounds, DelayModel(n_clients=8, hetero=2.5,
                                              seed=3),
                           FedBuffTrigger(buffer_k=5))
    assert (sched.arrivals > sched.quorum).any()   # duplicates present
    fed = FedConfig(n_clients=8, fedbuff_lr_norm=True)
    with one_thread():
        st_auto, _, _ = train.train_bafdp("milano", 1, fed, rounds,
                                          schedule=sched, device="cpu")
        st_fallback, _, _ = train.train_bafdp(
            "milano", 1, fed, rounds, schedule=sched, feed_arrivals=False,
            device="cpu")
    z_a = torch.cat([l.reshape(-1) for l in tree_leaves(st_auto.z)])
    z_f = torch.cat([l.reshape(-1) for l in tree_leaves(st_fallback.z)])
    assert not torch.equal(z_a, z_f)


def test_fig456_age_adaptive_scenario_bounds_staleness():
    """The ``age_adaptive`` scenario (age-aware selection + adaptive
    quorum) bounds max staleness over a long horizon, where the fastest /
    fixed policy starves the slow tail."""
    dm_kw, trigger_fn, _ = fig456.SCENARIOS["age_adaptive"]
    n, frac, rounds = 8, fig456.ACTIVE_FRAC, 150
    dm = DelayModel(**{"n_clients": n, "hetero": 1.0, "seed": 0, **dm_kw})
    aged = build_schedule(rounds, dm, trigger_fn()).to_sim()
    fast = build_schedule(rounds, dm,
                          QuorumTrigger(active_frac=frac)).to_sim()
    s = max(1, int(round(n * frac)))
    thr = 2 * int(np.ceil(n / s))            # default age_threshold
    bound = thr + int(np.ceil(n / s))        # overdue admissions may queue
    assert aged.staleness.max() <= bound, aged.staleness.max()
    assert fast.staleness.max() > bound      # fastest/fixed really starves


@pytest.mark.parametrize("name", fig456.DEVICE_SCENARIOS)
def test_scenario_pack_smoke_trains_quick(name):
    """Every device scenario trains end to end through the fig456 harness
    and reports its sparse-schedule statistics (no densification unless
    asked for)."""
    assert name in fig456.SCENARIOS
    with one_thread():
        row, meta = fig456.run_scenario(name, "milano", rounds=3,
                                        device="cpu")
    assert meta is None                 # densification is opt-in
    parts = row.split(",", 2)
    assert parts[0] == f"fig456/milano:{name}"
    float(parts[1])
    assert "max_stale=" in parts[2] and "mean_quorum=" in parts[2]


def test_privacy_level_evolves():
    """Fig. 3's behaviour: eps moves from its init and stays feasible
    (the reference's loop: MLP_H1, 6 Milano clients, 60 rounds, the
    internal sampler, input noise 0.02)."""
    cfg, n_clients = MLP_H1, 6
    train_set, _, _ = build_windows(make_dataset("milano", n_clients,
                                                 seed=0), cfg)
    fed = FedConfig(n_clients=6, alpha_eps=5e-2, privacy_budget_a=30.0)
    c3 = gaussian_c3(cfg.d_x + cfg.d_y, fed.dp_delta, 0.05)

    def local_loss(W, batch, gen, eps):
        x, y = batch
        return mse_loss(W, perturb_inputs(gen, x, eps, 0.02), y, cfg)

    gen = torch.Generator().manual_seed(0)
    state = init_fed_state(gen, lambda g: init_forecaster(g, cfg, "cpu"),
                           fed, device="cpu")
    step = functools.partial(
        bafdp.bafdp_round, local_loss=local_loss, fed=fed, c3=c3,
        n_samples=train_set["x"].shape[1], d_dim=cfg.d_x + cfg.d_y,
        byz_mask=byz_mask(fed.n_clients, fed.n_byzantine, device="cpu"))
    rng = np.random.RandomState(0)
    with one_thread():
        for t in range(60):
            x, y = client_batches(rng, train_set, 32)
            state, _ = step(state, (torch.from_numpy(x).float(),
                                    torch.from_numpy(y).float()),
                            round_generator(0, t, "cpu"))
    eps = state.eps.numpy()
    assert (eps >= fed.eps_min).all() and (eps <= fed.privacy_budget_a).all()
    assert not np.allclose(eps, fed.privacy_budget_a * 0.5)   # moved


# ---------------------------------------------------------------------------
# the claim summary
# ---------------------------------------------------------------------------
# rows for all eight claims: Table I's ranks, Table IV with BAFDP above
# RSA (claim 2 PARTIAL: 0.1 worse than 1.2x of 0.3), a fig456 speedup
# under 1 (claim 3 PARTIAL), an eps that falls on one dataset (claim 4
# PARTIAL), fig8's series, Theorem 1's slope, Fig. 7, and Table II/III
# sweeps with an interior and an edge optimum (claim 8)
CLAIM_ROWS = """name,us_per_call,derived
table1/FedGRU/milano/H1,1.0,rmse=60.0;mae=40.0
table1_rank/FedGRU,0.0,avg_rank=2.50
table1_rank/AFL,0.0,avg_rank=3.00
table1_rank/BAFDP,0.0,avg_rank=1.50
table1_rank/UDP,0.0,avg_rank=4.25
# table1 done in 12s
table4/RSA/ratio0.1/H1,1.0,rmse=70.1;mae=40.0
table4/DP-RSA/ratio0.1/H1,1.0,rmse=71.2;mae=40.0
table4/BAFDP/ratio0.0/H1,1.0,rmse=60.0;mae=40.0
table4/BAFDP/ratio0.1/H1,1.0,rmse=80.0;mae=40.0
table4/BAFDP/ratio0.3/H1,1.0,rmse=62.0;mae=40.0
fig456/milano,1.0,t_async_s=11.2;t_sync_s=33.9;speedup=3.02;final_loss_async=0.07;final_loss_sync=0.02
fig456/trento,1.0,t_async_s=40.0;t_sync_s=30.0;speedup=0.75;final_loss_async=0.07;final_loss_sync=0.02
fig456/milano:fedbuff,1.0,t_total_s=8.5;max_stale=3;mean_quorum=3.50;mean_arrivals=5.00;final_loss=0.0473
fig3/milano,1.0,eps_start=0.600;eps_final=0.900;per_client_spread=0.010
fig3/trento,1.0,eps_start=0.600;eps_final=0.500;per_client_spread=0.020
fig8/ratio0.8,1.0,final=0.05;rounds_to_1.2xbest=120
fig8/ratio0.4,1.0,final=0.04;rounds_to_1.2xbest=80
fig8/ratio0.0,1.0,final=0.03;rounds_to_1.2xbest=60
theorem1/slope,1.0,loglog_slope=1.37;T_at_ladder=31/49/88/145;bound=2.0
fig7/ratio0.2,0.0,transfer_gb=68750;sign_compressed_gb=42969;participants=8
table23/milano/H1/a10,1.0,rmse=90.0;mae=50.0
table23/milano/H1/a40,1.0,rmse=85.0;mae=50.0
table23/milano/H1/a70,1.0,rmse=88.0;mae=50.0
table23/trento/H24/a0.1,1.0,rmse=30.0;mae=20.0
table23/trento/H24/a1,1.0,rmse=31.0;mae=20.0
table23/trento/H24/a10,1.0,rmse=32.0;mae=20.0
fig3/ERROR,0.0,failed
"""


def test_summarize_claims_returns_the_reference_text(reference, tmp_path):
    """The port's ``main`` on a row file returns the reference's string,
    and the same string from the rows as a list."""
    import importlib

    ref_mod = importlib.import_module("benchmarks.summarize_claims")
    path = tmp_path / "bench_output.txt"
    path.write_text(CLAIM_ROWS)
    want = ref_mod.main(str(path))
    assert summarize_claims.main(str(path)) == want
    assert summarize_claims.main(rows=CLAIM_ROWS.splitlines()) == want
    verdicts = [line for line in want.splitlines() if line[:2].rstrip(".")
                .isdigit()]
    assert [v.split(".")[0] for v in verdicts] == [str(i) for i in
                                                   range(1, 9)]
    assert "PARTIAL" in verdicts[1] and "PARTIAL" in verdicts[2] \
        and "PARTIAL" in verdicts[3] and "CONFIRMED" in verdicts[0]
    assert "milano/H1: best a=40 (interior)" in verdicts[7]
    assert "trento/H24: best a=0.1 (edge)" in verdicts[7]


def test_summarize_claims_leaves_fig8s_guarded_row_out(reference, tmp_path):
    """Fig. 8's guarded series (``fig8/ratio0.4-tm``, which the suite
    prints beside the plain ratios) is no point of claim 5's series: the
    port's text is the one without that row, where the reference's
    ``float()`` raises on the suffix."""
    import importlib

    ref_mod = importlib.import_module("benchmarks.summarize_claims")
    plain = tmp_path / "plain.txt"
    plain.write_text(CLAIM_ROWS)
    guarded = tmp_path / "guarded.txt"
    guarded.write_text(CLAIM_ROWS + "fig8/ratio0.4-tm,1.0,final=0.04;"
                       "rounds_to_1.2xbest=70\n")
    with pytest.raises(ValueError, match="0.4-tm"):
        ref_mod.main(str(guarded))
    assert summarize_claims.main(str(guarded)) == ref_mod.main(str(plain))
