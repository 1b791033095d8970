"""The port's baseline trainers and forecasters against the reference's.

* Forecasters (``gru``, ``lstm``, ``attn``): the forward on the
  reference's own initial weights, one client and a stack of clients, at
  rtol 1e-5 / atol 1e-6 (f32 matmuls and transcendental functions a few
  ulp apart over 9 recurrent steps); one gradient (``torch.autograd.grad``
  against ``jax.grad``) at rtol 1e-4 / atol 1e-6.
* ``BaselineTrainer``: every method over 3 rounds from the reference's
  initial state, explicit ``act`` rows, a deterministic attack
  (``sign_flip``) and ``dp_sigma=0``, on the backbone ``METHODS`` pairs
  with it; the server state and the metrics at rtol 2e-5 / atol 1e-6
  (the bound of ``test_torch_round.py``).
* Inside the port: the properties of the reference's
  ``tests/test_trainer_metrics.py`` and ``tests/test_fedasync.py``; the
  noisy paths (UDP, NbAFL, DP-RSA) by statistics and by determinism under
  one seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reference import flat_items, one_thread
from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch import train
from repro_torch.configs import FedConfig, ForecastConfig
from repro_torch.core.fed_state import (baseline_state_from_numpy,
                                        params_from_numpy)
from repro_torch.core.trainers import BaselineTrainer
from repro_torch.models.forecasting import (Forecaster, apply_forecaster,
                                            init_forecaster, mse_loss)
from repro_torch.tree import tree_leaves, tree_map

C, B, ROUNDS = 5, 8, 3
RTOL, ATOL = 2e-5, 1e-6
BACKBONES = ("gru", "lstm", "attn")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def _cfg(model):
    return ForecastConfig(model=model, hidden=(16, 8), rnn_hidden=8,
                          horizon=2)


def _ref_cfg(r, model):
    return r.configs.ForecastConfig(model=model, hidden=(16, 8),
                                    rnn_hidden=8, horizon=2)


def _ref_params(r, model, seed=0, n=None):
    """One model (``n=None``) or an (n, ...) stack, reference-initialised,
    numpy."""
    rcfg = _ref_cfg(r, model)
    if n is None:
        p = r.forecasting.init_forecaster(jax.random.PRNGKey(seed), rcfg)
    else:
        keys = jax.random.split(jax.random.PRNGKey(seed), n)
        p = jax.vmap(lambda k: r.forecasting.init_forecaster(k, rcfg))(keys)
    return jax.tree.map(np.asarray, p)


def _data(model, seed=0, lead=()):
    rng = np.random.RandomState(seed)
    cfg = _cfg(model)
    x = rng.randn(*lead, B, cfg.d_x).astype(np.float32)
    y = rng.randn(*lead, B, cfg.d_y).astype(np.float32)
    return x, y


# ---------------------------------------------------------------------------
# forecasters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", BACKBONES)
def test_forecaster_forward_matches_reference(reference, model):
    r = reference
    rcfg, cfg = _ref_cfg(r, model), _cfg(model)
    one = _ref_params(r, model)
    x, y = _data(model)
    want = np.asarray(r.forecasting.apply_forecaster(one, jnp.asarray(x),
                                                     rcfg))
    got = apply_forecaster(params_from_numpy(one, device="cpu"),
                           torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    module = Forecaster(params_from_numpy(one, device="cpu"), cfg)
    assert torch.equal(module(torch.from_numpy(x)), got)
    assert [p for p, _ in flat_items(module.param_tree())] == \
        [p for p, _ in flat_items(one)]
    # a stack of 3 clients, each on its own batch
    W = _ref_params(r, model, seed=1, n=3)
    xs, ys = _data(model, seed=2, lead=(3,))
    got_s = apply_forecaster(params_from_numpy(W, device="cpu"),
                             torch.from_numpy(xs), cfg)
    loss_s = mse_loss(params_from_numpy(W, device="cpu"),
                      torch.from_numpy(xs), torch.from_numpy(ys), cfg)
    assert got_s.shape == (3, B, cfg.d_y) and loss_s.shape == (3,)
    for c in range(3):
        w_c = jax.tree.map(lambda l: l[c], W)
        np.testing.assert_allclose(
            got_s[c].numpy(),
            np.asarray(r.forecasting.apply_forecaster(w_c, xs[c], rcfg)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            float(loss_s[c]),
            float(r.forecasting.mse_loss(w_c, xs[c], ys[c], rcfg)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", BACKBONES)
def test_forecaster_gradient_matches_reference(reference, model):
    r = reference
    rcfg, cfg = _ref_cfg(r, model), _cfg(model)
    one = _ref_params(r, model, seed=3)
    x, y = _data(model, seed=4)
    want = jax.grad(r.forecasting.mse_loss)(one, jnp.asarray(x),
                                            jnp.asarray(y), rcfg)
    p = tree_map(lambda t: t.requires_grad_(True),
                 params_from_numpy(one, device="cpu"))
    g = torch.autograd.grad(mse_loss(p, torch.from_numpy(x),
                                     torch.from_numpy(y), cfg),
                            tree_leaves(p))
    want_items = list(flat_items(jax.tree.map(np.asarray, want)))
    assert len(g) == len(want_items)
    for gl, (path, wl) in zip(g, want_items):
        np.testing.assert_allclose(gl.numpy(), wl, rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_init_shapes_follow_the_reference(reference):
    for model in ("mlp",) + BACKBONES:
        want = _ref_params(reference, model)
        got = init_forecaster(torch.Generator().manual_seed(0), _cfg(model))
        g, w = dict(flat_items(got)), dict(flat_items(want))
        assert sorted(g) == sorted(w), model
        for k in g:
            assert tuple(g[k].shape) == w[k].shape, (model, k)


# ---------------------------------------------------------------------------
# BaselineTrainer against the reference
# ---------------------------------------------------------------------------
CASES = {f"{m}/{v[1]}": (v[0], v[1])
         for m, v in train.METHODS.items() if v[0] != "bafdp"}
CASES.update({"FedProx/mlp": ("fedprox", "mlp")})
CASES.update({f"robust_agg-{a}/mlp": ("robust_agg", "mlp", a)
              for a in ("median", "trimmed_mean", "krum", "geomed",
                        "centered_clip")})


def _rows(seed):
    rng = np.random.RandomState(seed)
    act = rng.rand(ROUNDS, C) < 0.6
    act[:, 0] = True
    act[1, 4] = True                    # a Byzantine client delivers
    return act


def _batches(model, seed):
    rng = np.random.RandomState(seed)
    cfg = _cfg(model)
    return [(rng.rand(C, B, cfg.d_x).astype(np.float32),
             rng.rand(C, B, cfg.d_y).astype(np.float32))
            for _ in range(ROUNDS)]


FED_KW = dict(n_clients=C, attack="sign_flip", byzantine_frac=0.3,
              attack_scale=3.0, staleness_decay="poly")


def _run_reference(r, method, model, aggregator, act, batches):
    rcfg = _ref_cfg(r, model)
    fed = r.configs.FedConfig(**FED_KW)

    def loss(p, b, k):
        x, y = b
        return r.forecasting.mse_loss(p, x, y, rcfg)

    tr = r.trainers.BaselineTrainer(method=method, loss=loss, fed=fed,
                                    aggregator=aggregator)
    st = tr.init(r.forecasting.init_forecaster(jax.random.PRNGKey(7), rcfg))
    init = jax.tree.map(np.asarray, st)
    step = tr.jitted_round()
    states, metrics = [], []
    for t in range(ROUNDS):
        st, m = step(st, tuple(map(jnp.asarray, batches[t])),
                     jax.random.PRNGKey(t), act=jnp.asarray(act[t]))
        states.append(jax.tree.map(np.asarray, st))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return init, states, metrics


def _port_trainer(method, model, aggregator, **kw):
    cfg = _cfg(model)

    def loss(W, b, gen):
        x, y = b
        return mse_loss(W, x, y, cfg)

    return BaselineTrainer(method=method, loss=loss,
                           fed=FedConfig(**dict(FED_KW, **kw)),
                           aggregator=aggregator)


@pytest.mark.parametrize("name", sorted(CASES))
def test_baseline_round_matches_reference(reference, name):
    method, model, *agg_name = CASES[name]
    aggregator = agg_name[0] if agg_name else "fedavg"
    act = _rows(sorted(CASES).index(name))
    batches = _batches(model, sorted(CASES).index(name))
    init, ref_states, ref_metrics = _run_reference(
        reference, method, model, aggregator, act, batches)
    tr = _port_trainer(method, model, aggregator)
    st = baseline_state_from_numpy(init, device="cpu")
    for t in range(ROUNDS):
        st, m = tr.round(st, tuple(torch.from_numpy(a) for a in batches[t]),
                         torch.Generator().manual_seed(t), act=act[t])
        got = dict(flat_items(tree_map(lambda x: x.numpy(), st)))
        want = dict(flat_items(ref_states[t]))
        assert sorted(got) == sorted(want)
        for k in got:
            if k in ("/t", "/tau"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           atol=ATOL,
                                           err_msg=f"round {t} {k}")
        assert sorted(m) == sorted(ref_metrics[t])
        for k in m:
            np.testing.assert_allclose(m[k].numpy(), ref_metrics[t][k],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"round {t} metric {k}")


def test_baseline_cases_cover_every_method():
    kinds = {v[0] for v in CASES.values()}
    assert kinds == {v[0] for v in train.METHODS.values()} - {"bafdp"} \
        | {"fedprox", "robust_agg"}


def test_baseline_state_round_trip(reference):
    """The reference's initial state of every method (``p``, ``quasi``,
    ``tau`` as it keeps them) carries over, dtypes included."""
    r = reference
    for method in ("fedavg", "afl", "fedda", "fedasync"):
        tr = r.trainers.BaselineTrainer(
            method=method, loss=None, fed=r.configs.FedConfig(n_clients=C))
        want = jax.tree.map(np.asarray, tr.init(
            r.forecasting.init_forecaster(jax.random.PRNGKey(0),
                                          _ref_cfg(r, "attn"))))
        got = baseline_state_from_numpy(want, device="cpu")
        assert sorted(got) == sorted(want)
        g = dict(flat_items(tree_map(lambda x: x.numpy(), got)))
        for k, w in flat_items(want):
            assert g[k].dtype == w.dtype, (method, k)
            np.testing.assert_array_equal(g[k], w)
    with pytest.raises(ValueError, match="missing"):
        baseline_state_from_numpy({"t": np.zeros((), np.int32)},
                                  device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        baseline_state_from_numpy(dict(want, bogus=np.zeros(1)),
                                  device="cpu")


# ---------------------------------------------------------------------------
# inside the port: tests/test_trainer_metrics.py and tests/test_fedasync.py
# ---------------------------------------------------------------------------
def _make(method="fedavg", n_clients=6, **fed_kw):
    cfg = ForecastConfig(hidden=(16, 8), horizon=1)

    def loss(W, b, gen):
        x, y = b
        return mse_loss(W, x, y, cfg)

    fed = FedConfig(n_clients=n_clients, attack="none", **fed_kw)
    tr = BaselineTrainer(method=method, loss=loss, fed=fed)
    st = tr.init(init_forecaster(torch.Generator().manual_seed(0), cfg))
    g = torch.Generator().manual_seed(1)
    X = torch.randn(n_clients, 16, cfg.d_x, generator=g)
    Y = torch.sum(X[..., :3], -1, keepdim=True) * 0.5
    return tr, st, (X, Y)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_loss_excludes_inactive_clients():
    """One client has absurd targets: while it is inactive the reported
    loss does not see it."""
    tr, st, (X, Y) = _make()
    Y_bad = Y.clone()
    Y_bad[0] = 30.0
    act_without = np.asarray([False, True, True, True, True, True])
    act_with = np.asarray([True, True, True, True, True, False])
    _, m_without = tr.round(st, (X, Y_bad), gen(1), act=act_without)
    _, m_with = tr.round(st, (X, Y_bad), gen(1), act=act_with)
    assert float(m_without["loss"]) < 50
    assert float(m_with["loss"]) > 50


def test_loss_invariant_to_inactive_data():
    tr, st, (X, Y) = _make()
    act = np.asarray([False, True, True, True, True, True])
    _, m_a = tr.round(st, (X, Y), gen(1), act=act)
    Y2 = Y.clone()
    Y2[0] = Y[0] * 100.0
    _, m_b = tr.round(st, (X, Y2), gen(1), act=act)
    np.testing.assert_allclose(float(m_a["loss"]), float(m_b["loss"]),
                               rtol=1e-6)
    assert int(m_a["n_active"]) == 5


def test_all_active_unchanged_semantics():
    tr, st, batch = _make()
    _, m = tr.round(st, batch, gen(1), act=np.ones(6, bool))
    assert np.isfinite(float(m["loss"])) and int(m["n_active"]) == 6


def test_fedasync_tau_tracks_participation():
    tr, st, batch = _make("fedasync", n_clients=5)
    rng = np.random.RandomState(0)
    last = np.zeros(5, np.int64)
    for t in range(6):
        mask = rng.rand(5) < 0.5
        st, m = tr.round(st, batch, gen(t), act=mask)
        last[mask] = t
        np.testing.assert_array_equal(st["tau"].numpy(), last)
        assert np.isfinite(float(m["loss"]))
        assert int(m["n_active"]) == int(mask.sum())


def test_fedasync_empty_round_is_noop():
    """No arrivals: the AFO server keeps its model (the mixing divides by
    max(sum(act), 1))."""
    tr, st, batch = _make("fedasync", n_clients=5)
    st, _ = tr.round(st, batch, gen(0))
    st2, _ = tr.round(st, batch, gen(9), act=np.zeros(5, bool))
    for a, b in zip(tree_leaves(st["server"]), tree_leaves(st2["server"])):
        assert torch.equal(a, b)
    assert torch.equal(st["tau"], st2["tau"])


def test_fedasync_staleness_damps_mixing():
    """Under poly decay a long-stale arrival moves the server less than a
    fresh one."""
    tr, st, batch = _make("fedasync", n_clients=5, staleness_decay="poly",
                          staleness_poly_a=1.0)
    only0 = np.asarray([True, False, False, False, False])
    st_f = dict(st, t=torch.tensor(10, dtype=torch.int32),
                tau=torch.tensor([10, 0, 0, 0, 0], dtype=torch.int32))
    st_s = dict(st, t=torch.tensor(10, dtype=torch.int32),
                tau=torch.zeros(5, dtype=torch.int32))
    out_f, _ = tr.round(st_f, batch, gen(1), act=only0)
    out_s, _ = tr.round(st_s, batch, gen(1), act=only0)

    def delta(out):
        return sum(float((a - b).abs().sum()) for a, b in zip(
            tree_leaves(out["server"]), tree_leaves(st["server"])))

    assert 0 < delta(out_s) < delta(out_f)


def test_fedasync_training_reduces_loss():
    tr, st, batch = _make("fedasync", n_clients=5, active_frac=0.6)
    losses = []
    for t in range(40):
        st, m = tr.round(st, batch, gen(t))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_afl_weights_see_every_client_loss():
    """AFL's exponentiated weights read all C losses, inactive clients
    included: the weights move even where the clients did not train."""
    tr, st, (X, Y) = _make("afl")
    Y2 = Y.clone()
    Y2[0] = 5.0
    out, _ = tr.round(st, (X, Y2), gen(0),
                      act=np.asarray([False] + [True] * 5))
    p = out["p"]
    assert float(p.sum()) == pytest.approx(1.0, abs=1e-6)
    assert int(torch.argmax(p)) == 0


# ---------------------------------------------------------------------------
# the noisy paths: statistics and determinism
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method,lr,psi,std", [
    ("udp", 0.0, 1.0, 1.0 / np.sqrt(10)),
    ("nbafl", 0.0, 1.0, np.sqrt(0.1 + 0.25)),
    ("dp_rsa", 1e-6, 1e4, 1e-2 * np.sqrt(10))])
def test_noisy_uploads_statistics_and_determinism(method, lr, psi, std):
    """With (next to) no local step every upload is the server's params
    plus N(0, 1) noise, so the server moves by the noise alone: the mean
    of C=10 uploads (UDP), plus the N(0, 0.5^2) downlink (NbAFL); DP-RSA
    moves by lr psi = 1e-2 times a sum of 10 fair +-1 votes.  The same
    seed repeats bit for bit, a new seed does not."""
    cfg = ForecastConfig(hidden=(64, 32), horizon=1)

    def loss(W, b, g):
        x, y = b
        return mse_loss(W, x, y, cfg)

    tr = BaselineTrainer(method=method, loss=loss, lr=lr, dp_sigma=1.0,
                         psi=psi, fed=FedConfig(n_clients=10, attack="none"))
    st = tr.init(init_forecaster(gen(0), cfg))
    X = torch.randn(10, 4, cfg.d_x, generator=gen(1))
    batch = (X, X[..., :1])
    out, _ = tr.round(st, batch, gen(5), act=np.ones(10, bool))
    again, _ = tr.round(st, batch, gen(5), act=np.ones(10, bool))
    other, _ = tr.round(st, batch, gen(6), act=np.ones(10, bool))
    d = torch.cat([(a - b).reshape(-1) for a, b in zip(
        tree_leaves(out["server"]), tree_leaves(st["server"]))])
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(out["server"]), tree_leaves(again["server"])))
    assert not torch.equal(tree_leaves(out["server"])[1],
                           tree_leaves(other["server"])[1])
    assert d.numel() > 3000 and abs(float(d.mean())) < 0.05 * std
    assert abs(float(d.std()) / std - 1.0) < 0.1


# ---------------------------------------------------------------------------
# train_baseline / run_method
# ---------------------------------------------------------------------------
def test_train_baseline_and_run_method_on_the_cpu():
    fed = FedConfig(n_clients=3)
    params, cfg, (test, scalers), hist = train.train_baseline(
        "FedGRU", "milano", 1, fed, rounds=2, collect=("loss", "bogus"),
        active_masks=np.ones((2, 3), bool), device="cpu")
    assert cfg.model == "gru" and len(hist["loss"]) == 2
    assert np.isnan(hist["bogus"]).all()       # skip_missing
    rmse, mae = train.eval_rmse_mae(params, cfg, test, scalers)
    assert np.isfinite([rmse, mae]).all()
    for method in ("AFL", "BAFDP"):
        assert np.isfinite(train.run_method(method, "milano", 1, fed=fed,
                                            rounds=2, device="cpu")).all()
    with pytest.raises(ValueError, match="train_bafdp"):
        train.train_baseline("BAFDP", "milano", 1, fed, rounds=1,
                             device="cpu")
