"""The round's building blocks against the reference: the MLP, the DRO
regularizer and its gradient, LDP, the attacks, staleness decay and
compensation, the samplers and the train loop.

Tolerance 1e-6 relative where f32 matmuls or pow enter (another summation
order or libm: a few ulp); exact where both sides compute the same
operations in the same order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.configs import FedConfig, ForecastConfig
from repro_torch.core import bafdp, byzantine, dro, privacy
from repro_torch.core.fed_state import params_from_numpy
from repro_torch.core.async_engine import DelayModel
from repro_torch.core.schedule import (FederatedRun, SyncTrigger,
                                       build_schedule, round_generator)
from repro_torch.models.forecasting import (Forecaster, apply_forecaster,
                                            init_forecaster, mse_loss)
from repro_torch.models.layers import dense_init
from repro_torch.tree import tree_leaves, tree_map

CFG = ForecastConfig(hidden=(16, 8), horizon=3)
C = 4


def _ref_stack(r, seed=0):
    """A (C, ...) stack of reference-initialised MLPs, numpy."""
    rcfg = r.configs.ForecastConfig(hidden=CFG.hidden, horizon=CFG.horizon)
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    W = jax.vmap(lambda k: r.forecasting.init_forecaster(k, rcfg))(keys)
    return jax.tree.map(np.asarray, W), rcfg


def test_dense_init_is_a_truncated_fan_in_normal():
    g = torch.Generator().manual_seed(0)
    w = dense_init(g, (400, 300))
    std = 1 / np.sqrt(400)
    assert w.shape == (400, 300) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * std
    # std of N(0, 1) truncated to [-2, 2] is 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01


def test_forecaster_matches_reference(reference):
    r = reference
    W_np, rcfg = _ref_stack(r)
    rng = np.random.RandomState(0)
    x = rng.rand(C, 8, CFG.d_x).astype(np.float32)
    y = rng.rand(C, 8, CFG.d_y).astype(np.float32)
    W = params_from_numpy(W_np, device="cpu")
    got = apply_forecaster(W, torch.from_numpy(x), CFG)
    loss = mse_loss(W, torch.from_numpy(x), torch.from_numpy(y), CFG)
    for c in range(C):
        w_c = jax.tree.map(lambda l: l[c], W_np)
        want = np.asarray(r.forecasting.apply_forecaster(w_c, x[c], rcfg))
        np.testing.assert_allclose(got[c].numpy(), want, rtol=1e-6,
                                   atol=1e-6)
        module = Forecaster(tree_map(lambda l: l[c], W), CFG)
        assert torch.equal(module(torch.from_numpy(x[c])),
                           apply_forecaster(module.param_tree(),
                                            torch.from_numpy(x[c]), CFG))
        np.testing.assert_allclose(
            float(loss[c]),
            float(r.forecasting.mse_loss(w_c, x[c], y[c], rcfg)), rtol=1e-6)
    p = init_forecaster(torch.Generator().manual_seed(0), CFG)
    assert sorted(p) == ["l0", "l1", "l2"]
    assert p["l0"]["w"].shape == (CFG.d_x, 16)
    with pytest.raises(ValueError, match="not yet ported"):
        init_forecaster(torch.Generator(), ForecastConfig(model="gru"))


@pytest.mark.parametrize("kind", ["spectral", "frobenius"])
def test_lipschitz_surrogate_and_its_gradient_match_reference(reference,
                                                              kind):
    """G(omega) and dG/domega per client: the gradient flows through the
    4-step power iteration, the norm clamps and exp(clip(log G))."""
    r = reference
    W_np, _ = _ref_stack(r, seed=1)
    W = tree_map(lambda l: l.requires_grad_(True),
                 params_from_numpy(W_np, device="cpu"))
    G = dro.lipschitz_surrogate(W, kind)
    grads = torch.autograd.grad(G.sum(), tree_leaves(W),
                                materialize_grads=True)
    for c in range(C):
        w_c = jax.tree.map(lambda l: jnp.asarray(l[c]), W_np)
        want, want_g = jax.value_and_grad(
            lambda p: r.dro.lipschitz_surrogate(p, kind))(w_c)
        np.testing.assert_allclose(float(G[c].detach()), float(want),
                                   rtol=1e-5)
        for g, wg in zip(grads, jax.tree.leaves(want_g)):
            np.testing.assert_allclose(g[c].numpy(), np.asarray(wg),
                                       rtol=1e-4, atol=1e-6)


def test_dro_radius_and_privacy_scalars_match_reference(reference):
    r = reference
    fed, rfed = FedConfig(), r.configs.FedConfig()
    for n, d in [(100, 23), (1, 46), (1200, 2)]:
        assert dro.eta_radius(n, d, fed) == r.dro.eta_radius(n, d, rfed)
    assert privacy.gaussian_c3(46, 1e-5, 0.05) \
        == r.privacy.gaussian_c3(46, 1e-5, 0.05)
    eps = np.array([0.0, 1e-3, 0.5, 3.0, 40.0], np.float32)
    te = torch.from_numpy(eps)
    np.testing.assert_array_equal(
        privacy.sigma_for_eps(te, 2.5).numpy(),
        np.asarray(r.privacy.sigma_for_eps(jnp.asarray(eps), 2.5)))
    np.testing.assert_array_equal(
        privacy.eps_feasible(te, fed).numpy(),
        np.asarray(r.privacy.eps_feasible(jnp.asarray(eps), rfed)))
    np.testing.assert_allclose(
        dro.rho(te, 100, 23, 2.5, fed).numpy(),
        np.asarray(r.dro.rho(jnp.asarray(eps), 100, 23, 2.5, rfed)),
        rtol=1e-7)
    hist = np.array([1.5, 2.0, 0.7], np.float32)
    np.testing.assert_allclose(
        privacy.privacy_accountant(hist, 1e-5),
        r.privacy.privacy_accountant(jnp.asarray(hist), 1e-5), rtol=1e-6)


def test_perturb_inputs_draws_from_the_generator():
    x = torch.rand(3, 500, 7)
    eps = torch.tensor([0.5, 2.0, 1e-4])
    assert torch.equal(privacy.perturb_inputs(torch.Generator(), x, eps,
                                              0.0), x)
    a = privacy.perturb_inputs(torch.Generator().manual_seed(1), x, eps, 0.3)
    b = privacy.perturb_inputs(torch.Generator().manual_seed(1), x, eps, 0.3)
    assert torch.equal(a, b)
    # sigma = c3 / max(eps, eps_min), per client row
    for c, sigma in enumerate([0.6, 0.15, 0.3 / 1e-2]):
        assert abs(float((a[c] - x[c]).std()) / sigma - 1) < 0.05


def test_eps_ledger_matches_reference(reference):
    r = reference
    led, rled = privacy.EpsLedger(5), r.privacy.EpsLedger(5)
    for ids, eps in [([0, 2, 2], [1.0, 0.5, 0.7]), ([4], [3.0]), ([], [])]:
        led.record(ids, eps)
        rled.record(ids, eps)
    assert led.totals(1e-5) == rled.totals(1e-5)
    np.testing.assert_array_equal(led.advanced(1e-5), rled.advanced(1e-5))
    fresh = privacy.EpsLedger(5)
    fresh.load_state_dict(led.state_dict())
    assert fresh.totals(1e-5) == led.totals(1e-5)
    with pytest.raises(ValueError, match="out of range"):
        led.record([5], [1.0])


@pytest.mark.parametrize("attack", ["none", "sign_flip", "same_value",
                                    "scaled", "zero", "alie",
                                    "traffic_shift"])
def test_deterministic_attacks_match_reference(reference, attack):
    r = reference
    W_np, _ = _ref_stack(r, seed=2)
    mask = np.array([False, True, False, True])
    want = r.byzantine.apply_attack(attack, jax.random.PRNGKey(0),
                                    jax.tree.map(jnp.asarray, W_np),
                                    jnp.asarray(mask), scale=3.0)
    got = byzantine.apply_attack(attack, torch.Generator(),
                                 params_from_numpy(W_np, device="cpu"),
                                 torch.from_numpy(mask), scale=3.0)
    tol = 1e-6 if attack == "alie" else 0.0
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)
    x = np.random.RandomState(0).rand(C, 5, 22).astype(np.float32)
    y = x[..., :3].copy()
    rb = r.byzantine.poison_batch(attack, (x, y), jnp.asarray(mask),
                                  shift=4)
    pb = byzantine.poison_batch(attack, (torch.from_numpy(x),
                                         torch.from_numpy(y)),
                                torch.from_numpy(mask), shift=4)
    for g, w in zip(pb, rb):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gaussian_attack_replaces_only_byzantine_rows():
    W = {"l0": {"b": torch.zeros(C, 50), "w": torch.ones(C, 40, 50)}}
    mask = byzantine.byz_mask(C, 2)
    assert mask.tolist() == [False, False, True, True]
    out = byzantine.apply_attack("gaussian",
                                 torch.Generator().manual_seed(0), W, mask,
                                 scale=10.0)
    assert torch.equal(out["l0"]["w"][:2], W["l0"]["w"][:2])
    assert abs(float(out["l0"]["w"][2:].std()) / 10.0 - 1) < 0.05
    with pytest.raises(ValueError, match="unknown attack"):
        byzantine.apply_attack("bogus", torch.Generator(), W, mask)


@pytest.mark.parametrize("decay", ["constant", "hinge", "poly"])
def test_staleness_decay_and_reg_decay_match_reference(reference, decay):
    r = reference
    fed = FedConfig(staleness_decay=decay, staleness_hinge_b=2.0)
    rfed = r.configs.FedConfig(staleness_decay=decay, staleness_hinge_b=2.0)
    d = np.array([-1.0, 0.0, 1.0, 2.0, 3.0, 17.0], np.float32)
    np.testing.assert_allclose(
        bafdp.staleness_weights(torch.from_numpy(d), fed).numpy(),
        np.asarray(r.bafdp.staleness_weights(jnp.asarray(d), rfed)),
        rtol=1e-6)
    for t in (0, 1, 41):
        np.testing.assert_allclose(
            float(bafdp.reg_decay(1e-3, torch.tensor(t, dtype=torch.int32),
                                  0.25)),
            float(r.bafdp.reg_decay(1e-3, jnp.int32(t), 0.25)), rtol=1e-6)
    with pytest.raises(ValueError, match="staleness_decay"):
        bafdp.staleness_weights(torch.from_numpy(d),
                                FedConfig(staleness_decay="bogus"))


@pytest.mark.parametrize("mode", ["global", "per_client"])
def test_compensate_stale_matches_reference(reference, mode):
    r = reference
    W_np, _ = _ref_stack(r, seed=3)
    comp_np, _ = _ref_stack(r, seed=4)
    age = np.array([0.0, 1.0, 3.0, 30.0], np.float32)
    fed = FedConfig(compensation_scale_mode=mode, compensation_ref=0.5)
    rfed = r.configs.FedConfig(compensation_scale_mode=mode,
                               compensation_ref=0.5)
    want = r.bafdp.compensate_stale(W_np, comp_np, jnp.asarray(age), rfed)
    got = bafdp.compensate_stale(params_from_numpy(W_np, device="cpu"),
                                 params_from_numpy(comp_np, device="cpu"),
                                 torch.from_numpy(age), fed)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_internal_samplers():
    gen = torch.Generator().manual_seed(0)
    for frac in (0.1, 0.6, 1.0):
        m = bafdp.active_mask(gen, 10, frac)
        assert m.dtype == torch.bool and int(m.sum()) == max(1, round(
            10 * frac))
    age = torch.tensor([0, 9, 0, 5, 12, 0, 0, 1, 0, 0])
    for _ in range(5):
        m = bafdp.active_mask_age_aware(gen, 10, 0.3, age, 5)
        # the three overdue clients (age >= 5) are admitted first
        assert m.nonzero().flatten().tolist() == [1, 3, 4]
    assert bafdp.default_age_threshold(10, 0.6) == 4


def test_federated_run_loop_contract():
    calls = []

    def step(state, batch, gen, **kw):
        calls.append((batch, kw, torch.rand((), generator=gen).item()))
        return state + 1, {"loss": torch.tensor(float(state))}

    run = FederatedRun(step=step, rounds=5, start=2, device="cpu",
                       round_kwargs=lambda t: {"act": t})
    state, hist = run.run(0, lambda t: t, seed=3, collect=("loss", "gap"),
                          derive={"gap": lambda s, m: s * 10},
                          skip_missing=True)
    assert state == 3 and [c[0] for c in calls] == [2, 3, 4]
    assert [c[1] for c in calls] == [{"act": 2}, {"act": 3}, {"act": 4}]
    assert hist == {"loss": [0.0, 1.0, 2.0], "gap": [10, 20, 30]}
    # round generators depend on (seed, t) only
    again = torch.rand((), generator=round_generator(3, 2, "cpu")).item()
    assert again == calls[0][2]
    _, hist = run.run(0, lambda t: t, seed=3, collect=("nope",),
                      skip_missing=True)
    assert all(np.isnan(hist["nope"]))
    with pytest.raises(KeyError, match="nope"):
        run.run(0, lambda t: t, seed=3, collect=("nope",))
    sched = build_schedule(1, DelayModel(n_clients=3), SyncTrigger())
    with pytest.raises(ValueError, match="pass either schedule or "
                                         "round_kwargs"):
        FederatedRun(step=step, rounds=1, schedule=sched,
                     round_kwargs=lambda t: {}).run(0, None, 0)
    with pytest.raises(ValueError, match="seed"):
        FederatedRun(step=step, rounds=1, device="cpu").run(0, None)
