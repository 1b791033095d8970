"""The port's active-subset round (``bafdp_round_sparse``) against the
reference's, and its bit-for-bit contracts inside the port.

* Port vs reference: 3 rounds from the reference's own initial state,
  ``input_sigma=0``, padded rows in a shuffled order with padding and a
  negative id (and FedBuff duplicates in one config).  Tolerance rtol 2e-5
  / atol 1e-6, the bound of ``test_torch_round.py``: the frameworks order
  f32 matmul and reduction sums differently, a few ulp per round.
* Inside the port, bit for bit: the dense ``"active"``-scope round (the
  sparse round over the full-width masked block) against the gathered
  round over the reference's equivalence grid and under every attack,
  with LDP noise on; row order; streamed against materialized folds;
  FedBuff duplicates (last delivery wins).
* The C=1,000,000 smoke: exactly the S delivered rows move, and no aten
  op outputs a (C, >= 3) tensor other than the in-place write-backs (the
  counterpart of the reference's ``MemoryContractRule``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from test_torch_reference import (  # noqa: F401  (fixture)
    assert_states_close, port_state_arrays, ref_state_arrays, reference)

from repro_torch.configs import FedConfig, ForecastConfig
from repro_torch.core import bafdp
from repro_torch.core import byzantine as byz_lib
from repro_torch.core.byzantine import byz_mask
from repro_torch.core.fed_state import (fed_state_from_numpy,
                                        gather_clients, init_fed_state,
                                        scatter_clients)
from repro_torch.core.privacy import gaussian_c3, perturb_inputs
from repro_torch.kernels import ref as kref
from repro_torch.models.forecasting import init_forecaster, mse_loss
from repro_torch.tree import tree_leaves

CFG = ForecastConfig(hidden=(16, 8), horizon=1)
C, SMAX, B, ROUNDS = 6, 5, 8, 3
RTOL, ATOL = 2e-5, 1e-6


# ---------------------------------------------------------------------------
# port vs reference
# ---------------------------------------------------------------------------
REF_GRID = {
    "f32-poly-adam": dict(staleness_decay="poly", omega_optimizer="adam"),
    "int8-hinge": dict(sign_message="int8", staleness_decay="hinge",
                       staleness_hinge_b=0.0),
    "int8-dualint8": dict(sign_message="int8", dual_message="int8",
                          staleness_decay="poly"),
    "stream2-f32": dict(staleness_decay="poly", consensus_streaming=True,
                        consensus_chunk=2),
    "stream3-int8-dualint8": dict(staleness_decay="poly",
                                  sign_message="int8", dual_message="int8",
                                  consensus_streaming=True,
                                  consensus_chunk=3),
    "taylor-per_client": dict(staleness_decay="poly",
                              staleness_compensation="taylor",
                              compensation_scale_mode="per_client",
                              omega_optimizer="adam"),
    "fedbuff-dups": dict(staleness_decay="poly", fedbuff_lr_norm=True),
}
# each case's seed: its index in the sorted grid above, then 100 on
REF_SEEDS = {name: i for i, name in enumerate(sorted(REF_GRID))}
# every robust_consensus rule under sign_flip at 0.3, on both wires
REF_GRID.update({f"robust-{rule}-{wire}": dict(
    attack="sign_flip", byzantine_frac=0.3, robust_consensus=rule,
    robust_trim_frac=0.35, robust_clip_tau=0.5, sign_message=wire,
    staleness_decay="poly", omega_optimizer="adam")
    for rule in ("trimmed_mean", "median", "krum", "centered_clip")
    for wire in ("f32", "int8")})
# the deterministic attacks without a rule
REF_GRID.update({f"attack-{a}": dict(attack=a, byzantine_frac=0.3,
                                     attack_scale=3.0,
                                     staleness_decay="poly")
                 for a in ("same_value", "scaled", "zero", "alie",
                           "label_flip", "traffic_shift")})
REF_SEEDS.update({name: 100 + i for i, name in
                  enumerate(n for n in REF_GRID if n not in REF_SEEDS)})


def _ref_rows(seed, dups: bool):
    """Per round: padded (idx, stale, weight) in a shuffled order with the
    sentinel C, a negative id, and (``dups``) a FedBuff duplicate; and the
    per-client batches."""
    rng = np.random.RandomState(seed)
    rows = []
    for t in range(ROUNDS):
        ids = list(rng.choice(C, 3, replace=False))
        if dups:
            ids.append(ids[0])                   # a second delivery
        idx = np.asarray(ids + [-1] + [C] * (SMAX + 1 - len(ids) - 1),
                         np.int32)[:SMAX + 1]
        weight = np.ones(idx.size, np.float32)
        weight[idx == C] = 0.0
        stale = rng.randint(0, 5, idx.size).astype(np.float32)
        p = rng.permutation(idx.size)
        rows.append((idx[p], stale[p], weight[p]))
    batches = [(rng.rand(C, B, CFG.d_x).astype(np.float32),
                rng.rand(C, B, CFG.d_y).astype(np.float32))
               for _ in range(ROUNDS)]
    return rows, batches


def _run_reference(r, knobs, rows, batches):
    fed = r.configs.FedConfig(n_clients=C, consensus_scope="active",
                              **knobs)
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
        r.bafdp.bafdp_round_sparse, local_loss=local_loss, fed=fed, c3=c3,
        n_samples=100, d_dim=CFG.d_x + CFG.d_y,
        byz_mask=r.byzantine.byz_mask(C, fed.n_byzantine)))
    states, metrics = [], []
    for t, (idx, stale, weight) in enumerate(rows):
        state, m = step(state, tuple(map(jnp.asarray, batches[t])),
                        jax.random.PRNGKey(t), idx=jnp.asarray(idx),
                        stale=jnp.asarray(stale), weight=jnp.asarray(weight))
        states.append(ref_state_arrays(state))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return init, states, metrics


def _port_loss(fed, sigma, cfg=CFG):
    def local_loss(W, batch, gen, eps):
        x, y = batch
        return mse_loss(W, perturb_inputs(gen, x, eps, sigma, fed.eps_min),
                        y, cfg)
    return local_loss


def _run_port(knobs, init, rows, batches):
    fed = FedConfig(n_clients=C, consensus_scope="active", **knobs)
    c3 = gaussian_c3(CFG.d_x + CFG.d_y, fed.dp_delta, 0.05)
    state = fed_state_from_numpy(init, device="cpu")
    step = functools.partial(
        bafdp.bafdp_round_sparse, local_loss=_port_loss(fed, 0.0), fed=fed,
        c3=c3, n_samples=100, d_dim=CFG.d_x + CFG.d_y,
        byz_mask=byz_mask(C, fed.n_byzantine))
    states, metrics = [], []
    for t, (idx, stale, weight) in enumerate(rows):
        batch = tuple(torch.from_numpy(a) for a in batches[t])
        state, m = step(state, batch, torch.Generator().manual_seed(t),
                        idx=idx, stale=stale, weight=weight)
        states.append(port_state_arrays(state))
        metrics.append({k: v.numpy() for k, v in m.items()})
    return states, metrics


@pytest.mark.parametrize("name", sorted(REF_GRID))
def test_sparse_round_matches_reference(reference, name):
    knobs = REF_GRID[name]
    rows, batches = _ref_rows(REF_SEEDS[name], dups=name == "fedbuff-dups")
    init, ref_states, ref_metrics = _run_reference(reference, knobs, rows,
                                                   batches)
    states, metrics = _run_port(knobs, init, rows, batches)
    for t in range(ROUNDS):
        assert_states_close(states[t], ref_states[t], rtol=RTOL, atol=ATOL)
        assert sorted(metrics[t]) == sorted(ref_metrics[t])
        for k in metrics[t]:
            np.testing.assert_allclose(
                metrics[t][k], ref_metrics[t][k], rtol=RTOL, atol=ATOL,
                err_msg=f"round {t} metric {k}")


def test_streamed_folds_match_reference(reference):
    """The streamed folds against the reference's, and bit for bit against
    the port's materialized folds at every chunk size."""
    r = reference
    rng = np.random.RandomState(0)
    X = rng.randn(7, 33).astype(np.float32)
    X[2] = X[1]                                   # a tie with z below
    w = np.asarray([1, 0.5, 0, 1, 0.25, 0, 1], np.float32)
    z = X[1].copy()
    phi = (rng.randn(33) * 0.01).astype(np.float32)
    Xt, wt, zt, pt = map(torch.from_numpy, (X, w, z, phi))
    plain = kref.fold_weighted_rowsum(Xt, wt)
    dual = kref.fold_dual_rowsum(Xt, wt)
    signs = {"f32": kref.sign_agg_fold_ref(zt, Xt, pt, wt, 0.005, 0.01, 9)}
    from repro_torch.distributed import collectives
    msg = collectives.encode_sign_message(zt, Xt, wt)
    signs["int8"] = kref.sign_agg_int8_fold_ref(zt, msg.payload, msg.scale,
                                                pt, 0.005, 0.01, 9)
    assert torch.equal(signs["f32"], signs["int8"])
    for chunk in (1, 2, 3, 7, 10):
        assert torch.equal(kref.fold_weighted_rowsum_stream(Xt, wt, chunk),
                           plain)
        assert torch.equal(kref.fold_dual_rowsum(Xt, wt, chunk), dual)
        for m in ("f32", "int8"):
            got = kref.sign_agg_fold_stream_ref(zt, Xt, pt, wt, 0.005, 0.01,
                                                9, chunk, message=m)
            assert torch.equal(got, signs[m]), (chunk, m)
            want = r.ref.sign_agg_fold_stream_ref(
                jnp.asarray(z), jnp.asarray(X), jnp.asarray(phi),
                jnp.asarray(w), 0.005, 0.01, 9, chunk, message=m)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            kref.fold_dual_rowsum(Xt, wt, chunk).numpy(),
            np.asarray(r.ref.fold_dual_rowsum(jnp.asarray(X),
                                              jnp.asarray(w), chunk)),
            rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="chunk_size"):
        kref.fold_weighted_rowsum_stream(Xt, wt, 0)


@pytest.mark.parametrize("message", ["f32", "int8"])
def test_sign_consensus_streaming_matches_reference(reference, message):
    """The one-leaf ``ops.sign_consensus(streaming=True)`` against the
    reference's streamed dispatch, and bit for bit against the port's
    materialized ``n_total`` fold at every chunk size; streaming without
    ``n_total`` raises as the reference does."""
    from repro_torch.kernels import ops
    r = reference
    rng = np.random.RandomState(1)
    X = rng.randn(6, 40).astype(np.float32)
    X[3] = X[0]
    w = np.asarray([1, 0.5, 0, 1, 0.25, 0], np.float32)
    z = X[0].copy()
    phi = (rng.randn(40) * 0.01).astype(np.float32)
    Xt, wt, zt, pt = map(torch.from_numpy, (X, w, z, phi))
    want = ops.sign_consensus(zt, Xt, pt, wt, 0.005, 0.01, message=message,
                              n_total=11)
    for chunk in (1, 2, 4, 6, 9):
        got = ops.sign_consensus(zt, Xt, pt, wt, 0.005, 0.01,
                                 message=message, n_total=11,
                                 streaming=True, chunk_size=chunk)
        assert torch.equal(got, want), chunk
        ref_z = r.ops.sign_consensus(
            jnp.asarray(z), jnp.asarray(X), jnp.asarray(phi), jnp.asarray(w),
            0.005, 0.01, message=message, n_total=11, streaming=True,
            chunk_size=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_z),
                                   rtol=1e-6, atol=1e-7)
    for mod, arr in ((ops, torch.from_numpy), (r.ops, jnp.asarray)):
        with pytest.raises(ValueError, match="needs n_total"):
            mod.sign_consensus(arr(z), arr(X), arr(phi), arr(w), 0.005,
                               0.01, message=message, streaming=True)


# ---------------------------------------------------------------------------
# inside the port: the dense active-scope round against the gathered one
# ---------------------------------------------------------------------------
def make_problem(fed, seed=0, sigma=0.02):
    """(state, batch, dense_step, sparse_step): both with
    consensus_scope='active' (the dense one is the masked oracle)."""
    fed = dataclasses.replace(fed, consensus_scope="active")
    gen = torch.Generator().manual_seed(seed)
    state = init_fed_state(gen, lambda g: init_forecaster(g, CFG), fed,
                           device="cpu")
    X = torch.randn(fed.n_clients, B, CFG.d_x, generator=gen)
    Y = torch.sum(X[..., :3], -1, keepdim=True) * 0.5
    c3 = gaussian_c3(CFG.d_x + CFG.d_y, fed.dp_delta, fed.dp_sensitivity)
    kw = dict(local_loss=_port_loss(fed, sigma), fed=fed, c3=c3,
              n_samples=200, d_dim=CFG.d_x + CFG.d_y,
              byz_mask=byz_mask(fed.n_clients, fed.n_byzantine))
    return (state, (X, Y), functools.partial(bafdp.bafdp_round, **kw),
            functools.partial(bafdp.bafdp_round_sparse, **kw))


def draw_round(rng, force=None):
    """A duplicate-free round: (mask, (C,) ages, permuted padded rows)."""
    mask = rng.rand(C) < 0.6
    if force is not None:
        mask[force] = True
    if not mask.any():
        mask[rng.randint(C)] = True
    i = np.flatnonzero(mask)[:SMAX]
    if force is not None and force not in i:
        i[-1] = force
    mask = np.zeros(C, bool)
    mask[i] = True
    ages = rng.randint(0, 6, i.size)
    idx = np.full(SMAX, C, np.int32)
    stale = np.zeros(SMAX, np.float32)
    weight = np.zeros(SMAX, np.float32)
    perm = rng.permutation(i.size)
    idx[:i.size] = i[perm]
    stale[:i.size] = ages[perm]
    weight[:i.size] = 1.0
    stale_c = np.zeros(C, np.float32)
    stale_c[i[perm]] = ages[perm]
    return mask, stale_c, (idx, stale, weight)


def snapshot(state) -> list:
    return [l.clone() for f in state if f is not None
            for l in tree_leaves(f)]


def assert_states_equal(a, b, msg=""):
    la, lb = snapshot(a), snapshot(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (msg, i)
        assert torch.equal(x, y), (
            f"{msg} leaf {i}: max diff {float((x - y).abs().max())}")


GRID = [dict(staleness_decay=d, staleness_compensation=c, sign_message=m,
             omega_optimizer=o)
        for d in ("constant", "hinge", "poly")
        for c in ("none", "taylor")
        for m in ("f32", "int8")
        for o in ("sgd", "adam")]
GRID += [dict(staleness_decay=d, staleness_compensation="taylor",
              sign_message="int8", omega_optimizer=o, fedbuff_lr_norm=True)
         for d in ("constant", "poly") for o in ("sgd", "adam")]
GRID += [dict(staleness_decay=d, staleness_compensation=c, sign_message=m,
              dual_message="int8", omega_optimizer="sgd")
         for d in ("constant", "poly")
         for c in ("none", "taylor")
         for m in ("f32", "int8")]
GRID += [dict(staleness_decay="poly", staleness_compensation="taylor",
              sign_message=m, dual_message=dm, omega_optimizer="sgd",
              consensus_streaming=True, consensus_chunk=cs)
         for m in ("f32", "int8")
         for dm in ("f32", "int8")
         for cs in (2, 3)]
GRID += [dict(staleness_decay=d, staleness_compensation="taylor",
              sign_message=m, omega_optimizer="sgd",
              compensation_scale_mode="per_client")
         for d in ("constant", "poly") for m in ("f32", "int8")]


def _parity(fed, rng, rounds=3, force=None, msg=""):
    state, batch, dense, sparse = make_problem(fed)
    sd = sa = state
    for t in range(rounds):
        mask, stale_c, (idx, stale, weight) = draw_round(rng, force)
        sd, md = dense(sd, batch, torch.Generator().manual_seed(50 + t),
                       act=mask, stale=stale_c)
        sa, ms = sparse(sa, batch, torch.Generator().manual_seed(50 + t),
                        idx=idx, stale=stale, weight=weight)
        assert_states_equal(sd, sa, f"{msg} round {t}")
        assert sorted(md) == sorted(ms)
        for k in md:
            assert torch.equal(md[k], ms[k]), (msg, t, k)
    assert np.isfinite(float(ms["loss"]))


@pytest.mark.parametrize(
    "fed_kw", GRID, ids=["-".join(str(v) for v in g.values()) for g in GRID])
def test_dense_sparse_bit_parity(fed_kw):
    """The gathered round equals the masked full-width round bit for bit,
    state and metrics, over 3 rounds with shuffled padded rows, nonzero
    admission ages and LDP noise on."""
    _parity(FedConfig(n_clients=C, active_frac=0.5, **fed_kw),
            np.random.RandomState(7))


@pytest.mark.parametrize("attack",
                         [a for a in byz_lib.ATTACKS if a != "none"])
def test_dense_sparse_bit_parity_under_attack(attack):
    """Every attack, the randomized ones included: gaussian draws key off
    (round seed, leaf, client id) and alie's statistics read only the
    delivered rows.  A Byzantine client delivers every round."""
    fed = FedConfig(n_clients=C, active_frac=0.5, attack=attack,
                    byzantine_frac=1 / 3, attack_scale=3.0,
                    staleness_decay="poly", staleness_compensation="taylor")
    _parity(fed, np.random.RandomState(11), force=C - 1, msg=attack)


@pytest.mark.parametrize("attack", ["sign_flip", "same_value"])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median", "krum",
                                  "centered_clip"])
def test_dense_sparse_bit_parity_robust_consensus(rule, attack):
    """Every robust rule runs through the one shared code path: the
    aggregate comes from weight-masked block statistics, so the masked
    dense round and the gathered round stay bit-identical."""
    fed = FedConfig(n_clients=C, active_frac=0.5, attack=attack,
                    byzantine_frac=1 / 3, attack_scale=3.0,
                    robust_consensus=rule, robust_clip_tau=0.5,
                    staleness_decay="hinge", staleness_hinge_b=0.0)
    _parity(fed, np.random.RandomState(23), force=C - 1,
            msg=f"{rule} under {attack}")


def test_randomized_attacks_depend_on_the_client_not_the_row():
    """A client's gaussian draw is the same in a full block and a gathered
    one; alie's statistics ignore zero-weight rows."""
    gen = torch.Generator().manual_seed(4)
    honest = {"a": torch.randn(6, 3, 2), "b": torch.randn(6, 5)}
    full = byz_lib.corrupt("gaussian", gen, honest, scale=2.0,
                           client_ids=np.arange(6))
    part = byz_lib.corrupt("gaussian", gen, {k: v[[4, 1]] for k, v in
                                             honest.items()},
                           scale=2.0, client_ids=[4, 1])
    for k in honest:
        assert torch.equal(full[k][[4, 1]], part[k])
    w = torch.tensor([1.0, 0, 1, 0, 1, 0])
    masked = byz_lib.corrupt("alie", gen, honest, weight=w)
    kept = byz_lib.corrupt("alie", gen, {k: v[[0, 2, 4]] for k, v in
                                         honest.items()})
    for k in honest:
        assert torch.equal(masked[k][0], kept[k][0])
    with pytest.raises(ValueError, match="client_ids"):
        byz_lib.corrupt("gaussian", gen, honest, client_ids=[0, 1])


def test_row_order_invariance():
    """Any permutation of the padded rows, padding in the middle included,
    gives the identical state."""
    fed = FedConfig(n_clients=C, active_frac=0.5, staleness_decay="poly",
                    staleness_compensation="taylor", omega_optimizer="adam")
    state, batch, _, sparse = make_problem(fed)
    idx0 = np.asarray([0, 2, 5, C, C], np.int32)
    stale0 = np.asarray([4, 1, 2, 0, 0], np.float32)
    w0 = np.asarray([1, 1, 1, 0, 0], np.float32)

    def after(p):
        out, _ = sparse(bafdp._clone_state(state), batch,
                        torch.Generator().manual_seed(3), idx=idx0[p],
                        stale=stale0[p], weight=w0[p])
        return out

    want = after(np.arange(SMAX))
    rng = np.random.RandomState(0)
    for _ in range(4):
        p = rng.permutation(SMAX)
        assert_states_equal(want, after(p), f"perm {p}")


def test_streaming_round_bit_identical_to_materialized():
    """consensus_streaming=True reproduces the materialized round bit for
    bit at every chunk size."""
    base = FedConfig(n_clients=C, active_frac=0.5, staleness_decay="poly",
                     staleness_compensation="taylor", sign_message="int8",
                     dual_message="int8")
    rounds = [draw_round(np.random.RandomState(21))[2] for _ in range(3)]

    def run(**kw):
        state, batch, _, sparse = make_problem(
            dataclasses.replace(base, **kw))
        for t, (idx, stale, weight) in enumerate(rounds):
            state, _ = sparse(state, batch, torch.Generator().manual_seed(t),
                              idx=idx, stale=stale, weight=weight)
        return state

    want = run()
    for chunk in (1, 2, 3, SMAX, SMAX + 3):
        assert_states_equal(want, run(consensus_streaming=True,
                                      consensus_chunk=chunk), f"{chunk}")


def test_sparse_round_consumes_its_state_and_dense_keeps_its_own():
    """The sparse round writes into the state it is given; the dense
    active-scope round runs it on a copy."""
    fed = FedConfig(n_clients=C, active_frac=0.5)
    state, batch, dense, sparse = make_problem(fed)
    before = snapshot(state)
    mask, stale_c, (idx, stale, weight) = draw_round(
        np.random.RandomState(1))
    dense(state, batch, torch.Generator().manual_seed(0), act=mask,
          stale=stale_c)
    for x, y in zip(before, snapshot(state)):
        assert torch.equal(x, y)
    out, _ = sparse(state, batch, torch.Generator().manual_seed(0),
                    idx=idx, stale=stale, weight=weight)
    assert out.W["l0"]["w"] is state.W["l0"]["w"]
    w_before = before[1]                         # W/l0/w, sorted-key order
    moved = torch.any((state.W["l0"]["w"] != w_before).reshape(C, -1),
                      dim=1)
    assert moved.nonzero().flatten().tolist() == sorted(
        int(i) for i in idx if i < C)


def test_fedbuff_duplicate_left_fold():
    """A duplicate delivery enters the Eq. (20) fold with its own decay
    weight, in arrival order; the write-back equals the dedup'd round's;
    n_active counts the duplicate."""
    fed = FedConfig(n_clients=C, active_frac=0.5, staleness_decay="poly")
    state, batch, _, sparse = make_problem(fed)
    gen = torch.Generator().manual_seed(0)
    out_dup, m_dup = sparse(bafdp._clone_state(state), batch, gen,
                            idx=np.asarray([2, 5, 2, C, C]),
                            stale=np.asarray([3, 1, 0, 0, 0], np.float32),
                            weight=np.asarray([1, 1, 1, 0, 0], np.float32))
    out_ded, m_ded = sparse(bafdp._clone_state(state), batch, gen,
                            idx=np.asarray([2, 5, C, C, C]),
                            stale=np.asarray([3, 1, 0, 0, 0], np.float32),
                            weight=np.asarray([1, 1, 0, 0, 0], np.float32))
    assert float(m_dup["n_active"]) == 3.0
    assert float(m_ded["n_active"]) == 2.0
    assert not torch.equal(tree_leaves(out_dup.z)[0],
                           tree_leaves(out_ded.z)[0])
    for field in ("W", "eps", "tau"):
        for a, b in zip(tree_leaves(getattr(out_dup, field)),
                        tree_leaves(getattr(out_ded, field))):
            assert torch.equal(a, b), field
    # the consensus value: the fold over the sorted deliveries
    # [2 (age 3), 2 (age 0), 5 (age 1)]
    rows = torch.tensor([2, 2, 5])
    s_w = bafdp.staleness_weights(torch.tensor([3.0, 0.0, 1.0]), fed)
    for z0, zd, w_l, p_l in zip(tree_leaves(state.z), tree_leaves(out_dup.z),
                                tree_leaves(out_dup.W),
                                tree_leaves(state.phi)):
        phi_m = kref.true_div(kref.fold_weighted_rowsum(
            p_l[rows].reshape(3, -1), torch.ones(3)), C)
        want = kref.sign_agg_fold_ref(z0.reshape(-1),
                                      w_l[rows].reshape(3, -1), phi_m, s_w,
                                      fed.psi, fed.alpha_z, C)
        assert torch.equal(zd.reshape(-1), want)


def test_duplicate_last_delivery_wins_with_per_delivery_batches():
    """With batch_gathered=True duplicate deliveries carry their own data,
    and the write-back keeps the last delivery's update."""
    fed = FedConfig(n_clients=C, active_frac=0.5)
    state, (X, Y), _, sparse = make_problem(fed, sigma=0.0)
    g = torch.Generator().manual_seed(9)
    Xa, Xb = torch.randn(B, CFG.d_x, generator=g), torch.randn(
        B, CFG.d_x, generator=g)
    Yd, pad_x = torch.zeros(B, 1), torch.zeros(B, CFG.d_x)
    pad_y = torch.zeros(B, 1)

    def run(xs, ys, idx, stale, weight):
        out, _ = sparse(bafdp._clone_state(state),
                        (torch.stack(xs), torch.stack(ys)),
                        torch.Generator().manual_seed(0),
                        idx=np.asarray(idx), stale=np.asarray(stale,
                                                              np.float32),
                        weight=np.asarray(weight, np.float32),
                        batch_gathered=True)
        return out

    out = run([Xa, Xb, X[4], pad_x, pad_x], [Yd, Yd, Y[4], pad_y, pad_y],
              [2, 2, 4, C, C], [3, 0, 0, 0, 0], [1, 1, 1, 0, 0])
    only_b = run([Xb, X[4], pad_x, pad_x, pad_x],
                 [Yd, Y[4], pad_y, pad_y, pad_y],
                 [2, 4, C, C, C], [0, 0, 0, 0, 0], [1, 1, 0, 0, 0])
    only_a = run([Xa, X[4], pad_x, pad_x, pad_x],
                 [Yd, Y[4], pad_y, pad_y, pad_y],
                 [2, 4, C, C, C], [3, 0, 0, 0, 0], [1, 1, 0, 0, 0])
    for a, b, c in zip(tree_leaves(out.W), tree_leaves(only_b.W),
                       tree_leaves(only_a.W)):
        assert torch.equal(a[2], b[2]), "the last delivery must win"
        assert not torch.equal(b[2], c[2])


def test_negative_idx_is_padding():
    fed = FedConfig(n_clients=C, active_frac=0.5)
    state, batch, _, sparse = make_problem(fed)
    gen = torch.Generator().manual_seed(0)
    out_neg, m_neg = sparse(bafdp._clone_state(state), batch, gen,
                            idx=np.asarray([-1, 3, 5, C, C]),
                            weight=np.asarray([1, 1, 1, 0, 0], np.float32))
    out_ref, m_ref = sparse(bafdp._clone_state(state), batch, gen,
                            idx=np.asarray([3, 5, C, C, C]),
                            weight=np.asarray([1, 1, 0, 0, 0], np.float32))
    assert_states_equal(out_neg, out_ref, "negative idx")
    assert float(m_neg["n_active"]) == float(m_ref["n_active"]) == 2.0


def test_fedbuff_lr_norm_counts_duplicates_natively():
    fed = FedConfig(n_clients=C, active_frac=0.5, fedbuff_lr_norm=True)
    state, batch, _, sparse = make_problem(fed)
    kw = dict(idx=np.asarray([1, 4, 1, C, C]),
              stale=np.asarray([2, 0, 0, 0, 0], np.float32),
              weight=np.asarray([1, 1, 1, 0, 0], np.float32))

    def run(**more):
        out, _ = sparse(bafdp._clone_state(state), batch,
                        torch.Generator().manual_seed(0), **kw, **more)
        return out

    out_def = run()
    assert_states_equal(out_def, run(arrivals=np.int32(3)), "K = sum(w)")
    assert not torch.equal(tree_leaves(out_def.z)[0],
                           tree_leaves(run(arrivals=np.int32(2)).z)[0])


def test_batch_gathered_disambiguation():
    fed = FedConfig(n_clients=C, active_frac=0.5)
    state, (X, Y), _, sparse = make_problem(fed)
    w = np.asarray([1, 1, 1, 0, 0], np.float32)

    def run(batch, idx, **kw):
        out, _ = sparse(bafdp._clone_state(state), batch,
                        torch.Generator().manual_seed(0),
                        idx=np.asarray(idx), weight=w, **kw)
        return out

    want = run((X, Y), [0, 2, 4, C, C])
    gid = [0, 2, 4, 5, 5]
    assert_states_equal(want, run((X[gid], Y[gid]), [0, 2, 4, C, C],
                                  batch_gathered=True), "pre-gathered")
    gid_u = [4, 0, 2, 5, 5]
    assert_states_equal(want, run((X[gid_u], Y[gid_u]), [4, 0, 2, C, C],
                                  batch_gathered=True), "unsorted")
    with pytest.raises(ValueError, match="batch_gathered"):
        run((X, Y), [0, 2, 4, C, C], batch_gathered=True)
    with pytest.raises(ValueError, match="batch_gathered"):
        run((X[gid], Y[gid]), [0, 2, 4, C, C], batch_gathered=False)
    with pytest.raises(ValueError, match="neither"):
        run((X[:3], Y[:3]), [0, 2, 4, C, C])


def test_block_metrics_identically_labeled():
    """Both active-scope rounds report ``_block`` statistics and
    ``metrics_k`` (the delivered weight, >= 1), never the fleet-wide keys;
    the ``"all"`` scope keeps the fleet-wide keys."""
    fed = FedConfig(n_clients=C, active_frac=0.5, staleness_decay="poly",
                    staleness_compensation="taylor")
    state, batch, dense, sparse = make_problem(fed)
    mask, stale_c, (idx, stale, weight) = draw_round(
        np.random.RandomState(5))
    _, md = dense(state, batch, torch.Generator(), act=mask, stale=stale_c)
    _, ms = sparse(state, batch, torch.Generator(), idx=idx, stale=stale,
                   weight=weight)
    fleet = ("lipschitz", "consensus_gap", "staleness_mean",
             "staleness_weight_mean", "compensation_norm")
    assert set(md) == set(ms) == {"loss", "data_loss", "eps_mean",
                                  "lambda_mean", "n_active", "metrics_k"} \
        | {f"{k}_block" for k in fleet}
    assert float(ms["metrics_k"]) == max(float(weight.sum()), 1.0)
    fed_all = FedConfig(n_clients=C, active_frac=0.5)
    state, batch, _, _ = make_problem(fed_all)
    _, m = bafdp.bafdp_round(
        state, batch, torch.Generator(), local_loss=_port_loss(fed_all, 0.0),
        fed=fed_all, c3=1.0, n_samples=200, d_dim=CFG.d_x + CFG.d_y,
        byz_mask=byz_mask(C, 0))
    for k in fleet:
        assert k in m and f"{k}_block" not in m


def test_scope_all_and_active_differ():
    """The "all" scope keeps the inactive clients' frozen messages in the
    Eq. (20) sum, so the two scopes give different z."""
    fed_all = FedConfig(n_clients=C, active_frac=0.5)
    state, batch, _, _ = make_problem(fed_all)
    kw = dict(c3=1.0, n_samples=200, d_dim=CFG.d_x + CFG.d_y,
              byz_mask=byz_mask(C, 0))
    act = np.asarray([True, False, True, False, True, False])
    out = {}
    for scope in ("all", "active"):
        fed = dataclasses.replace(fed_all, consensus_scope=scope)
        s, _ = bafdp.bafdp_round(state, batch, torch.Generator(),
                                 local_loss=_port_loss(fed, 0.0), fed=fed,
                                 act=np.ones(C, bool), **kw)
        out[scope], _ = bafdp.bafdp_round(
            s, batch, torch.Generator(), local_loss=_port_loss(fed, 0.0),
            fed=fed, act=act, **kw)
    assert not torch.equal(tree_leaves(out["all"].z)[0],
                           tree_leaves(out["active"].z)[0])


@pytest.mark.parametrize("knobs,match", [
    (dict(consensus_scope="all"), "needs consensus_scope='active'"),
    (dict(consensus_streaming=True, consensus_chunk=0),
     "consensus_chunk must be >= 1"),
    # ``geomed`` is an aggregator, not a consensus rule
    pytest.param(dict(robust_consensus="geomed"), "unknown robust_consensus",
                 id="geomed-unknown-rule"),
    (dict(staleness_compensation="bogus"), "unknown staleness_compensation"),
])
def test_sparse_round_rejects(knobs, match):
    fed = dataclasses.replace(FedConfig(n_clients=C, active_frac=0.5,
                                        consensus_scope="active"), **knobs)
    state, batch, _, _ = make_problem(FedConfig(n_clients=C))
    with pytest.raises(ValueError, match=match):
        bafdp.bafdp_round_sparse(
            state, batch, torch.Generator(), local_loss=None, fed=fed,
            c3=1.0, n_samples=10, d_dim=4, byz_mask=byz_mask(C, 0),
            idx=np.arange(3))


def test_gather_clips_and_scatter_drops_padding_in_place():
    leaf = torch.arange(12.0).reshape(4, 3)
    tree = {"a": leaf}
    got = gather_clients(tree, torch.tensor([3, 4, -1, 1]))
    assert got["a"][:, 0].tolist() == [9.0, 9.0, 0.0, 3.0]
    out = scatter_clients(tree, np.asarray([4, 0, 2, -1]),
                          {"a": torch.full((4, 3), -1.0,
                                           dtype=torch.float64)})
    assert out["a"] is leaf and leaf.dtype == torch.float32
    assert leaf[:, 0].tolist() == [-1.0, 3.0, -1.0, 9.0]
    scatter_clients(tree, np.asarray([4, 4]), {"a": torch.zeros(2, 3)})
    assert leaf[:, 0].tolist() == [-1.0, 3.0, -1.0, 9.0]


# ---------------------------------------------------------------------------
# the million-client smoke
# ---------------------------------------------------------------------------
class RowContract(TorchDispatchMode):
    """Records every aten op whose output has ``C`` rows and >= 3 inner
    elements, except the in-place write-backs (``index_copy_``)."""

    def __init__(self, n_rows: int):
        super().__init__()
        self.n_rows = n_rows
        self.violations = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is not torch.ops.aten.index_copy_.default:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.ndim >= 1 \
                        and t.shape[0] == self.n_rows \
                        and t.numel() // self.n_rows >= 3:
                    self.violations.append((str(func), tuple(t.shape)))
        return out


def _million_client_round(robust: str):
    """One sparse round at C=1,000,000, S=8, a tiny model, under the
    :class:`RowContract` mode; returns (state, W before, the mode)."""
    C_BIG, S, D = 1_000_000, 8, 8
    fed = FedConfig(n_clients=C_BIG, active_frac=S / C_BIG,
                    consensus_scope="active", omega_optimizer="sgd",
                    robust_consensus=robust)
    rng = np.random.RandomState(0)
    w = (0.01 * rng.randn(C_BIG, D)).astype(np.float32)
    zeros = np.zeros((C_BIG, D), np.float32)
    state = fed_state_from_numpy(dict(
        W={"b": np.zeros(C_BIG, np.float32), "w": w},
        z={"b": np.zeros((), np.float32), "w": w[0].copy()},
        z_local={"b": np.zeros(C_BIG, np.float32),
                 "w": np.broadcast_to(w[0], (C_BIG, D)).copy()},
        phi={"b": np.zeros(C_BIG, np.float32), "w": zeros},
        lam=np.zeros(C_BIG, np.float32), eps=np.full(C_BIG, 1.5, np.float32),
        t=np.zeros((), np.int32), tau=np.zeros(C_BIG, np.int32)),
        device="cpu")
    w_old = state.W["w"].clone()

    def local_loss(W, batch, gen, eps):
        x, y = batch
        pred = (x @ W["w"][..., None])[..., 0] + W["b"][:, None]
        return torch.mean((pred - y) ** 2, dim=-1)

    Xg = torch.from_numpy(rng.randn(S, 4, D).astype(np.float32))
    Yg = torch.sum(Xg[..., :2], -1) * 0.3
    idx = np.asarray([5, 999_999, 17, 123_456, 0, 42, 777_777, 31_337])
    stale = np.asarray([0, 3, 1, 0, 7, 0, 2, 0], np.float32)
    mode = RowContract(C_BIG)
    with mode:
        new_state, m = bafdp.bafdp_round_sparse(
            state, (Xg, Yg), torch.Generator().manual_seed(1),
            local_loss=local_loss, fed=fed, c3=1.0, n_samples=100, d_dim=D,
            byz_mask=torch.zeros(C_BIG, dtype=torch.bool), idx=idx,
            stale=stale, weight=np.ones(S, np.float32),
            batch_gathered=True)
    assert mode.violations == []
    assert int(m["n_active"]) == S and np.isfinite(float(m["loss"]))
    changed = torch.any(new_state.W["w"] != w_old, dim=1).nonzero()
    assert changed.flatten().tolist() == sorted(idx.tolist())
    assert new_state.tau[torch.from_numpy(idx)].tolist() == [0] * S
    assert int(new_state.t) == 1
    return new_state, mode


def test_million_client_round_smoke():
    """C=1,000,000, S=8, a tiny model: one sparse round moves exactly the
    S delivered rows, and no op builds a (C, D) tensor."""
    state, mode = _million_client_round("none")
    # the contract check is live: a dense (C, D) op is caught
    with mode:
        state.W["w"] + 1.0
    assert mode.violations and mode.violations[0][1] == (1_000_000, 8)


def test_million_client_round_smoke_krum():
    """The same round with ``robust_consensus="krum"``: the robust
    aggregate (pairwise distances included) reads only the gathered
    block, so no op builds a (C, D) tensor either."""
    _million_client_round("krum")
