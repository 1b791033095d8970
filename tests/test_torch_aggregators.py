"""The port's aggregators (``repro_torch.core.aggregators``) against the
reference's, and their contracts inside the port.

* Block rules (``robust_block``) vs the reference on the same numpy
  inputs, each rule with all rows valid and padded with garbage rows.
  Tolerances: trimmed mean and median exact (the sort and the selection
  are exact and the fold is the same left-fold, so the bits agree);
  krum exact on inputs whose scores are well apart (it selects a row);
  centered clip rtol 2e-5 / atol 1e-6 (norms are reductions over the
  feature axis, which the two frameworks group differently).
* Plain aggregators vs the reference: every ``AGGREGATORS`` entry, plus
  ``fedatt``, ``fedda`` and ``rsa_sign``, at rtol 2e-5 / atol 1e-6;
  ``geomed`` (64 Weiszfeld iterations, each a division by a norm) at
  rtol 1e-4 / atol 1e-5.
* Inside the port, the counterparts of the reference's unit contracts
  (``tests/test_byzantine_sparse.py``) and of its attack x aggregator
  matrix (``tests/test_robustness_matrix.py``), with the same constants.
  The matrix's ``same_value`` trimmed-mean run is also held to the
  reference's on one initial state and one data set without input noise:
  losses at rtol 1e-4.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import given, settings, st   # hypothesis or graceful skips
from test_torch_reference import one_thread
from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.core import aggregators as agg
from repro_torch.core import byzantine as byz
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map

RULES = [r for r in agg.ROBUST_CONSENSUS_RULES if r != "none"]
RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def to_jax(tree):
    return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor)
                      else tree)


def flat(tree):
    return torch.cat([l.reshape(-1).float() for l in tree_leaves(tree)])


# ---------------------------------------------------------------------------
# block rules against the reference
# ---------------------------------------------------------------------------
def _block(pad: int, seed: int = 0):
    """5 valid rows of a two-leaf tree ({"b": (R, 5), "w": (R, 4, 3)})
    interleaved with ``pad`` garbage rows (x100), and the (R,) weight.
    The valid rows sit at distinct distances along one direction, so
    krum's scores are well apart."""
    rng = np.random.RandomState(seed)
    D = 5 + 12
    u = rng.randn(D).astype(np.float32)
    Xv = (rng.randn(5, D) * 0.05 + np.outer([1, 4, 9, 16, 30], u) * 0.1
          ).astype(np.float32)
    R = 5 + pad
    X = (rng.randn(R, D) * 100).astype(np.float32)
    w = np.zeros((R,), np.float32)
    pos = np.linspace(0, R - 1, 5).astype(int)
    X[pos] = Xv
    w[pos] = 1.0
    tree = {"b": X[:, :5].copy(), "w": X[:, 5:].reshape(R, 4, 3).copy()}
    center = {"b": np.zeros(5, np.float32),
              "w": np.full((4, 3), 0.2, np.float32)}
    return tree, w, center


@pytest.mark.parametrize("pad", [0, 4])
@pytest.mark.parametrize("rule", RULES)
def test_robust_block_matches_reference(reference, rule, pad):
    tree, w, center = _block(pad)
    weight = None if pad == 0 else w
    kw = dict(trim_frac=0.2, n_byzantine=1, clip_tau=0.5, clip_iters=3)
    want = reference.aggregators.robust_block(
        rule, to_jax(tree), None if weight is None else jnp.asarray(weight),
        to_jax(center), **kw)
    got = agg.robust_block(rule, to_torch(tree),
                           None if weight is None else torch.from_numpy(w),
                           to_torch(center), **kw)
    assert sorted(got) == sorted(want)
    for k in got:
        g, r = to_numpy(got[k]), np.asarray(want[k])
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if rule == "centered_clip":
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:                                  # exact: == on every element
            np.testing.assert_array_equal(g, r, err_msg=k)


def test_krum_scores_of_the_block_are_well_apart():
    """The premise of the exact krum comparison: the best score leads the
    next one by far more than any rounding (float64 on the host)."""
    tree, w, _ = _block(0)
    X = np.concatenate([tree["b"], tree["w"].reshape(5, -1)], 1)
    d2 = ((X[:, None].astype(np.float64) - X[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    scores = np.sort(np.sort(d2, 1)[:, :2].sum(1))  # K - b - 2 = 2 nearest
    assert scores[1] - scores[0] > 1e-3 * scores[1]


@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_block_sort_places_nan_and_big_as_the_reference(reference, rule):
    """NaN sorts past the finite ``_BIG`` sentinel in both frameworks, so
    a NaN message lands in the same rank, and +-inf where the reference
    puts it."""
    tree, w, center = _block(3, seed=2)
    tree["b"][np.flatnonzero(w)[1], 2] = np.nan
    tree["b"][np.flatnonzero(w)[3], 0] = np.inf
    tree["b"][np.flatnonzero(w)[2], 4] = -np.inf
    want = reference.aggregators.robust_block(
        rule, to_jax(tree), jnp.asarray(w), to_jax(center), trim_frac=0.2)
    got = agg.robust_block(rule, to_torch(tree), torch.from_numpy(w),
                           to_torch(center), trim_frac=0.2)
    for k in got:
        np.testing.assert_array_equal(to_numpy(got[k]), np.asarray(want[k]))
    col = np.asarray([3.0, np.nan, 1e30, -np.inf, np.inf, -1.0], np.float32)
    np.testing.assert_array_equal(
        torch.sort(torch.from_numpy(col)).values.numpy(),
        np.asarray(jnp.sort(jnp.asarray(col))))


def test_block_krum_picks_the_first_tie_and_never_an_invalid_row(
        reference):
    """Two valid rows have equal scores: argmin takes the first in both
    frameworks.  One valid row (K = 1, every valid score _BIG-sized) still
    wins over the invalid rows, which the +inf mask (not _BIG) keeps out."""
    rng = np.random.RandomState(5)
    for valid_at in ([2, 4], [3]):
        X = rng.randn(6, 4).astype(np.float32)
        w = np.zeros(6, np.float32)
        w[valid_at] = 1.0
        want = reference.aggregators.robust_block(
            "krum", {"a": jnp.asarray(X)}, jnp.asarray(w))
        got = agg.robust_block("krum", {"a": torch.from_numpy(X)},
                               torch.from_numpy(w))
        np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
        np.testing.assert_array_equal(got["a"].numpy(), X[valid_at[0]])


# ---------------------------------------------------------------------------
# block rules inside the port (tests/test_byzantine_sparse.py's contracts)
# ---------------------------------------------------------------------------
def _blocks_with_padding(pad, seed=0):
    """4 fixed valid rows interleaved with ``pad`` garbage rows."""
    rng = np.random.RandomState(seed)
    Xv = rng.randn(4, 7).astype(np.float32)
    R = 4 + pad
    X = (rng.randn(R, 7) * 100).astype(np.float32)
    w = np.zeros((R,), np.float32)
    pos = np.linspace(0, R - 1, 4).astype(int)
    X[pos] = Xv
    w[pos] = 1.0
    return torch.from_numpy(X), torch.from_numpy(w)


@pytest.mark.parametrize("rule", RULES)
def test_robust_block_width_invariant_bitwise(rule):
    """The same 4 valid rows give bit-identical aggregates whatever the
    number of garbage rows around them."""
    z = {"a": torch.zeros(7)}
    outs = []
    for pad in (0, 3, 9, 20):
        X, w = _blocks_with_padding(pad)
        outs.append(agg.robust_block(rule, {"a": X}, w, z,
                                     n_byzantine=1)["a"])
    for o in outs[1:]:
        assert torch.equal(outs[0], o)


@pytest.mark.parametrize("rule", RULES)
def test_robust_block_ignores_padding_garbage(rule):
    """Zero-weight rows are invisible: other garbage in them cannot change
    a bit of the aggregate."""
    X, w = _blocks_with_padding(6)
    z = {"a": torch.zeros(7)}
    want = agg.robust_block(rule, {"a": X}, w, z, n_byzantine=1)
    X2 = torch.where(w[:, None] > 0, X, torch.full_like(X, -1e20))
    got = agg.robust_block(rule, {"a": X2}, w, z, n_byzantine=1)
    assert torch.equal(want["a"], got["a"])


def test_robust_block_unknown_rule_raises():
    X, w = _blocks_with_padding(0)
    with pytest.raises(ValueError, match="robust_consensus"):
        agg.robust_block("geomed", {"a": X}, w, {"a": torch.zeros(7)})
    with pytest.raises(ValueError, match="center"):
        agg.robust_block("centered_clip", {"a": X}, w)


def test_robust_block_weighted_matches_fleet_rule():
    """All-ones weight, no padding: the block rules agree with the fleet
    rules on the same stack."""
    X = torch.from_numpy(np.random.RandomState(3).randn(9, 5)
                         .astype(np.float32))
    w = torch.ones(9)
    z = {"a": torch.zeros(5)}
    out = agg.robust_block("median", {"a": X}, w, z)
    np.testing.assert_allclose(out["a"].numpy(),
                               np.median(X.numpy(), axis=0), rtol=1e-6)
    out_tm = agg.robust_block("trimmed_mean", {"a": X}, w, z, trim_frac=0.2)
    np.testing.assert_allclose(out_tm["a"].numpy(),
                               agg.trimmed_mean({"a": X}, 0.2)["a"].numpy(),
                               rtol=1e-6)


def test_trimmed_mean_small_block_clamps_k():
    """C=3, trim_frac=0.2: the clamp trims one row per side, so one huge
    outlier cannot drag the aggregate (it is the median of the rows)."""
    s = {"w": torch.tensor([[0.0, 1.0], [0.2, 0.9], [1e6, -1e6]])}
    out = agg.trimmed_mean(s, trim_frac=0.2)
    assert float(torch.max(torch.abs(out["w"]))) < 10.0
    np.testing.assert_allclose(out["w"].numpy(),
                               np.median(s["w"].numpy(), axis=0), rtol=1e-6)
    blk = agg.robust_block("trimmed_mean", s, None, trim_frac=0.2)
    np.testing.assert_allclose(blk["w"].numpy(), out["w"].numpy(),
                               rtol=1e-6)


def test_trimmed_mean_two_rows_cannot_trim():
    """C=2 cannot trim a side and keep a row: k stays 0 (a plain mean)."""
    s = {"w": torch.tensor([[1.0], [3.0]])}
    np.testing.assert_allclose(agg.trimmed_mean(s, 0.4)["w"].numpy(), [2.0],
                               rtol=1e-6)
    np.testing.assert_allclose(
        agg.robust_block("trimmed_mean", s, None, trim_frac=0.4)["w"]
        .numpy(), [2.0], rtol=1e-6)


def test_trimmed_mean_unchanged_on_large_fleet():
    """C=12, frac=0.2 -> k=2 on each side."""
    X = np.random.RandomState(0).randn(12, 6).astype(np.float32)
    out = agg.trimmed_mean({"w": torch.from_numpy(X)}, trim_frac=0.2)
    s = np.sort(X, axis=0)
    np.testing.assert_allclose(out["w"].numpy(), s[2:10].mean(axis=0),
                               rtol=1e-6)


def test_median_of_an_even_count_averages_the_middle_two():
    """``torch.median`` would return the lower middle value."""
    s = {"w": torch.tensor([[1.0], [7.0], [3.0], [4.0]])}
    assert float(agg.median(s)["w"]) == 3.5
    assert float(agg.robust_block("median", s, None)["w"]) == 3.5
    assert float(torch.median(s["w"])) == 3.0


# ---------------------------------------------------------------------------
# plain aggregators against the reference
# ---------------------------------------------------------------------------
def _stack(seed=0, C=10):
    rng = np.random.RandomState(seed)
    mu = {"b": np.full((5,), -1.0), "w": np.full((4, 3), 2.0)}
    # spread clients at distinct distances (krum's scores well apart)
    r = (np.arange(C) + 1.0) ** 1.5 / C
    stack = {k: (v[None] + 0.1 * rng.randn(C, *v.shape)
                 + r.reshape((-1,) + (1,) * v.ndim)
                 * rng.randn(*v.shape)).astype(np.float32)
             for k, v in mu.items()}
    server = {k: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32)
              for k, v in mu.items()}
    quasi = {k: (v + 0.05).astype(np.float32) for k, v in server.items()}
    return stack, server, quasi


PLAIN = {
    "fedavg": (lambda a, s, q, x: a.fedavg(s), RTOL, ATOL),
    "fedavg_weighted": (lambda a, s, q, x: a.fedavg(
        s, x(np.linspace(0.1, 1.0, 10, dtype=np.float32))), RTOL, ATOL),
    "median": (lambda a, s, q, x: a.median(s), RTOL, ATOL),
    "trimmed_mean": (lambda a, s, q, x: a.trimmed_mean(s), RTOL, ATOL),
    "krum": (lambda a, s, q, x: a.krum(s, 2), RTOL, ATOL),
    "krum_multi3": (lambda a, s, q, x: a.krum(s, 2, multi=3), RTOL, ATOL),
    "geomed": (lambda a, s, q, x: a.geomed(s), 1e-4, 1e-5),
    "centered_clip": (lambda a, s, q, x: a.centered_clip(s, q, tau=0.5),
                      RTOL, ATOL),
    "fedatt": (lambda a, s, q, x: a.fedatt(s, q), RTOL, ATOL),
    "fedda": (lambda a, s, q, x: a.fedda(s, q, {k: v + 0.05 for k, v in
                                                q.items()}), RTOL, ATOL),
    "rsa_sign": (lambda a, s, q, x: a.rsa_sign(s, q), RTOL, ATOL),
}


def test_plain_grid_covers_every_aggregator():
    assert set(agg.AGGREGATORS) <= set(PLAIN)


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_plain_aggregator_matches_reference(reference, name):
    """Tolerance per entry: rtol 2e-5 / atol 1e-6; geomed rtol 1e-4 /
    atol 1e-5 (64 iterations, each a division by a norm)."""
    fn, rtol, atol = PLAIN[name]
    stack, server, _ = _stack()
    want = fn(reference.aggregators, to_jax(stack), to_jax(server),
              jnp.asarray)
    got = fn(agg, to_torch(stack), to_torch(server), torch.from_numpy)
    assert sorted(got) == sorted(want)
    for k in got:
        g, r = to_numpy(got[k]), np.asarray(want[k])
        assert g.shape == r.shape, k
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=k)


def test_flat_stack_and_unflatten_match_reference(reference):
    stack, _, _ = _stack(seed=1)
    got = agg.flat_stack(to_torch(stack)).numpy()
    want = np.asarray(reference.aggregators.flat_stack(to_jax(stack)))
    np.testing.assert_array_equal(got, want)
    one = agg.unflatten_like(torch.from_numpy(got[3]),
                             tree_map(lambda l: l[0], to_torch(stack)))
    for k in stack:
        np.testing.assert_array_equal(one[k].numpy(), stack[k][3])


# ---------------------------------------------------------------------------
# the attack x aggregator matrix (tests/test_robustness_matrix.py)
# ---------------------------------------------------------------------------
C_M = 12            # clients
B_M = 2             # byzantine (<= trimmed_mean's per-side trim of 0.2 C)
SIGMA = 0.1         # honest spread around the consensus
ROBUST_BOUND = 1.0  # L2 distance every robust rule must stay within
BREAK_FACTOR = 3.0  # fedavg must exceed ROBUST_BOUND by this much


def _honest(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": torch.from_numpy((2.0 + SIGMA * rng.randn(C_M, 4, 3))
                                  .astype(np.float32)),
            "b": torch.from_numpy((-1.0 + SIGMA * rng.randn(C_M, 5))
                                  .astype(np.float32))}


def _take_honest(stacked, mask):
    keep = torch.from_numpy(np.flatnonzero(~mask.numpy()))
    return tree_map(lambda l: l[keep], stacked)


def dist(a, b):
    return float(torch.linalg.norm(flat(a) - flat(b)))


MASK = byz.byz_mask(C_M, B_M)
HONEST = _honest()
HONEST_MEAN = agg.fedavg(_take_honest(HONEST, MASK))
SERVER = HONEST_MEAN
QUASI = tree_map(lambda l: l + 0.05, HONEST_MEAN)
MATRIX_RULES = {
    **agg.AGGREGATORS,
    "krum": functools.partial(agg.krum, n_byzantine=B_M),
    "centered_clip": lambda s: agg.centered_clip(s, SERVER, tau=2.0),
    "fedatt": lambda s: agg.fedatt(s, SERVER),
    "fedda": lambda s: agg.fedda(s, SERVER, QUASI),
}
ROBUST_RULES = sorted(set(MATRIX_RULES) - {"fedavg"})


def corrupted(attack, seed=1):
    return byz.apply_attack(attack, torch.Generator().manual_seed(seed),
                            HONEST, MASK)


@pytest.mark.parametrize("attack", byz.ATTACKS)
@pytest.mark.parametrize("rule", ROBUST_RULES)
def test_robust_rule_bounded_under_attack(rule, attack):
    """Every robust rule stays within ROBUST_BOUND of the honest-only
    aggregate whatever the B corrupted clients send."""
    out = MATRIX_RULES[rule](corrupted(attack))
    assert torch.isfinite(flat(out)).all(), f"{rule} under {attack}"
    d = dist(out, HONEST_MEAN)
    assert d <= ROBUST_BOUND, f"{rule} under {attack}: dist {d:.3f}"


@pytest.mark.parametrize("attack", byz.ATTACKS)
def test_rsa_sign_bounded_under_attack(attack):
    """Each corrupted client moves each coordinate of RSA's sign sum by at
    most 1, so |corrupted - honest-only| <= B."""
    full = agg.rsa_sign(corrupted(attack), SERVER)
    honest = agg.rsa_sign(_take_honest(HONEST, MASK), SERVER)
    gap = float(torch.max(torch.abs(flat(full) - flat(honest))))
    assert gap <= B_M + 1e-6, f"rsa_sign under {attack}: gap {gap}"


@pytest.mark.parametrize("attack", byz.ATTACKS)
def test_int8_weighted_consensus_bounded_under_attack(attack):
    """Through the dispatch with staleness weights and the int8 wire, the
    B corrupted clients move each coordinate of the consensus update by at
    most alpha_z psi 2 sum_{i in B} s_i / C."""
    psi, alpha_z = 0.01, 0.1
    z = flat(SERVER)
    bad = corrupted(attack)
    W_full = torch.stack([flat(tree_map(lambda l: l[i], bad))
                          for i in range(C_M)])
    W_honest = torch.stack([flat(tree_map(lambda l: l[i], HONEST))
                            for i in range(C_M)])
    sw = torch.linspace(0.2, 1.0, C_M)
    phi = torch.zeros_like(z)
    got = ops.sign_consensus(z, W_full, phi, sw, psi, alpha_z,
                             message="int8")
    base = ops.sign_consensus(z, W_honest, phi, sw, psi, alpha_z,
                              message="int8")
    byz_weight = float(torch.sum(sw * MASK.float()))
    gap = float(torch.max(torch.abs(got - base)))
    assert gap <= alpha_z * psi * 2.0 * byz_weight / C_M + 1e-6


@pytest.mark.parametrize("attack", ["scaled", "gaussian"])
def test_fedavg_breaks(attack):
    """The linear mean has unbounded sensitivity: magnitude attacks drag it
    far outside the robust envelope."""
    d = dist(agg.fedavg(corrupted(attack)), HONEST_MEAN)
    assert d > BREAK_FACTOR * ROBUST_BOUND, f"fedavg under {attack}: {d:.3f}"


def test_fedavg_exact_on_honest():
    assert dist(agg.fedavg(_take_honest(HONEST, MASK)), HONEST_MEAN) < 1e-5


@pytest.mark.parametrize("rule", sorted(MATRIX_RULES))
def test_rules_finite_on_clean_fleet(rule):
    out = MATRIX_RULES[rule](HONEST)
    assert torch.isfinite(flat(out)).all()
    assert dist(out, HONEST_MEAN) <= ROBUST_BOUND


@given(st.integers(0, 10_000),
       st.sampled_from(sorted(MATRIX_RULES) + ["rsa_sign"]))
@settings(max_examples=40, deadline=None)
def test_aggregators_permutation_invariant(seed, rule):
    """Client order never matters: every rule is a function of the set of
    messages."""
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(C_M))
    shuffled = tree_map(lambda l: l[perm], HONEST)
    if rule == "rsa_sign":
        a, b = agg.rsa_sign(HONEST, SERVER), agg.rsa_sign(shuffled, SERVER)
    else:
        a, b = MATRIX_RULES[rule](HONEST), MATRIX_RULES[rule](shuffled)
    np.testing.assert_allclose(flat(a).numpy(), flat(b).numpy(), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the 30 %-Byzantine sparse training matrix (tests/test_byzantine_sparse.py)
# ---------------------------------------------------------------------------
TRAIN_C = 10
TRAIN_ROUNDS = 40
ROBUST_LOSS_FACTOR = 2.0
BREAK_LOSS_FACTOR = 100.0
SCALED_DRIFT_CONTRAST = 2.0


def _sparse_fed(attack, rule):
    """The matrix's configuration: full participation, 30 % Byzantine,
    strong consensus coupling (psi=1.0) so a corrupted z shows in the
    honest-eval loss."""
    from repro_torch.configs import FedConfig

    return FedConfig(n_clients=TRAIN_C, active_frac=1.0, attack=attack,
                     byzantine_frac=0.3, robust_consensus=rule,
                     robust_trim_frac=0.45, consensus_scope="active",
                     psi=1.0, alpha_z=0.1)


def _run_sparse(fed, state, X, Y, input_c3=0.02):
    """TRAIN_ROUNDS of ``bafdp_round_sparse`` from ``state`` on (X, Y),
    input noise of scale ``input_c3``.  Returns (final z flat,
    honest-eval loss)."""
    from repro_torch.configs import MLP_H1
    from repro_torch.core import bafdp
    from repro_torch.core.privacy import gaussian_c3, perturb_inputs
    from repro_torch.core.schedule import round_generator
    from repro_torch.models.forecasting import mse_loss

    cfg = MLP_H1
    c3 = gaussian_c3(cfg.d_x + cfg.d_y, fed.dp_delta, fed.dp_sensitivity)

    def local_loss(W, b, g, eps):
        x, y = b
        return mse_loss(W, perturb_inputs(g, x, eps, input_c3), y, cfg)

    mask = byz.byz_mask(TRAIN_C, fed.n_byzantine)
    idx = np.arange(TRAIN_C)
    w = np.ones(TRAIN_C, np.float32)
    for t in range(TRAIN_ROUNDS):
        state, _ = bafdp.bafdp_round_sparse(
            state, (X, Y), round_generator(0, t, "cpu"),
            local_loss=local_loss, fed=fed, c3=c3, n_samples=200,
            d_dim=cfg.d_x + cfg.d_y, byz_mask=mask, idx=idx, weight=w)
    honest = torch.from_numpy(np.flatnonzero(~mask.numpy()))
    Xh = X[honest].reshape(-1, cfg.d_x)
    Yh = Y[honest].reshape(-1, 1)
    return flat(state.z).numpy(), float(mse_loss(state.z, Xh, Yh, cfg))


@functools.lru_cache(maxsize=None)
def _train_sparse(attack, rule):
    """The matrix's run from the port's own draws (init and data from
    one generator).  Returns (final z flat, honest-eval loss)."""
    from repro_torch.configs import MLP_H1
    from repro_torch.core.fed_state import init_fed_state
    from repro_torch.models.forecasting import init_forecaster

    cfg = MLP_H1
    fed = _sparse_fed(attack, rule)
    gen = torch.Generator().manual_seed(0)
    state = init_fed_state(gen, lambda g: init_forecaster(g, cfg), fed,
                           device="cpu")
    X = torch.randn(TRAIN_C, 8, cfg.d_x, generator=gen)
    Y = torch.sum(X[..., :3], -1, keepdim=True) * 0.5
    return _run_sparse(fed, state, X, Y)


@pytest.mark.parametrize("attack",
                         [a for a in byz.ATTACKS if a != "same_value"])
def test_trimmed_mean_bounded_under_every_attack_sparse(attack):
    """robust_consensus='trimmed_mean' at 30 % Byzantine: the honest-eval
    loss stays within 2x of the attack-free run under every attack but
    ``same_value`` (see the next test)."""
    _, free = _train_sparse("none", "trimmed_mean")
    _, attacked = _train_sparse(attack, "trimmed_mean")
    assert np.isfinite(attacked), f"trimmed_mean diverged under {attack}"
    assert attacked <= ROBUST_LOSS_FACTOR * free, \
        f"trimmed_mean under {attack}: {attacked:.4f} vs free {free:.4f}"


def _shared_inputs(r):
    """One initial state (the reference's, from PRNGKey(0)) and one numpy
    data set for both packages."""
    import jax

    from test_torch_reference import ref_state_arrays

    cfg = r.configs.MLP_H1
    fed = r.configs.FedConfig(n_clients=TRAIN_C)
    init = ref_state_arrays(r.fed_state.init_fed_state(
        jax.random.PRNGKey(0),
        lambda k: r.forecasting.init_forecaster(k, cfg), fed))
    X = np.random.RandomState(0).randn(TRAIN_C, 8, cfg.d_x).astype(
        np.float32)
    Y = (np.sum(X[..., :3], -1, keepdims=True) * 0.5).astype(np.float32)
    return init, X, Y


def _train_sparse_reference(r, attack, rule, init, X, Y, input_c3=0.02):
    """:func:`_run_sparse` in the reference, from ``init`` on (X, Y); its
    input noise comes from its own draws."""
    import jax

    cfg = r.configs.MLP_H1
    fed = r.configs.FedConfig(
        n_clients=TRAIN_C, active_frac=1.0, attack=attack,
        byzantine_frac=0.3, robust_consensus=rule, robust_trim_frac=0.45,
        consensus_scope="active", psi=1.0, alpha_z=0.1)
    key = jax.random.PRNGKey(0)
    state = r.fed_state.FedState(**{
        k: None if v is None else jax.tree.map(jnp.asarray, v)
        for k, v in init.items()})
    c3 = r.privacy.gaussian_c3(cfg.d_x + cfg.d_y, fed.dp_delta,
                               fed.dp_sensitivity)

    def local_loss(p, b, k, eps):
        x, y = b
        return r.forecasting.mse_loss(
            p, r.privacy.perturb_inputs(k, x, eps, input_c3), y, cfg)

    mask = r.byzantine.byz_mask(TRAIN_C, fed.n_byzantine)
    step = jax.jit(functools.partial(
        r.bafdp.bafdp_round_sparse, local_loss=local_loss, fed=fed, c3=c3,
        n_samples=200, d_dim=cfg.d_x + cfg.d_y, byz_mask=mask))
    idx = jnp.arange(TRAIN_C, dtype=jnp.int32)
    w = jnp.ones((TRAIN_C,), jnp.float32)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    for t in range(TRAIN_ROUNDS):
        state, _ = step(state, (Xj, Yj), jax.random.fold_in(key, t),
                        idx=idx, weight=w)
    honest = np.flatnonzero(~np.asarray(mask))
    return float(r.forecasting.mse_loss(
        state.z, Xj[honest].reshape(-1, cfg.d_x),
        Yj[honest].reshape(-1, 1), cfg))


def test_trimmed_mean_under_same_value_no_worse_than_reference(reference):
    """Under ``same_value`` the trimmed mean keeps the two upper-middle
    honest ranks of every coordinate (3 of 10 rows sit at the top), a bias
    the psi=1.0 coupling compounds, so the attacked loss ends above the
    attack-free one (2.3x here), not at the 1.21x the reference's test
    pins on its own draws (that file does not import here).  The port is
    held to the reference on the same run: one initial state (the
    reference's), one numpy data set, no input noise (the one draw the
    packages cannot share), so both losses, and with them the ratio,
    agree at rtol 1e-4 (40 rounds of f32 drift; 2e-6 seen) and the ratio
    stays far from the unguarded fold's blow-up (BREAK_LOSS_FACTOR)."""
    from repro_torch.core.fed_state import fed_state_from_numpy

    init, X, Y = _shared_inputs(reference)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    got, want = {}, {}
    for attack in ("none", "same_value"):
        want[attack] = _train_sparse_reference(
            reference, attack, "trimmed_mean", init, X, Y, input_c3=0.0)
        got[attack] = _run_sparse(
            _sparse_fed(attack, "trimmed_mean"),
            fed_state_from_numpy(init, device="cpu"), Xt, Yt,
            input_c3=0.0)[1]
    np.testing.assert_allclose([got["none"], got["same_value"]],
                               [want["none"], want["same_value"]],
                               rtol=1e-4, atol=0)
    ratio = got["same_value"] / got["none"]
    np.testing.assert_allclose(ratio, want["same_value"] / want["none"],
                               rtol=1e-4)
    assert 1.0 < ratio <= BREAK_LOSS_FACTOR, ratio


def test_unguarded_consensus_breaks_under_same_value():
    """robust_consensus='none' breaks: the coherent same_value push runs
    away through the client-consensus coupling (NaN counts as broken)."""
    _, free = _train_sparse("none", "none")
    _, attacked = _train_sparse("same_value", "none")
    assert not (attacked <= BREAK_LOSS_FACTOR * free), \
        f"expected a blow-up, got {attacked:.4f} vs free {free:.4f}"


def test_unguarded_consensus_dragged_under_scaled():
    """Under 'scaled' the unguarded fold's final z lands several times
    further from its attack-free run than the trimmed-mean run's."""
    z_free_none, _ = _train_sparse("none", "none")
    z_atk_none, _ = _train_sparse("scaled", "none")
    z_free_tm, _ = _train_sparse("none", "trimmed_mean")
    z_atk_tm, _ = _train_sparse("scaled", "trimmed_mean")
    drift_none = np.linalg.norm(z_atk_none - z_free_none)
    drift_tm = np.linalg.norm(z_atk_tm - z_free_tm)
    assert drift_none > SCALED_DRIFT_CONTRAST * drift_tm, \
        f"drift none={drift_none:.2f} vs trimmed_mean={drift_tm:.2f}"


def test_sign_flip_absorbed_by_sign_fold():
    """sign_flip cannot break Eq. (20) at 30 % Byzantine: each message is
    a +-1 vote, so both the unguarded and the robust run stay inside the
    robust envelope."""
    for rule in ("none", "trimmed_mean"):
        _, free = _train_sparse("none", rule)
        _, attacked = _train_sparse("sign_flip", rule)
        assert attacked <= ROBUST_LOSS_FACTOR * free, \
            f"{rule} under sign_flip: {attacked:.4f} vs {free:.4f}"
