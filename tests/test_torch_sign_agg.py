"""The Eq. (20) consensus kernels B1-B3: their plain versions against the
reference's oracles, and the dispatch against the reference's dispatch.
(The CUDA kernels against their plain versions: test_torch_cuda.py.)

Tolerances: 1e-6 (f32) / 3e-2 (bf16), the reference's own kernel tests'
(``tests/test_kernels.py``): XLA sums the rows in another grouping than
the port's row-order fold.  Inside the port (int8 vs f32 wire, kernel vs
plain version) the match is bitwise.
"""
import numpy as np
import pytest
import torch
from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.distributed import collectives
from repro_torch.kernels import ops, ref, sign_agg

GRID_D = [128, 1024, 5000, 8193]
GRID_C = [2, 16]
DTYPES = ["float32", "bfloat16"]
PSI, ALPHA = 0.005, 0.01


def _problem(D, C, seed, weighted=True):
    rng = np.random.RandomState(seed)
    z = rng.randn(D).astype(np.float32)
    W = rng.randn(C, D).astype(np.float32)
    phi = (rng.randn(D) * 0.01).astype(np.float32)
    sw = rng.uniform(0.05, 1.0, C).astype(np.float32) if weighted else None
    return z, W, phi, sw


def _jax(a, dtype):
    import jax.numpy as jnp
    return None if a is None else jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype):
    return None if a is None else torch.from_numpy(a).to(
        getattr(torch, dtype))


def _close(got, want, dtype):
    tol = 1e-6 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("D", GRID_D)
@pytest.mark.parametrize("C", GRID_C)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sign_agg_plain_matches_reference(reference, D, C, dtype):
    z, W, phi, _ = _problem(D, C, D + C)
    want = reference.ref.sign_agg_ref(_jax(z, dtype), _jax(W, dtype),
                                      _jax(phi, dtype), PSI, ALPHA)
    got = sign_agg.sign_agg(_torch(z, dtype), _torch(W, dtype),
                            _torch(phi, dtype), PSI, ALPHA)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("D", GRID_D)
@pytest.mark.parametrize("C", GRID_C)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sign_agg_weighted_plain_matches_reference(reference, D, C, dtype):
    z, W, phi, sw = _problem(D, C, D * C)
    want = reference.ref.sign_agg_weighted_ref(
        _jax(z, dtype), _jax(W, dtype), _jax(phi, dtype), _jax(sw, "float32"),
        PSI, ALPHA)
    got = sign_agg.sign_agg_weighted(
        _torch(z, dtype), _torch(W, dtype), _torch(phi, dtype),
        torch.from_numpy(sw), PSI, ALPHA)
    _close(got, want, dtype)


@pytest.mark.parametrize("D", GRID_D)
@pytest.mark.parametrize("C", GRID_C)
@pytest.mark.parametrize("weighted", [True, False])
def test_sign_agg_int8_plain_matches_reference(reference, D, C, weighted):
    z, W, phi, sw = _problem(D, C, 7 * D + C, weighted)
    payload = np.sign(z[None] - W).astype(np.int8)
    want = reference.ref.sign_agg_int8_ref(
        _jax(z, "float32"), _jax(payload, "int8"), _jax(sw, "float32"),
        _jax(phi, "float32"), PSI, ALPHA)
    got = sign_agg.sign_agg_weighted_int8(
        torch.from_numpy(z), torch.from_numpy(payload), _torch(sw, "float32"),
        torch.from_numpy(phi), PSI, ALPHA)
    _close(got, want, "float32")


def test_n_total_divisor_matches_reference_fold(reference):
    """B2/B3 with ``n_total``: the active-subset divisor of the reference's
    order-canonical folds."""
    z, W, phi, sw = _problem(1500, 6, 9)
    sw[[1, 4]] = 0.0
    jz, jW, jphi, jsw = (_jax(a, "float32") for a in (z, W, phi, sw))
    want = reference.ref.sign_agg_fold_ref(jz, jW, jphi, jsw, PSI, ALPHA, 11)
    got = sign_agg.sign_agg_weighted(*map(torch.from_numpy, (z, W, phi, sw)),
                                     PSI, ALPHA, n_total=11)
    _close(got, want, "float32")
    payload = np.sign(z[None] - W).astype(np.int8)
    want8 = reference.ref.sign_agg_int8_fold_ref(
        jz, _jax(payload, "int8"), jsw, jphi, PSI, ALPHA, 11)
    got8 = sign_agg.sign_agg_weighted_int8(
        torch.from_numpy(z), torch.from_numpy(payload), torch.from_numpy(sw),
        torch.from_numpy(phi), PSI, ALPHA, n_total=11)
    _close(got8, want8, "float32")
    assert torch.equal(got8, got)


def test_int8_sign_sum_accumulates_past_c128(reference):
    """C=200 clients all on one side of z: |sum| = 200 wraps in int8; the
    int8 path sums in int32 and equals the f32 oracle exactly."""
    C, D = 200, 600
    z = np.random.RandomState(1).randn(D).astype(np.float32)
    W = np.tile((z - 1000.0)[None], (C, 1))
    phi = np.zeros(D, np.float32)
    got = ops.sign_consensus(torch.from_numpy(z), torch.from_numpy(W),
                             torch.from_numpy(phi), None, PSI, ALPHA,
                             message="int8")
    want = reference.ref.sign_agg_ref(z, W, phi, PSI, ALPHA)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    msg = collectives.encode_sign_message(torch.from_numpy(z),
                                          torch.from_numpy(W))
    assert torch.equal(collectives.sign_sum(msg, C), torch.ones(D))
    assert int(msg.payload.sum(0, dtype=torch.int8)[0]) == 200 - 256


@pytest.mark.parametrize("decay", ["constant", "hinge", "poly"])
@pytest.mark.parametrize("message", ["f32", "int8"])
def test_sign_consensus_matches_reference_dispatch(reference, decay,
                                                  message):
    """The port's dispatch against the reference's, ``impl="xla"`` and
    ``impl="interpret"`` (the Pallas kernel run on the CPU)."""
    r = reference
    z, W, phi, _ = _problem(1500, 12, 0, weighted=False)
    stale = np.arange(12, dtype=np.float32)
    fed = r.configs.FedConfig(staleness_decay=decay)
    weights = None if decay == "constant" else np.array(
        r.bafdp.staleness_weights(stale, fed))
    tz, tW, tphi = map(torch.from_numpy, (z, W, phi))
    tw = None if weights is None else torch.from_numpy(weights)
    got = ops.sign_consensus(tz, tW, tphi, tw, PSI, ALPHA, message=message)
    for impl in ("xla", "interpret"):
        want = r.ops.sign_consensus(z, W, phi, weights, PSI, ALPHA,
                                    message=message, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=f"{decay}/{message}/"
                                   f"{impl}")
    # inside the port: one result whatever the wire format or impl
    other = "f32" if message == "int8" else "int8"
    assert torch.equal(got, ops.sign_consensus(tz, tW, tphi, tw, PSI, ALPHA,
                                               message=other))
    assert torch.equal(got, ops.sign_consensus(tz, tW, tphi, tw, PSI, ALPHA,
                                               message=message,
                                               impl="torch"))


def test_sign_follows_jnp_sign_at_nan_and_signed_zero(reference):
    """``sign`` is ``jnp.sign``: NaN stays NaN (``torch.sign`` gives 0)."""
    import jax.numpy as jnp

    x = np.array([np.nan, -0.0, 0.0, 2.0, -3.0], np.float32)
    got = ref.jsign(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.sign(x))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    z, W, phi, sw = _problem(256, 4, 5)
    W[1, :8] = np.nan
    W[2, 8:16] = z[8:16]                 # sign exactly 0
    for fn, want in (
            (lambda *a: sign_agg.sign_agg(*a[:3], PSI, ALPHA),
             reference.ref.sign_agg_ref(z, W, phi, PSI, ALPHA)),
            (lambda *a: sign_agg.sign_agg_weighted(*a, PSI, ALPHA),
             reference.ref.sign_agg_weighted_ref(z, W, phi, sw, PSI, ALPHA))):
        got = fn(*map(torch.from_numpy, (z, W, phi, sw)))
        assert np.isnan(got.numpy()[:8]).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_dispatch_validation_errors():
    z, W, phi, sw = map(torch.from_numpy, _problem(128, 4, 0))
    with pytest.raises(ValueError, match="n_total"):
        ops.sign_consensus(z, W, phi, None, PSI, ALPHA, n_total=8)
    with pytest.raises(ValueError, match="sign message"):
        ops.sign_consensus(z, W, phi, None, PSI, ALPHA, message="int4")
    with pytest.raises(ValueError, match="impl"):
        ops.sign_consensus(z, W, phi, None, PSI, ALPHA, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        ops.sign_consensus(z, W, phi, None, PSI, ALPHA, impl="cuda")


def test_cpu_tensors_never_reach_the_kernel_build(monkeypatch):
    """On the CPU the wrappers run the plain versions and build nothing."""
    from repro_torch.kernels import _build

    def refuse(name):
        raise AssertionError("the CPU path tried to build a kernel")

    monkeypatch.setattr(_build, "load", refuse)
    sign_agg.reset_launch_counts()
    z, W, phi, sw = map(torch.from_numpy, _problem(128, 4, 0))
    sign_agg.sign_agg(z, W, phi, PSI, ALPHA)
    sign_agg.sign_agg_weighted(z, W, phi, sw, PSI, ALPHA)
    ops.sign_consensus(z, W, phi, sw, PSI, ALPHA, message="int8")
    assert set(sign_agg.LAUNCHES.values()) == {0}


def test_sign_agg_entry_points_match_reference(reference):
    """``ops.sign_agg`` / ``ops.sign_agg_weighted`` (B1 / B2 through the
    dispatch) against the reference's, ``impl="xla"``."""
    z, W, phi, sw = _problem(1000, 5, 3)
    tz, tW, tphi, tsw = map(torch.from_numpy, (z, W, phi, sw))
    for impl in ("auto", "torch"):
        np.testing.assert_allclose(
            ops.sign_agg(tz, tW, tphi, PSI, ALPHA, impl=impl).numpy(),
            np.asarray(reference.ops.sign_agg(z, W, phi, PSI, ALPHA,
                                              impl="xla")),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            ops.sign_agg_weighted(tz, tW, tphi, tsw, PSI, ALPHA,
                                  impl=impl).numpy(),
            np.asarray(reference.ops.sign_agg_weighted(
                z, W, phi, sw, PSI, ALPHA, impl="xla")), rtol=0, atol=1e-6)


# ---- B1/B2 over every leaf of a tree (sign_agg_group) -------------------

MAIN_LEAF_D = [128, 2816, 128, 16384, 64, 8192, 24, 1536]   # MLP_H24
ODD_LEAF_D = [1, 3, 8193]


def _leaves(sizes, C, seed):
    rng = np.random.RandomState(seed)
    out = []
    for D in sizes:
        z = rng.randn(D).astype(np.float32)
        W = rng.randn(C, D).astype(np.float32)
        W[0, :2] = np.nan                     # NaN and tie columns
        W[C - 1, 2:4] = z[2:4]
        out.append((z, W, (rng.randn(D) * 0.01).astype(np.float32)))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["plain", "weighted", "n_total"])
def test_sign_agg_group_matches_reference_per_leaf(reference, dtype, mode):
    """The grouped call on the CPU against the reference's per-leaf
    oracles (``sign_agg_ref`` without weights, ``sign_agg_fold_ref`` with
    them), over the 8 MLP_H24 leaves and odd sizes."""
    C = 10
    leaves = _leaves(MAIN_LEAF_D + ODD_LEAF_D, C, 3)
    sw = np.random.RandomState(4).uniform(0.05, 1.0, C).astype(np.float32)
    n_total = 3 * C if mode == "n_total" else 0
    weights = None if mode == "plain" else torch.from_numpy(sw)
    got = sign_agg.sign_agg_group(
        [_torch(z, dtype) for z, _, _ in leaves],
        [_torch(W, dtype) for _, W, _ in leaves],
        [_torch(p, dtype) for _, _, p in leaves], weights, PSI, ALPHA,
        n_total=n_total)
    assert len(got) == len(leaves)
    for (z, W, phi), g in zip(leaves, got):
        jz, jW, jphi = (_jax(a, dtype) for a in (z, W, phi))
        if mode == "plain":
            want = reference.ref.sign_agg_ref(jz, jW, jphi, PSI, ALPHA)
        else:
            want = reference.ref.sign_agg_fold_ref(
                jz, jW, jphi, _jax(sw, "float32"), PSI, ALPHA, n_total or C)
        assert g.dtype == getattr(torch, dtype) and g.shape == (z.size,)
        assert np.isnan(g[:2].float().numpy()).all()
        _close(g, want, dtype)


@pytest.mark.parametrize("decay", ["constant", "hinge", "poly"])
@pytest.mark.parametrize("message", ["f32", "int8"])
def test_sign_consensus_leaves_equals_per_leaf_dispatch(reference, decay,
                                                        message):
    """``ops.sign_consensus_leaves`` equals ``ops.sign_consensus`` leaf by
    leaf, bit for bit, for both wire formats and every decay, with and
    without ``n_total``, through ``impl="auto"`` and ``"torch"``."""
    C = 12
    fed = reference.configs.FedConfig(staleness_decay=decay)
    weights = None if decay == "constant" else torch.from_numpy(np.array(
        reference.bafdp.staleness_weights(np.arange(C, dtype=np.float32),
                                          fed)))
    leaves = [tuple(map(torch.from_numpy, leaf))
              for leaf in _leaves(MAIN_LEAF_D + ODD_LEAF_D, C, 5)]
    zs, Ws, phis = map(list, zip(*leaves))
    for n_total in [None] if weights is None else [None, 2 * C]:
        for impl in ("auto", "torch"):
            got = ops.sign_consensus_leaves(zs, Ws, phis, weights, PSI,
                                            ALPHA, message=message,
                                            impl=impl, n_total=n_total)
            for (z, W, phi), g in zip(leaves, got):
                want = ops.sign_consensus(z, W, phi, weights, PSI, ALPHA,
                                          message=message, impl=impl,
                                          n_total=n_total)
                assert g.dtype == want.dtype
                assert g.numpy().tobytes() == want.numpy().tobytes()


def _kernel_columns(table, width, n_leaves):
    """Which (leaf, column) each thread of the group kernel writes: block
    b of a launch belongs to the last leaf whose first block is <= b, and
    thread t of its k-th block owns ``width`` (vector) or 1 columns from
    ``(k * THREADS + t) * width`` on, up to the leaf's D."""
    cols = sign_agg.TABLE_COLS
    seen = {}
    for l0 in range(0, n_leaves, sign_agg.MAX_LEAVES):
        rows = [table[l * cols:(l + 1) * cols]
                for l in range(l0, min(n_leaves, l0 + sign_agg.MAX_LEAVES))]
        last = rows[-1]
        grid = last[5] + -(-last[4] // (sign_agg.THREADS
                                        * (width if last[6] else 1)))
        for b in range(grid):
            k = max(i for i, r in enumerate(rows) if r[5] <= b)
            D, first, vec = rows[k][4], rows[k][5], rows[k][6]
            v = width if vec else 1
            for t in range(sign_agg.THREADS):
                d0 = ((b - first) * sign_agg.THREADS + t) * v
                for d in range(d0, min(d0 + v, D)):
                    seen[(l0 + k, d)] = seen.get((l0 + k, d), 0) + 1
    return seen


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_leaf_table_covers_every_column_exactly_once(itemsize):
    """Each column of each leaf is written by exactly one thread, on the
    vector path and the scalar one, across a split at MAX_LEAVES."""
    width = sign_agg.vec_width(itemsize)
    sizes = MAIN_LEAF_D + ODD_LEAF_D + [width, width + 1, 4096, 4097]
    sizes = (sizes * 6)[:sign_agg.MAX_LEAVES + 3]
    base = 1 << 20
    leaves = [(base, base + 256, base + 512, base + 768 + 4 * (l % 3), D)
              for l, D in enumerate(sizes)]
    table = sign_agg.leaf_table(leaves, itemsize)
    assert len(table) == sign_agg.TABLE_COLS * len(sizes)
    seen = _kernel_columns(table, width, len(sizes))
    assert set(seen.values()) == {1}
    assert sorted(seen) == [(l, d) for l, D in enumerate(sizes)
                            for d in range(D)]


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_leaf_table_flags_the_vector_path_only_where_it_is_safe(itemsize):
    """A leaf is vectorized only when all four addresses are 16-byte
    aligned and D is a multiple of the vector width (4 f32, 8 bf16, 8
    int8 message columns)."""
    width = sign_agg.vec_width(itemsize)
    a = 1 << 20
    cases = [((a, a, a, a, 8 * width), 1),
             ((a, a, a, a, 8 * width + 1), 0),
             ((a, a, a, a, width // 2), 0),
             ((a + itemsize, a, a, a, 8 * width), 0),     # a view, offset 1
             ((a, a + itemsize, a, a, 8 * width), 0),
             ((a, a, a + 8, a, 8 * width), 0),
             ((a, a, a, a + itemsize, 8 * width), 0),
             ((a, a, a, a, 1), 0), ((a, a, a, a, 3), 0)]
    table = sign_agg.leaf_table([leaf for leaf, _ in cases], itemsize)
    flags = table[6::sign_agg.TABLE_COLS]
    assert flags == [vec for _, vec in cases]
    if itemsize == 2:                       # bf16: D a multiple of 8, not 4
        assert sign_agg.leaf_table([(a, a, a, a, 12)], 2)[6] == 0
    if itemsize == 1:                       # int8: D a multiple of 8, not 4
        assert sign_agg.leaf_table([(a, a, a, a, 12)], 1)[6] == 0


def test_leaf_table_splits_at_max_leaves():
    """65 leaves: two launches, the second's blocks counted from 0."""
    n = sign_agg.MAX_LEAVES + 1
    table = sign_agg.leaf_table([(0, 0, 0, 0, 1024)] * n, 4)
    firsts = table[5::sign_agg.TABLE_COLS]
    assert firsts[:3] == [0, 1, 2]
    assert firsts[sign_agg.MAX_LEAVES - 1] == sign_agg.MAX_LEAVES - 1
    assert firsts[sign_agg.MAX_LEAVES] == 0
    assert -(-n // sign_agg.MAX_LEAVES) == 2


def test_table_constants_match_the_kernel_source():
    """THREADS, MAX_LEAVES and TABLE_COLS are the .cu's constants, and
    the out offsets keep every leaf's z' on a 16-byte boundary."""
    import re
    from pathlib import Path

    src = (Path(sign_agg.__file__).parent / "csrc" / "sign_agg.cu"
           ).read_text()
    for name, value in (("kThreads", sign_agg.THREADS),
                        ("kMaxLeaves", sign_agg.MAX_LEAVES),
                        ("kTableCols", sign_agg.TABLE_COLS),
                        ("kVecBytes", sign_agg.VEC_BYTES),
                        ("kInt8Cols", sign_agg.INT8_COLS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1)) == value
    # both kernels take their vector width from vec_width of their
    # message rows' element size, as leaf_table does
    assert "return elem == 1 ? kInt8Cols : kVecBytes / elem;" in src
    assert "kVec = vec_width(sizeof(T));" in src
    assert "kVec = vec_width(sizeof(int8_t));" in src
    assert [sign_agg.vec_width(i) for i in (4, 2, 1)] == [4, 8, 8]
    D = sign_agg.THREADS * sign_agg.INT8_COLS     # one int8 block's columns
    table = sign_agg.leaf_table([(0, 0, 0, 0, d) for d in (D, D + 8, 1)],
                                1)
    assert table[5::sign_agg.TABLE_COLS] == [0, 1, 3]
    for itemsize in (4, 2):
        offs, total = sign_agg.out_offsets([1, 3, 24, 8193, 5], itemsize)
        assert all(o * itemsize % 16 == 0 for o in offs)
        assert total >= offs[-1] + 5 and total * itemsize % 16 == 0


def test_round_leaves_take_the_vector_path(monkeypatch):
    """The leaves a forecaster round hands the grouped call (MLP_H24,
    f32) all qualify for 16-byte vectors, as the 8 MLP_H24 sizes do in
    bf16."""
    from repro_torch import train
    from repro_torch.configs import FedConfig

    calls = []
    grouped = ops.sign_consensus_leaves

    def spy(zs, Ws, phis, *args, **kwargs):
        calls.append([(z.data_ptr(), W.data_ptr(), p.data_ptr(), z.numel())
                      for z, W, p in zip(zs, Ws, phis)])
        return grouped(zs, Ws, phis, *args, **kwargs)

    monkeypatch.setattr(ops, "sign_consensus_leaves", spy)
    train.train_bafdp("milano", 24, FedConfig(n_clients=4), rounds=1,
                      device="cpu")
    assert [D for *_, D in calls[0]] == MAIN_LEAF_D
    for itemsize in (4, 2):
        offs, _ = sign_agg.out_offsets(MAIN_LEAF_D, itemsize)
        if itemsize == 4:
            leaves = [(z, W, p, 4096 + o * 4, D)
                      for (z, W, p, D), o in zip(calls[0], offs)]
        else:
            leaves = [(256, 256, 256, 4096 + o * 2, D)
                      for D, o in zip(MAIN_LEAF_D, offs)]
        flags = sign_agg.leaf_table(leaves, itemsize)[6::sign_agg.TABLE_COLS]
        assert flags == [1] * len(MAIN_LEAF_D)


def test_group_dispatch_validation_errors():
    leaves = [tuple(map(torch.from_numpy, leaf))
              for leaf in _leaves([128, 64], 4, 0)]
    zs, Ws, phis = map(list, zip(*leaves))
    with pytest.raises(ValueError, match="n_total"):
        ops.sign_consensus_leaves(zs, Ws, phis, None, PSI, ALPHA, n_total=8)
    with pytest.raises(ValueError, match="n_total"):
        sign_agg.sign_agg_group(zs, Ws, phis, None, PSI, ALPHA, n_total=8)
    with pytest.raises(ValueError, match="sign message"):
        ops.sign_consensus_leaves(zs, Ws, phis, None, PSI, ALPHA,
                                  message="int4")
    with pytest.raises(ValueError, match="impl"):
        ops.sign_consensus_leaves(zs, Ws, phis, None, PSI, ALPHA,
                                  impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        ops.sign_consensus_leaves(zs, Ws, phis, None, PSI, ALPHA,
                                  impl="cuda")
    with pytest.raises(ValueError, match="leaves"):
        sign_agg.sign_agg_group([], [], [], None, PSI, ALPHA)
    with pytest.raises(ValueError, match="leaves"):
        sign_agg.sign_agg_group(zs, Ws[:1], phis, None, PSI, ALPHA)


def test_cpu_group_never_reaches_the_kernel_build(monkeypatch):
    """On the CPU the grouped call runs the plain version, builds nothing
    and counts no launch."""
    from repro_torch.kernels import _build

    def refuse(name):
        raise AssertionError("the CPU path tried to build a kernel")

    monkeypatch.setattr(_build, "load", refuse)
    sign_agg.reset_launch_counts()
    leaves = [tuple(map(torch.from_numpy, leaf))
              for leaf in _leaves(MAIN_LEAF_D, 4, 0)]
    zs, Ws, phis = map(list, zip(*leaves))
    sign_agg.sign_agg_group(zs, Ws, phis, None, PSI, ALPHA)
    ops.sign_consensus_leaves(zs, Ws, phis, torch.ones(4), PSI, ALPHA)
    assert set(sign_agg.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("name", ["constant-f32-sgd", "poly-f32-adam",
                                  "poly-int8-adam", "hinge-int8-dualint8",
                                  "taylor-global"])
def test_round_grouped_dispatch_equals_per_leaf_dispatch(monkeypatch, name):
    """3 rounds of ``bafdp_round`` through the grouped consensus call
    equal 3 rounds through a per-leaf dispatch, over the whole state, bit
    for bit."""
    from test_torch_reference import flat_items, port_state_arrays
    from test_torch_round import CFG, GRID, _rows, _run_port

    from repro_torch.configs import FedConfig
    from repro_torch.core.fed_state import init_fed_state
    from repro_torch.models.forecasting import init_forecaster

    knobs = GRID[name]
    act, stale, batches = _rows(seed=1)
    init = port_state_arrays(init_fed_state(
        torch.Generator().manual_seed(2), lambda g: init_forecaster(g, CFG),
        FedConfig(n_clients=5, **knobs), device="cpu"))
    grouped, _ = _run_port(knobs, init, act, stale, batches)

    def per_leaf(zs, Ws, phis, weights, psi, alpha_z, message="f32",
                 impl="auto", n_total=None):
        return [ops.sign_consensus(z, W, p, weights, psi, alpha_z,
                                   message=message, impl=impl,
                                   n_total=n_total)
                for z, W, p in zip(zs, Ws, phis)]

    monkeypatch.setattr(ops, "sign_consensus_leaves", per_leaf)
    split, _ = _run_port(knobs, init, act, stale, batches)
    for t in range(len(grouped)):
        a, b = dict(flat_items(grouped[t])), dict(flat_items(split[t]))
        assert sorted(a) == sorted(b)
        for path in a:
            assert np.asarray(a[path]).tobytes() == \
                np.asarray(b[path]).tobytes(), f"round {t} {path}"


# ---- B3 over every leaf of a tree (sign_agg_int8_group) -----------------

INT8_LEAF_D = MAIN_LEAF_D + [1, 3, 24, 8193]


def _int8_leaves(sizes, C, seed):
    """(z, payload, phi_mean) per leaf: ternary int8 signs, as the wire
    carries them."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(D).astype(np.float32),
             rng.randint(-1, 2, (C, D)).astype(np.int8),
             (rng.randn(D) * 0.01).astype(np.float32)) for D in sizes]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["plain", "weighted", "n_total"])
def test_sign_agg_int8_group_matches_reference_pallas_per_leaf(reference,
                                                               dtype, mode):
    """The grouped B3 call on the CPU against the reference's Pallas B3
    (``sign_agg_weighted_int8`` in interpret mode, as the reference's own
    tests run it), leaf by leaf over the 8 MLP_H24 leaves and odd sizes:
    unweighted (int32 sum), with the scale column, and with ``n_total``."""
    import jax.numpy as jnp

    C = 10
    leaves = _int8_leaves(INT8_LEAF_D, C, 6)
    sw = np.random.RandomState(7).uniform(0.05, 1.0, C).astype(np.float32)
    scale = None if mode == "plain" else sw
    n_total = 3 * C if mode == "n_total" else 0
    got = sign_agg.sign_agg_int8_group(
        [_torch(z, dtype) for z, _, _ in leaves],
        [torch.from_numpy(q) for _, q, _ in leaves],
        [_torch(p, dtype) for _, _, p in leaves], _torch(scale, "float32"),
        PSI, ALPHA, n_total=n_total)
    assert len(got) == len(leaves)
    for (z, q, phi), g in zip(leaves, got):
        want = reference.sign_agg.sign_agg_weighted_int8(
            _jax(z, dtype), jnp.asarray(q), _jax(scale, "float32"),
            _jax(phi, dtype), PSI, ALPHA, n_total=n_total, interpret=True)
        assert g.dtype == getattr(torch, dtype) and g.shape == (z.size,)
        _close(g, want, dtype)


@pytest.mark.parametrize("decay", ["constant", "poly"])
def test_int8_round_makes_one_grouped_call(monkeypatch, decay):
    """With the int8 wire, each round of ``train_bafdp`` makes one grouped
    B3 call over all 8 leaves and no one-leaf call, and each round's
    ``ops.sign_consensus_leaves`` equals ``ops.sign_consensus`` leaf by
    leaf on the same inputs, bit for bit."""
    from repro_torch import train
    from repro_torch.configs import FedConfig

    grouped = sign_agg.sign_agg_int8_group
    one = sign_agg.sign_agg_weighted_int8
    leaves_of = ops.sign_consensus_leaves
    group_calls, one_leaf_calls, rounds = [], [], []

    def group_spy(zs, *args, **kwargs):
        group_calls.append([z.numel() for z in zs])
        return grouped(zs, *args, **kwargs)

    def one_spy(*args, **kwargs):
        one_leaf_calls.append(1)
        return one(*args, **kwargs)

    def captured(zs, Ws, phis, weights, psi, alpha_z, **kwargs):
        got = leaves_of(zs, Ws, phis, weights, psi, alpha_z, **kwargs)
        rounds.append(([t.clone() for t in zs], [t.clone() for t in Ws],
                       [t.clone() for t in phis],
                       None if weights is None else weights.clone(), psi,
                       alpha_z, kwargs, [t.clone() for t in got]))
        return got

    monkeypatch.setattr(sign_agg, "sign_agg_int8_group", group_spy)
    monkeypatch.setattr(sign_agg, "sign_agg_weighted_int8", one_spy)
    monkeypatch.setattr(ops, "sign_consensus_leaves", captured)
    train.train_bafdp("milano", 24, FedConfig(
        n_clients=4, sign_message="int8", staleness_decay=decay), rounds=3,
        device="cpu")
    assert group_calls == [MAIN_LEAF_D] * 3 and not one_leaf_calls
    assert len(rounds) == 3 and rounds[0][6] == {"message": "int8"}
    for zs, Ws, phis, weights, psi, alpha_z, kwargs, got in rounds:
        for z, W, p, g in zip(zs, Ws, phis, got):
            want = ops.sign_consensus(z, W, p, weights, psi, alpha_z,
                                      **kwargs)
            assert g.numpy().tobytes() == want.numpy().tobytes()


def test_cpu_int8_group_never_reaches_the_kernel_build(monkeypatch):
    """On the CPU the grouped B3 call and the int8 dispatch over leaves run
    the plain version, build nothing and count no launch."""
    from repro_torch.kernels import _build

    def refuse(name):
        raise AssertionError("the CPU path tried to build a kernel")

    monkeypatch.setattr(_build, "load", refuse)
    sign_agg.reset_launch_counts()
    leaves = _int8_leaves(MAIN_LEAF_D, 4, 0)
    zs, qs, phis = ([torch.from_numpy(leaf[k]) for leaf in leaves]
                    for k in range(3))
    sign_agg.sign_agg_int8_group(zs, qs, phis, None, PSI, ALPHA)
    sign_agg.sign_agg_int8_group(zs, qs, phis, torch.ones(4), PSI, ALPHA,
                                 n_total=8)
    Ws = [torch.randn(4, z.numel()) for z in zs]
    ops.sign_consensus_leaves(zs, Ws, phis, torch.ones(4), PSI, ALPHA,
                              message="int8")
    assert set(sign_agg.LAUNCHES.values()) == {0}


def test_int8_group_validation_errors():
    leaves = _int8_leaves([128, 64], 4, 0)
    zs, qs, phis = ([torch.from_numpy(leaf[k]) for leaf in leaves]
                    for k in range(3))
    with pytest.raises(ValueError, match="leaves"):
        sign_agg.sign_agg_int8_group([], [], [], None, PSI, ALPHA)
    with pytest.raises(ValueError, match="leaves"):
        sign_agg.sign_agg_int8_group(zs, qs[:1], phis, None, PSI, ALPHA)
    with pytest.raises(ValueError, match="n_total"):
        ops.sign_consensus_leaves(zs, [q.float() for q in qs], phis, None,
                                  PSI, ALPHA, message="int8", n_total=8)
