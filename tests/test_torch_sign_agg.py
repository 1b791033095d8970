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
