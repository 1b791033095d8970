"""The port's wire formats against the reference's: the int8 sign message
(lossless) and the absmax int8 dual message, exactly — the same f32
values go in, the same int8 payloads and f32 scales come out."""
import numpy as np
import pytest
import torch
from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.distributed import collectives


def _signs_problem(D=700, C=9, seed=3):
    rng = np.random.RandomState(seed)
    z = rng.randn(D).astype(np.float32)
    W = rng.randn(C, D).astype(np.float32)
    W[0, :10] = z[:10]                   # exact ties: sign 0
    sw = rng.uniform(0.05, 1.0, C).astype(np.float32)
    return z, W, sw


@pytest.mark.parametrize("weighted", [True, False])
def test_sign_message_matches_reference_exactly(reference, weighted):
    rc = reference.collectives
    z, W, sw = _signs_problem()
    sw = sw if weighted else None
    want = rc.encode_sign_message(z, W, sw)
    got = collectives.encode_sign_message(
        torch.from_numpy(z), torch.from_numpy(W),
        None if sw is None else torch.from_numpy(sw))
    assert got.payload.dtype == torch.int8
    np.testing.assert_array_equal(got.payload.numpy(),
                                  np.asarray(want.payload))
    if weighted:
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
    else:
        assert got.scale is None and want.scale is None
    np.testing.assert_array_equal(
        collectives.decode_sign_message(got).numpy(),
        np.asarray(rc.decode_sign_message(want)))
    # lossless: the decoded message IS s_i * sign(z - w_i)
    sgn = np.sign(z[None] - W)
    np.testing.assert_array_equal(
        collectives.decode_sign_message(got).numpy(),
        sgn if sw is None else sgn * sw[:, None])
    # the reduction: int32 exact when unweighted; an f32 fold when weighted
    tol = 0 if sw is None else 1e-6
    np.testing.assert_allclose(collectives.sign_sum(got, 9).numpy(),
                               np.asarray(rc.sign_sum(want, 9)),
                               rtol=0, atol=tol)


def test_message_bytes_match_reference(reference):
    rc = reference.collectives
    for args in [(9, 700, "int8"), (9, 700, "f32")]:
        for weighted in (True, False):
            assert collectives.message_bytes(*args, weighted=weighted) \
                == rc.message_bytes(*args, weighted=weighted)
        assert collectives.dual_message_bytes(*args) \
            == rc.dual_message_bytes(*args)
    for fn in (collectives.message_bytes, collectives.dual_message_bytes):
        with pytest.raises(ValueError, match="unknown"):
            fn(9, 700, "int4")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dual_message_matches_reference_exactly(reference, seed):
    rc = reference.collectives
    rng = np.random.RandomState(seed)
    phi = (rng.randn(6, 513) * 10.0 ** rng.uniform(-6, 2, (6, 1))
           ).astype(np.float32)
    phi[2] = 0.0                         # an all-zero row: scale 1
    phi[3, 7] = -np.abs(phi[3]).max() * 1.5   # a negative absmax
    want = rc.encode_dual_message(phi)
    got = collectives.encode_dual_message(torch.from_numpy(phi))
    np.testing.assert_array_equal(got.payload.numpy(),
                                  np.asarray(want.payload))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    dec = collectives.decode_dual_message(got).numpy()
    np.testing.assert_array_equal(dec,
                                  np.asarray(rc.decode_dual_message(want)))
    bound = np.abs(phi).max(axis=1, keepdims=True) \
        * collectives.DUAL_INT8_REL_ERR
    assert (np.abs(dec - phi) <= bound * (1 + 1e-6)).all()
