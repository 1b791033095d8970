"""The CUDA kernels B1-B3 on the card against their plain versions on the
card, bit for bit.  Needs a CUDA device and nvcc; skips without a device.
Imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import ref, sign_agg

GRID_D = [128, 1024, 5000, 8193]
GRID_C = [2, 16]
DTYPES = ["float32", "bfloat16"]
PSI, ALPHA = 0.005, 0.01


def _problem(D, C, seed):
    rng = np.random.RandomState(seed)
    z = rng.randn(D).astype(np.float32)
    W = rng.randn(C, D).astype(np.float32)
    phi = (rng.randn(D) * 0.01).astype(np.float32)
    sw = rng.uniform(0.05, 1.0, C).astype(np.float32)
    return z, W, phi, sw


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns, NaN positions equal whatever their payload."""
    a, b = a.float().cpu(), b.float().cpu()
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32),
                                b[~nan].view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("D", GRID_D)
@pytest.mark.parametrize("C", GRID_C + [200])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernels_match_plain_versions_bitwise(D, C, dtype):
    """Each kernel launched on the card equals its plain version run on
    the card on the same inputs, bit for bit (NaN and ties included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    z, W, phi, sw = _problem(D, C, D + C)
    W[0, :5] = np.nan
    W[1, 5:9] = z[5:9]
    dev = torch.device("cuda")
    tz, tW, tphi = (_torch(a, dtype).to(dev) for a in (z, W, phi))
    tsw = torch.from_numpy(sw).to(dev)
    payload = collectives.encode_sign_message(tz, tW).payload
    sign_agg.reset_launch_counts()
    pairs = [
        (sign_agg.sign_agg(tz, tW, tphi, PSI, ALPHA),
         ref.sign_agg_ref(tz, tW, tphi, PSI, ALPHA)),
        (sign_agg.sign_agg_weighted(tz, tW, tphi, tsw, PSI, ALPHA),
         ref.sign_agg_weighted_ref(tz, tW, tphi, tsw, PSI, ALPHA)),
        (sign_agg.sign_agg_weighted(tz, tW, tphi, tsw, PSI, ALPHA,
                                    n_total=3 * C),
         ref.sign_agg_fold_ref(tz, tW, tphi, tsw, PSI, ALPHA, 3 * C)),
        (sign_agg.sign_agg_weighted_int8(tz, payload, tsw, tphi, PSI, ALPHA),
         ref.sign_agg_int8_ref(tz, payload, tsw, tphi, PSI, ALPHA)),
        (sign_agg.sign_agg_weighted_int8(tz, payload, None, tphi, PSI,
                                         ALPHA),
         ref.sign_agg_int8_ref(tz, payload, None, tphi, PSI, ALPHA)),
    ]
    torch.cuda.synchronize()
    assert sign_agg.LAUNCHES == {"sign_agg": 1, "sign_agg_weighted": 2,
                                 "sign_agg_weighted_int8": 2}
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == tz.dtype
        assert _bits_equal(got, want), f"pair {i}"


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    z, W, phi, sw = (torch.from_numpy(a).cuda() for a in _problem(128, 4, 0))
    with pytest.raises(TypeError):
        sign_agg.sign_agg(z.double(), W.double(), phi.double(), PSI, ALPHA)
    with pytest.raises(ValueError, match="contiguous"):
        sign_agg.sign_agg(z, W.t().contiguous().t(), phi, PSI, ALPHA)
    with pytest.raises(ValueError):
        sign_agg.sign_agg_weighted(z, W, phi, sw[:3], PSI, ALPHA)
    with pytest.raises(TypeError):
        sign_agg.sign_agg_weighted_int8(z, W, None, phi, PSI, ALPHA)
