"""The CUDA kernels on the card against their plain versions on the card:
B1-B3 bit for bit; B4 (prefill attention) and B5 (decode attention)
within abs/rel 3e-5 in f32 (the reference's own bound between its
kernels and oracles, tests/test_kernels.py) and, in bf16, within one
rounding of the output: 1e-2 relative plus 1e-3 of the output's RMS
(kernel and plain version both compute in f32 from the same bf16 inputs
and round once, so they may differ by one bf16 ulp, <= 2^-7).  And a
full-width SmolLM-360M generate through both attention kernels, its
launches counted.  Needs a CUDA device and nvcc; skips without a device.
Imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
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


def _randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(
        getattr(torch, dtype))


def _n_sm():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _assert_close(got, want, dtype):
    """The bounds of the module docstring."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    if dtype == "float32":
        torch.testing.assert_close(g, w, atol=3e-5, rtol=3e-5)
    else:
        torch.testing.assert_close(
            g, w, rtol=1e-2, atol=1e-3 * float(w.pow(2).mean().sqrt()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", [
    (2, 128, 128, 4, 2, 64, True, 0), (2, 256, 256, 2, 2, 128, True, 64),
    (2, 256, 256, 6, 2, 64, False, 0), (2, 100, 300, 6, 2, 64, True, 0),
    (1, 77, 77, 3, 1, 256, True, 32), (2, 1, 65, 15, 5, 64, True, 0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_attention_matches_plain_version(B, Sq, Sk, H, Hkv, D,
                                                    causal, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = _randn((B, Sq, H, D), dtype, 1)
    k = _randn((B, Sk, Hkv, D), dtype, 2)
    v = _randn((B, Sk, Hkv, D), dtype, 3)
    fa_k.reset_launch_counts()
    got = fa_k.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_k.LAUNCHES["flash_attention"] == 1
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,Hkv,D", [
    (3, 256, 4, 2, 64), (3, 512, 8, 8, 128), (3, 1024, 2, 1, 64),
    (3, 777, 15, 5, 64), (2, 300, 16, 16, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_attention_matches_plain_version(B, L, H, Hkv, D, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = _randn((B, H, D), dtype, 4)
    k = _randn((B, L, Hkv, D), dtype, 5)
    v = _randn((B, L, Hkv, D), dtype, 6)
    length = torch.tensor([1, L // 2, L][:B], dtype=torch.int32,
                          device="cuda")
    k_poisoned, v_poisoned = k.clone(), v.clone()
    for b in range(B):      # nothing at or past length[b] may be read
        k_poisoned[b, int(length[b]):] = float("nan")
        v_poisoned[b, int(length[b]):] = float("nan")
    dec_k.reset_launch_counts()
    got = dec_k.decode_attention(q, k_poisoned, v_poisoned, length)
    want = ref.decode_attention_ref(q, k, v, length)
    torch.cuda.synchronize()
    assert dec_k.LAUNCHES["decode_attention"] == dec_k.launches_per_call(
        B, Hkv, L, _n_sm())
    _assert_close(got, want, dtype)


@pytest.mark.cuda
def test_cuda_full_width_generate_launches_the_attention_kernels():
    """SmolLM-360M at full width (32 layers, d 960) on the card: a
    4-token generate runs B5 in every layer of every step; a prefill
    step runs B4 once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ServeEngine, ServeRequest

    cfg = get_arch("smollm-360m")
    params = tr.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    prompts = [np.arange(1, 9, dtype=np.int32), np.arange(5, 8,
                                                          dtype=np.int32)]
    dec_k.reset_launch_counts()
    fa_k.reset_launch_counts()
    eng = ServeEngine(params, cfg, batch=2, cache_len=64)
    outs = eng.generate([ServeRequest(prompt=p, max_new=4) for p in prompts])
    assert eng.steps == 8 + 4
    assert dec_k.LAUNCHES["decode_attention"] == 32 * eng.steps * \
        dec_k.launches_per_call(2, cfg.n_kv_heads, 64, _n_sm())
    assert [len(o) for o in outs] == [4, 4]
    assert all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs)
    toks = torch.from_numpy(np.stack([np.arange(40)] * 2)).cuda()
    logits = make_prefill_step(cfg)(params, {"tokens": toks})
    assert fa_k.LAUNCHES["flash_attention"] == 32
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
