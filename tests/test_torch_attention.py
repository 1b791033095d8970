"""The attention kernels B4 (prefill) and B5 (decode): their plain versions
against the reference's oracles and against the reference's Pallas
kernels (run in interpret mode on the CPU), on the reference's own test
grid (``tests/test_kernels.py``) in f32 and bf16; Sq < Sk against the
oracle only (the Pallas kernel aligns queries to the start there, the
oracle to the end).  Also: the wrappers' argument checks, and that a CPU
tensor runs the plain version and launches nothing.  (The CUDA kernels
against their plain versions: test_torch_cuda.py.)

Tolerances: abs/rel 3e-5 in f32, the reference's own bound between its
kernel and its oracle (``tests/test_kernels.py``); 3e-2 in bf16 (one
bf16 rounding of the output, ~4e-3 relative, plus the inputs' own).

The reference's ``repro.kernels`` imports without the ``jax.core`` alias.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops, ref

FLASH_GRID = [(128, 4, 2, 64), (256, 2, 2, 128), (256, 6, 2, 64)]
MASKS = [(True, 0), (True, 64), (False, 0)]
DECODE_GRID = [(256, 4, 2, 64, 64), (512, 8, 8, 128, 128),
               (1024, 2, 1, 64, 256)]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def jref():
    return SimpleNamespace(
        ref=importlib.import_module("repro.kernels.ref"),
        ops=importlib.import_module("repro.kernels.ops"))


def _tol(dtype):
    return 3e-5 if dtype == "float32" else 3e-2


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _jax(a, dtype):
    import jax.numpy as jnp
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, dtype):
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S,H,Hkv,Dh", FLASH_GRID)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_plain_matches_reference(jref, S, H, Hkv, Dh, causal,
                                                 window, dtype):
    """Through the port's dispatch on CPU tensors (the plain version)
    against the reference's oracle and its Pallas kernel."""
    B = 2
    q, k, v = _arrays(S + H, (B, S, H, Dh), (B, S, Hkv, Dh),
                      (B, S, Hkv, Dh))
    fa_k.reset_launch_counts()
    got = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), causal=causal, window=window)
    assert fa_k.LAUNCHES["flash_attention"] == 0
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    _close(got, jref.ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                             window=window), dtype)
    _close(got, jref.ops.flash_attention(jq, jk, jv, causal=causal,
                                         window=window, impl="interpret",
                                         bq=64, bk=64), dtype)


@pytest.mark.parametrize("Sq,Sk", [(64, 192), (100, 300), (1, 77)])
@pytest.mark.parametrize("causal,window", MASKS + [(False, 32)])
def test_flash_attention_plain_sq_below_sk_matches_oracle(jref, Sq, Sk,
                                                          causal, window):
    """Queries end-aligned with the keys, ragged lengths included."""
    q, k, v = _arrays(Sq + Sk, (2, Sq, 6, 64), (2, Sk, 2, 64), (2, Sk, 2, 64))
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window)
    want = jref.ref.flash_attention_ref(_jax(q, "float32"),
                                        _jax(k, "float32"),
                                        _jax(v, "float32"), causal=causal,
                                        window=window)
    _close(got, want, "float32")


@pytest.mark.parametrize("L,H,Hkv,Dh,bl", DECODE_GRID)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_plain_matches_reference(jref, L, H, Hkv, Dh, bl,
                                                  dtype):
    B = 3
    q, k, v = _arrays(L, (B, H, Dh), (B, L, Hkv, Dh), (B, L, Hkv, Dh))
    length = np.array([1, L // 2, L], np.int32)
    dec_k.reset_launch_counts()
    got = ops.decode_attention(_torch(q, dtype), _torch(k, dtype),
                               _torch(v, dtype), torch.from_numpy(length))
    assert dec_k.LAUNCHES["decode_attention"] == 0
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    jlen = _jax(length, "int32")
    _close(got, jref.ref.decode_attention_ref(jq, jk, jv, jlen), dtype)
    _close(got, jref.ops.decode_attention(jq, jk, jv, jlen, impl="interpret",
                                          bl=bl), dtype)


def test_decode_attention_plain_odd_cache_matches_oracle(jref):
    q, k, v = _arrays(7, (4, 15, 64), (4, 777, 5, 64), (4, 777, 5, 64))
    length = np.array([1, 388, 777, 500], np.int32)
    got = ref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(length))
    want = jref.ref.decode_attention_ref(
        _jax(q, "float32"), _jax(k, "float32"), _jax(v, "float32"),
        _jax(length, "int32"))
    _close(got, want, "float32")


def test_decode_split_len_covers_the_cache_in_whole_chunks():
    """Whole chunks, covering L, at most ``MAX_SPLITS`` splits (one
    cluster), and no more splits than give ``BLOCKS_PER_SM`` blocks per
    SM."""
    for B, Hkv, L in [(8, 5, 4096), (8, 5, 512), (3, 2, 256), (1, 1, 1),
                      (8, 5, 777), (128, 8, 32768), (1, 1, 32768)]:
        sl = dec_k.split_len(B, Hkv, L, 132)
        n = -(-L // sl)
        assert sl % dec_k.CHUNK == 0 and (n - 1) * sl < L <= n * sl
        assert n <= dec_k.MAX_SPLITS == 8
        assert n == 1 or B * Hkv * (n - 1) < dec_k.BLOCKS_PER_SM * 132
    assert dec_k.split_len(8, 5, 4096, 132) == 512       # 8 splits
    assert dec_k.split_len(8, 5, 512, 132) == 64         # 8 splits


@pytest.mark.parametrize("B,Hkv,L,launches", [
    (8, 5, 512, 1), (8, 5, 4096, 1), (2, 5, 64, 1), (1, 1, 1, 1),
    (2, 5, 65, 1), (128, 8, 32768, 1)])
def test_decode_launches_per_call(B, Hkv, L, launches):
    """One launch per call at every shape: the splits merge through the
    cluster's shared memory, with no combine pass."""
    assert dec_k.launches_per_call(B, Hkv, L, 132) == launches


def _flash_inputs(dtype=torch.float32, B=1, Sq=8, Sk=8, H=4, Hkv=2, D=64):
    q = torch.zeros((B, Sq, H, D), dtype=dtype)
    k = torch.zeros((B, Sk, Hkv, D), dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("case,exc,match", [
    (lambda: _flash_inputs(), ValueError, "CUDA"),
    (lambda: _flash_inputs(torch.float64), TypeError, "float32"),
    (lambda: (lambda q, k, v: (q, k.bfloat16(), v))(*_flash_inputs()),
     TypeError, "dtype"),
    (lambda: (lambda q, k, v: (q.transpose(1, 2).contiguous()
                               .transpose(1, 2), k, v))(*_flash_inputs()),
     ValueError, "contiguous"),
    (lambda: _flash_inputs(D=48), ValueError, "head dim"),
    (lambda: _flash_inputs(H=5, Hkv=2), ValueError, "KV head"),
    (lambda: _flash_inputs(Sq=9, Sk=8), ValueError, "Sq=9 > Sk=8"),
    (lambda: (lambda q, k, v: (q, k, v[:, :4]))(*_flash_inputs()),
     ValueError, "expected"),
])
def test_flash_attention_checks_raise(case, exc, match):
    """The wrapper's checks (run for CUDA tensors): on the CPU every valid
    input gets as far as the device check."""
    q, k, v = case()
    with pytest.raises(exc, match=match):
        fa_k.check_args(q, k, v, True, 0)


def test_flash_attention_check_window_and_alignment():
    q, k, v = _flash_inputs()
    with pytest.raises(ValueError, match="window"):
        fa_k.check_args(q, k, v, True, -1)
    buf = torch.zeros(q.numel() + 1)
    with pytest.raises(ValueError, match="aligned"):
        fa_k.check_args(buf[1:].view(q.shape), k, v, True, 0)


@pytest.mark.parametrize("change,exc,match", [
    ({}, ValueError, "CUDA"),
    ({"length": torch.ones(2, dtype=torch.int64)}, ValueError, "int32"),
    ({"length": torch.ones(3, dtype=torch.int32)}, ValueError, "length"),
    ({"q": torch.zeros((2, 4, 32))}, ValueError, "do not match"),
    ({"v": torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16)}, ValueError,
     "expected"),
    ({"q": torch.zeros((2, 3, 64))}, ValueError, "KV head"),
])
def test_decode_attention_checks_raise(change, exc, match):
    args = {"q": torch.zeros((2, 4, 64)), "k": torch.zeros((2, 16, 2, 64)),
            "v": torch.zeros((2, 16, 2, 64)),
            "length": torch.ones(2, dtype=torch.int32)}
    args.update(change)
    with pytest.raises(exc, match=match):
        dec_k.check_args(args["q"], args["k"], args["v"], args["length"])


def test_dispatch_on_cpu_tensors_is_the_plain_version():
    """The model's entry points go straight to the wrappers: on the CPU
    they return the plain version bit for bit and launch nothing."""
    q, k, v = (torch.from_numpy(a) for a in _arrays(
        3, (2, 40, 6, 64), (2, 40, 2, 64), (2, 40, 2, 64)))
    length = torch.tensor([1, 40], dtype=torch.int32)
    fa_k.reset_launch_counts()
    dec_k.reset_launch_counts()
    assert torch.equal(ops.flash_attention(q, k, v, causal=True, window=8),
                       ref.flash_attention_ref(q, k, v, causal=True,
                                               window=8))
    assert torch.equal(ops.decode_attention(q[:, -1], k, v, length),
                       ref.decode_attention_ref(q[:, -1], k, v, length))
    assert fa_k.LAUNCHES["flash_attention"] == 0
    assert dec_k.LAUNCHES["decode_attention"] == 0
