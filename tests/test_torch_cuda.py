"""The CUDA kernels on the card against their plain versions on the card:
B1-B3 bit for bit (each also as one grouped launch over many leaves,
and inside training rounds against one-leaf calls); B4 (prefill attention) and B5 (decode attention)
within abs/rel 3e-5 in f32 (the reference's own bound between its
kernels and oracles, tests/test_kernels.py) and, in bf16, within one
rounding of the output: 1e-2 relative plus 1e-3 of the output's RMS
(kernel and plain version both compute in f32 from the same bf16 inputs
and round once, so they may differ by one bf16 ulp, <= 2^-7); B6 (the
Mamba selective scan) bit for bit.  And a full-width SmolLM-360M
generate through both attention kernels, its launches counted, and the
Hymba and Granite-MoE smoke models on the card against the CPU.  B4's
backward (f32 and bf16, head dim 64) within 1e-5 + 1e-4 |plain|
elementwise (plus one bf16 ulp of the plain value in bf16) and bit for
bit run to run, B4's output (both dtypes) the same with and without its
log-sum-exp, B6's backward bit for bit, autograd through both, and B5
refusing autograd (no backward).  B4 and B5 also at Gemma-7B's and
Phi3-medium's heads (B5 over long_500k's ring of 8,192 slots), RoPE's
frequencies equal on both devices, a checkpoint of CUDA tensors
restored onto the card bit for bit, and the host mesh on the card (one
NCCL rank; placed tensors are the tensors; a placed round is the
unplaced round bit for bit).
Needs a CUDA device and nvcc; skips without a device.
Imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ref, sign_agg, ssm_scan

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


MAIN_LEAF_D = [128, 2816, 128, 16384, 64, 8192, 24, 1536]   # MLP_H24


def _group_leaves(sizes, C, dtype, seed, offset=()):
    """(z, W, phi) per leaf on the card, NaN and tie columns included;
    the leaves numbered in ``offset`` are views one element into their
    storage (misaligned for 16-byte vectors)."""
    leaves = []
    for l, D in enumerate(sizes):
        z, W, phi, _ = _problem(D, C, seed + l)
        W[0, :min(D, 2)] = np.nan
        W[C - 1, 2:4] = z[2:4]
        k = 1 if l in offset else 0
        t = [_torch(np.concatenate([np.zeros(k, np.float32), a.ravel()]),
                    dtype).cuda()[k:] for a in (z, W, phi)]
        leaves.append((t[0], t[1].view(C, D), t[2]))
    return leaves


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "weighted", "n_total"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_sign_agg_group_matches_plain_version_bitwise(mode, dtype):
    """One grouped launch over the MLP_H24 leaves, odd sizes, misaligned
    views and the TPU grid's sizes equals the plain version bit for bit;
    the main-path leaves take the vector path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = 10
    sizes = MAIN_LEAF_D + [1, 3, 8193, 1000, 1024] + GRID_D
    n = len(MAIN_LEAF_D)
    zs, Ws, phis = map(list, zip(*_group_leaves(
        sizes, C, dtype, 7, offset=(n + 3, n + 4))))
    sw = torch.from_numpy(_problem(1, C, 1)[3]).cuda()
    weights = None if mode == "plain" else sw
    n_total = 3 * C if mode == "n_total" else 0
    isz = zs[0].element_size()
    table = sign_agg.leaf_table(
        [(z.data_ptr(), W.data_ptr(), p.data_ptr(), 0, z.numel())
         for z, W, p in zip(zs, Ws, phis)], isz)
    flags = table[6::sign_agg.TABLE_COLS]
    assert flags[:n] == [1] * n and flags[n + 3:n + 5] == [0, 0]
    sign_agg.reset_launch_counts()
    got = sign_agg.sign_agg_group(zs, Ws, phis, weights, PSI, ALPHA,
                                  n_total=n_total)
    torch.cuda.synchronize()
    want = ref.sign_agg_group_ref(zs, Ws, phis, weights, PSI, ALPHA,
                                  n_total=n_total)
    name = "sign_agg" if weights is None else "sign_agg_weighted"
    assert sign_agg.LAUNCHES[name] == 1
    assert sum(sign_agg.LAUNCHES.values()) == 1
    for l, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _bits_equal(g, w), f"leaf {l} D={sizes[l]}"


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 16, 200])
def test_cuda_sign_agg_group_splits_past_max_leaves(C):
    """65 leaves take two launches and still equal the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sizes = [(37 * l) % 300 + 1 for l in range(sign_agg.MAX_LEAVES + 1)]
    zs, Ws, phis = map(list, zip(*_group_leaves(sizes, C, "float32", 3)))
    sw = torch.from_numpy(_problem(1, C, 2)[3]).cuda()
    sign_agg.reset_launch_counts()
    got = sign_agg.sign_agg_group(zs, Ws, phis, sw, PSI, ALPHA)
    torch.cuda.synchronize()
    assert sign_agg.LAUNCHES["sign_agg_weighted"] == 2
    want = ref.sign_agg_group_ref(zs, Ws, phis, sw, PSI, ALPHA)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_sign_agg_group_raises_on_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    zs, Ws, phis = map(list, zip(*_group_leaves([128, 64], 4, "float32",
                                                0)))
    with pytest.raises(TypeError):                      # mixed dtypes
        sign_agg.sign_agg_group(zs, [Ws[0], Ws[1].bfloat16()],
                                [phis[0], phis[1].bfloat16()], None, PSI,
                                ALPHA)
    with pytest.raises(TypeError):
        sign_agg.sign_agg_group([zs[0], zs[1].bfloat16()], Ws,
                                [phis[0], phis[1].bfloat16()], None, PSI,
                                ALPHA)
    with pytest.raises(ValueError, match="C=4"):        # mixed C
        sign_agg.sign_agg_group(zs, [Ws[0], Ws[1][:3].contiguous()], phis,
                                None, PSI, ALPHA)
    with pytest.raises(ValueError, match="CUDA"):       # a CPU leaf
        sign_agg.sign_agg_group([zs[0], zs[1].cpu()], [Ws[0], Ws[1].cpu()],
                                [phis[0], phis[1].cpu()], None, PSI, ALPHA)
    with pytest.raises(ValueError):                     # weights (C,)
        sign_agg.sign_agg_group(zs, Ws, phis, torch.ones(3, device="cuda"),
                                PSI, ALPHA)
    with pytest.raises(ValueError, match="contiguous"):
        sign_agg.sign_agg_group(zs, [Ws[0], Ws[1].t().contiguous().t()],
                                phis, None, PSI, ALPHA)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    dict(staleness_decay="constant"), dict(staleness_decay="poly"),
    dict(staleness_decay="hinge", fedbuff_lr_norm=True)])
def test_cuda_sign_agg_group_in_rounds_equals_one_leaf_calls(monkeypatch,
                                                             knobs):
    """In 3 training rounds on the card, each grouped consensus call
    equals one-leaf kernel calls on the same leaves, bit for bit; B1/B2
    launch once a round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import train
    from repro_torch.configs import FedConfig
    from repro_torch.kernels import ops

    grouped = ops.sign_consensus_leaves
    calls = []

    def checked(zs, Ws, phis, weights, psi, alpha_z, **kwargs):
        got = grouped(zs, Ws, phis, weights, psi, alpha_z, **kwargs)
        for z, W, p, g in zip(zs, Ws, phis, got):
            one = (sign_agg.sign_agg(z, W, p, psi, alpha_z)
                   if weights is None else
                   sign_agg.sign_agg_weighted(z, W, p, weights, psi,
                                              alpha_z))
            assert _bits_equal(g, one)
        calls.append([z.numel() for z in zs])
        return got

    monkeypatch.setattr(ops, "sign_consensus_leaves", checked)
    sign_agg.reset_launch_counts()
    train.train_bafdp("milano", 24, FedConfig(n_clients=10, **knobs),
                      rounds=3, device="cuda")
    assert calls == [MAIN_LEAF_D] * 3
    name = ("sign_agg" if knobs["staleness_decay"] == "constant"
            else "sign_agg_weighted")
    assert sign_agg.LAUNCHES[name] == 3 + 3 * len(MAIN_LEAF_D)


def _payloads(zs, C, seed, offset=()):
    """A (C, D) int8 payload per leaf on the card, full-range values (the
    kernel sign-extends every byte); the leaves numbered in ``offset`` are
    views one element into their storage."""
    rng = np.random.RandomState(seed)
    out = []
    for l, z in enumerate(zs):
        k = 1 if l in offset else 0
        q = rng.randint(-128, 128, C * z.numel() + k).astype(np.int8)
        out.append(torch.from_numpy(q).cuda()[k:].view(C, z.numel()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "weighted", "n_total"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_sign_agg_int8_group_matches_plain_version_bitwise(mode, dtype):
    """One grouped B3 launch over the MLP_H24 leaves, odd sizes,
    misaligned views and the TPU grid's sizes equals the plain version
    bit for bit; the main-path leaves take the vector path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = 10
    sizes = MAIN_LEAF_D + [1, 3, 8193, 1000, 1024] + GRID_D
    n = len(MAIN_LEAF_D)
    zs, _, phis = map(list, zip(*_group_leaves(
        sizes, C, dtype, 11, offset=(n + 3, n + 4))))
    qs = _payloads(zs, C, 12, offset=(n + 3, n + 4))
    sw = torch.from_numpy(_problem(1, C, 1)[3]).cuda()
    scale = None if mode == "plain" else sw
    n_total = 3 * C if mode == "n_total" else 0
    table = sign_agg.leaf_table(
        [(z.data_ptr(), q.data_ptr(), p.data_ptr(), 0, z.numel())
         for z, q, p in zip(zs, qs, phis)], 1)
    flags = table[6::sign_agg.TABLE_COLS]
    assert flags[:n] == [1] * n
    assert flags[n + 3:n + 5] == [0, 0]
    sign_agg.reset_launch_counts()
    got = sign_agg.sign_agg_int8_group(zs, qs, phis, scale, PSI, ALPHA,
                                       n_total=n_total)
    torch.cuda.synchronize()
    want = ref.sign_agg_int8_group_ref(zs, qs, phis, scale, PSI, ALPHA,
                                       n_total=n_total)
    assert sign_agg.LAUNCHES["sign_agg_weighted_int8"] == 1
    assert sum(sign_agg.LAUNCHES.values()) == 1
    for l, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _bits_equal(g, w), f"leaf {l} D={sizes[l]}"


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 16, 200])
def test_cuda_sign_agg_int8_group_splits_past_max_leaves(C):
    """65 leaves take two B3 launches and still equal the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sizes = [(37 * l) % 300 + 1 for l in range(sign_agg.MAX_LEAVES + 1)]
    zs, _, phis = map(list, zip(*_group_leaves(sizes, C, "float32", 3)))
    qs = _payloads(zs, C, 4)
    sw = torch.from_numpy(_problem(1, C, 2)[3]).cuda()
    sign_agg.reset_launch_counts()
    got = sign_agg.sign_agg_int8_group(zs, qs, phis, sw, PSI, ALPHA)
    torch.cuda.synchronize()
    assert sign_agg.LAUNCHES["sign_agg_weighted_int8"] == 2
    want = ref.sign_agg_int8_group_ref(zs, qs, phis, sw, PSI, ALPHA)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_sign_agg_int8_group_sums_past_the_int8_range(dtype):
    """C=200 all-ones payloads sum to 200 (an int8 sum would wrap to -56)
    on both paths: the update equals B1's with every client 1000 below z,
    and the plain version, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = 200
    zs, _, phis = map(list, zip(*_group_leaves([600, 8193, 4096], 1, dtype,
                                               5)))
    qs = [torch.ones(C, z.numel(), dtype=torch.int8, device="cuda")
          for z in zs]
    got = sign_agg.sign_agg_int8_group(zs, qs, phis, None, PSI, ALPHA)
    torch.cuda.synchronize()
    for z, q, p, g in zip(zs, qs, phis, got):
        below = (z.float()[None] - 1000.0).expand(C, -1).to(z.dtype)
        assert _bits_equal(g, ref.sign_agg_ref(z, below, p, PSI, ALPHA))
        assert _bits_equal(g, ref.sign_agg_int8_fold_ref(z, q, None, p, PSI,
                                                         ALPHA, C))


@pytest.mark.cuda
def test_cuda_sign_agg_int8_group_raises_on_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    zs, Ws, phis = map(list, zip(*_group_leaves([128, 64], 4, "float32",
                                                0)))
    qs = _payloads(zs, 4, 0)
    with pytest.raises(TypeError):                      # float rows
        sign_agg.sign_agg_int8_group(zs, Ws, phis, None, PSI, ALPHA)
    with pytest.raises(TypeError):                      # mixed z dtypes
        sign_agg.sign_agg_int8_group([zs[0], zs[1].bfloat16()], qs,
                                     [phis[0], phis[1].bfloat16()], None,
                                     PSI, ALPHA)
    with pytest.raises(ValueError, match="C=4"):        # mixed C
        sign_agg.sign_agg_int8_group(zs, [qs[0], qs[1][:3].contiguous()],
                                     phis, None, PSI, ALPHA)
    with pytest.raises(ValueError, match="CUDA"):       # a CPU leaf
        sign_agg.sign_agg_int8_group([zs[0], zs[1].cpu()],
                                     [qs[0], qs[1].cpu()],
                                     [phis[0], phis[1].cpu()], None, PSI,
                                     ALPHA)
    with pytest.raises(ValueError):                     # scale (C,)
        sign_agg.sign_agg_int8_group(zs, qs, phis,
                                     torch.ones(3, device="cuda"), PSI,
                                     ALPHA)
    with pytest.raises(ValueError, match="contiguous"):
        sign_agg.sign_agg_int8_group(zs, [qs[0], qs[1].t().contiguous().t()],
                                     phis, None, PSI, ALPHA)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["constant", "poly", "hinge"])
def test_cuda_sign_agg_int8_group_in_rounds_equals_one_leaf_calls(
        monkeypatch, decay):
    """In 3 training rounds on the card with the int8 wire, each grouped
    consensus call equals one-leaf B3 calls on the same leaves' payloads,
    bit for bit; B3 launches once a round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import train
    from repro_torch.configs import FedConfig
    from repro_torch.kernels import ops

    grouped = ops.sign_consensus_leaves
    calls = []

    def checked(zs, Ws, phis, weights, psi, alpha_z, **kwargs):
        got = grouped(zs, Ws, phis, weights, psi, alpha_z, **kwargs)
        for z, W, p, g in zip(zs, Ws, phis, got):
            msg = collectives.encode_sign_message(z, W, weights)
            one = sign_agg.sign_agg_weighted_int8(z, msg.payload, msg.scale,
                                                  p, psi, alpha_z)
            assert _bits_equal(g, one)
        calls.append([z.numel() for z in zs])
        return got

    monkeypatch.setattr(ops, "sign_consensus_leaves", checked)
    sign_agg.reset_launch_counts()
    train.train_bafdp("milano", 24, FedConfig(
        n_clients=10, sign_message="int8", staleness_decay=decay), rounds=3,
        device="cuda")
    assert calls == [MAIN_LEAF_D] * 3
    assert sign_agg.LAUNCHES["sign_agg_weighted_int8"] == \
        3 + 3 * len(MAIN_LEAF_D)


def _randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(
        getattr(torch, dtype))


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
    (1, 77, 77, 3, 1, 256, True, 32), (2, 1, 65, 15, 5, 64, True, 0),
    (2, 300, 300, 25, 5, 64, True, 0),                  # Hymba's heads
    (2, 100, 300, 25, 5, 64, True, 64),                 # Sq < Sk, window
    (1, 4097, 4097, 5, 1, 64, True, 0),                 # no whole tile
    (1, 200, 520, 4, 2, 128, False, 0), (1, 300, 300, 2, 1, 256, False, 100),
    (1, 512, 512, 16, 16, 256, True, 0),                # Gemma-7B's heads
    (1, 512, 512, 40, 10, 128, True, 0)])               # Phi3-medium's
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


# B4's backward: the bound chip_smoke.py holds it to, elementwise
BWD_ATOL, BWD_RTOL = 1e-5, 1e-4
# (B, Sq, Sk, H, Hkv, causal, window) that the backward's tiles make
# risky, in both dtypes: Sq and Sk not multiples of a tile with a window
# edge inside a tile, a group of 5 query heads at B=2, a row shorter than
# one tile
BWD_TILING_CASES = [(1, 200, 200, 4, 4, True, 50),
                    (2, 300, 300, 10, 2, True, 0), (1, 40, 40, 2, 1, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,causal,window", [
    (1, 1024, 1024, 15, 5, True, 0),                    # SmolLM's heads
    (2, 300, 300, 4, 2, True, 64), (1, 200, 333, 6, 2, False, 0),
    (2, 333, 200, 4, 4, False, 0), (1, 100, 250, 3, 1, True, 0),
    (1, 130, 130, 2, 1, False, 40),
    *BWD_TILING_CASES])
def test_cuda_flash_attention_backward_matches_plain_version(
        B, Sq, Sk, H, Hkv, causal, window):
    """The backward kernels (three launches a call) against their plain
    version on the same inputs, out and lse within 1e-5 + 1e-4 |plain|
    elementwise, and bit for bit the same on a second call (no
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (_randn(s, "float32", i) for i, s in enumerate(
        ((B, Sq, H, 64), (B, Sk, Hkv, 64), (B, Sk, Hkv, 64)), 1))
    do = _randn((B, Sq, H, 64), "float32", 9)
    out, lse = fa_k.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
    fa_k.reset_launch_counts()
    got = fa_k.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    again = fa_k.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    assert fa_k.LAUNCHES["flash_attention_bwd"] == 2 * fa_k.BWD_LAUNCHES
    for g, a, w in zip(got, again, want):
        assert _bits_equal(g, a)
        assert g.shape == w.shape and g.dtype == torch.float32
        assert bool(((g - w).abs() <= BWD_ATOL + BWD_RTOL * w.abs()).all())


def _bf16_ulp(w: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ``w`` (0 at 0)."""
    return torch.exp2(torch.floor(torch.log2(w.float().abs())) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,causal,window", [
    (1, 1024, 1024, 25, 5, True, 0),                    # Hymba's heads
    (2, 300, 300, 4, 2, True, 64), (1, 200, 333, 6, 2, False, 0),
    (2, 333, 200, 4, 4, False, 0), (1, 100, 250, 3, 1, True, 0),
    (1, 130, 130, 2, 1, False, 40),
    *BWD_TILING_CASES])
def test_cuda_flash_attention_backward_bf16_matches_plain_version(
        B, Sq, Sk, H, Hkv, causal, window):
    """The bf16 backward kernel against its plain version on the same bf16
    inputs, out and lse (from B4's bf16 forward): within 1e-5 + 1e-4
    |plain| plus one bf16 ulp of the plain value elementwise (both
    compute in f32 and round the gradient once), and bit for bit on a
    second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (_randn(s, "bfloat16", i) for i, s in enumerate(
        ((B, Sq, H, 64), (B, Sk, Hkv, 64), (B, Sk, Hkv, 64)), 1))
    do = _randn((B, Sq, H, 64), "bfloat16", 9)
    out, lse = fa_k.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
    fa_k.reset_launch_counts()
    got = fa_k.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    again = fa_k.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    assert fa_k.LAUNCHES["flash_attention_bwd"] == 2 * fa_k.BWD_LAUNCHES
    for g, a, w in zip(got, again, want):
        assert _bits_equal(g, a)
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        bound = BWD_ATOL + BWD_RTOL * w.float().abs() + _bf16_ulp(w)
        assert bool(((g.float() - w.float()).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", [
    (1, 4096, 4096, 25, 5, 64, True, 0), (2, 300, 300, 4, 2, 128, True, 64),
    (1, 200, 333, 6, 2, 64, False, 0)])
def test_cuda_flash_attention_bf16_lse_leaves_the_output_unchanged(
        B, Sq, Sk, H, Hkv, D, causal, window):
    """B4's bf16 kernel with its log-sum-exp output (ln 2 (m_2 + log2 l)
    from its base-2 softmax) gives the same output bit for bit as
    without it, and the plain version's lse within 1e-5 + 1e-6 |lse|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (_randn(s, "bfloat16", i) for i, s in enumerate(
        ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)), 1))
    plain = fa_k.flash_attention(q, k, v, causal=causal, window=window)
    out, lse = fa_k.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
    _, want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      with_lse=True)
    torch.cuda.synchronize()
    assert _bits_equal(out, plain) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", [
    (1, 4096, 4096, 15, 5, 64, True, 0), (1, 4096, 1500, 16, 16, 64, False, 0),
    (2, 300, 300, 4, 2, 128, True, 64)])
def test_cuda_flash_attention_lse_leaves_the_output_unchanged(
        B, Sq, Sk, H, Hkv, D, causal, window):
    """B4 with its log-sum-exp output gives the same output bit for bit as
    without it, and the plain version's lse within 1e-5 + 1e-6 |lse|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (_randn(s, "float32", i) for i, s in enumerate(
        ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)), 1))
    plain = fa_k.flash_attention(q, k, v, causal=causal, window=window)
    out, lse = fa_k.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
    _, want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      with_lse=True)
    torch.cuda.synchronize()
    assert _bits_equal(out, plain)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)


@pytest.mark.cuda
def test_cuda_autograd_through_b4_and_the_refusals():
    """Under autograd a CUDA f32 call of B4 is the Function: one forward
    launch, the backward's launches, gradients as autograd of the plain
    version.  So is a bf16 call (its gradients in bf16, the launches
    counted alike), and B6 under autograd is ``SsmScanFn`` (one forward
    and one backward launch, gradients as the plain backward's, bit for
    bit).  B5 under autograd raises NotImplementedError (no backward)
    and B4 at another head dim ValueError, rather than detach."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (_randn(s, "float32", i).requires_grad_(True) for i, s in
               enumerate(((1, 200, 6, 64), (1, 200, 2, 64),
                          (1, 200, 2, 64)), 1))
    do = _randn((1, 200, 6, 64), "float32", 7)
    fa_k.reset_launch_counts()
    got = torch.autograd.grad(fa_k.flash_attention(q, k, v), (q, k, v), do)
    assert fa_k.LAUNCHES == {"flash_attention": 1,
                             "flash_attention_bwd": fa_k.BWD_LAUNCHES}
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v), (q, k, v),
                               do)
    for g, w in zip(got, want):
        assert bool(((g - w).abs() <= BWD_ATOL + BWD_RTOL * w.abs()).all())
    qb, kb, vb = (t.detach().bfloat16().requires_grad_(True)
                  for t in (q, k, v))
    fa_k.reset_launch_counts()
    got = torch.autograd.grad(fa_k.flash_attention(qb, kb, vb), (qb, kb, vb),
                              do.bfloat16())
    assert fa_k.LAUNCHES == {"flash_attention": 1,
                             "flash_attention_bwd": fa_k.BWD_LAUNCHES}
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        # bf16 inputs against the f32 gradient: the inputs' rounding
        torch.testing.assert_close(g.float(), w, rtol=5e-2,
                                   atol=5e-2 * float(w.abs().max()))
    with pytest.raises(ValueError, match="head dim"):
        fa_k.flash_attention(*(_randn((1, 8, 2, 128), "float32", 1)
                               .requires_grad_(True) for _ in range(3)))
    length = torch.full((1,), 200, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="B5"):
        dec_k.decode_attention(q[:, 0], k, v, length)
    a, b, h0 = (t.requires_grad_(True) for t in _scan_inputs(
        (1, 40, 8, 2), "float32", True, 3))
    dhs = _randn((1, 40, 8, 2), "float32", 4)
    ssm_scan.reset_launch_counts()
    hs = ssm_scan.ssm_scan(a, b, h0)
    got = torch.autograd.grad(hs, (a, b, h0), dhs)
    assert ssm_scan.LAUNCHES == {"ssm_scan": 1, "ssm_scan_bwd": 1}
    want = ref.ssm_scan_bwd_ref(a.detach(), hs.detach(), h0.detach(), dhs)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


SERVE_LENS = [16, 40, 100, 200, 256, 300, 400, 512]   # chip_smoke's


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,Hkv,D,lens", [
    (3, 256, 4, 2, 64, None), (3, 512, 8, 8, 128, None),
    (3, 1024, 2, 1, 64, None), (3, 777, 15, 5, 64, None),
    (2, 300, 16, 16, 256, None),
    (8, 512, 15, 5, 64, SERVE_LENS),            # SmolLM-360M serving
    (8, 512, 25, 5, 64, SERVE_LENS),            # Hymba-1.5B serving
    (2, 8192, 16, 16, 256, [8192, 8192]),       # Gemma-7B's long_500k ring
    (1, 8192, 40, 10, 128, [8192])])            # Phi3-medium's
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_attention_matches_plain_version(B, L, H, Hkv, D, lens,
                                                     dtype):
    """One launch per call, nothing at or past ``length[b]`` read (the
    cache's tail is NaN), and two calls on the same inputs bit for bit
    equal (the splits merge in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = _randn((B, H, D), dtype, 4)
    k = _randn((B, L, Hkv, D), dtype, 5)
    v = _randn((B, L, Hkv, D), dtype, 6)
    length = torch.tensor(lens or [1, L // 2, L][:B], dtype=torch.int32,
                          device="cuda")
    k_poisoned, v_poisoned = k.clone(), v.clone()
    for b in range(B):      # nothing at or past length[b] may be read
        k_poisoned[b, int(length[b]):] = float("nan")
        v_poisoned[b, int(length[b]):] = float("nan")
    dec_k.reset_launch_counts()
    got = dec_k.decode_attention(q, k_poisoned, v_poisoned, length)
    want = ref.decode_attention_ref(q, k, v, length)
    torch.cuda.synchronize()
    assert dec_k.LAUNCHES["decode_attention"] == 1
    _assert_close(got, want, dtype)
    again = dec_k.decode_attention(q, k_poisoned, v_poisoned, length)
    assert _bits_equal(got, again)


@pytest.mark.cuda
def test_cuda_rope_freqs_equal_the_cpus():
    """RoPE's frequencies on the card are the CPU's, bit for bit (one
    ulp of a frequency near 1 moves its angle by ~0.03 rad at long_500k's
    positions), and so are the rotated values at those positions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import layers

    for hd in (64, 128, 256):
        for theta in (1e4, 5e5):
            cpu = layers.rope_freqs(hd, theta, "cpu")
            gpu = layers.rope_freqs(hd, theta, "cuda")
            assert gpu.device.type == "cuda"
            assert torch.equal(cpu.view(torch.int32),
                               gpu.cpu().view(torch.int32))
    x = torch.randn((1, 4, 2, 256), generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(524_280, 524_284)[None]
    want = layers.apply_rope(x, pos, 1e4)
    got = layers.apply_rope(x.cuda(), pos.cuda(), 1e4).cpu()
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip_keeps_device_and_dtype(tmp_path):
    """A tree of CUDA tensors (f32, bf16, int32 scalars and vectors, a
    tuple and a ``None``) through ``Checkpointer``: restored onto the card
    in each template leaf's dtype, bit for bit; restored onto CPU
    templates, the same values there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.checkpoint import Checkpointer

    tree = {"w": _randn((3, 5), "float32", 7),
            "unit": (_randn((2, 4), "bfloat16", 8), None,
                     {"t": torch.tensor(11, dtype=torch.int32,
                                        device="cuda")}),
            "tau": torch.arange(4, dtype=torch.int32, device="cuda")}
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(tree, 3)
    zeros = lambda l: None if l is None else torch.zeros_like(l)
    template = {"w": zeros(tree["w"]), "tau": zeros(tree["tau"]),
                "unit": tuple(zeros(u) if not isinstance(u, dict) else
                              {"t": zeros(u["t"])} for u in tree["unit"])}
    got, step = ck.restore_latest(template)
    assert step == 3 and got["unit"][1] is None
    pairs = [(got["w"], tree["w"]), (got["tau"], tree["tau"]),
             (got["unit"][0], tree["unit"][0]),
             (got["unit"][2]["t"], tree["unit"][2]["t"])]
    for g, w in pairs:
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert _bits_equal(g, w) if g.is_floating_point() else \
            torch.equal(g, w)
    on_cpu, _ = ck.restore_latest({"w": template["w"].cpu(),
                                   "tau": template["tau"].cpu(),
                                   "unit": (template["unit"][0].cpu(), None,
                                            {"t": template["unit"][2]["t"]
                                             .cpu()})})
    assert on_cpu["w"].device.type == "cpu"
    assert _bits_equal(on_cpu["unit"][0], tree["unit"][0])


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
    assert dec_k.LAUNCHES["decode_attention"] == 32 * eng.steps
    assert [len(o) for o in outs] == [4, 4]
    assert all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs)
    toks = torch.from_numpy(np.stack([np.arange(40)] * 2)).cuda()
    logits = make_prefill_step(cfg)(params, {"tokens": toks})
    assert fa_k.LAUNCHES["flash_attention"] == 32
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


def _scan_inputs(shape, dtype, with_h0, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, S, D, N = shape
    a = torch.rand(shape, generator=g, device="cuda") * 0.799 + 0.2
    b = torch.randn(shape, generator=g, device="cuda") * 0.1
    h0 = (torch.randn((B, D, N), generator=g, device="cuda") if with_h0
          else None)
    return a.to(getattr(torch, dtype)), b.to(getattr(torch, dtype)), h0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 128, 64, 8), (2, 256, 256, 16), (2, 64, 128, 4),   # the TPU grid
    (4, 128, 1600, 16), (3, 77, 100, 5), (1, 1, 1, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_cuda_ssm_scan_matches_plain_version_bitwise(shape, dtype, with_h0):
    """B6 on the card equals its plain version on the card bit for bit,
    from zeros and from a nonzero h0; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b, h0 = _scan_inputs(shape, dtype, with_h0, sum(shape))
    ssm_scan.reset_launch_counts()
    got = ssm_scan.ssm_scan(a, b, h0)
    want = ref.ssm_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    assert ssm_scan.LAUNCHES == {"ssm_scan": 1, "ssm_scan_bwd": 0}
    assert got.dtype == torch.float32 and got.shape == a.shape
    assert _bits_equal(got, want)


@pytest.mark.cuda
def test_cuda_ssm_scan_raises_on_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b, h0 = _scan_inputs((2, 8, 4, 3), "float32", True, 0)
    with pytest.raises(TypeError):
        ssm_scan.ssm_scan(a.double(), b.double(), h0)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan.ssm_scan(a.transpose(2, 3).contiguous().transpose(2, 3), b,
                          h0)
    with pytest.raises(ValueError, match="h0"):
        ssm_scan.ssm_scan(a, b, h0.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 128, 64, 8), (4, 128, 1600, 16), (3, 77, 100, 5), (1, 1, 1, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_cuda_ssm_scan_bwd_matches_plain_version_bitwise(shape, dtype,
                                                         with_h0):
    """B6's backward on the card equals its plain version on the card bit
    for bit (da, db in a's dtype, dh0 f32), from zeros and from h0, with
    a nonzero gradient on every row; one launch per call; two calls
    alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b, h0 = _scan_inputs(shape, dtype, with_h0, 7 + sum(shape))
    hs = ref.ssm_scan_ref(a, b, h0)
    dhs = _randn(shape, "float32", 11)
    ssm_scan.reset_launch_counts()
    got = ssm_scan.ssm_scan_bwd(a, hs, h0, dhs)
    again = ssm_scan.ssm_scan_bwd(a, hs, h0, dhs)
    want = ref.ssm_scan_bwd_ref(a, hs, h0, dhs)
    torch.cuda.synchronize()
    assert ssm_scan.LAUNCHES == {"ssm_scan": 0, "ssm_scan_bwd": 2}
    assert got[0].dtype == got[1].dtype == a.dtype
    assert got[2].dtype == torch.float32
    for g, x, w in zip(got, again, want):
        assert _bits_equal(g, w) and _bits_equal(g, x)


@pytest.mark.cuda
def test_cuda_ssm_scan_bwd_raises_on_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b, h0 = _scan_inputs((2, 8, 4, 3), "float32", True, 0)
    hs = ref.ssm_scan_ref(a, b, h0)
    with pytest.raises(ValueError, match="dhs"):
        ssm_scan.ssm_scan_bwd(a, hs, h0, hs.bfloat16())
    with pytest.raises(ValueError, match="hs"):
        ssm_scan.ssm_scan_bwd(a, hs.cpu(), h0, hs)
    with pytest.raises(ValueError, match="h0"):
        ssm_scan.ssm_scan_bwd(a, hs, h0[:1], hs)


@pytest.mark.cuda
def test_cuda_hymba_smoke_model_matches_the_cpu():
    """The Hymba smoke model (2 layers, d 256, f32) with the same weights
    on the card and on the CPU: the prefill forward over 200 tokens (two
    B6 chunks per layer, the second padded) within abs/rel 5e-5 (f32 sums
    in the devices' own orders, ~1e-6 relative each, through two layers),
    and greedy tokens of a ``ServeEngine.generate`` equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ServeEngine, ServeRequest

    cfg = reduce_for_smoke(get_arch("hymba-1.5b"))
    cpu = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = tr.lm_params_from_numpy(tr.lm_params_to_numpy(cpu, cfg), cfg,
                                  device="cuda")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 200)))
    for mod in (fa_k, dec_k, ssm_scan):
        mod.reset_launch_counts()
    got, _ = tr.forward_logits(gpu, {"tokens": toks.cuda()}, cfg)
    want, _ = tr.forward_logits(cpu, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    assert fa_k.LAUNCHES["flash_attention"] == 2
    assert ssm_scan.LAUNCHES["ssm_scan"] == 2 * 2
    torch.testing.assert_close(got.cpu(), want, atol=5e-5, rtol=5e-5)
    prompts = [np.arange(1, 9, dtype=np.int32), np.arange(5, 8,
                                                          dtype=np.int32)]
    outs = [ServeEngine(p, cfg, batch=2, cache_len=32, device=dev).generate(
        [ServeRequest(prompt=q, max_new=6) for q in prompts])
        for p, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    assert ssm_scan.LAUNCHES["ssm_scan"] == 2 * 2      # decode runs no B6
    assert [o.tolist() for o in outs[0]] == [o.tolist() for o in outs[1]]


def _load_chip_smoke():
    """``chip_smoke.py`` as a module (its helpers; nothing runs)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_cuda_granite_moe_smoke_model_matches_the_cpu():
    """The Granite-MoE smoke model (2 layers, d 256, 4 experts, top-2,
    f32) with the same weights on the card and on the CPU: the prefill
    forward over 2 x 200 tokens routes alike on both but at near-ties (a
    gap of the CPU's k-th and (k+1)-th probability below 1e-5, counted;
    ``chip_smoke.routing_flips``, which raises on any other flip), its
    logits within abs/rel 5e-5 when no token flipped (as the Hymba test
    holds them), B4 once per layer; and greedy tokens of a
    ``ServeEngine.generate`` equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ServeEngine, ServeRequest

    smoke = _load_chip_smoke()
    cfg = reduce_for_smoke(get_arch("granite-moe-3b-a800m"))
    cpu = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = tr.lm_params_from_numpy(tr.lm_params_to_numpy(cpu, cfg), cfg,
                                  device="cuda")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 200)))
    fa_k.reset_launch_counts()
    with smoke.RouteLog() as on_gpu:
        got, _ = tr.forward_logits(gpu, {"tokens": toks.cuda()}, cfg)
    with smoke.RouteLog() as on_cpu:
        want, _ = tr.forward_logits(cpu, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    assert fa_k.LAUNCHES["flash_attention"] == 2
    ties, downstream, compared, equal = smoke.routing_flips(
        on_cpu.calls, on_gpu.calls, 200, 1e-5)
    assert compared == equal > 0
    assert bool(torch.isfinite(got).all())
    if not ties and not downstream:
        torch.testing.assert_close(got.cpu(), want, atol=5e-5, rtol=5e-5)
    prompts = [np.arange(1, 9, dtype=np.int32), np.arange(5, 8,
                                                          dtype=np.int32)]
    outs = [ServeEngine(p, cfg, batch=2, cache_len=32, device=dev).generate(
        [ServeRequest(prompt=q, max_new=6) for q in prompts])
        for p, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    assert [o.tolist() for o in outs[0]] == [o.tolist() for o in outs[1]]



@pytest.mark.cuda
def test_cuda_xlstm_smoke_model_launches_no_kernel_and_matches_the_cpu():
    """The xLSTM smoke model ([mLSTM, sLSTM], d 256, f32) with the same
    weights on the card and on the CPU: the prefill forward over 2 x 256
    tokens (one mLSTM chunk, one 256-step sLSTM scan chunk) within abs/rel
    5e-5 (as the Hymba test holds it), no kernel of the port launched
    (the reference's mLSTM and sLSTM are plain XLA), and greedy tokens of
    a ``ServeEngine.generate`` equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ServeEngine, ServeRequest

    cfg = reduce_for_smoke(get_arch("xlstm-1.3b"))
    cpu = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = tr.lm_params_from_numpy(tr.lm_params_to_numpy(cpu, cfg), cfg,
                                  device="cuda")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 256)))
    for mod in (fa_k, dec_k, ssm_scan):
        mod.reset_launch_counts()
    got, _ = tr.forward_logits(gpu, {"tokens": toks.cuda()}, cfg)
    want, _ = tr.forward_logits(cpu, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, atol=5e-5, rtol=5e-5)
    prompts = [np.arange(1, 9, dtype=np.int32), np.arange(5, 8,
                                                          dtype=np.int32)]
    outs = [ServeEngine(p, cfg, batch=2, cache_len=32, device=dev).generate(
        [ServeRequest(prompt=q, max_new=6) for q in prompts])
        for p, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    assert [o.tolist() for o in outs[0]] == [o.tolist() for o in outs[1]]
    assert sum(m for mod in (fa_k, dec_k, ssm_scan)
               for m in mod.LAUNCHES.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_cuda_encdec_and_vlm_smoke_launches_per_step(arch):
    """The SeamlessM4T and LLaVA smoke models on the card: a prefill step
    launches B4 once per encoder layer, decoder layer and cross-attention
    (2 + 2 + 2) or once per layer (2); a decode step B5 once per decoder
    layer and cross-attention (2 + 2) or once per layer (2), the encoded
    memory in the state; the logits within abs/rel 5e-5 of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, prefill_inputs)
    from repro_torch.models import transformer as tr

    cfg = reduce_for_smoke(get_arch(arch))
    enc = bool(cfg.n_enc_layers)
    cpu = tr.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = tr.lm_params_from_numpy(tr.lm_params_to_numpy(cpu, cfg), cfg,
                                  device="cuda")
    inputs = prefill_inputs(cfg, 2, 200, torch.Generator().manual_seed(1))
    fa_k.reset_launch_counts()
    got = make_prefill_step(cfg)(gpu, {k: v.cuda() for k, v in
                                       inputs.items()})
    torch.cuda.synchronize()
    assert fa_k.LAUNCHES["flash_attention"] == (6 if enc else 2)
    want = make_prefill_step(cfg)(cpu, inputs)
    torch.testing.assert_close(got.cpu(), want, atol=5e-5, rtol=5e-5)
    states = {}
    for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
        states[dev] = tr.init_decode_state(cfg, 2, 16, torch.float32,
                                           device=dev)
        if enc:
            states[dev]["memory"] = tr.encode(
                params, inputs["enc_embeds"].to(dev), cfg)
    step = make_decode_step(cfg)
    for t in range(4):
        tok = inputs["tokens"][:, t:t + 1]
        dec_k.reset_launch_counts()
        got, states["cuda"] = step(gpu, states["cuda"], tok.cuda(), t)
        torch.cuda.synchronize()
        assert dec_k.LAUNCHES["decode_attention"] == (4 if enc else 2)
        want, states["cpu"] = step(cpu, states["cpu"], tok, t)
        torch.testing.assert_close(got.cpu(), want, atol=5e-5, rtol=5e-5)

def _quorum_schedule(rounds):
    """The quickstart's quorum server over 10 clients of heterogeneous
    latency."""
    from repro_torch import train
    from repro_torch.core.async_engine import DelayModel
    from repro_torch.core.schedule import build_schedule

    return build_schedule(rounds, DelayModel(n_clients=10, hetero=1.0,
                                             seed=0),
                          train.make_trigger("quorum", 0.6))


def _sparse_train(rounds, **knobs):
    from repro_torch import train
    from repro_torch.configs import FedConfig

    state, _, _ = train.train_bafdp(
        "milano", 24, FedConfig(n_clients=10, staleness_decay="poly",
                                **knobs), rounds=rounds,
        schedule=_quorum_schedule(rounds), round_impl="sparse",
        device="cuda")
    return state


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_cuda_sparse_round_launches_its_kernel_once_a_round(wire):
    """The sparse round's Eq. (20) step is one grouped launch a round: B2
    on the f32 wire, B3 (weighted) on the int8 wire, nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sign_agg.reset_launch_counts()
    _sparse_train(3, sign_message=wire)
    assert sign_agg.LAUNCHES == {
        "sign_agg": 0, "sign_agg_weighted": 3 if wire == "f32" else 0,
        "sign_agg_weighted_int8": 3 if wire == "int8" else 0}


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_cuda_streamed_sparse_z_equals_materialized_bitwise(wire):
    """consensus_streaming runs the plain streamed fold (no launch) and
    gives the materialized (B2/B3) round's z bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.tree import tree_leaves

    want = _sparse_train(3, sign_message=wire)
    sign_agg.reset_launch_counts()
    got = _sparse_train(3, sign_message=wire, consensus_streaming=True,
                        consensus_chunk=3)
    assert sum(sign_agg.LAUNCHES.values()) == 0
    for a, b in zip(tree_leaves(got.z), tree_leaves(want.z)):
        assert _bits_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_cuda_materialized_sparse_path_never_runs_the_plain_fold(
        monkeypatch, wire):
    """On CUDA tensors the materialized consensus launches the kernel; the
    plain versions of B1-B3 are never called."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def refuse(*args, **kwargs):
        raise AssertionError("the plain consensus fold ran on CUDA tensors")

    for name in ("sign_agg_ref", "sign_agg_fold_ref", "sign_agg_group_ref",
                 "sign_agg_int8_fold_ref", "sign_agg_int8_group_ref",
                 "int8_sign_sum"):
        monkeypatch.setattr(ref, name, refuse)
    sign_agg.reset_launch_counts()
    _sparse_train(2, sign_message=wire)
    assert sum(sign_agg.LAUNCHES.values()) == 2


# ---------------------------------------------------------------------------
# placement: the host mesh on the card
@pytest.mark.cuda
def test_cuda_host_mesh_is_one_nccl_rank_and_places_without_copy():
    """``make_host_mesh()`` on the card: a 1 x 1 ``DeviceMesh`` over an
    NCCL group of one rank that reduces; ``place_tree`` gives DTensors
    whose local shards are the CUDA tensors themselves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.distributed import context
    from repro_torch.distributed.sharding import P, local_tree, place_tree
    from repro_torch.launch.mesh import registered_host_mesh

    tree = {"w": torch.randn((8, 16), device="cuda"),
            "u": (torch.randn((4,), device="cuda"),)}
    with registered_host_mesh() as mesh:
        assert context.get_mesh() is mesh
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1)
        x = torch.ones((3,), device="cuda")
        dist.all_reduce(x)
        assert torch.equal(x, torch.ones((3,), device="cuda"))
        placed = place_tree(tree, {"w": P("data", "model"), "u": (P(None),)},
                            mesh)
        local = local_tree(placed)
        for a, b in ((tree["w"], local["w"]), (tree["u"][0], local["u"][0])):
            assert b.device.type == "cuda" and b.data_ptr() == a.data_ptr()
            assert torch.equal(a, b)
    assert context.get_mesh() is None and not dist.is_initialized()


@pytest.mark.cuda
def test_cuda_placed_smoke_round_equals_the_unplaced_round():
    """Two rounds of the smoke SmolLM on the card through ``train_setup``
    on the placed state (host mesh) equal ``make_train_step``'s rounds
    from the same state bit for bit, B1 once and B4 in every layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.configs import (FedConfig, InputShape, get_arch,
                                     reduce_for_smoke)
    from repro_torch.core.fed_state import init_fed_state, init_lm_tree
    from repro_torch.data.tokens import lm_batch
    from repro_torch.distributed.sharding import local_tree, place_tree
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import registered_host_mesh
    from repro_torch.tree import tree_leaves

    cfg = reduce_for_smoke(get_arch("smollm-360m"))
    C, b, S, rounds = 2, 2, 64, 2
    knobs = dict(byzantine_frac=0.5, attack="sign_flip", alpha_w=2e-2)
    fed = dataclasses.replace(steps.fed_config_for(cfg, C), **knobs)
    raw = lm_batch(np.random.RandomState(0), cfg, C * b, S)
    batch = {k: torch.from_numpy(v).to("cuda").reshape((C, b) + v.shape[1:])
             for k, v in raw.items()}

    def init():
        return init_fed_state(torch.Generator(device="cuda").manual_seed(0),
                              lambda g: init_lm_tree(g, cfg, "cuda"), fed,
                              device="cuda")

    def leaves(state):
        return [l for f in state if f is not None for l in tree_leaves(f)]

    step, state = steps.make_train_step(cfg, fed), init()
    for t in range(rounds):
        state, _ = step(state, batch, t)
    with registered_host_mesh() as mesh:
        pstep, _, (specs, _, _), _ = steps.train_setup(
            cfg, InputShape("smoke", S, C * b, "train"), mesh,
            base_fed=FedConfig(**knobs), n_clients=C)
        first = init()
        placed = local_tree(place_tree(first, specs, mesh))
        assert all(a.data_ptr() == p.data_ptr()
                   for a, p in zip(leaves(first), leaves(placed)))
        sign_agg.reset_launch_counts()
        fa_k.reset_launch_counts()
        for t in range(rounds):
            placed, _ = pstep(placed, batch, t)
        assert sign_agg.LAUNCHES["sign_agg"] == rounds
        assert fa_k.LAUNCHES["flash_attention"] == \
            (2 if cfg.remat else 1) * rounds * C * cfg.n_layers
    for a, p in zip(leaves(state), leaves(placed)):
        assert _bits_equal(a, p)
