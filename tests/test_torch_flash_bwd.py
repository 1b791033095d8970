"""B4's gradient on the CPU: the plain backward ``ref.flash_attention_bwd_ref``
(the kernel's own formulation: P from the forward's log-sum-exp, delta =
rowsum(dO * O), dS = P * (dP - delta), dK and dV summed over each KV
head's query group) against ``torch.autograd`` of the plain forward and
against ``jax.vjp`` of the reference's attention oracle
(``repro.kernels.ref.flash_attention_ref``), causal, windowed and
without a mask, with Sq != Sk; the same on bf16 inputs; the log-sum-exp
output; and the autograd Function's CPU route in both dtypes.  (The CUDA
kernel against this plain version: tests/test_torch_cuda.py and
chip_smoke.py.)

Tolerance, elementwise: |got - want| <= 1e-5 + 1e-4 |want|, the bound
chip_smoke.py holds the CUDA kernel to (f32 sums in another order; the
measured worst here is under a tenth of it).  On bf16 inputs, against
autograd in f32 of the same (widened) inputs: one bf16 rounding of the
gradient (2^-8 |want|), plus the forward output's own rounding to bf16
carried through delta = rowsum(dO * O) into dQ and dK (computed per
element below), plus 1e-6 for f32 sums.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops, ref

ATOL, RTOL = 1e-5, 1e-4
# (B, Sq, Sk, H, Hkv, D, causal, window)
CASES = {
    "causal": (2, 96, 96, 4, 2, 64, True, 0),
    "window": (1, 80, 80, 6, 2, 64, True, 32),
    "no-mask-sq<sk": (1, 40, 72, 4, 4, 64, False, 0),
    "no-mask-sq>sk": (2, 72, 40, 4, 1, 64, False, 0),
    "causal-sq<sk": (1, 48, 80, 3, 1, 64, True, 0),
    "window-d128": (1, 64, 64, 2, 1, 128, True, 16),
}


def _inputs(case, seed=0):
    B, Sq, Sk, H, Hkv, D, _, _ = CASES[case]
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D), (B, Sq, H, D))]


def _within(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    excess = np.abs(got - want) - (ATOL + RTOL * np.abs(want))
    assert excess.max() <= 0, f"{what}: worst excess {excess.max():.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_and_jax(case):
    *_, causal, window = CASES[case]
    q, k, v, do = _inputs(case)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    out, lse = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                       window=window, with_lse=True)
    assert torch.equal(out, ref.flash_attention_ref(
        qt, kt, vt, causal=causal, window=window))
    got = ref.flash_attention_bwd_ref(qt, kt, vt, out, lse, dot,
                                      causal=causal, window=window)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    auto = torch.autograd.grad(
        ref.flash_attention_ref(*leaves, causal=causal, window=window),
        leaves, dot)
    jref = importlib.import_module("repro.kernels.ref")
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    for name, g, a, j in zip("qkv", got, auto, jgrads):
        assert g.shape == a.shape and g.dtype == torch.float32
        _within(g.numpy(), a.numpy(), f"{case} d{name} vs autograd")
        _within(g.numpy(), np.asarray(j), f"{case} d{name} vs jax")


U_BF16 = 2.0 ** -8          # one bf16 rounding, relative


@pytest.mark.parametrize("case", sorted(c for c in CASES if "d128" not in c))
def test_plain_backward_on_bf16_within_one_rounding(case):
    """The plain backward on bf16 inputs (out rounded to bf16 by the plain
    forward, lse f32) against autograd of the plain forward in f32 on the
    same values: dV within one bf16 rounding; dQ and dK also within what
    O's rounding (at most 2^-8 |O|) moves them through delta:
    ``|d delta_i| <= 2^-8 sum_d |dO_id O_id|``, then ``dQ_i`` by
    ``scale sum_k P_ik |d delta_i| |K_k|`` and ``dK_k`` by ``sum_i P_ik
    |d delta_i| scale |Q_i|`` (over each KV head's group)."""
    B, Sq, Sk, H, Hkv, D, causal, window = CASES[case]
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _inputs(case))
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, with_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                      window=window)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    o32 = ref.flash_attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(o32, leaves, do.float())
    G, scale = H // Hkv, ref.attention_scale(D)
    logits, ok = ref._attention_logits(q, k, causal, window)
    p = torch.where(ok, torch.exp(logits - lse.reshape(B, Hkv, G, Sq)[
        ..., None]), torch.zeros(()))
    dd = U_BF16 * (do.float() * o32.detach()).abs().sum(-1)   # (B, Sq, H)
    pd = p * dd.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)[..., None]
    via_o = (scale * torch.einsum("bkgqs,bskd->bqkgd", pd, k.float().abs())
             .reshape(B, Sq, H, D),
             torch.einsum("bkgqs,bqkgd->bskd", pd, scale * q.float().abs()
                          .reshape(B, Sq, Hkv, G, D)),
             torch.zeros(()))
    for name, g, w, extra in zip("qkv", got, want, via_o):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        excess = (g.float() - w).abs() - (U_BF16 * w.abs() + extra + 1e-6)
        assert float(excess.max()) <= 0, f"{case} d{name}: {excess.max()}"


@pytest.mark.parametrize("case", ["causal", "window", "no-mask-sq>sk"])
def test_lse_is_each_rows_logsumexp(case):
    """``with_lse=True`` returns (B, H, Sq) f32: the log-sum-exp of each
    row's kept scaled logits (float64 on the host as the yardstick)."""
    B, Sq, Sk, H, Hkv, D, causal, window = CASES[case]
    q, k, v, _ = _inputs(case, seed=1)
    _, lse = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, window=window,
                                     with_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    G = H // Hkv
    s = np.einsum("bqhd,bshd->bhqs", q.astype(np.float64),
                  np.repeat(k, G, axis=2).astype(np.float64)) / np.sqrt(D)
    qi = np.arange(Sq)[:, None] + (Sk - Sq)
    ki = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= ki <= qi
    if window:
        ok &= ki > qi - window
    s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)


def test_function_on_the_cpu_runs_the_plain_versions():
    """Under autograd a CPU call is ``FlashAttentionFn``: the plain forward
    (the same output as without autograd) and the plain backward, bit for
    bit; nothing is launched.  Without autograd the plain forward alone."""
    q, k, v, do = map(torch.from_numpy, _inputs("window"))
    *_, causal, window = CASES["window"]
    fa_k.reset_launch_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None and "FlashAttentionFn" in \
        type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, leaves, do)
    plain, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window, with_lse=True)
    assert torch.equal(out.detach(), plain)
    want = ref.flash_attention_bwd_ref(q, k, v, plain, lse, do,
                                       causal=causal, window=window)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert ops.flash_attention(*leaves, causal=causal,
                                   window=window).grad_fn is None
    assert fa_k.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}


def test_function_on_the_cpu_runs_the_plain_versions_in_bf16():
    """The same in bf16: the Function's forward is the plain bf16 forward
    and its gradients the plain backward on the bf16 output and the f32
    lse, bit for bit, in bf16; nothing is launched."""
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _inputs("causal"))
    fa_k.reset_launch_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    plain, lse = ref.flash_attention_ref(q, k, v, with_lse=True)
    assert out.dtype == torch.bfloat16 and torch.equal(out.detach(), plain)
    for g, w in zip(grads, ref.flash_attention_bwd_ref(q, k, v, plain, lse,
                                                       do)):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    assert fa_k.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}


def test_backward_checks_raise():
    """What the backward kernel refuses, before any device check: a head
    dim other than 64, a mis-shaped or non-f32 lse, an out or dout of
    another dtype than q (bf16 inputs pass the dtype check, as f32 ones
    do, and reach the device check); then that a CPU tensor is no CUDA
    tensor."""
    q, k, v, do = map(torch.from_numpy, _inputs("causal"))
    out, lse = ref.flash_attention_ref(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa_k.check_bwd_args(*(t.bfloat16() for t in (q, k, v, out)), lse,
                            do.bfloat16(), True, 0)
    with pytest.raises(ValueError, match="lse must be"):
        fa_k.check_bwd_args(*(t.bfloat16() for t in (q, k, v, out)),
                            lse.bfloat16(), do.bfloat16(), True, 0)
    with pytest.raises(TypeError, match="dout dtype"):
        fa_k.check_bwd_args(*(t.bfloat16() for t in (q, k, v, out)), lse,
                            do, True, 0)
    q2, k2, v2, do2 = map(torch.from_numpy, _inputs("window-d128"))
    out2, lse2 = ref.flash_attention_ref(q2, k2, v2, with_lse=True)
    with pytest.raises(ValueError, match="head dim"):
        fa_k.check_bwd_args(q2, k2, v2, out2, lse2, do2, True, 16)
    with pytest.raises(ValueError, match="lse must be"):
        fa_k.check_bwd_args(q, k, v, out, lse[:, :1], do, True, 0)
    with pytest.raises(ValueError, match="CUDA"):
        fa_k.check_bwd_args(q, k, v, out, lse, do, True, 0)
    assert fa_k.BWD_LAUNCHES == 2 and fa_k.BWD_HEAD_DIMS == (64,)
