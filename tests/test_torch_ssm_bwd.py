"""B6's gradient on the CPU: the plain backward ``ref.ssm_scan_bwd_ref``
(the reverse recurrence ``g_t = dhs_t + a_{t+1} g_{t+1}``, ``da_t = g_t
h_{t-1}``, ``db_t = g_t``, ``dh0 = a_1 g_1``) against ``torch.autograd``
of the plain forward ``ref.ssm_scan_ref`` and against ``jax.vjp`` of the
reference's ``repro.models.ssm._assoc_scan``; the autograd Function
``ssm_scan.SsmScanFn`` through the model's chunk loop; and the backward
wrapper's checks.  (The CUDA kernel against this plain version:
tests/test_torch_cuda.py and chip_smoke.py.)

Tolerances: against autograd, bit for bit (both fold in time order with
the same roundings); against the reference, 1e-5 abs/rel (its
``associative_scan`` combines in a tree order, ROADMAP Queue C trap D).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as ssm_k
from repro_torch.models import ssm

SHAPES = [(2, 37, 5, 3), (1, 128, 16, 4), (3, 1, 4, 2)]


def _inputs(shape, seed, dtype=torch.float32):
    """a in [0.2, 0.999) (decays, as exp(delta A) gives), b and dhs ~
    N(0, 1) scaled, h0 ~ N(0, 1): numpy draws, as the reference gets."""
    rng = np.random.RandomState(seed)
    B, S, D, N = shape
    a = (rng.rand(*shape) * 0.799 + 0.2).astype(np.float32)
    b = (rng.randn(*shape) * 0.1).astype(np.float32)
    h0 = rng.randn(B, D, N).astype(np.float32)
    dhs = rng.randn(*shape).astype(np.float32)
    t = lambda x: torch.from_numpy(x)
    return t(a).to(dtype), t(b).to(dtype), t(h0), t(dhs), (a, b, h0, dhs)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_backward_equals_autograd_bitwise(shape, dtype, with_h0):
    """The reverse fold equals autograd of the forward fold bit for bit,
    f32 and bf16 a, b (da, db in their dtype), from zeros and from h0."""
    a, b, h0, dhs, _ = _inputs(shape, sum(shape), getattr(torch, dtype))
    h0 = h0 if with_h0 else None
    leaves = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    if with_h0:
        leaves.append(h0.clone().requires_grad_(True))
    hs = ref.ssm_scan_ref(*leaves)
    auto = torch.autograd.grad(hs, leaves, dhs)
    da, db, dh0 = ref.ssm_scan_bwd_ref(a, hs.detach(), h0, dhs)
    assert da.dtype == db.dtype == a.dtype and dh0.dtype == torch.float32
    assert dh0.shape == (shape[0], shape[2], shape[3])
    for got, want in zip((da, db, dh0), auto):
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_the_reference_vjp(shape):
    """Against ``jax.vjp`` of the reference's ``_assoc_scan`` with h0 on
    the same numpy inputs, a cotangent on both of its outputs (every
    h_t and the last state, which the port's chunk loop adds into dhs's
    last row): da, db, dh0 within 1e-5."""
    a, b, h0, dhs, (an, bn, h0n, dhsn) = _inputs(shape, 7 + sum(shape))
    dlast = np.random.RandomState(3).randn(*h0n.shape).astype(np.float32)
    jssm = importlib.import_module("repro.models.ssm")
    _, vjp = jax.vjp(jssm._assoc_scan, *map(jnp.asarray, (an, bn, h0n)))
    jda, jdb, jdh0 = vjp((jnp.asarray(dhsn), jnp.asarray(dlast)))
    g = dhs.clone()
    g[:, -1] += torch.from_numpy(dlast)
    hs = ref.ssm_scan_ref(a, b, h0)
    for got, want in zip(ref.ssm_scan_bwd_ref(a, hs, h0, g),
                         (jda, jdb, jdh0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_function_on_the_cpu_gives_autograd_of_the_chunk_loop(monkeypatch):
    """A Mamba mixer over 300 tokens (three 128-step chunks, the last
    padded) under autograd: every call of ``ops.ssm_scan`` is the
    Function, and the parameters' and the input's gradients equal
    autograd through the plain forward bit for bit, so the carried state
    passes each chunk's gradient back into the one before.  Nothing is
    launched."""
    cfg = reduce_for_smoke(get_arch("hymba-1.5b"))
    params = {k: v.requires_grad_(True) for k, v in ssm.init_mamba(
        torch.Generator().manual_seed(0), cfg, d_in=cfg.d_model).items()}
    x = torch.randn((2, 300, cfg.d_model),
                    generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    dy = torch.randn((2, 300, cfg.d_model),
                     generator=torch.Generator().manual_seed(2))
    leaves = [x, *params.values()]
    seen = []
    real = ops.ssm_scan

    def spy(a, b, h0=None):
        out = real(a, b, h0)
        seen.append(type(out.grad_fn).__name__)
        return out

    monkeypatch.setattr(ops, "ssm_scan", spy)
    ssm_k.reset_launch_counts()
    got = torch.autograd.grad(ssm.mamba_scan(params, x, cfg), leaves, dy)
    assert len(seen) == 3 and all("SsmScanFn" in n for n in seen), seen
    monkeypatch.setattr(ops, "ssm_scan", ref.ssm_scan_ref)
    want = torch.autograd.grad(ssm.mamba_scan(params, x, cfg), leaves, dy)
    for name, g, w in zip(["x", *params], got, want):
        assert torch.equal(g, w), name
    assert ssm_k.LAUNCHES == {"ssm_scan": 0, "ssm_scan_bwd": 0}


def test_function_runs_only_under_autograd():
    """Without grad mode, or with no input requiring grad, the call is the
    plain forward (no graph); with one it is the Function, also for h0
    alone."""
    a, b, h0, _, _ = _inputs((1, 8, 3, 2), 0)
    assert ssm_k.ssm_scan(a, b, h0).grad_fn is None
    h0g = h0.clone().requires_grad_(True)
    with torch.no_grad():
        assert ssm_k.ssm_scan(a, b, h0g).grad_fn is None
    out = ssm_k.ssm_scan(a, b, h0g)
    assert "SsmScanFn" in type(out.grad_fn).__name__
    assert torch.equal(out.detach(), ref.ssm_scan_ref(a, b, h0))


def test_backward_checks_raise():
    """What the backward kernel refuses, before the device check: hs or
    dhs not f32 in a's shape, a non-contiguous dhs, a wrong h0, a dtype
    other than f32/bf16; then that a CPU tensor is no CUDA tensor."""
    a, b, h0, dhs, _ = _inputs((2, 8, 4, 3), 1)
    hs = ref.ssm_scan_ref(a, b, h0)
    with pytest.raises(ValueError, match="hs must be float32"):
        ssm_k.check_bwd_args(a, hs.bfloat16(), h0, dhs)
    with pytest.raises(ValueError, match="dhs must be float32"):
        ssm_k.check_bwd_args(a, hs, h0, dhs[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        ssm_k.check_bwd_args(a, hs, h0, dhs.transpose(2, 3).contiguous()
                             .transpose(2, 3))
    with pytest.raises(ValueError, match="h0"):
        ssm_k.check_bwd_args(a, hs, h0[:1], dhs)
    with pytest.raises(TypeError):
        ssm_k.check_bwd_args(a.double(), hs, h0, dhs)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_k.check_bwd_args(a, hs, h0, dhs)
