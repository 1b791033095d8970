"""The numerical recipe of B4's float32 tensor-core kernel, on the CPU.

The kernel (``flash_fwd_tf32x3`` in ``src/repro_torch/kernels/csrc/
flash_attention.cu``) runs only on the card.  :func:`kernel_recipe`
repeats its arithmetic here in PyTorch:

* Q times the scale in f32 (as the plain version does), then every operand
  of both products split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``,
  with ``tf32`` the kernel's ``cvt.rna.tf32.f32`` (round to nearest, ties
  away from zero, to 10 mantissa bits) done on the bit pattern;
* S = Q K^T by k-steps of 8 (one ``mma.sync.m16n8k8``), each k-step adding
  ``lo(Q) hi(K)``, then ``hi(Q) lo(K)``, then ``hi(Q) hi(K)`` to the f32
  sum: the cross terms first, ``lo lo`` dropped;
* the online softmax over key tiles of the kernel's BK, ``expf(s - m)``;
* each key tile's P V the same way, P split like the other operands, by
  k-steps of 8 keys, summed on its own and then added to the output in f32;
* ``acc / l`` in f32.

The tests hold it to the plain version ``ref.flash_attention_ref`` within
the bound the kernel is held to on the card (``chip_smoke.py::attn_tol``,
``tests/test_torch_cuda.py::_assert_close``): abs/rel 3e-5.  One TF32
product of each (``split_ops=False``: the usual TF32 recipe) does not hold
that bound.  The tensor cores' own summation inside a k-step cannot be
repeated here exactly; the card decides that part.

    PYTHONPATH=src python tests/test_torch_flash_tf32.py

prints, for each case and both recipes, the worst excess over the bound
and the number of outputs past it.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load_chip_smoke()
# keys per tile by head dim, as the kernel's dispatch_f32 launches it
KERNEL_BK = {D: args[2]
             for D, args in chip_smoke.dispatch_tiles("dispatch_f32").items()}
K_STEP = 8                                 # the depth of mma m16n8k8

# (B, Sq, Sk, H, Hkv, D, causal, window); the cases of
# test_torch_flash_bf16.py and SmolLM-360M's heads
CASES = {
    "smollm-heads": (1, 1024, 1024, 15, 5, 64, True, 0),
    "hymba-heads": (1, 512, 512, 25, 5, 64, True, 0),
    "d128-window64": (1, 256, 256, 4, 2, 128, True, 64),
    "d256-window32": (1, 128, 128, 2, 1, 256, True, 32),
    "sq100-sk300": (1, 100, 300, 6, 2, 64, True, 0),
    "ragged-s77": (2, 77, 77, 3, 1, 64, True, 0),
    "hymba-heads-sq100-sk300-window64": (1, 100, 300, 25, 5, 64, True, 64),
    "d128-full-sq200-sk520": (1, 200, 520, 4, 2, 128, False, 0),
}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, ties away
    from zero (add half of the dropped 13 bits' unit to the magnitude,
    then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo) with ``hi = tf32(x)``, ``lo = tf32(x - hi)``; ``x - hi``
    is exact in f32."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma_sum(acc, eq, a, b, a_dim, b_dim, split_ops: bool):
    """``acc`` plus the product ``einsum(eq, a, b)`` over the contracted
    axis (``a_dim`` of a, ``b_dim`` of b), k-step by k-step as the kernel
    issues its mma's: ``lo hi``, ``hi lo``, ``hi hi`` (``split_ops``) or
    ``hi hi`` alone."""
    (ah, al), (bh, bl) = split(a), split(b)
    for c in range(0, a.shape[a_dim], K_STEP):
        step = lambda x, d: x.narrow(d, c, K_STEP)
        if split_ops:
            acc = acc + torch.einsum(eq, step(al, a_dim), step(bh, b_dim))
            acc = acc + torch.einsum(eq, step(ah, a_dim), step(bl, b_dim))
        acc = acc + torch.einsum(eq, step(ah, a_dim), step(bh, b_dim))
    return acc


def kernel_recipe(q, k, v, causal: bool, window: int, bk: int,
                  split_ops: bool = True) -> torch.Tensor:
    """B4's f32 kernel arithmetic in PyTorch (``split_ops=False``: one
    TF32 product).  q: (B, Sq, H, D), k, v: (B, Sk, Hkv, D), f32.
    Returns (B, Sq, H, D) in f32."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qs = q.reshape(B, Sq, Hkv, H // Hkv, D) * ref.attention_scale(D)
    qa = torch.arange(Sq)[:, None] + (Sk - Sq)
    m = torch.full((B, Hkv, H // Hkv, Sq), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, H // Hkv, Sq, D))
    for k0 in range(0, Sk, bk):
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        n = kt.shape[1]
        if n % K_STEP:     # the kernel's zero fill past Sk
            pad = (0, 0, 0, 0, 0, K_STEP - n % K_STEP)
            kt, vt = (torch.nn.functional.pad(t, pad) for t in (kt, vt))
        s = mma_sum(torch.zeros(m.shape + (kt.shape[1],)),
                    "bqkgd,bskd->bkgqs", qs, kt, 4, 3, split_ops)
        ka = torch.arange(k0, k0 + kt.shape[1])[None, :]
        ok = ka < Sk
        if causal:
            ok = ok & (ka <= qa)
        if window:
            ok = ok & (ka > qa - window)
        s = s.masked_fill(~ok, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # a row with no key kept so far keeps m = -inf; exp(-inf) = 0
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        corr = torch.exp(m - m_use)
        p = torch.exp(s - m_use[..., None])
        l = l * corr + p.sum(-1)
        # this key tile's P V on its own, then added to the output
        pv = mma_sum(torch.zeros_like(acc), "bkgqs,bskd->bkgqd", p, vt, 4, 1,
                     split_ops)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def excess(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| minus the f32 bound of ``attn_tol``, per element."""
    return (got - want).abs() - (3e-5 + 3e-5 * want.abs())


def inputs(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    return mk(B, Sq, H, D), mk(B, Sk, Hkv, D), mk(B, Sk, Hkv, D)


def run_case(name, split_ops, seed=0):
    B, Sq, Sk, H, Hkv, D, causal, window = CASES[name]
    q, k, v = inputs(B, Sq, Sk, H, Hkv, D, seed)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = kernel_recipe(q, k, v, causal, window, KERNEL_BK[D], split_ops)
    return got, want


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 + 2 ** -20, 1 - 2 ** -12, 3.0, 0.0])
    want = torch.tensor([1 + 2 ** -10, 1 + 2 * 2 ** -10, -(1 + 2 ** -10),
                         1 + 2 ** -10, 1.0, 3.0, 0.0])
    torch.testing.assert_close(tf32(x), want, rtol=0, atol=0)
    hi, lo = split(x)
    assert bool((tf32(hi) == hi).all() and (tf32(lo) == lo).all())


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_recipe_holds_the_kernel_bound(name):
    got, want = run_case(name, split_ops=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    ex = excess(got, want)
    assert float(ex.max()) <= 0, (f"{int((ex > 0).sum())} outputs past the "
                                  f"bound, worst by {float(ex.max()):.3e}")


def test_one_tf32_product_does_not_hold_the_kernel_bound():
    """Why the kernel splits every operand: at SmolLM-360M's heads one
    TF32 product of each puts outputs past the bound the split holds."""
    got, want = run_case("smollm-heads", split_ops=False)
    assert int((excess(got, want) > 0).sum()) > 0


def test_bound_is_attn_tol():
    """The bound here is ``chip_smoke.py::attn_tol``'s for f32."""
    got, want = run_case("ragged-s77", split_ops=False)
    torch.testing.assert_close(
        excess(got, want), (got - want).abs() - chip_smoke.attn_tol(want),
        rtol=0, atol=0)


def test_kernel_tiles_read_from_the_dispatch():
    """Every head dim of the cases has the kernel's keys per tile, a whole
    number of mma k-steps, read from ``dispatch_f32``'s launches."""
    assert set(KERNEL_BK) == {64, 128, 256}
    assert {c[5] for c in CASES.values()} <= set(KERNEL_BK)
    assert all(bk % K_STEP == 0 for bk in KERNEL_BK.values())


if __name__ == "__main__":
    for case in CASES:
        for split_ops in (True, False):
            ex = excess(*run_case(case, split_ops))
            print(f"{case:32s} {'3xTF32' if split_ops else '1xTF32':7s} "
                  f"worst excess {float(ex.max()):+.3e}, past the bound "
                  f"{int((ex > 0).sum())} of {ex.numel()}")
