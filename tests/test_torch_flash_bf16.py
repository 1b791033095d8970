"""The numerical recipe of B4's bf16 tensor-core kernel, on the CPU.

The kernel (``flash_fwd_bf16`` in ``src/repro_torch/kernels/csrc/
flash_attention.cu``) runs only on the card.  :func:`kernel_recipe`
repeats its arithmetic here in PyTorch: S from the bf16 inputs in f32,
times the scale; the online softmax over key tiles of the kernel's BK,
exp2 with log2(e) folded into the scale; P split into ``hi = bf16(p)``
and ``lo = bf16(p - hi)``, both multiplied by V; f32 accumulation; one
bf16 rounding of the output.  The tests hold it to the plain version
``ref.flash_attention_ref`` within the bound the kernel is held to on the
card (``chip_smoke.py::attn_tol``, ``tests/test_torch_cuda.py::
_assert_close``): 1e-2 of |want| plus 1e-3 of want's RMS.  P rounded once
to bf16, the usual flash recipe, does not hold that bound.

    PYTHONPATH=src python tests/test_torch_flash_bf16.py

prints, for each case and both recipes, the worst excess over the bound
and the number of outputs past it.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

LOG2E = 1.4426950408889634
KERNEL_BK = {64: 64, 128: 64, 256: 32}     # keys per tile, by head dim

# (B, Sq, Sk, H, Hkv, D, causal, window)
CASES = {
    "hymba-heads": (1, 512, 512, 25, 5, 64, True, 0),
    "d128-window64": (1, 256, 256, 4, 2, 128, True, 64),
    "d256-window32": (1, 128, 128, 2, 1, 256, True, 32),
    "sq100-sk300": (1, 100, 300, 6, 2, 64, True, 0),
    "ragged-s77": (2, 77, 77, 3, 1, 64, True, 0),
    "hymba-heads-sq100-sk300-window64": (1, 100, 300, 25, 5, 64, True, 64),
    "d128-full-sq200-sk520": (1, 200, 520, 4, 2, 128, False, 0),
}


def kernel_recipe(q, k, v, causal: bool, window: int, bk: int,
                  split: bool = True) -> torch.Tensor:
    """B4's bf16 kernel arithmetic in PyTorch (``split=False``: P rounded
    once to bf16).  q: (B, Sq, H, D), k, v: (B, Sk, Hkv, D), bf16.
    Returns (B, Sq, H, D) in bf16."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    # the kernel's f32 scale * log2(e), rounded once as the host does
    sl = (torch.tensor(ref.attention_scale(D), dtype=torch.float32)
          * torch.tensor(LOG2E, dtype=torch.float32))
    qf = q.float().reshape(B, Sq, Hkv, H // Hkv, D)
    qa = torch.arange(Sq)[:, None] + (Sk - Sq)
    m = torch.full((B, Hkv, H // Hkv, Sq), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, H // Hkv, Sq, D))
    for k0 in range(0, Sk, bk):
        kt, vt = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kt)
        ka = torch.arange(k0, k0 + kt.shape[1])[None, :]
        ok = torch.ones((Sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            ok &= ka <= qa
        if window:
            ok &= ka > qa - window
        s = s.masked_fill(~ok, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # a row with no key kept so far keeps m = -inf; exp2(-inf) = 0
        ms = torch.where(m_new == -torch.inf, 0.0, m_new) * sl
        corr = torch.exp2(m * sl - ms)
        p = torch.exp2(s * sl - ms[..., None])
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        pv = torch.einsum("bkgqs,bskd->bkgqd", hi, vt)
        if split:
            lo = (p - hi).bfloat16().float()
            pv = pv + torch.einsum("bkgqs,bskd->bkgqd", lo, vt)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).bfloat16()


def excess(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| minus the bf16 bound of ``attn_tol``, per element."""
    w = want.float()
    tol = 1e-2 * w.abs() + 1e-3 * float(w.pow(2).mean().sqrt())
    return (got.float() - w).abs() - tol


def inputs(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(
        rng.randn(*s).astype(np.float32)).bfloat16()
    return mk(B, Sq, H, D), mk(B, Sk, Hkv, D), mk(B, Sk, Hkv, D)


def run_case(name, split, seed=0):
    B, Sq, Sk, H, Hkv, D, causal, window = CASES[name]
    q, k, v = inputs(B, Sq, Sk, H, Hkv, D, seed)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = kernel_recipe(q, k, v, causal, window, KERNEL_BK[D], split)
    return got, want


@pytest.mark.parametrize("name", list(CASES))
def test_split_p_recipe_holds_the_kernel_bound(name):
    got, want = run_case(name, split=True)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    ex = excess(got, want)
    assert float(ex.max()) <= 0, (f"{int((ex > 0).sum())} outputs past the "
                                  f"bound, worst by {float(ex.max()):.3e}")


def test_single_rounding_of_p_does_not_hold_the_kernel_bound():
    """Why the kernel splits P: at Hymba's heads P rounded once to bf16
    puts outputs past the bound the split holds."""
    got, want = run_case("hymba-heads", split=False)
    assert int((excess(got, want) > 0).sum()) > 0


def test_bound_is_attn_tol():
    """The bound here is ``chip_smoke.py::attn_tol``'s for bf16."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    got, want = run_case("ragged-s77", split=False)
    torch.testing.assert_close(
        excess(got, want),
        (got.float() - want.float()).abs() - chip_smoke.attn_tol(want),
        rtol=0, atol=0)


if __name__ == "__main__":
    for case in CASES:
        for split in (True, False):
            ex = excess(*run_case(case, split))
            print(f"{case:32s} {'split P' if split else 'P once':8s} "
                  f"worst excess {float(ex.max()):+.3e}, past the bound "
                  f"{int((ex > 0).sum())} of {ex.numel()}")
