"""The port's bf16 compute path against the JAX reference on the CPU.

Every other model test runs the smoke configs in f32 (``reduce_for_smoke``
sets both dtypes to float32).  Here SmolLM-360M's and Hymba-1.5B's smoke
configs get ``compute_dtype="bfloat16"`` in both packages, with the
reference's own ``init_lm`` weights (f32), and each package's bf16 logits
are compared with the reference's f32 logits on the same tokens:

    e_port = port_bf16 - ref_f32,   e_ref = ref_bf16 - ref_f32.

bf16 roundings do not happen at the same places in two frameworks, so the
two errors are not held to each other element by element.  What is held is
their size, with bounds fixed before the first run:

* ``0.5 <= RMS(e_port) / RMS(e_ref) <= 1.25``: the port's dtype policy
  (which products run in bf16, where f32 is kept) loses no more than the
  reference's, and the lower bound catches a port that quietly computes in
  f32 (its error would be ~0);
* ``max|e_port| <= 1.5 * max|e_ref|``.

S = 300 passes the reference's Q_CHUNK = 256 and, for Hymba, the Mamba
scan's 128-step chunks.  A miss is a fault of the port, to be fixed in
``src/repro_torch/``, not by moving the bounds.

    PYTHONPATH=src python tests/test_torch_bf16_policy.py

prints both errors and the ratios for each case.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.models import transformer as tr

ARCHS = ["smollm-360m", "hymba-1.5b"]
LENGTHS = [16, 300]
RMS_RATIO = (0.5, 1.25)
MAX_RATIO = 1.5


def _bf16(cfg):
    return dataclasses.replace(cfg, compute_dtype="bfloat16")


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's ``init_lm`` weights of the f32 smoke config, as
    numpy (``compute_dtype`` does not enter ``init_lm``)."""
    import jax

    jconfigs = importlib.import_module("repro.configs")
    jtr = importlib.import_module("repro.models.transformer")
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_arch(arch))
    return jax.tree.map(np.asarray, jtr.init_lm(jax.random.PRNGKey(0), jcfg))


@functools.lru_cache(maxsize=None)
def logits(arch, S):
    """(ref f32, ref bf16, port bf16) logits on the same tokens, each as
    a float64 numpy array, and the two bf16 dtypes."""
    import jax
    import jax.numpy as jnp

    jconfigs = importlib.import_module("repro.configs")
    jtr = importlib.import_module("repro.models.transformer")
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_arch(arch))
    cfg = _bf16(reduce_for_smoke(get_arch(arch)))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_bf16(jcfg))
    tree = _weights(arch)
    jparams = jax.tree.map(jnp.asarray, tree)
    toks = np.random.RandomState(S).randint(0, cfg.vocab_size, (2, S))
    jtoks = {"tokens": jnp.asarray(toks)}
    ref32, _ = jtr.forward_logits(jparams, jtoks, jcfg)
    ref16, _ = jtr.forward_logits(jparams, jtoks, _bf16(jcfg))
    port16, _ = tr.forward_logits(
        tr.lm_params_from_numpy(tree, cfg, device="cpu"),
        {"tokens": torch.from_numpy(toks)}, cfg)
    as64 = lambda x: np.asarray(jnp.asarray(x, jnp.float32), np.float64)
    return (as64(ref32), as64(ref16),
            port16.detach().double().numpy(), str(ref16.dtype), port16.dtype)


def errors(arch, S):
    """(RMS(e_port), RMS(e_ref), max|e_port|, max|e_ref|)."""
    ref32, ref16, port16 = logits(arch, S)[:3]
    e_port, e_ref = port16 - ref32, ref16 - ref32
    rms = lambda e: float(np.sqrt(np.mean(e ** 2)))
    return (rms(e_port), rms(e_ref), float(np.abs(e_port).max()),
            float(np.abs(e_ref).max()))


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_in_bf16_in_both_packages(arch, S):
    ref32, _, port16, ref_dtype, port_dtype = logits(arch, S)
    assert ref_dtype == "bfloat16" and port_dtype == torch.bfloat16
    assert port16.shape == ref32.shape and np.isfinite(port16).all()


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_error_is_the_reference_s(arch, S):
    rms_port, rms_ref, max_port, max_ref = errors(arch, S)
    assert rms_ref > 0
    ratio = rms_port / rms_ref
    assert RMS_RATIO[0] <= ratio <= RMS_RATIO[1], (
        f"RMS error {rms_port:.4g} vs the reference's {rms_ref:.4g} "
        f"(ratio {ratio:.3f})")
    assert max_port <= MAX_RATIO * max_ref, (
        f"max error {max_port:.4g} vs the reference's {max_ref:.4g}")


if __name__ == "__main__":
    for arch in ARCHS:
        for S in LENGTHS:
            rp, rr, mp, mr = errors(arch, S)
            print(f"{arch:12s} S={S:4d} RMS port {rp:.4g} ref {rr:.4g} "
                  f"(ratio {rp / rr:.3f}); max port {mp:.4g} ref {mr:.4g} "
                  f"(ratio {mp / mr:.3f})")
