"""The port's bf16 compute path against the JAX reference on the CPU.

Every other model test runs the smoke configs in f32 (``reduce_for_smoke``
sets both dtypes to float32).  Here the smoke configs of SmolLM-360M,
Hymba-1.5B, Granite-MoE-3B-a800m, OLMoE-1B-7B, xLSTM-1.3B and
LLaVA-NeXT-Mistral-7B get ``compute_dtype="bfloat16"`` in both packages,
with the reference's own ``init_lm`` weights (f32), and each package's
bf16 logits are compared with the reference's f32 logits on the same
tokens (LLaVA's after a prefix of 16 patch embeddings, the same numpy
array in both):

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
scan's 128-step chunks.  xLSTM runs S = 16 and 768 instead: the
reference's sLSTM scan takes only multiples of 256 past 256 steps, and
768 puts the mLSTM in three chunks of 256 (gcd(768, 512)).  A miss is
a fault of the port, to be fixed in ``src/repro_torch/``, not by moving
the bounds.

The MoE models route each token to its top-k experts, a discontinuity:
where the f32 run's k-th and (k+1)-th router probabilities nearly tie,
bf16 rounding (which each framework does at its own places) may pick
another expert, and that token and every later position of its row
(causal attention) then differ by O(1).  Each package flips a few such
tokens, not the same ones (over 30 prompts of the Granite smoke model:
14 in the reference, 10 in the port), so the errors' sizes would count
flips, not the dtype policy.  For these models both packages' routing is
recorded in every layer (the reference's by wrapping its ``moe_ffn`` with
a ``jax.debug.callback``), every flip (expert set, or keep mask, unlike
the f32 run's) must sit at a near-tie, a gap of the f32 run's k-th and
(k+1)-th probability below ``NEAR_TIE``, and the bounds above hold over
the positions neither package's flips reach.

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

ARCHS = ["smollm-360m", "hymba-1.5b", "granite-moe-3b-a800m",
         "olmoe-1b-7b"]
LENGTHS = [16, 300]
CASES = [(arch, S) for arch in ARCHS for S in LENGTHS] + [
    ("xlstm-1.3b", 16), ("xlstm-1.3b", 768),
    ("llava-next-mistral-7b", 16), ("llava-next-mistral-7b", 300)]
RMS_RATIO = (0.5, 1.25)
MAX_RATIO = 1.5
# 5 bf16 ulps (2^-8 relative each) of the router's input, on router
# probabilities of O(1 / n_experts)
NEAR_TIE = 5 * 2.0 ** -8 / 4


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


class RoutingLog:
    """Each MoE call's (sorted top-k experts, keep mask, probabilities)
    of one package, layer by layer, while active."""

    def __init__(self):
        self.calls = []

    def port(self):
        moe = importlib.import_module("repro_torch.models.moe")
        real = moe.route

        def spy(*args, **kwargs):
            r = real(*args, **kwargs)
            self.calls.append((np.sort(r.idx.numpy(), axis=1),
                               r.keep.numpy(), r.probs.numpy()))
            return r
        return moe, "route", spy

    def reference(self):
        import jax
        import jax.numpy as jnp

        jmoe = importlib.import_module("repro.models.moe")
        real = jmoe.moe_ffn

        def spy(p, x, cfg):
            T, k = x.shape[0] * x.shape[1], cfg.moe.top_k
            logits = jnp.einsum("td,de->te", x.reshape(T, -1).astype(
                jnp.float32), p["router"])
            probs = jax.nn.softmax(logits, axis=-1)
            _, idx = jax.lax.top_k(probs, k)
            e = idx.reshape(-1)
            onehot = jax.nn.one_hot(e, cfg.moe.n_experts, dtype=jnp.int32)
            pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot,
                                      e[:, None], axis=1)[:, 0]
            keep = (pos < jmoe.capacity(T, cfg)).reshape(T, k)
            jax.debug.callback(
                lambda i, kp, pr: self.calls.append(
                    (np.sort(np.asarray(i), axis=1), np.asarray(kp),
                     np.asarray(pr))), idx, keep, probs, ordered=True)
            return real(p, x, cfg)
        return jmoe, "moe_ffn", spy

    def run(self, target, fn):
        mod, name, spy = target
        real = getattr(mod, name)
        setattr(mod, name, spy)
        try:
            return fn()
        finally:
            setattr(mod, name, real)


def untouched(f32, bf16, shape):
    """(B, S) mask of the positions that no routing flip of the bf16 run
    ``bf16`` (a ``RoutingLog``'s calls) against the f32 run ``f32``
    reaches, and the flips as (layer, token, f32 gap); raises on a flip
    at a position no earlier layer's flip reached that is not a
    near-tie.  A token whose experts or keep mask differ reaches its own
    position and every later one of its row."""
    B, S = shape
    first = np.full(B, S)        # the first position of each row reached
    flips = []
    for layer, ((i32, k32, p32), (i16, k16, _)) in enumerate(zip(f32, bf16)):
        k = i32.shape[1]
        top = -np.sort(-p32, axis=1)
        reached = first.copy()   # by the flips of earlier layers
        for t in np.nonzero((i16 != i32).any(1) | (k16 != k32).any(1))[0]:
            b, s = divmod(int(t), S)
            if (i16[t] != i32[t]).any() and s < reached[b]:
                gap = float(top[t, k - 1] - top[t, k])
                flips.append((layer, int(t), gap))
                assert gap < NEAR_TIE, (
                    f"layer {layer} token {t}: routing differs from the f32 "
                    f"run's at a gap of {gap:.3g}, not a near-tie")
            first[b] = min(first[b], s)
    return np.arange(S)[None, :] < first[:, None], flips


@functools.lru_cache(maxsize=None)
def logits(arch, S):
    """(ref f32, ref bf16, port bf16) logits on the same tokens, each as
    a float64 numpy array, the two bf16 dtypes, the (B, S) mask of the
    positions held (all but those routing flips reach) and the flips of
    each package."""
    import jax
    import jax.numpy as jnp

    jconfigs = importlib.import_module("repro.configs")
    jtr = importlib.import_module("repro.models.transformer")
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_arch(arch))
    cfg = _bf16(reduce_for_smoke(get_arch(arch)))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_bf16(jcfg))
    tree = _weights(arch)
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.RandomState(S)
    toks = rng.randint(0, cfg.vocab_size, (2, S))
    inputs = {"tokens": toks}
    if cfg.frontend != "none":
        inputs["frontend_embeds"] = rng.randn(
            2, cfg.frontend_tokens, cfg.d_model).astype(np.float32)
    jtoks = {k: jnp.asarray(v) for k, v in inputs.items()}
    logs = {name: RoutingLog() for name in ("ref32", "ref16", "port16")}
    ref32, _ = logs["ref32"].run(logs["ref32"].reference(), lambda: (
        jax.block_until_ready(jtr.forward_logits(jparams, jtoks, jcfg))))
    ref16, _ = logs["ref16"].run(logs["ref16"].reference(), lambda: (
        jax.block_until_ready(jtr.forward_logits(jparams, jtoks,
                                                 _bf16(jcfg)))))
    port16, _ = logs["port16"].run(logs["port16"].port(), lambda: (
        tr.forward_logits(tr.lm_params_from_numpy(tree, cfg, device="cpu"),
                          {k: torch.from_numpy(v) for k, v in inputs.items()},
                          cfg)))
    held, flips = np.ones(toks.shape, bool), {}
    for name in ("ref16", "port16"):
        mask, flips[name] = untouched(logs["ref32"].calls, logs[name].calls,
                                      toks.shape)
        held &= mask
    as64 = lambda x: np.asarray(jnp.asarray(x, jnp.float32), np.float64)
    return (as64(ref32), as64(ref16),
            port16.detach().double().numpy(), str(ref16.dtype), port16.dtype,
            held, flips)


def errors(arch, S):
    """(RMS(e_port), RMS(e_ref), max|e_port|, max|e_ref|) over the
    positions held."""
    ref32, ref16, port16 = logits(arch, S)[:3]
    held = logits(arch, S)[5]
    e_port, e_ref = (port16 - ref32)[held], (ref16 - ref32)[held]
    rms = lambda e: float(np.sqrt(np.mean(e ** 2)))
    return (rms(e_port), rms(e_ref), float(np.abs(e_port).max()),
            float(np.abs(e_ref).max()))


@pytest.mark.parametrize("arch,S", CASES)
def test_bf16_logits_in_bf16_in_both_packages(arch, S):
    ref32, _, port16, ref_dtype, port_dtype, held, _ = logits(arch, S)
    assert ref_dtype == "bfloat16" and port_dtype == torch.bfloat16
    assert port16.shape == ref32.shape and np.isfinite(port16).all()
    # the errors are measured over a quarter of the logits at least;
    # without MoE over all of them
    assert held.mean() >= 0.25
    assert held.all() or "moe" in arch


@pytest.mark.parametrize("arch,S", CASES)
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
    for arch, S in CASES:
        rp, rr, mp, mr = errors(arch, S)
        held, flips = logits(arch, S)[5:]
        print(f"{arch:12s} S={S:4d} RMS port {rp:.4g} ref {rr:.4g} "
              f"(ratio {rp / rr:.3f}); max port {mp:.4g} ref {mr:.4g} "
              f"(ratio {mp / mr:.3f}); held {int(held.sum())}/"
              f"{held.size} positions; flips (layer, token, f32 gap) "
              f"{flips}")
