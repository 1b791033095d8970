"""The partition and merge order of B5's cluster kernel, on the CPU.

The kernel (``decode_cluster`` in ``src/repro_torch/kernels/csrc/
decode_attention.cu``) runs only on the card.  :func:`kernel_order`
repeats its cut of the work and the order of its merges here, in f32:

* the cache cut into splits of ``split_len`` positions (the wrapper's
  ``split_len`` on a card of 132 SMs), one block each, the splits of a
  (row, KV head) pair one cluster;
* inside a split, batches of ``kSteps`` key steps; step ``u`` of warp
  ``w`` gives lane group ``kg`` the key ``base + (u * kWarps + w) * kKeys
  + kg``, read only when it lies before ``min(split end, length[b])``;
* per lane group an online softmax in log2 units (q times the scale and
  log2(e)), one update per batch;
* the lane groups of a warp merged by the xor butterfly, the warps of a
  block in order, then the splits in rank order: ``a += acc * w`` with
  ``w = 2^(m - M)``, an empty partial (m = -inf) weighing 0;
* ``a / max(l, 1e-30)``.

Its constants come from the ``.cu`` (``kThreads``, ``kSteps``,
``kMaxSplits``) and ``Tile``'s rules for f32 (a lane reads 4 floats).
The tests hold it to the JAX reference's Pallas kernel (interpret mode)
at abs/rel 3e-5, the bound B5 is held to on the card, over ragged
lengths with empty splits, and show that nothing at or past
``length[b]`` enters the result.

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_split.py
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import ref
from test_torch_reference import reference  # noqa: F401  (fixture)

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
      "kernels" / "csrc" / "decode_attention.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


THREADS, STEPS, MAX_SPLITS = (_const(n) for n in
                              ("kThreads", "kSteps", "kMaxSplits"))
WARPS = THREADS // 32
VEC = 4                                   # f32: 16 bytes a lane per load
N_SM = 132
LOG2E = 1.4426950408889634
LENGTHS = [1, 16, 40, 512]                # in a cache of 512: empty splits
TOL = 3e-5


def tile(D: int):
    """``Tile<D, float>``: lanes per key and keys per warp step."""
    lanes = min(D // VEC, 32)
    return lanes, 32 // lanes


def _weight(m: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    return torch.where(m == -math.inf, torch.zeros_like(m),
                       torch.exp2(m - M))


def _merge(parts):
    """Partials (m (G,), l (G,), acc (G, D)) in the given order."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    l = torch.zeros_like(M)
    a = torch.zeros_like(parts[0][2])
    for m, lp, acc in parts:
        w = _weight(m, M)
        l = torch.addcmul(l, lp, w)
        a = torch.addcmul(a, acc, w[:, None])
    return M, l, a


def _fold(qs, kb, vb, keys, stop):
    """One lane group's online softmax over its keys, batch by batch.
    ``keys``: per batch, the ``STEPS`` key positions (read if < stop)."""
    G, D = qs.shape
    m = torch.full((G,), -math.inf)
    l = torch.zeros(G)
    acc = torch.zeros(G, D)
    for batch in keys:
        valid = [p for p in batch if p < stop]
        if not valid:
            continue
        s = qs @ kb[valid].T                             # (G, n), log2 units
        mx = torch.maximum(m, s.max(dim=1).values)
        corr = torch.exp2(m - mx)
        p = torch.exp2(s - mx[:, None])
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None] + p @ vb[valid]
        m = mx
    return m, l, acc


def kernel_order(q, k, v, length):
    """B5 as the cluster kernel cuts and merges it, in f32.  q: (B, H, D);
    k, v: (B, L, Hkv, D); length: (B,) int."""
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    lanes, keys_per_step = tile(D)
    span = STEPS * WARPS * keys_per_step
    sl = dec_k.split_len(B, Hkv, L, N_SM)
    n_split = -(-L // sl)
    assert n_split <= MAX_SPLITS
    scale = ref.attention_scale(D) * LOG2E
    out = torch.empty(B, H, D)
    for b in range(B):
        n = min(int(length[b]), L)
        for hk in range(Hkv):
            qs = q[b, hk * G:(hk + 1) * G].float() * scale
            kb, vb = k[b, :, hk].float(), v[b, :, hk].float()
            splits = []
            for split in range(n_split):
                start, stop = split * sl, min(split * sl + sl, n)
                warps = []
                for w in range(WARPS):
                    groups = [_fold(qs, kb, vb, [
                        [base + (u * WARPS + w) * keys_per_step + kg
                         for u in range(STEPS)]
                        for base in range(start, stop, span)], stop)
                        for kg in range(keys_per_step)]
                    o = 1
                    while lanes * o < 32:                # xor butterfly
                        groups = [_merge([groups[i], groups[i ^ o]])
                                  for i in range(len(groups))]
                        o *= 2
                    warps.append(groups[0])
                splits.append(_merge(warps))
            _, l, a = _merge(splits)
            out[b, hk * G:(hk + 1) * G] = a / l.clamp(min=1e-30)[:, None]
    return out


def _inputs(seed, B, L, H, Hkv, D):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(*s).astype(np.float32) for s in
               [(B, H, D), (B, L, Hkv, D), (B, L, Hkv, D)])
    return q, k, v


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("H,Hkv", [(15, 5), (25, 5)])
def test_kernel_order_matches_the_reference_kernel(reference, D, H, Hkv):
    """Ragged lengths (1, 16, 40, 512) in a cache of 512: most splits of
    the short rows are empty and weigh 0."""
    import jax.numpy as jnp

    q, k, v = _inputs(D + H, len(LENGTHS), 512, H, Hkv, D)
    length = np.array(LENGTHS, np.int32)
    got = kernel_order(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), length)
    want = reference.ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(length),
        impl="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_kernel_order_reads_nothing_past_length(D):
    """A NaN cache past ``length[b]`` leaves the result bit for bit as it
    was: no position at or past it is read."""
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(D, len(LENGTHS), 512, 15, 5, D))
    length = np.array(LENGTHS, np.int32)
    kp, vp = k.clone(), v.clone()
    for b, n in enumerate(LENGTHS):
        kp[b, n:] = float("nan")
        vp[b, n:] = float("nan")
    clean = kernel_order(q, k, v, length)
    poisoned = kernel_order(q, kp, vp, length)
    assert torch.isfinite(poisoned).all()
    assert torch.equal(clean, poisoned)


def test_the_serving_cut_is_eight_splits_of_one_chunk():
    """B=8, Hkv=5, L=512 on 132 SMs: 8 splits of 64 positions, so a row of
    length 16 leaves 7 of its 8 blocks empty."""
    sl = dec_k.split_len(8, 5, 512, N_SM)
    assert sl == dec_k.CHUNK and -(-512 // sl) == MAX_SPLITS
