"""Plain PyTorch versions of the port's CUDA kernels.

Each function here is the plain version of one CUDA kernel: the CPU path
of its wrapper and the yardstick the kernel is held to on the card.  They
mirror the oracles of the JAX package's ``kernels/ref.py``:

* the Eq. (20) consensus kernels B1-B3 (``csrc/sign_agg.cu``, wrappers in
  ``kernels/sign_agg.py``; over many leaves at once:
  :func:`sign_agg_group_ref` for B1/B2, :func:`sign_agg_int8_group_ref`
  for B3), and their split over ranks: the partial sums
  (:func:`sign_sum_group_ref`, :func:`sign_sum_int8_group_ref`) and the
  epilogue on the all-reduced sums (:func:`sign_finish_group_ref`);
* prefill attention B4 (``csrc/flash_attention.cu``) and decode attention
  B5 (``csrc/decode_attention.cu``), in the model's layout, computed in
  f32 and returned in the query's dtype;
* the Mamba recurrence B6 (``csrc/ssm_scan.cu``), a fold over time in f32,
  and its backward (:func:`ssm_scan_bwd_ref`), the reverse fold.

In B1-B3 every cross-client sum adds rows strictly in order (a Python loop of
``acc = acc + w[j] * X[j]`` in f32), never through ``torch.sum``, which
regroups.  The kernels loop rows in the same order with the same
roundings, so they agree with these folds bit for bit.  Divisions by the
client count are true divisions (see :func:`true_div`).

The streamed folds (:func:`fold_weighted_rowsum_stream`,
:func:`sign_agg_fold_stream_ref`, :func:`fold_dual_rowsum` with a chunk)
are the same left-folds consumed a chunk of rows at a time, the
reference's ``consensus_streaming``; a chunk boundary never regroups an
addition, so they equal the one-pass folds bit for bit.  They are no
kernel's plain version: the reference's streamed path reaches no Pallas
kernel, and the port's runs them on every device.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import torch


def jsign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: +-1 off zero, the operand itself at +-0 and NaN.
    (``torch.sign`` maps NaN to 0 and -0.0 to +0.0.)"""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def true_div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` rounded once.  CUDA's tensor-by-Python-scalar division
    multiplies by the reciprocal, which can be 1 ulp off; dividing by a
    full tensor is a true division on every device."""
    return x / torch.full_like(x, float(n))


def fold_weighted_rowsum(X: torch.Tensor, weights: torch.Tensor
                         ) -> torch.Tensor:
    """``sum_j weights[j] * X[j]`` accumulated strictly in row order, in
    f32.  A zero-weight row adds an exact +-0.0, so the masked C-row fold
    equals the fold over just the surviving rows."""
    Xf = X.float()
    wf = weights.float()
    acc = torch.zeros(X.shape[1:], dtype=torch.float32, device=X.device)
    for j in range(X.shape[0]):
        acc = acc + wf[j] * Xf[j]
    return acc


def _epilogue(z: torch.Tensor, phi_mean: torch.Tensor, ssum: torch.Tensor,
              n: int, psi: float, alpha_z: float) -> torch.Tensor:
    """``z - alpha_z * (phi_mean + psi * ssum / n)`` in f32, cast to z's
    dtype — the kernels' epilogue, one rounding per operation."""
    dz = phi_mean.float() + psi * true_div(ssum, n)
    return (z.float() - alpha_z * dz).to(z.dtype)


def sign_agg_ref(z: torch.Tensor, W: torch.Tensor, phi_mean: torch.Tensor,
                 psi: float, alpha_z: float) -> torch.Tensor:
    """B1: ``z - alpha_z * (phi_mean + psi * mean_i sign(z - w_i))``.
    z, phi_mean: (D,); W: (C, D)."""
    zf = z.float()
    Wf = W.float()
    acc = torch.zeros_like(zf)
    for i in range(W.shape[0]):
        acc = acc + jsign(zf - Wf[i])
    return _epilogue(z, phi_mean, acc, W.shape[0], psi, alpha_z)


def sign_agg_fold_ref(z: torch.Tensor, W: torch.Tensor,
                      phi_mean: torch.Tensor, weights: torch.Tensor,
                      psi: float, alpha_z: float,
                      n_total: int) -> torch.Tensor:
    """B2: ``z - alpha_z * (phi_mean + psi * fold_j w_j sign(z - W_j) /
    n_total)`` — the staleness-weighted sum, normalised by ``n_total``."""
    zf = z.float()
    Wf = W.float()
    wf = weights.float()
    acc = torch.zeros_like(zf)
    for j in range(W.shape[0]):
        acc = acc + wf[j] * jsign(zf - Wf[j])
    return _epilogue(z, phi_mean, acc, n_total, psi, alpha_z)


def _fold_chunks(R: int, chunk_size: int, fold_chunk, init):
    """Drive ``fold_chunk(start, size, acc)`` over ``[0, R)`` in row order:
    the full ``chunk_size``-row chunks, then the tail (``R % chunk_size``
    rows) as one short chunk.  A chunk boundary never reorders a
    left-fold's additions, so the result is bit-identical to the one-pass
    fold for any ``chunk_size >= 1``."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    acc = init
    for start in range(0, R, chunk_size):
        acc = fold_chunk(start, min(chunk_size, R - start), acc)
    return acc


def fold_weighted_rowsum_stream(X: torch.Tensor, weights: torch.Tensor,
                                chunk_size: int) -> torch.Tensor:
    """:func:`fold_weighted_rowsum` consumed ``chunk_size`` rows at a time
    (the arrival-event shape); bit-identical to it."""
    wf = weights.float()

    def fold_chunk(start, size, acc):
        Xc = X[start:start + size].float()
        for j in range(size):
            acc = acc + wf[start + j] * Xc[j]
        return acc

    return _fold_chunks(X.shape[0], chunk_size, fold_chunk,
                        torch.zeros(X.shape[1:], dtype=torch.float32,
                                    device=X.device))


def sign_agg_fold_stream_ref(z: torch.Tensor, W: torch.Tensor,
                             phi_mean: torch.Tensor, weights: torch.Tensor,
                             psi: float, alpha_z: float, n_total: int,
                             chunk_size: int,
                             message: str = "f32") -> torch.Tensor:
    """:func:`sign_agg_fold_ref` as an online reduction over chunks of
    ``chunk_size`` rows: no more than one ``(chunk_size, D)`` message block
    exists at a time.  ``message="int8"`` round-trips each chunk's signs
    through the int8 wire (lossless), so the whole payload never exists
    either.  Bit-identical to :func:`sign_agg_fold_ref` and to
    :func:`sign_agg_int8_fold_ref` on the encoded message."""
    if message not in ("f32", "int8"):
        raise ValueError(f"unknown sign message format: {message!r}")
    zf = z.float()
    wf = weights.float()

    def fold_chunk(start, size, acc):
        sgn = jsign(zf[None, :] - W[start:start + size].float())
        if message == "int8":
            sgn = sgn.to(torch.int8).float()
        for j in range(size):
            acc = acc + wf[start + j] * sgn[j]
        return acc

    acc = _fold_chunks(W.shape[0], chunk_size, fold_chunk,
                       torch.zeros_like(zf))
    return _epilogue(z, phi_mean, acc, n_total, psi, alpha_z)


def fold_dual_rowsum(phi_rows: torch.Tensor, weights: torch.Tensor,
                     chunk_size: int = 0) -> torch.Tensor:
    """``sum_j weights[j] * decode(encode(phi_rows[j]))``: the Eq. (22)
    dual-side left-fold through the int8 dual wire.  The quantizer is
    row-local, so ``chunk_size >= 1`` (encode, decode and fold one chunk
    at a time) is bit-identical to ``chunk_size=0`` (the whole block)."""
    from repro_torch.distributed import collectives

    if chunk_size == 0:
        dec = collectives.decode_dual_message(
            collectives.encode_dual_message(phi_rows))
        return fold_weighted_rowsum(dec, weights)
    wf = weights.float()

    def fold_chunk(start, size, acc):
        dec = collectives.decode_dual_message(
            collectives.encode_dual_message(phi_rows[start:start + size]))
        for j in range(size):
            acc = acc + wf[start + j] * dec[j]
        return acc

    return _fold_chunks(phi_rows.shape[0], chunk_size, fold_chunk,
                        torch.zeros(phi_rows.shape[1:], dtype=torch.float32,
                                    device=phi_rows.device))


def sign_agg_weighted_ref(z: torch.Tensor, W: torch.Tensor,
                          phi_mean: torch.Tensor, weights: torch.Tensor,
                          psi: float, alpha_z: float) -> torch.Tensor:
    """B2 with the divisor C: ``sum_i s_i sign(z - w_i) / C`` (divided by
    C, not by ``sum(s_i)``); all-ones weights reduce to B1."""
    return sign_agg_fold_ref(z, W, phi_mean, weights, psi, alpha_z,
                             W.shape[0])


def sign_agg_group_ref(zs: Sequence[torch.Tensor],
                       Ws: Sequence[torch.Tensor],
                       phis: Sequence[torch.Tensor],
                       weights: Optional[torch.Tensor], psi: float,
                       alpha_z: float, n_total: int = 0
                       ) -> List[torch.Tensor]:
    """B1/B2 over a list of leaves (the group kernel's plain version):
    :func:`sign_agg_ref` per leaf without ``weights``, else
    :func:`sign_agg_fold_ref` with the divisor ``n_total or C``."""
    if weights is None:
        return [sign_agg_ref(z, W, phi, psi, alpha_z)
                for z, W, phi in zip(zs, Ws, phis)]
    return [sign_agg_fold_ref(z, W, phi, weights, psi, alpha_z,
                              n_total or W.shape[0])
            for z, W, phi in zip(zs, Ws, phis)]


def int8_sign_sum(payload: torch.Tensor,
                  scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``sum_i scale_i * payload_i`` from the int8 wire, never in int8:
    an exact int32 sum when unweighted, the f32 row-order fold when
    weighted."""
    if scale is None:
        return payload.to(torch.int32).sum(0, dtype=torch.int32).float()
    return fold_weighted_rowsum(payload, scale)


def sign_agg_int8_fold_ref(z: torch.Tensor, payload: torch.Tensor,
                           scale: Optional[torch.Tensor],
                           phi_mean: torch.Tensor, psi: float,
                           alpha_z: float, n_total: int) -> torch.Tensor:
    """B3: the consensus update read from the int8 wire, divisor
    ``n_total``.  ``payload``: (C, D) int8 signs; ``scale``: (C,) f32 or
    ``None``."""
    return _epilogue(z, phi_mean, int8_sign_sum(payload, scale), n_total,
                     psi, alpha_z)


def sign_agg_int8_group_ref(zs: Sequence[torch.Tensor],
                            payloads: Sequence[torch.Tensor],
                            phis: Sequence[torch.Tensor],
                            scale: Optional[torch.Tensor], psi: float,
                            alpha_z: float, n_total: int = 0
                            ) -> List[torch.Tensor]:
    """B3 over a list of leaves (the group kernel's plain version):
    :func:`sign_agg_int8_fold_ref` per leaf, divisor ``n_total or C``."""
    return [sign_agg_int8_fold_ref(z, q, scale, phi, psi, alpha_z,
                                   n_total or q.shape[0])
            for z, q, phi in zip(zs, payloads, phis)]


def sign_sum_group_ref(zs: Sequence[torch.Tensor],
                       Ws: Sequence[torch.Tensor],
                       weights: Optional[torch.Tensor]
                       ) -> List[torch.Tensor]:
    """B1/B2's partial per leaf: ``sum_i s_i jsign(z - W_i)`` over the
    rows given, the row-order f32 fold of :func:`sign_agg_ref` /
    :func:`sign_agg_fold_ref` without their epilogue (``s_i`` 1 without
    ``weights``)."""
    out = []
    for z, W in zip(zs, Ws):
        zf, Wf = z.float(), W.float()
        acc = torch.zeros_like(zf)
        for i in range(W.shape[0]):
            sg = jsign(zf - Wf[i])
            acc = acc + (sg if weights is None else weights[i].float() * sg)
        out.append(acc)
    return out


def sign_sum_int8_group_ref(payloads: Sequence[torch.Tensor],
                            scale: Optional[torch.Tensor]
                            ) -> List[torch.Tensor]:
    """B3's partial per leaf: the int8 payload's exact int32 sum over the
    rows given (``scale`` None), or the f32 row-order fold ``acc + s_i
    q_i`` (:func:`int8_sign_sum` without the cast)."""
    if scale is None:
        return [q.to(torch.int32).sum(0, dtype=torch.int32)
                for q in payloads]
    return [fold_weighted_rowsum(q, scale) for q in payloads]


def sign_finish_group_ref(zs: Sequence[torch.Tensor],
                          sums: Sequence[torch.Tensor],
                          phis: Sequence[torch.Tensor], psi: float,
                          alpha_z: float, n: int) -> List[torch.Tensor]:
    """The epilogue of B1-B3 on all-reduced sums (f32, or int32 converted
    to f32 first, as B3 converts its sum): ``z - alpha_z (phi_mean + psi
    sum / n)``, with :func:`true_div`."""
    return [_epilogue(z, phi, s.float(), n, psi, alpha_z)
            for z, s, phi in zip(zs, sums, phis)]


def weighted_split_bound(z: torch.Tensor, phi_mean: torch.Tensor,
                         weights: torch.Tensor, n: int, psi: float,
                         alpha_z: float) -> torch.Tensor:
    """How far a weighted Eq. (20) step whose fold is split over ranks may
    land from the one-pass fold's, per coordinate of z'.  The two sums of
    the C terms ``s_i sign_i`` (the row-order fold; the per-rank folds and
    their all-reduce) are each a sum of C terms in some grouping, within
    ``g S`` of the exact one (``g = (C-1) u / (1 - (C-1) u)``, u = 2^-24,
    ``S = sum_i |s_i|``): they differ by at most ``2 g S``, which the
    epilogue scales by ``|psi alpha_z| / n``.  Each side then rounds its
    five epilogue operations to within half an ulp (``u |x|``) of their
    values, bounded through ``S``, ``|phi_mean|`` and ``|z|``; a bf16 z'
    adds its final rounding (2^-9 |z'|) on each side."""
    C = weights.shape[0]
    u = 2.0 ** -24
    g = (C - 1) * u / (1.0 - (C - 1) * u)
    S = float(torch.sum(torch.abs(weights.double())))
    ap = abs(psi * alpha_z)
    q = S / n
    p = abs(psi) * q
    dz = torch.abs(phi_mean.double()) + p
    m = abs(alpha_z) * dz
    zz = torch.abs(z.double()) + m
    bound = ap * 2.0 * g * S / n + 2.0 * u * (
        ap * q + abs(alpha_z) * p + abs(alpha_z) * dz + m + zz)
    if z.dtype == torch.bfloat16:
        bound = bound + 2.0 * 2.0 ** -9 * zz
    return (bound + 2.0 ** -140).float()


def sign_agg_int8_ref(z: torch.Tensor, payload: torch.Tensor,
                      scale: Optional[torch.Tensor], phi_mean: torch.Tensor,
                      psi: float, alpha_z: float) -> torch.Tensor:
    """B3 with the divisor C.  Given ``payload = sign(z - w_i)`` and
    ``scale = s`` this equals :func:`sign_agg_weighted_ref` bit for bit
    (a sign message quantizes losslessly)."""
    return sign_agg_int8_fold_ref(z, payload, scale, phi_mean, psi, alpha_z,
                                  payload.shape[0])


@functools.lru_cache(maxsize=None)
def attention_scale(D: int) -> float:
    """``1 / sqrt(D)`` in f32 (an f32 sqrt, then an f32 division), as the
    oracles compute it; the kernels are handed the same value."""
    d = torch.tensor(float(D), dtype=torch.float32)
    return float(1.0 / torch.sqrt(d))


def _attention_logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
                      window: int):
    """The scaled logits (B, Hkv, G, Sq, Sk) in f32 and the (Sq, Sk) mask
    of the keys each query keeps (queries end-aligned with the keys)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg * attention_scale(D),
                          k.float())
    qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    ki = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window:
        ok &= ki > qi - window
    return logits, ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        with_lse: bool = False):
    """B4: plain softmax attention, GQA-aware, in f32.

    q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D).  Returns (B, Sq, H, D) in q's
    dtype.  Queries are end-aligned with the keys: query i sits at
    absolute position ``i + Sk - Sq``.  Masked logits are -1e30, so a row
    with no key left (causal and Sq > Sk) averages every value.
    ``with_lse=True`` returns ``(out, lse)``, ``lse`` (B, H, Sq) f32 the
    log-sum-exp of each row's scaled logits, which the backward
    (:func:`flash_attention_bwd_ref`) recomputes P from."""
    B, Sq, H, D = q.shape
    logits, ok = _attention_logits(q, k, causal, window)
    logits = torch.where(ok, logits, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True, window: int = 0):
    """B4's gradient, in the kernel's own formulation, in f32: P
    recomputed from the forward's ``lse`` (B, H, Sq), ``delta =
    rowsum(dO * O)``, ``dS = P * (dP - delta)`` with ``dP = dO V^T``, then
    ``dQ = scale dS K``, ``dK = scale dS^T Q`` and ``dV = P^T dO``, dK and
    dV summed over the query heads of each KV head's group.  ``out`` and
    ``dout``: (B, Sq, H, D).  Returns (dq, dk, dv) in the inputs' shapes
    and dtypes."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = attention_scale(D)
    logits, ok = _attention_logits(q, k, causal, window)
    lse_g = lse.float().reshape(B, Hkv, G, Sq)[..., None]
    p = torch.where(ok, torch.exp(logits - lse_g),
                    torch.zeros((), device=q.device))
    do_g = dout.reshape(B, Sq, Hkv, G, D).float()
    o_g = out.reshape(B, Sq, Hkv, G, D).float()
    delta = torch.einsum("bqkgd,bqkgd->bkgq", do_g, o_g)[..., None]
    dp = torch.einsum("bqkgd,bskd->bkgqs", do_g, v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    # Q scaled before the product, as the kernel holds it
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.reshape(B, Sq, Hkv, G, D).float() * scale)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do_g)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: torch.Tensor) -> torch.Tensor:
    """B5: one query token per head against a KV cache, in f32.

    q: (B, H, D); k, v: (B, L, Hkv, D) (the model's cache layout);
    length: (B,) valid positions per row (positions >= length are
    masked).  Returns (B, H, D) in q's dtype."""
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg * attention_scale(D),
                          k.float())
    length = torch.as_tensor(length, device=q.device).expand(B)
    valid = torch.arange(L, device=q.device)[None, :] < length[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_partial_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, length: torch.Tensor):
    """B5's partial over one block of cache positions, in f32: q (B, H,
    D); k, v (B, L, Hkv, D); length (B,) valid positions of the block, 0
    allowed.  Returns (out (B, H, D) f32, the softmax-weighted mean of V
    over the valid positions; lse (B, H) f32, the log-sum-exp of the
    scaled logits there).  A row with no valid position gets out 0 and
    lse -inf (where :func:`decode_attention_ref`'s -1e30 mask would
    average every value)."""
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg * attention_scale(D),
                          k.float())
    length = torch.as_tensor(length, device=q.device).expand(B)
    valid = (torch.arange(L, device=q.device)[None, :]
             < length[:, None])[:, None, None, :]
    logits = torch.where(valid, logits,
                         torch.tensor(-math.inf, device=q.device))
    lse = torch.logsumexp(logits, dim=-1)
    finite = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    probs = torch.where(valid, torch.exp(logits - finite[..., None]),
                        torch.zeros((), device=q.device))
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(B, H, D), lse.reshape(B, H)


def merge_decode_partials(outs, lses, dtype: torch.dtype) -> torch.Tensor:
    """The merge of B5's partials over the blocks of a split cache, in
    block order: ``outs`` (M, B, H, D) f32 and ``lses`` (M, B, H) f32 (or
    sequences of them), weights ``exp(lse_r - max_r lse_r)`` (a block
    with lse -inf weighs exactly 0), the weighted sum of the outputs over
    the sum of the weights, rounded once to ``dtype``.  Every rank that
    merges the same partials gets the same bits."""
    outs, lses = list(outs), list(lses)
    top = lses[0]
    for lse in lses[1:]:
        top = torch.maximum(top, lse)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    num = den = None
    for out, lse in zip(outs, lses):
        w = torch.where(lse == -math.inf, torch.zeros_like(lse),
                        torch.exp(lse - top))
        num = out * w[..., None] if num is None else num + out * w[..., None]
        den = w if den is None else den + w
    return (num / torch.clamp_min(den, 1e-30)[..., None]).to(dtype)


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B6: the diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t``.

    a, b: (B, S, D, N), any float type, read as f32; h0: (B, D, N) or
    ``None`` (zeros, the Pallas kernel's start).  Returns hs: (B, S, D, N)
    in f32.  Each step is ``a_t * h`` and then ``+ b_t``, two rounded
    operations as the oracle writes them; the kernel does the same, so the
    two agree bit for bit."""
    B, S, D, N = a.shape
    h = (torch.zeros((B, D, N), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    hs = torch.empty((B, S, D, N), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t].float() * h
        h = h + b[:, t].float()
        hs[:, t] = h
    return hs


def ssm_scan_bwd_ref(a: torch.Tensor, hs: torch.Tensor,
                     h0: Optional[torch.Tensor], dhs: torch.Tensor):
    """B6's gradient: the reverse recurrence, a fold down the time axis in
    f32.  With ``h_{t-1}`` the forward's ``hs[:, t-1]`` (``h0`` or zeros
    at t = 0) and ``dhs`` the gradient reaching each ``hs_t`` (taken as
    given, its last row included)::

        g_{S-1} = dhs_{S-1},  g_t = dhs_t + a_{t+1} * g_{t+1}
        da_t = g_t * h_{t-1},  db_t = g_t,  dh0 = a_0 * g_0

    each product and sum rounded on its own, in the kernel's order, so
    the two agree bit for bit.  a: (B, S, D, N) f32 or bf16; hs, dhs:
    (B, S, D, N); h0: (B, D, N) or ``None``.  Returns (da, db) in a's
    dtype and dh0 (B, D, N) f32."""
    B, S, D, N = a.shape
    h_init = (torch.zeros((B, D, N), dtype=torch.float32, device=a.device)
              if h0 is None else h0.float())
    da = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    db = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    g = dhs[:, S - 1].float().clone()
    for t in range(S - 1, -1, -1):
        if t < S - 1:
            g = dhs[:, t].float() + a[:, t + 1].float() * g
        h_prev = hs[:, t - 1].float() if t > 0 else h_init
        da[:, t] = (g * h_prev).to(a.dtype)
        db[:, t] = g.to(a.dtype)
    return da, db, a[:, 0].float() * g
