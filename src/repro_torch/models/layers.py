"""Shared layers: init, norms, RoPE, embeddings, dense FFN variants and the
LM-training losses ``chunked_ce_from_hidden`` and ``cross_entropy`` (the
port of the JAX package's ``models/layers.py``).

Parameters are plain tensors, looked up by the reference's names
(``params["scale"]``, ``params["w_gate"]``, ...).  Every function keeps
the reference's dtype rules: norms and RoPE compute in f32 and return the
input's dtype; projections run in the activation's dtype.

``ranks=`` (a ``data_parallel.RankBlock`` whose ``specs`` are the plan's
specs of ``params``, over a ``"model"`` axis of several ranks): the
params are this rank's blocks and the layer runs tensor-parallel
(``distributed/tensor_parallel.py``): the embedding vocab-parallel, the
logits this rank's vocabulary block, the FFN column- then row-parallel
(one sum over ``"model"``), a norm's scale gathered at use.  Without it,
or over one ``"model"`` rank, the same functions run world 1's ops.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def span(name: str):
    """A profiler label while ``torch.profiler`` records, else nothing
    (``profile_serve`` sums the device time under each label)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def dense_init(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               scale: float = 1.0, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: ``scale / sqrt(fan_in)`` times a
    standard normal truncated to [-2, 2], drawn from ``gen`` (on ``gen``'s
    device unless ``device`` says otherwise)."""
    std = scale / math.sqrt(shape[in_axis])
    t = torch.empty(tuple(shape), dtype=torch.float32,
                    device=gen.device if device is None else device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)


# ---------------------------------------------------------------------------
# Norms
def init_rmsnorm(d: int, dtype: torch.dtype = torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5,
            ranks=None) -> torch.Tensor:
    scale = tp.gather_leaf(params["scale"], tp.spec(ranks, "scale"), ranks)
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-halves form, angles in f32)
@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: str) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return (1.0 / (theta ** exps)).to(device)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` in f32, computed once on the host
    (f32 ``pow``, as the reference's ``jnp`` op by op) and copied to
    ``device``: the same bits on every device, whatever the device's own
    ``pow`` rounds.  At ``long_500k``'s positions (~2^19) one ulp of a
    frequency near 1 moves its angle by ~0.03 rad.  Cached per (head
    dim, theta, device): one host-to-device copy each."""
    return _rope_freqs_on(head_dim, float(theta),
                          str(torch.device(device or "cpu")))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)    # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
def init_embedding(gen: torch.Generator, cfg: ArchConfig):
    dt = dtype_of(cfg.param_dtype)
    p = {"tok": dense_init(gen, (cfg.padded_vocab, cfg.d_model), in_axis=1,
                           dtype=dt)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype=dt)
    return p


def embed(params, tokens: torch.Tensor, cfg: ArchConfig,
          ranks=None) -> torch.Tensor:
    x = tp.embed_rows(params["tok"], tp.spec(ranks, "tok"), tokens, ranks)
    if cfg.name.startswith("gemma"):          # gemma scales embeddings
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x.to(dtype_of(cfg.compute_dtype))


def lm_logits(params, x: torch.Tensor, cfg: ArchConfig,
              ranks=None) -> torch.Tensor:
    """``x`` times the LM head (the tied ``tok.t()`` or ``head``): the
    logits over the padded vocabulary; under ``ranks``, this rank's
    vocabulary block of them (the reference's out spec puts the
    vocabulary on ``"model"``)."""
    if cfg.tie_embeddings:
        w, spec = params["tok"].t(), tp.spec(ranks, "tok")
        spec = spec if spec is None else type(spec)(*reversed(spec))
    else:
        w, spec = params["head"], tp.spec(ranks, "head")
    return tp.linear_cols(x, w, spec, ranks)


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU / GeGLU / GELU); jax.nn.gelu is the tanh form
def init_ffn(gen: torch.Generator, cfg: ArchConfig):
    dt = dtype_of(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn_act in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, (d, f), dtype=dt),
                "w_up": dense_init(gen, (d, f), dtype=dt),
                "w_down": dense_init(gen, (f, d), dtype=dt)}
    return {"w_in": dense_init(gen, (d, f), dtype=dt),
            "w_out": dense_init(gen, (f, d), dtype=dt)}


def gate_act(g: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The gate of a SwiGLU (silu) or GeGLU (tanh gelu) FFN."""
    return F.silu(g) if cfg.ffn_act == "swiglu" else F.gelu(
        g, approximate="tanh")


def ffn(params, x: torch.Tensor, cfg: ArchConfig,
        ranks=None) -> torch.Tensor:
    """The FFN.  Under ``ranks``, where the plan splits ``w_gate``/``w_up``
    (or ``w_in``) on d_ff and ``w_down`` (or ``w_out``) on the same dim,
    the rank's d_ff block end to end and one sum; else each product whole
    (``tensor_parallel.linear``)."""
    gated = cfg.ffn_act in ("swiglu", "geglu")
    ups = ("w_gate", "w_up") if gated else ("w_in",)
    down = "w_down" if gated else "w_out"
    split = all(tp.model_dim(tp.spec(ranks, n), ranks) == 1 for n in ups) \
        and tp.model_dim(tp.spec(ranks, down), ranks) == 0
    r = None if split else ranks        # the split's products are local
    proj = lambda n: tp.linear(x, params[n], tp.spec(r, n), r)
    if gated:
        h = gate_act(proj("w_gate"), cfg) * proj("w_up")
    else:
        h = F.gelu(proj("w_in"), approximate="tanh")
    if split:
        return tp.linear_from_block(h, params[down], tp.spec(ranks, down),
                                    ranks)
    return tp.linear(h, params[down], tp.spec(ranks, down), ranks)


# ---------------------------------------------------------------------------
# LM losses
def chunked_ce_from_hidden(embed_params, x: torch.Tensor,
                           labels: torch.Tensor, cfg: ArchConfig,
                           chunk: int = 512) -> torch.Tensor:
    """Next-token CE with the LM head applied per sequence chunk, so the
    (B, S, V) logits never exist at once: each chunk's (B, chunk, V)
    logits are recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant), not kept.  The NLL and the count are summed over the
    chunks in order, in f32, as the reference's scan does.

    x: (B, S, d) final hidden states; labels: (B, S), -1 masked."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        S = S + pad

    def terms(xb, lb):
        return _ce_terms(lm_logits(embed_params, xb, cfg), lb,
                         cfg.vocab_size)

    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        n, c = checkpoint(terms, x[:, i:i + chunk], labels[:, i:i + chunk],
                          use_reentrant=False)
        nll, cnt = nll + n, cnt + c
    return nll / torch.clamp_min(cnt, 1.0)


def _vocab_mask(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """f32 logits with -1e9 added on the padded vocab tail."""
    logits = logits.float()
    pv = logits.shape[-1]
    if pv > vocab_size:
        neg = torch.cat([
            torch.zeros((vocab_size,), dtype=torch.float32,
                        device=logits.device),
            torch.full((pv - vocab_size,), -1e9, dtype=torch.float32,
                       device=logits.device)])
        logits = logits + neg
    return logits


def _nll(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int):
    """Per-position NLL (0 where label == -1) and the validity mask."""
    logits = _vocab_mask(logits, vocab_size)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    return (logz - ll) * valid, valid


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int):
    """(sum of the NLL, number of valid labels), both f32 scalars."""
    nll, valid = _nll(logits, labels, vocab_size)
    return torch.sum(nll), torch.sum(valid).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean next-token CE, masking the padded vocab tail and label == -1."""
    nll, valid = _nll(logits, labels, vocab_size)
    return torch.sum(nll) / torch.clamp_min(torch.sum(valid), 1)
