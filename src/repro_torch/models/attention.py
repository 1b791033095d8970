"""GQA self-attention for prefill and for decode with a KV cache (full or
ring-buffer window), and encoder-decoder cross-attention: the port of the
JAX package's ``models/attention.py``.

The core contraction goes through ``kernels/ops``: B4
(``ops.flash_attention``) over the whole sequence at prefill, B5
(``ops.decode_attention``) over the cache at decode.  On a CUDA tensor
those launch the hand-written kernels; on a CPU tensor they run the plain
versions.  The projections stay matrix products, as the reference leaves
them to XLA.  Cross-attention takes no RoPE and no mask: B4 without
the causal mask over the encoder's memory when the decoder sends more
than one position (a prefill), B5 over every memory position of every
row for one position (a decode step).

``ranks=`` (a ``data_parallel.RankBlock`` with the plan's specs of
``params``, over a ``"model"`` axis of several ranks) runs a layer
tensor-parallel (``distributed/tensor_parallel.py``), one program per
rank, reading each weight's spec:

* prefill, **local heads**: where the rank's column blocks of ``wq``,
  ``wk`` and ``wv`` are whole heads and its query heads use only its own
  KV heads (``n_kv_heads % M == 0``) and ``wo`` is split on its rows, B4
  runs on the rank's heads and its output is ``wo``'s row block: one sum;
* prefill, **gathered heads**: otherwise q, k and v are gathered whole and
  B4 runs over every head on every rank (GSPMD replicates attention where
  heads do not divide), then ``wo`` as its spec says;
* ``cfg.attn_seq_shards`` (the reference's sequence-parallel prefill, its
  trigger and split: ``tensor_parallel.seq_blocks``): rank p runs B4 for
  the queries ``[p S/M, (p+1) S/M)`` of every head against the keys up to
  their end (B4 aligns queries to the end of the keys, which gives the
  causal offset and the window), and the blocks are gathered along S;
* decode: q, k and v are gathered whole; the cache, placed ``P("data",
  "model", None, None)``, holds the rank's block of positions; the new
  slot is written by the rank that owns it; B5's partial runs over the
  block (``ops.decode_attention_partial``, the rank's valid length
  ``clamp(min(step + 1, L) - r L/M, 0, L/M)``); the ranks' (out, lse)
  are gathered and merged in rank order (``ops.merge_decode_partials``),
  so every rank has the same bits; then ``wo``.  A cache the plan splits
  over ``"model"`` on another dim (``long_500k`` at B = 1 on the
  production meshes: head_dim) raises ``NotImplementedError`` naming
  7(b) step 3d;
* cross-attention onto an encoder's memory (whole on every rank): on
  the rank's heads where :func:`local_heads`, else on every head after
  a gather; B4 without the mask for Sq > 1, B5 whole over the memory
  for Sq = 1 (never its partial: the memory is not split by positions).

Without ``ranks`` (world 1) the same functions run the whole layer: each
product is ``x @ w``, nothing is exchanged, B5 runs whole over the cache,
and ``cfg.attn_seq_shards`` is the identity: B4 already runs the whole
query axis in one call, which gives the values the reference's chunks
give.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, dtype_of


def init_attention(gen: torch.Generator, cfg: ArchConfig,
                   cross: bool = False):
    dt = dtype_of(cfg.param_dtype)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype=dt),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dt),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dt),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype=dt),
    }


def _project_qkv(params, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ArchConfig, q_pos: torch.Tensor, k_pos: torch.Tensor,
                 use_rope: bool = True, ranks=None):
    """q, k, v with RoPE (``use_rope``): every head, or under ``ranks``
    (whose products are column-parallel) every head gathered; the
    caller passes None for a rank's own heads (its local products)."""
    hd = cfg.resolved_head_dim
    proj = lambda n, x: tp.linear(x, params[n], tp.spec(ranks, n), ranks)
    q, k, v = proj("wq", xq), proj("wk", xkv), proj("wv", xkv)
    q = q.reshape(q.shape[:-1] + (-1, hd))
    k = k.reshape(k.shape[:-1] + (-1, hd))
    v = v.reshape(v.shape[:-1] + (-1, hd))
    if use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    return q, k, v


def local_heads(cfg: ArchConfig, ranks) -> bool:
    """Whether the plan gives this rank whole heads: ``wq``, ``wk`` and
    ``wv`` split on their output dim, ``wo`` on its input dim, and the KV
    heads split evenly (so each rank's query heads use its KV heads).
    Never at world 1."""
    cols = all(tp.model_dim(tp.spec(ranks, w), ranks) == 1
               for w in ("wq", "wk", "wv"))
    return (cols and tp.model_dim(tp.spec(ranks, "wo"), ranks) == 0
            and cfg.n_kv_heads % ranks.model.size == 0)


def self_attention(params, x: torch.Tensor, cfg: ArchConfig, *,
                   causal: bool = True, window: int = 0,
                   positions=None, ranks=None) -> torch.Tensor:
    """Prefill self-attention over any length S. x: (B, S, d).  A
    non-causal call attends everywhere, as the reference's unchunked
    path does.  ``ranks``, ``cfg.attn_seq_shards``: see the module's
    docstring."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    window = window if causal else 0
    blocks = tp.seq_blocks(cfg, S, ranks)
    local = not blocks and local_heads(cfg, ranks)
    q, k, v = _project_qkv(params, x, x, cfg, positions, positions,
                           ranks=None if local else ranks)
    if blocks:
        n, p = S // blocks, ranks.model.rank
        keys = slice(0, (p + 1) * n) if causal else slice(None)
        out = ops.flash_attention(q[:, p * n:(p + 1) * n].contiguous(),
                                  k[:, keys].contiguous(),
                                  v[:, keys].contiguous(), causal=causal,
                                  window=window)
        out = tp.gather(out.reshape(B, n, -1), ranks, 1)
    else:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        out = out.reshape(B, S, -1)
    if local:
        return tp.linear_from_block(out, params["wo"], tp.spec(ranks, "wo"),
                                    ranks)
    return tp.linear(out, params["wo"], tp.spec(ranks, "wo"), ranks)


def init_kv_cache(cfg: ArchConfig, batch: int, cache_len: int,
                  n_layers: int, dtype: torch.dtype,
                  device=None) -> Dict[str, torch.Tensor]:
    """Zeroed K and V caches, (n_layers, batch, cache_len, Hkv, hd) each."""
    shape = (n_layers, batch, cache_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params, x: torch.Tensor, layer_cache, step: int,
                     cfg: ArchConfig, *, window: int = 0, ranks=None):
    """One-token decode. x: (B, 1, d); layer_cache: {'k','v'}: (B, L, kv,
    hd) where L = cache_len (full) or window (ring buffer); ``step`` =
    number of tokens already in the cache (absolute position of the new
    token).  Writes the new K/V into ``layer_cache`` in place (one slot,
    not a copy of the cache) and returns (out (B, 1, d), layer_cache).

    The full cache writes at ``min(step, L - 1)``: past its end the last
    slot is overwritten.  The ring buffer writes at ``step % L``.  Every
    row attends to the first ``min(step + 1, L)`` slots.  ``ranks``: see
    the module's docstring (``ranks.state_specs`` holds the cache's
    specs)."""
    B = x.shape[0]
    step = int(step)
    pos = torch.full((B, 1), step, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, x, cfg, pos, pos, ranks=ranks)
    q = q[:, 0]
    dim = tp.model_dim(tp.state_spec(ranks, "k"), ranks)
    if dim not in (None, 1):
        raise NotImplementedError(
            f"a decode cache {tuple(layer_cache['k'].shape)} split over "
            f"'model' on dim {dim}, not its positions: {tp.STEP3D}")
    Lr = layer_cache["k"].shape[1]
    M, r = (ranks.model.size, ranks.model.rank) if dim == 1 else (1, 0)
    L = Lr * M
    slot = step % L if window else min(step, L - 1)
    owner, local = divmod(slot, Lr)
    if owner == r:
        layer_cache["k"][:, local] = k_new[:, 0]
        layer_cache["v"][:, local] = v_new[:, 0]
    n = min(max(min(step + 1, L) - r * Lr, 0), Lr)
    length = torch.full((B,), n, dtype=torch.int32, device=x.device)
    if dim is None:
        out = ops.decode_attention(q, layer_cache["k"], layer_cache["v"],
                                   length)
    else:
        o, lse = ops.decode_attention_partial(q, layer_cache["k"],
                                              layer_cache["v"], length)
        parts = tp.gather(torch.cat([o, lse[..., None]], dim=-1)[None],
                          ranks, 0)
        hd = q.shape[-1]
        out = ops.merge_decode_partials(parts[..., :hd], parts[..., hd],
                                        q.dtype)
    out = out.reshape(B, 1, -1)
    return tp.linear(out, params["wo"], tp.spec(ranks, "wo"), ranks), \
        layer_cache


def cross_attention(params, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ArchConfig, ranks=None) -> torch.Tensor:
    """Decoder->encoder attention. x: (B, Sq, d); memory: (B, Sk, d).
    K and V are projected from ``memory`` at every call, as in the
    reference.  Sq > 1 runs B4 (``causal=False``, Sq and Sk as they
    come); Sq = 1 runs B5 with ``length`` = Sk for every row.
    ``ranks``: on the rank's heads where :func:`local_heads` (q from x,
    k and v from the whole memory, the local column products; B4 or B5
    whole on them, then ``wo``'s row block: one sum), else on every head
    after a gather; the memory is never split by positions."""
    B, Sq, _ = x.shape
    Sk = memory.shape[1]
    local = local_heads(cfg, ranks)
    q, k, v = _project_qkv(params, x, memory, cfg, None, None,
                           use_rope=False, ranks=None if local else ranks)
    if Sq == 1:
        length = torch.full((B,), Sk, dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q[:, 0], k, v, length)
    else:
        out = ops.flash_attention(q, k, v, causal=False)
    out = out.reshape(B, Sq, -1)
    if local:
        return tp.linear_from_block(out, params["wo"], tp.spec(ranks, "wo"),
                                    ranks)
    return tp.linear(out, params["wo"], tp.spec(ranks, "wo"), ranks)
