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

``cfg.attn_seq_shards`` > 1 is the reference's sequence-parallel prefill
attention: its query chunks split over the ``"model"`` mesh axis.  B4
already runs the whole query axis in one call, which gives the values
the reference's chunks give on a 1-device ``"model"`` axis; so under no
ambient mesh (``distributed.context``) or such an axis it is the
identity, and over a larger axis it raises ``NotImplementedError``
(multi-device execution is not yet ported).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import check_model_axis
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
                 use_rope: bool = True):
    hd = cfg.resolved_head_dim
    q = xq @ params["wq"].to(xq.dtype)
    k = xkv @ params["wk"].to(xkv.dtype)
    v = xkv @ params["wv"].to(xkv.dtype)
    q = q.reshape(q.shape[:-1] + (cfg.n_heads, hd))
    k = k.reshape(k.shape[:-1] + (cfg.n_kv_heads, hd))
    v = v.reshape(v.shape[:-1] + (cfg.n_kv_heads, hd))
    if use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    return q, k, v


def self_attention(params, x: torch.Tensor, cfg: ArchConfig, *,
                   causal: bool = True, window: int = 0,
                   positions=None) -> torch.Tensor:
    """Prefill self-attention over any length S. x: (B, S, d).  A
    non-causal call attends everywhere, as the reference's unchunked
    path does.  ``cfg.attn_seq_shards``: see the module's docstring."""
    if cfg.attn_seq_shards > 1:
        check_model_axis("attn_seq_shards")
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, x, cfg, positions, positions)
    out = ops.flash_attention(q, k, v, causal=causal,
                              window=window if causal else 0)
    out = out.reshape(B, S, -1)
    return out @ params["wo"].to(out.dtype)


def init_kv_cache(cfg: ArchConfig, batch: int, cache_len: int,
                  n_layers: int, dtype: torch.dtype,
                  device=None) -> Dict[str, torch.Tensor]:
    """Zeroed K and V caches, (n_layers, batch, cache_len, Hkv, hd) each."""
    shape = (n_layers, batch, cache_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params, x: torch.Tensor, layer_cache, step: int,
                     cfg: ArchConfig, *, window: int = 0):
    """One-token decode. x: (B, 1, d); layer_cache: {'k','v'}: (B, L, kv,
    hd) where L = cache_len (full) or window (ring buffer); ``step`` =
    number of tokens already in the cache (absolute position of the new
    token).  Writes the new K/V into ``layer_cache`` in place (one slot,
    not a copy of the cache) and returns (out (B, 1, d), layer_cache).

    The full cache writes at ``min(step, L - 1)``: past its end the last
    slot is overwritten.  The ring buffer writes at ``step % L``.  Every
    row attends to the first ``min(step + 1, L)`` slots."""
    B = x.shape[0]
    L = layer_cache["k"].shape[1]
    step = int(step)
    pos = torch.full((B, 1), step, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, x, cfg, pos, pos)
    slot = step % L if window else min(step, L - 1)
    layer_cache["k"][:, slot] = k_new[:, 0]
    layer_cache["v"][:, slot] = v_new[:, 0]
    length = torch.full((B,), min(step + 1, L), dtype=torch.int32,
                        device=x.device)
    out = ops.decode_attention(q[:, 0], layer_cache["k"], layer_cache["v"],
                               length)
    out = out.reshape(B, 1, -1)
    return out @ params["wo"].to(out.dtype), layer_cache


def cross_attention(params, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """Decoder->encoder attention. x: (B, Sq, d); memory: (B, Sk, d).
    K and V are projected from ``memory`` at every call, as in the
    reference.  Sq > 1 runs B4 (``causal=False``, Sq and Sk as they
    come); Sq = 1 runs B5 with ``length`` = Sk for every row."""
    B, Sq, _ = x.shape
    Sk = memory.shape[1]
    q, k, v = _project_qkv(params, x, memory, cfg, None, None,
                           use_rope=False)
    if Sq == 1:
        length = torch.full((B,), Sk, dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q[:, 0], k, v, length)
    else:
        out = ops.flash_attention(q, k, v, causal=False)
    out = out.reshape(B, Sq, -1)
    return out @ params["wo"].to(out.dtype)
