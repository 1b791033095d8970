"""The LM stack for serving: the port of the JAX package's
``models/transformer.py`` for ATTN/SWA blocks, Mamba blocks and Hymba's
parallel attention + Mamba blocks, with a dense, MoE (``models/moe.py``)
or no FFN.

Parameters live in an ``nn.ModuleDict`` with the reference's names:
``embed`` (``tok`` [, ``head``]), ``layers`` (an ``nn.ModuleList``, one
entry per layer: ``ln1``, ``attn`` and/or ``mamba``, ``ln2``, ``ffn`` or
``moe``) and ``final_norm``.
The reference's layer ``scan`` over stacked weights becomes a loop over
the list; ``lm_params_from_numpy`` unstacks the reference's ``unit``
tree into it.  The parameters carry no gradient: the LM side of the port
serves; LM training (``remat``, the LDP ``noise=``) comes later.

The xLSTM block kinds (mLSTM, sLSTM), a multimodal frontend, an encoder
and ``moe_group_shard`` raise a ``ValueError`` naming them "not yet
ported"; a ``moe_impl`` other than ``"scatter"`` or ``"einsum"`` raises
a ``ValueError`` too.

Public API:
    init_lm(gen, cfg, device)                       -> params
    forward(params, inputs, cfg, ...)               -> (hidden, aux)
    forward_logits(params, inputs, cfg, ...)        -> (logits, aux)
    init_decode_state(cfg, batch, cache_len, dtype, window, device) -> state
    decode_step(params, state, tokens, step, cfg, window) -> (logits, state)
    lm_params_from_numpy(tree, cfg, device) / lm_params_to_numpy(params, cfg)
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import (
    ATTN,
    FFN_DENSE,
    FFN_MOE,
    HYMBA,
    MAMBA,
    SWA,
    ArchConfig,
)
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    embed,
    ffn,
    init_embedding,
    init_ffn,
    init_rmsnorm,
    lm_logits,
    rmsnorm,
)
from repro_torch.tree import resolve_device, tree_map

PORTED_KINDS = (ATTN, SWA, MAMBA, HYMBA)
MOE_IMPLS = {"scatter": moe_lib.moe_ffn, "einsum": moe_lib.moe_ffn_einsum}


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not yet ported to repro_torch")


def _check_kind(kind: str, cross: bool = False) -> None:
    if kind not in PORTED_KINDS:
        raise _not_ported(f"block kind {kind!r}")
    if cross:
        raise _not_ported("cross-attention")


def check_ported(cfg: ArchConfig) -> None:
    """Raise for any part of ``cfg`` the port cannot run yet."""
    for kind in sorted(set(cfg.pattern())):
        if kind not in PORTED_KINDS:
            raise _not_ported(f"block kind {kind!r} ({cfg.name})")
    if cfg.ffn_kind == FFN_MOE:
        if cfg.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {cfg.moe_impl!r} ({cfg.name}): "
                             f"expected one of {sorted(MOE_IMPLS)}")
        if cfg.moe_group_shard:
            raise _not_ported(f"moe_group_shard ({cfg.name})")
    if cfg.frontend != "none":
        raise _not_ported(f"the {cfg.frontend} frontend ({cfg.name})")
    if cfg.n_enc_layers:
        raise _not_ported(f"the encoder stack ({cfg.name})")


def _module(tree: Dict[str, Any]) -> nn.Module:
    """A nested dict of tensors as ``nn.ModuleDict``s of frozen
    ``nn.ParameterDict``s, keeping the keys."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _module(v) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# Pattern factorization: smallest repeating unit
def factor_pattern(pattern: Tuple[str, ...]) -> Tuple[Tuple[str, ...], int]:
    n = len(pattern)
    for ul in range(1, n + 1):
        if n % ul == 0 and pattern == pattern[:ul] * (n // ul):
            return pattern[:ul], n // ul
    return pattern, 1


# ---------------------------------------------------------------------------
# Single sub-layer
def _mamba_d_in(kind: str, cfg: ArchConfig) -> int:
    """Inner width of the Mamba mixer: 2 d for a MAMBA block, d for the
    Mamba heads of a HYMBA block."""
    return 2 * cfg.d_model if kind == MAMBA else cfg.d_model


def init_sublayer(gen: torch.Generator, kind: str, cfg: ArchConfig,
                  cross: bool = False) -> Dict[str, Any]:
    _check_kind(kind, cross)
    p: Dict[str, Any] = {"ln1": init_rmsnorm(cfg.d_model, device=gen.device)}
    if kind in (ATTN, SWA, HYMBA):
        p["attn"] = attn_lib.init_attention(gen, cfg)
    if kind in (MAMBA, HYMBA):
        p["mamba"] = ssm_lib.init_mamba(gen, cfg, d_in=_mamba_d_in(kind, cfg))
    if cfg.ffn_kind == FFN_DENSE and cfg.d_ff:
        p["ln2"] = init_rmsnorm(cfg.d_model, device=gen.device)
        p["ffn"] = init_ffn(gen, cfg)
    elif cfg.ffn_kind == FFN_MOE:
        p["ln2"] = init_rmsnorm(cfg.d_model, device=gen.device)
        p["moe"] = moe_lib.init_moe(gen, cfg)
    return p


def _apply_ffn(p, x: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The residual FFN of a layer: (x, the MoE's aux loss or None)."""
    aux = None
    if "ffn" in p:
        x = x + ffn(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    elif "moe" in p:
        y, aux = MOE_IMPLS[cfg.moe_impl](
            p["moe"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
        x = x + y
    return x, aux


def apply_sublayer(p, kind: str, x: torch.Tensor, cfg: ArchConfig, *,
                   window: int = 0, memory: Optional[torch.Tensor] = None,
                   causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence (prefill) form. Returns (x, aux_loss)."""
    _check_kind(kind, memory is not None)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == MAMBA:
        mix = ssm_lib.mamba_scan(p["mamba"], h, cfg)
    else:
        mix = attn_lib.self_attention(p["attn"], h, cfg, causal=causal,
                                      window=window)
        if kind == HYMBA:
            mix = 0.5 * (mix + ssm_lib.mamba_scan(p["mamba"], h, cfg))
    x, aux = _apply_ffn(p, x + mix, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def sublayer_state(kind: str, cfg: ArchConfig, batch: int, cache_len: int,
                   dtype: torch.dtype, device=None) -> Dict[str, Any]:
    """One layer's decode state: the K and V caches (B, L, Hkv, hd) of an
    attention or Hymba layer, and the ``mamba`` state of a Mamba or Hymba
    layer (``h`` (B, d_in, N) f32, ``conv`` (B, CONV_WIDTH - 1, d_in) in
    ``dtype``)."""
    _check_kind(kind)
    s: Dict[str, Any] = {}
    if kind in (ATTN, SWA, HYMBA):
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        s["k"] = torch.zeros(shape, dtype=dtype, device=device)
        s["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if kind in (MAMBA, HYMBA):
        s["mamba"] = ssm_lib.mamba_state_init(
            cfg, batch, _mamba_d_in(kind, cfg), dtype, device=device)
    return s


def apply_sublayer_decode(p, kind: str, x: torch.Tensor, state, step: int,
                          cfg: ArchConfig, *, window: int = 0,
                          memory: Optional[torch.Tensor] = None):
    """One decode step of one layer; updates ``state`` in place and
    returns (x, state)."""
    _check_kind(kind, memory is not None)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == MAMBA:
        mix, _ = ssm_lib.mamba_decode(p["mamba"], h, state["mamba"], cfg)
    else:
        mix, _ = attn_lib.decode_attention(p["attn"], h, state, step, cfg,
                                           window=window)
        if kind == HYMBA:
            m, _ = ssm_lib.mamba_decode(p["mamba"], h, state["mamba"], cfg)
            mix = 0.5 * (mix + m)
    x, _ = _apply_ffn(p, x + mix, cfg)
    return x, state


# ---------------------------------------------------------------------------
# Full model
def init_lm(gen: torch.Generator, cfg: ArchConfig, device=None) -> nn.Module:
    """Random weights drawn from ``gen`` on its device, then moved to
    ``device`` (None: the GPU, raising when there is none)."""
    check_ported(cfg)
    dev = resolve_device(device)
    emb = init_embedding(gen, cfg)
    layers = [init_sublayer(gen, kind, cfg) for kind in cfg.pattern()]
    final = init_rmsnorm(cfg.d_model, device=gen.device)
    return _assemble(emb, layers, final).to(dev)


def _assemble(emb, layers, final) -> nn.Module:
    return nn.ModuleDict({
        "embed": _module(emb),
        "layers": nn.ModuleList([_module(p) for p in layers]),
        "final_norm": _module(final)})


def forward(params, inputs: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            window: int = 0, noise: Optional[Tuple] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward. Returns (final hidden states, aux loss); the LM
    head is applied by the caller.  inputs: tokens (B, S)."""
    check_ported(cfg)
    if noise is not None:
        raise _not_ported("the LDP input noise (noise=)")
    x = embed(params["embed"], inputs["tokens"], cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(params["layers"], cfg.pattern()):
        x, a = apply_sublayer(p, kind, x, cfg, window=window)
        aux = aux + a                 # summed in layer order
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward_logits(params, inputs, cfg: ArchConfig, *, window: int = 0,
                   noise: Optional[Tuple] = None):
    """forward() + full LM head (tests / small-scale use)."""
    x, aux = forward(params, inputs, cfg, window=window, noise=noise)
    return lm_logits(params["embed"], x, cfg), aux


# ---------------------------------------------------------------------------
# Decode
def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      dtype: torch.dtype, window: int = 0,
                      device=None) -> Dict[str, Any]:
    """Per-layer decode state (a list, one dict per layer).  With a
    window the cache holds ``min(cache_len, window)`` slots (a ring)."""
    check_ported(cfg)
    L = min(cache_len, window) if window else cache_len
    dev = resolve_device(device)
    return {"layers": [sublayer_state(kind, cfg, batch, L, dtype, dev)
                       for kind in cfg.pattern()]}


def decode_step(params, state, tokens: torch.Tensor, step: int,
                cfg: ArchConfig, *, window: int = 0):
    """One decode step. tokens: (B, 1) integer; step: tokens already in the
    cache.  Returns (logits (B, 1, vocab_pad), state), the caches updated
    in place."""
    x = embed(params["embed"], tokens, cfg)
    for p, s, kind in zip(params["layers"], state["layers"], cfg.pattern()):
        x, _ = apply_sublayer_decode(p, kind, x, s, step, cfg, window=window)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg), state


# ---------------------------------------------------------------------------
# Weight carry-over from / to the reference's ``init_lm`` pytree
def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes: no torch.from_numpy
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                         device=None) -> nn.Module:
    """The reference's ``init_lm`` tree (arrays as numpy) as the port's
    parameters: ``tree["unit"][j]`` holds unit entry ``j`` of every layer
    group on a leading ``n_groups`` axis; layer ``g * len(unit) + j`` is
    its slice ``g``."""
    check_ported(cfg)
    dev = resolve_device(device)
    unit, n_groups = factor_pattern(cfg.pattern())
    layers = [tree_map(lambda a, g=g: _tensor(np.asarray(a)[g], dev),
                       tree["unit"][j])
              for g in range(n_groups) for j in range(len(unit))]
    return _assemble(tree_map(lambda a: _tensor(a, dev), tree["embed"]),
                     layers,
                     tree_map(lambda a: _tensor(a, dev), tree["final_norm"]))


def lm_params_to_numpy(params, cfg: ArchConfig) -> Dict[str, Any]:
    """The inverse of :func:`lm_params_from_numpy`: the reference's tree
    layout as numpy arrays (bf16 weights come back as f32)."""
    unit, n_groups = factor_pattern(cfg.pattern())
    per_layer = [tree_map(_numpy, _as_dict(p)) for p in params["layers"]]
    stacked = tuple(
        tree_map(lambda *xs: np.stack(xs),
                 *[per_layer[g * len(unit) + j] for g in range(n_groups)])
        for j in range(len(unit)))
    return {"embed": tree_map(_numpy, _as_dict(params["embed"])),
            "unit": stacked,
            "final_norm": tree_map(_numpy, _as_dict(params["final_norm"]))}


def _as_dict(mod: nn.Module) -> Dict[str, Any]:
    """Nested ``ModuleDict``/``ParameterDict`` as plain nested dicts."""
    return {k: _as_dict(v) if isinstance(v, nn.Module) else v
            for k, v in mod.items()}
