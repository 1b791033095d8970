"""The LM stack: the port of the JAX package's ``models/transformer.py``
for every block kind (ATTN/SWA, Mamba, Hymba's parallel attention +
Mamba, xLSTM's mLSTM and sLSTM) with a dense, MoE (``models/moe.py``) or
no FFN, the encoder stack and cross-attention of an encoder-decoder
(SeamlessM4T), and the projected frontend prefix of a VLM (LLaVA-NeXT);
serving and training.

Serving parameters live in an :class:`LMParams` (an ``nn.ModuleDict``)
with the reference's names: ``embed`` (``tok`` [, ``head``]), ``layers``
(an ``nn.ModuleList``, one entry per layer: ``ln1``, ``attn`` / ``mamba``
/ ``mlstm`` / ``slstm``, [``ln_cross``, ``cross``], ``ln2``, ``ffn`` or
``moe``), ``final_norm`` and, where the config has them, the bare tensor
``frontend_proj``, ``enc_unit`` (an ``nn.ModuleList`` of ATTN layers)
and ``enc_norm``.  The reference's layer ``scan`` over stacked weights
becomes a loop over the list; ``lm_params_from_numpy`` unstacks the
reference's ``unit`` and ``enc_unit`` trees into it.  These parameters
carry no gradient.

Training keeps the reference's tree (``unit`` a tuple of per-sublayer
dicts whose leaves stack the layer groups; :func:`lm_tree`), one row of
the federated state per client; :func:`lm_view` turns it into the
forward's parameters as views, so gradients land in the stacked leaves.
``forward(noise=(gen, sigma))`` adds the LDP input noise, ``cfg.remat``
checkpoints each unit of layers (and each sublayer of a unit of several)
with ``torch.utils.checkpoint``, and :func:`loss_fn` is CE + the MoE aux
loss.  Every kernel a training forward reaches has a backward: attention
(B4, f32 or bf16 at head dim 64) through ``FlashAttentionFn`` and the
Mamba scan (B6) through ``SsmScanFn``.

The knobs that place work on the ``"model"`` mesh axis,
``moe_group_shard`` (``models/moe.py``) and ``attn_seq_shards``
(``models/attention.py``), read the ambient mesh
(``distributed.context``): the identity under none or a 1-device
``"model"`` axis, ``NotImplementedError`` over a larger one.  A
``moe_impl`` other than ``"scatter"`` or ``"einsum"`` and an unknown
block kind raise a ``ValueError``.

Public API:
    init_lm(gen, cfg, device)                       -> params
    encode(params, enc_embeds, cfg)                 -> memory (enc-dec)
    forward(params, inputs, cfg, ...)               -> (hidden, aux)
    forward_logits(params, inputs, cfg, ...)        -> (logits, aux)
    loss_fn(params, inputs, cfg, window, noise)     -> scalar loss
    lm_tree(params, cfg) / lm_view(tree, cfg)       -> training tree / params
    serving_tree(params)                            -> params as plain dicts
    init_decode_state(cfg, batch, cache_len, dtype, window, device) -> state
    decode_step(params, state, tokens, step, cfg, window) -> (logits, state)
    lm_params_from_numpy(tree, cfg, device) / lm_params_to_numpy(params, cfg)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import (
    ATTN,
    FFN_DENSE,
    FFN_MOE,
    HYMBA,
    MAMBA,
    MLSTM,
    SLSTM,
    SWA,
    ArchConfig,
)
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    chunked_ce_from_hidden,
    dense_init,
    dtype_of,
    embed,
    ffn,
    init_embedding,
    init_ffn,
    init_rmsnorm,
    lm_logits,
    rmsnorm,
)
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import (host_array, resolve_device,
                              tensor_from_numpy, tree_map, tree_unstack)

PORTED_KINDS = (ATTN, SWA, MAMBA, HYMBA, MLSTM, SLSTM)
MOE_IMPLS = {"scatter": moe_lib.moe_ffn, "einsum": moe_lib.moe_ffn_einsum}


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def check_ported(cfg: ArchConfig) -> None:
    """Raise a ``ValueError`` for a block kind or ``moe_impl`` the port
    does not know.  Every other knob of ``cfg`` runs; the mesh knobs
    (``moe_group_shard``, ``attn_seq_shards``) are checked against the
    ambient mesh where they act."""
    for kind in sorted(set(cfg.pattern())):
        _check_kind(kind)
    if cfg.ffn_kind == FFN_MOE and cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl {cfg.moe_impl!r} ({cfg.name}): "
                         f"expected one of {sorted(MOE_IMPLS)}")


class LMParams(nn.ModuleDict):
    """The model's parameters: sub-trees as modules under the reference's
    keys, plus ``frontend_proj``, which the reference keeps as a bare
    array beside them, as a parameter of its own that ``params[key]`` and
    ``key in params`` reach like the rest."""

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or super().__contains__(key)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _module(tree: Dict[str, Any]) -> nn.Module:
    """A nested dict of tensors as ``nn.ModuleDict``s of frozen
    ``nn.ParameterDict``s, keeping the keys."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: _frozen(v) for k, v in tree.items()})
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
    _check_kind(kind)
    dev = gen.device
    p: Dict[str, Any] = {"ln1": init_rmsnorm(cfg.d_model, device=dev)}
    if kind in (ATTN, SWA, HYMBA):
        p["attn"] = attn_lib.init_attention(gen, cfg)
    if kind in (MAMBA, HYMBA):
        p["mamba"] = ssm_lib.init_mamba(gen, cfg, d_in=_mamba_d_in(kind, cfg))
    if kind == MLSTM:
        p["mlstm"] = ssm_lib.init_mlstm(gen, cfg)
    if kind == SLSTM:
        p["slstm"] = ssm_lib.init_slstm(gen, cfg)
    if cross:
        p["ln_cross"] = init_rmsnorm(cfg.d_model, device=dev)
        p["cross"] = attn_lib.init_attention(gen, cfg, cross=True)
    if cfg.ffn_kind == FFN_DENSE and cfg.d_ff:
        p["ln2"] = init_rmsnorm(cfg.d_model, device=dev)
        p["ffn"] = init_ffn(gen, cfg)
    elif cfg.ffn_kind == FFN_MOE:
        p["ln2"] = init_rmsnorm(cfg.d_model, device=dev)
        p["moe"] = moe_lib.init_moe(gen, cfg)
    return p


def _apply_cross_ffn(p, x: torch.Tensor, cfg: ArchConfig,
                     memory: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """What follows the mixer in a layer: cross-attention onto ``memory``
    (a decoder layer of an encoder-decoder), then the residual FFN.
    Returns (x, the MoE's aux loss or None)."""
    if memory is not None and "cross" in p:
        x = x + attn_lib.cross_attention(
            p["cross"], rmsnorm(p["ln_cross"], x, cfg.norm_eps), memory, cfg)
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
    _check_kind(kind)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == MAMBA:
        mix = ssm_lib.mamba_scan(p["mamba"], h, cfg)
    elif kind == MLSTM:
        mix = ssm_lib.mlstm_scan(p["mlstm"], h, cfg)
    elif kind == SLSTM:
        mix = ssm_lib.slstm_scan(p["slstm"], h, cfg)
    else:
        mix = attn_lib.self_attention(p["attn"], h, cfg, causal=causal,
                                      window=window)
        if kind == HYMBA:
            mix = 0.5 * (mix + ssm_lib.mamba_scan(p["mamba"], h, cfg))
    x, aux = _apply_cross_ffn(p, x + mix, cfg, memory)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def sublayer_state(kind: str, cfg: ArchConfig, batch: int, cache_len: int,
                   dtype: torch.dtype, device=None) -> Dict[str, Any]:
    """One layer's decode state: the K and V caches (B, L, Hkv, hd) of an
    attention or Hymba layer, the ``mamba`` state of a Mamba or Hymba
    layer (``h`` (B, d_in, N) f32, ``conv`` (B, CONV_WIDTH - 1, d_in) in
    ``dtype``), the ``mlstm`` state (``C``, ``n``, ``m``) or the
    ``slstm`` state (``h``, ``c``, ``n``, ``m``), all f32."""
    _check_kind(kind)
    s: Dict[str, Any] = {}
    if kind in (ATTN, SWA, HYMBA):
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        s["k"] = torch.zeros(shape, dtype=dtype, device=device)
        s["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if kind in (MAMBA, HYMBA):
        s["mamba"] = ssm_lib.mamba_state_init(
            cfg, batch, _mamba_d_in(kind, cfg), dtype, device=device)
    if kind == MLSTM:
        s["mlstm"] = ssm_lib.mlstm_state_init(cfg, batch, dtype,
                                              device=device)
    if kind == SLSTM:
        s["slstm"] = ssm_lib.slstm_state_init(cfg, batch, dtype,
                                              device=device)
    return s


def apply_sublayer_decode(p, kind: str, x: torch.Tensor, state, step: int,
                          cfg: ArchConfig, *, window: int = 0,
                          memory: Optional[torch.Tensor] = None):
    """One decode step of one layer; updates ``state`` in place and
    returns (x, state)."""
    _check_kind(kind)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == MAMBA:
        mix, _ = ssm_lib.mamba_decode(p["mamba"], h, state["mamba"], cfg)
    elif kind == MLSTM:
        mix, _ = ssm_lib.mlstm_decode(p["mlstm"], h, state["mlstm"], cfg)
    elif kind == SLSTM:
        mix, _ = ssm_lib.slstm_decode(p["slstm"], h, state["slstm"], cfg)
    else:
        mix, _ = attn_lib.decode_attention(p["attn"], h, state, step, cfg,
                                           window=window)
        if kind == HYMBA:
            m, _ = ssm_lib.mamba_decode(p["mamba"], h, state["mamba"], cfg)
            mix = 0.5 * (mix + m)
    x, _ = _apply_cross_ffn(p, x + mix, cfg, memory)
    return x, state


# ---------------------------------------------------------------------------
# Full model
def init_lm(gen: torch.Generator, cfg: ArchConfig, device=None) -> LMParams:
    """Random weights drawn from ``gen`` on its device, then moved to
    ``device`` (None: the GPU, raising when there is none)."""
    check_ported(cfg)
    dev = resolve_device(device)
    cross = cfg.n_enc_layers > 0
    emb = init_embedding(gen, cfg)
    layers = [init_sublayer(gen, kind, cfg, cross=cross)
              for kind in cfg.pattern()]
    final = init_rmsnorm(cfg.d_model, device=gen.device)
    extra: Dict[str, Any] = {}
    if cfg.frontend != "none":
        # the stub frontend's projector (patch / frame embeddings -> d)
        extra["frontend_proj"] = dense_init(
            gen, (cfg.d_model, cfg.d_model), dtype=dtype_of(cfg.param_dtype))
    if cfg.n_enc_layers:
        extra["enc_unit"] = [init_sublayer(gen, ATTN, cfg)
                             for _ in range(cfg.n_enc_layers)]
        extra["enc_norm"] = init_rmsnorm(cfg.d_model, device=gen.device)
    return _assemble(emb, layers, final, **extra).to(dev)


def _assemble(emb, layers, final, frontend_proj=None, enc_unit=None,
              enc_norm=None) -> LMParams:
    params = LMParams({
        "embed": _module(emb),
        "layers": nn.ModuleList([_module(p) for p in layers]),
        "final_norm": _module(final)})
    if frontend_proj is not None:
        params.register_parameter("frontend_proj", _frozen(frontend_proj))
    if enc_unit is not None:
        params["enc_unit"] = nn.ModuleList([_module(p) for p in enc_unit])
        params["enc_norm"] = _module(enc_norm)
    return params


def _remat_on(cfg: ArchConfig) -> bool:
    """``cfg.remat`` while autograd records (a serving call runs plain)."""
    return cfg.remat and torch.is_grad_enabled()


def _remat(fn, *args):
    """``fn(*args)`` under activation checkpointing (non-reentrant): its
    internals are recomputed in the backward, not kept.  No layer draws
    random numbers (the input noise is drawn before them), so the RNG
    state is not stashed."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def encode(params, enc_embeds: torch.Tensor, cfg: ArchConfig
           ) -> torch.Tensor:
    """The encoder stack of an encoder-decoder. enc_embeds: (B, F, d) ->
    memory (B, F, d) in the compute dtype: ``frontend_proj``, then the
    ``enc_unit`` ATTN layers without the causal mask (B4 in each; each
    layer checkpointed when ``cfg.remat``), then ``enc_norm``."""
    x = enc_embeds.to(dtype_of(cfg.compute_dtype))
    if "frontend_proj" in params:
        x = x @ params["frontend_proj"].to(x.dtype)

    def body(p, x):
        return apply_sublayer(p, ATTN, x, cfg, causal=False)[0]

    for p in params["enc_unit"]:
        x = _remat(body, p, x) if _remat_on(cfg) else body(p, x)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _perturb(x: torch.Tensor, gen: torch.Generator, sigma) -> torch.Tensor:
    """``x + sigma * N(0, 1)`` (the noise drawn in f32 from ``gen`` on x's
    device, then cast to x's dtype), as the reference adds it."""
    n = torch.randn(x.shape, generator=gen, dtype=torch.float32,
                    device=x.device)
    return x + (sigma * n).to(x.dtype)


def _run_unit(ps, kinds, x: torch.Tensor, aux: torch.Tensor,
              cfg: ArchConfig, window: int, memory):
    """One group of the repeating unit: each sublayer in turn, its aux
    loss summed in order; with ``cfg.remat`` and a unit of several
    sublayers, each sublayer checkpointed (the reference's nested remat:
    only one sublayer's internals live during the unit's backward)."""
    def apply_fn(p, kind, x):
        return apply_sublayer(p, kind, x, cfg, window=window, memory=memory)

    for p, kind in zip(ps, kinds):
        if _remat_on(cfg) and len(kinds) > 1:
            x, a = _remat(apply_fn, p, kind, x)
        else:
            x, a = apply_fn(p, kind, x)
        aux = aux + a
    return x, aux


def forward(params, inputs: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            window: int = 0, noise: Optional[Tuple] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training / prefill forward. Returns (final hidden states over the
    text positions, aux loss); the LM head is applied by the caller.

    inputs: tokens (B, S_text) [, frontend_embeds (B, F, d)] [,
    enc_embeds (B, F, d)].  A VLM's ``frontend_embeds`` are projected
    by ``frontend_proj`` and run as a prefix before the tokens, their F
    positions dropped from the output; an encoder-decoder's
    ``enc_embeds`` go through :func:`encode`, and every decoder layer
    attends to the result.

    ``noise=(gen, sigma)`` is the paper's LDP input perturbation in
    embedding space: ``sigma * N(0, 1)`` added to the token embeddings,
    to the VLM's ``frontend_embeds`` (before the projection) and to the
    encoder's ``enc_embeds``.  ``gen`` is a ``torch.Generator`` on the
    inputs' device (the round's, or one client row's of
    ``privacy.RowGenerators``); the three are separate draws from it, in
    that order.  (The reference draws them from ``key``,
    ``fold_in(key, 1)`` and ``fold_in(key, 2)``; no torch draw can
    repeat those bits.)

    With ``cfg.remat`` each group of the repeating unit is checkpointed
    (its aux loss carried through), as the reference's ``_scan_unit``
    does; it changes no value."""
    check_ported(cfg)
    unit, _ = factor_pattern(cfg.pattern())
    x = embed(params["embed"], inputs["tokens"], cfg)
    if noise is not None:
        gen, sigma = noise
        x = _perturb(x, gen, sigma)
    n_front = 0
    if (cfg.frontend != "none" and "frontend_embeds" in inputs
            and cfg.n_enc_layers == 0):
        fe = inputs["frontend_embeds"].to(x.dtype)
        if noise is not None:
            fe = _perturb(fe, gen, sigma)
        fe = fe @ params["frontend_proj"].to(x.dtype)
        x = torch.cat([fe, x], dim=1)                # image / audio prefix
        n_front = fe.shape[1]
    memory = None
    if cfg.n_enc_layers:
        enc_in = inputs["enc_embeds"]
        if noise is not None:
            enc_in = _perturb(enc_in, gen, sigma)
        memory = encode(params, enc_in, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = list(params["layers"])
    U = len(unit)
    for g0 in range(0, len(layers), U):
        args = (layers[g0:g0 + U], unit, x, aux, cfg, window, memory)
        x, aux = (_remat(_run_unit, *args) if _remat_on(cfg)
                  else _run_unit(*args))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x[:, n_front:], aux


def forward_logits(params, inputs, cfg: ArchConfig, *, window: int = 0,
                   noise: Optional[Tuple] = None):
    """forward() + full LM head (tests / small-scale use)."""
    x, aux = forward(params, inputs, cfg, window=window, noise=noise)
    return lm_logits(params["embed"], x, cfg), aux


def loss_fn(params, inputs: Dict[str, torch.Tensor], cfg: ArchConfig,
            window: int = 0, noise: Optional[Tuple] = None) -> torch.Tensor:
    """Training loss: the chunked next-token CE of ``inputs["labels"]``
    plus the aux loss (an MoE's load balance)."""
    x, aux = forward(params, inputs, cfg, window=window, noise=noise)
    ce = chunked_ce_from_hidden(params["embed"], x, inputs["labels"], cfg)
    return ce + aux


# ---------------------------------------------------------------------------
# The training tree (the reference's ``init_lm`` layout) and its views
def lm_tree(params, cfg: ArchConfig) -> Dict[str, Any]:
    """The reference's ``init_lm`` tree of ``params`` (an
    :class:`LMParams`) as tensors carrying no gradient: ``unit[j]`` stacks
    unit entry ``j`` of every layer group on a leading axis (layer ``g *
    len(unit) + j`` is its slice ``g``), ``enc_unit`` the encoder's
    layers; the other leaves share the parameters' storage."""
    unit, n_groups = factor_pattern(cfg.pattern())
    U = len(unit)
    plain = lambda mod: tree_map(torch.Tensor.detach, _as_dict(mod))
    stack = lambda mods: tree_map(lambda *ts: torch.stack(ts),
                                  *[_as_dict(m) for m in mods])
    layers = list(params["layers"])
    out: Dict[str, Any] = {
        "embed": plain(params["embed"]),
        "unit": tuple(stack([layers[g * U + j] for g in range(n_groups)])
                      for j in range(U)),
        "final_norm": plain(params["final_norm"])}
    if "frontend_proj" in params:
        out["frontend_proj"] = params["frontend_proj"].detach()
    if "enc_unit" in params:
        out["enc_unit"] = stack(list(params["enc_unit"]))
        out["enc_norm"] = plain(params["enc_norm"])
    return out


def lm_view(tree: Dict[str, Any], cfg: ArchConfig) -> Dict[str, Any]:
    """One client's training tree (:func:`lm_tree`'s layout, e.g. one row
    of the federated state's ``W``) as the forward's parameters: layer
    ``g * len(unit) + j`` is slice ``g`` of ``unit[j]``, the encoder's
    layers the slices of ``enc_unit``, all views (``torch.unbind``), so
    the gradient of a loss on them lands in the stacked leaves."""
    unit, n_groups = factor_pattern(cfg.pattern())
    per_entry = [tree_unstack(t) for t in tree["unit"]]
    params: Dict[str, Any] = {
        "embed": tree["embed"],
        "layers": [per_entry[j][g] for g in range(n_groups)
                   for j in range(len(unit))],
        "final_norm": tree["final_norm"]}
    if "frontend_proj" in tree:
        params["frontend_proj"] = tree["frontend_proj"]
    if "enc_unit" in tree:
        params["enc_unit"] = tree_unstack(tree["enc_unit"])
        params["enc_norm"] = tree["enc_norm"]
    return params


def serving_tree(params) -> Dict[str, Any]:
    """Serving parameters (an :class:`LMParams`) as plain nested dicts
    and lists of tensors sharing their storage, in :func:`lm_view`'s
    layout (``layers``, ``enc_unit`` one tree per layer): the tree that
    ``launch.steps``' serving specs describe and that
    ``distributed.sharding.place_tree`` places.  The steps run on it as
    on ``params``."""
    plain = lambda mod: tree_map(torch.Tensor.detach, _as_dict(mod))
    out: Dict[str, Any] = {
        "embed": plain(params["embed"]),
        "layers": [plain(p) for p in params["layers"]],
        "final_norm": plain(params["final_norm"])}
    if "frontend_proj" in params:
        out["frontend_proj"] = params["frontend_proj"].detach()
    if "enc_unit" in params:
        out["enc_unit"] = [plain(p) for p in params["enc_unit"]]
        out["enc_norm"] = plain(params["enc_norm"])
    return out


# ---------------------------------------------------------------------------
# Decode
def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      dtype: torch.dtype, window: int = 0,
                      device=None) -> Dict[str, Any]:
    """Per-layer decode state (a list, one dict per layer).  With a
    window the cache holds ``min(cache_len, window)`` slots (a ring).
    An encoder-decoder's state also holds ``memory`` (B, F, d) in
    ``dtype``, zeros until the caller sets it (``encode``'s output)."""
    check_ported(cfg)
    L = min(cache_len, window) if window else cache_len
    dev = resolve_device(device)
    state: Dict[str, Any] = {
        "layers": [sublayer_state(kind, cfg, batch, L, dtype, dev)
                   for kind in cfg.pattern()]}
    if cfg.n_enc_layers:
        state["memory"] = torch.zeros(
            (batch, cfg.frontend_tokens, cfg.d_model), dtype=dtype,
            device=dev)
    return state


def decode_step(params, state, tokens: torch.Tensor, step: int,
                cfg: ArchConfig, *, window: int = 0):
    """One decode step. tokens: (B, 1) integer; step: tokens already in the
    cache.  Returns (logits (B, 1, vocab_pad), state), the caches and
    recurrent states updated in place; every decoder layer of an
    encoder-decoder attends to ``state["memory"]``."""
    x = embed(params["embed"], tokens, cfg)
    memory = state.get("memory")
    for p, s, kind in zip(params["layers"], state["layers"], cfg.pattern()):
        x, _ = apply_sublayer_decode(p, kind, x, s, step, cfg, window=window,
                                     memory=memory)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg), state


# ---------------------------------------------------------------------------
# Weight carry-over from / to the reference's ``init_lm`` pytree
def _unstack(tree, n: int, device) -> List[Dict[str, Any]]:
    """Slices 0..n-1 of a tree whose leaves share a leading axis."""
    return [tree_map(lambda a, i=i: tensor_from_numpy(np.asarray(a)[i],
                                                      device), tree)
            for i in range(n)]


def lm_params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                         device=None) -> LMParams:
    """The reference's ``init_lm`` tree (arrays as numpy) as the port's
    parameters: ``tree["unit"][j]`` holds unit entry ``j`` of every layer
    group on a leading ``n_groups`` axis; layer ``g * len(unit) + j`` is
    its slice ``g``.  ``enc_unit`` holds the encoder's layers on a
    leading ``n_enc_layers`` axis; ``frontend_proj`` and ``enc_norm``
    carry over as they are."""
    check_ported(cfg)
    dev = resolve_device(device)
    unit, n_groups = factor_pattern(cfg.pattern())
    per_entry = [_unstack(t, n_groups, dev) for t in tree["unit"]]
    layers = [per_entry[j][g] for g in range(n_groups)
              for j in range(len(unit))]
    as_tensors = lambda t: tree_map(lambda a: tensor_from_numpy(a, dev), t)
    extra: Dict[str, Any] = {}
    if "frontend_proj" in tree:
        extra["frontend_proj"] = tensor_from_numpy(tree["frontend_proj"], dev)
    if "enc_unit" in tree:
        extra["enc_unit"] = _unstack(tree["enc_unit"], cfg.n_enc_layers, dev)
        extra["enc_norm"] = as_tensors(tree["enc_norm"])
    return _assemble(as_tensors(tree["embed"]), layers,
                     as_tensors(tree["final_norm"]), **extra)


def lm_params_to_numpy(params, cfg: ArchConfig) -> Dict[str, Any]:
    """The inverse of :func:`lm_params_from_numpy`: :func:`lm_tree` as
    numpy arrays (bf16 weights come back as f32)."""
    return tree_map(host_array, lm_tree(params, cfg))


def _as_dict(mod: nn.Module) -> Dict[str, Any]:
    """Nested ``ModuleDict``/``ParameterDict`` as plain nested dicts."""
    return {k: _as_dict(v) if isinstance(v, nn.Module) else v
            for k, v in mod.items()}
