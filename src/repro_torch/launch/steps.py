"""Step builders (the port of the JAX package's ``launch/steps.py``):
assemble (train_step | prefill_step | serve_step) + shape-only input
structs + placements for an (arch x input-shape x mesh) combination.

* ``make_train_step`` is a full **BAFDP federated round** over LM
  clients: per-client LDP embedding noise, the DRO regularizer, the
  Eq. (20) sign consensus (one B1 launch a round), the dual steps.
* ``make_prefill_step`` / ``make_decode_step`` run the deployment model;
  ``decode_window`` picks the ring-buffer window of a decode shape.
* ``train_setup`` / ``prefill_setup`` / ``decode_setup`` (and
  ``input_specs``, which dispatches on the shape's kind) return ``(step,
  arg structs, in specs, out specs)``: the structs are tensors on the
  ``meta`` device (shapes and dtypes, nothing allocated:
  ``batch_struct``, ``fed_state_struct``, ``params_struct``,
  ``prefill_inputs_struct``, ``init_decode_state`` on meta), the specs
  ``sharding.PartitionSpec`` trees of the reference's plan
  (``make_plan``), which ``sharding.named`` turns into DTensor
  placements and ``sharding.place_tree`` applies.  The reference defines
  its plan on its stacked layout (``unit`` leaves (n_groups, ...)); the
  port serves from per-layer lists (``transformer.lm_view``,
  ``init_decode_state``), so a serving setup gives each per-layer leaf
  its stacked spec less the leading layer-group dim, which the plan
  never shards (:func:`per_layer_param_specs`,
  :func:`per_layer_state_specs`).  The port runs eagerly: a step takes
  the local tensors (``sharding.local_tree``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ATTN, ArchConfig, FedConfig, InputShape
from repro_torch.core import bafdp as bafdp_lib
from repro_torch.core.byzantine import byz_mask
from repro_torch.core.fed_state import FedState, init_fed_state
from repro_torch.core.privacy import RowGenerators, gaussian_c3, sigma_for_eps
from repro_torch.distributed.sharding import P, make_plan, map_specs
from repro_torch.models import transformer as tr
from repro_torch.models.layers import (dense_init, dtype_of, init_embedding,
                                      init_rmsnorm, lm_logits)
from repro_torch.tree import tree_map, tree_unstack

# the DRO radius's sample count of an LM client, as the reference's step
N_SAMPLES = 4096


def fed_config_for(cfg: ArchConfig, n_clients: int,
                   base: Optional[FedConfig] = None) -> FedConfig:
    """LM-scale BAFDP config: embedding-space sensitivity (Delta ~ the
    0.02-scale embedding norm) so sigma = c3/eps sits at a useful level."""
    base = base or FedConfig()
    sens = 0.05 / math.sqrt(cfg.d_model)
    return dataclasses.replace(
        base, n_clients=n_clients, dp_sensitivity=sens,
        lipschitz_surrogate="frobenius", grad_clip=1.0)


def text_len(cfg: ArchConfig, seq_len: int) -> int:
    """Text tokens of a ``seq_len``-position input: a VLM's frontend
    prefix takes ``frontend_tokens`` of them; an encoder-decoder's frames
    go to the encoder, beside the ``seq_len`` tokens."""
    if cfg.frontend != "none" and cfg.n_enc_layers == 0:
        return seq_len - cfg.frontend_tokens
    return seq_len


# ===========================================================================
# train
def batch_shapes(cfg: ArchConfig, shape: InputShape, n_clients: int
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The training batch's arrays as ``{name: (shape, dtype)}`` (the
    reference's ``batch_struct``): tokens and labels (C, b, text_len)
    with ``b = global_batch // C``, and a VLM's ``frontend_embeds`` or an
    encoder-decoder's ``enc_embeds`` (C, b, frontend_tokens, d) in the
    compute dtype."""
    C = n_clients
    b = shape.global_batch // max(C, 1)
    if b < 1:
        raise ValueError(f"global batch {shape.global_batch} gives no "
                         f"sequence to each of {C} clients")
    st = text_len(cfg, shape.seq_len)
    cdt = dtype_of(cfg.compute_dtype)
    out = {"tokens": ((C, b, st), torch.int32),
           "labels": ((C, b, st), torch.int32)}
    if cfg.frontend != "none" and cfg.n_enc_layers == 0:
        out["frontend_embeds"] = ((C, b, cfg.frontend_tokens, cfg.d_model),
                                  cdt)
    if cfg.n_enc_layers:
        out["enc_embeds"] = ((C, b, cfg.frontend_tokens, cfg.d_model), cdt)
    return out


def make_local_loss(cfg: ArchConfig, fed: FedConfig, c3: float):
    """The round's ``local_loss(W, batch, gen, eps) -> (C,)``: client
    ``r``'s ``transformer.loss_fn`` on ``lm_view`` of row ``r`` of ``W``
    and of the batch, with the LDP noise ``(gen_r, sigma_for_eps(eps_r,
    c3, eps_min))``; ``gen_r`` is the round's generator itself (its
    draws taken client after client) or row ``r``'s of a
    ``RowGenerators``.  Clients run one at a time: B4 takes one
    client's weights a call."""

    def local_loss(W, batch, gen, eps):
        sigma = sigma_for_eps(eps, c3, fed.eps_min)
        losses = []
        for r, w_r in enumerate(tree_unstack(W)):
            g_r = gen.generator(r) if isinstance(gen, RowGenerators) else gen
            b_r = {k: v[r] for k, v in batch.items()}
            losses.append(tr.loss_fn(tr.lm_view(w_r, cfg), b_r, cfg,
                                     noise=(g_r, sigma[r])))
        return torch.stack(losses)

    return local_loss


def make_train_step(cfg: ArchConfig, fed: FedConfig
                    ) -> Callable[..., Tuple[FedState, Dict[str, Any]]]:
    """``train_step(state, batch, seed, act=None, stale=None) -> (state,
    metrics)``: one ``bafdp_round`` of LM clients from the round
    generator ``torch.Generator(device).manual_seed(seed)``, with the
    reference's ``n_samples`` (4096), ``d_dim`` (d_model) and Byzantine
    mask (the last ``fed.n_byzantine`` clients).  ``batch`` holds
    (C, b, ...) tensors on the state's device; ``act``/``stale`` are an
    external schedule's rows (None: the internal sampler)."""
    c3 = gaussian_c3(cfg.d_model, fed.dp_delta, fed.dp_sensitivity)
    local_loss = make_local_loss(cfg, fed, c3)

    def train_step(state: FedState, batch, seed, act=None, stale=None):
        dev = state.eps.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return bafdp_lib.bafdp_round(
            state, batch, gen, local_loss=local_loss, fed=fed, c3=c3,
            n_samples=N_SAMPLES, d_dim=cfg.d_model,
            byz_mask=byz_mask(fed.n_clients, fed.n_byzantine, device=dev),
            act=act, stale=stale)

    return train_step


# ===========================================================================
# prefill / decode (deployment model = consensus z)
def prefill_inputs(cfg: ArchConfig, batch: int, seq_len: int,
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random inputs of a prefill step (the reference's
    ``prefill_inputs_struct`` with values), on ``gen``'s device: tokens
    (batch, text_len) uniform over the vocabulary; for a VLM
    ``frontend_embeds`` and for an encoder-decoder ``enc_embeds``,
    (batch, frontend_tokens, d) standard normal in the compute dtype, the
    stub frontend's patch or frame embeddings."""
    dev = gen.device
    out = {"tokens": torch.randint(0, cfg.vocab_size,
                                   (batch, text_len(cfg, seq_len)),
                                   generator=gen, device=dev)}
    for name, wanted in (("frontend_embeds", cfg.frontend != "none"
                          and cfg.n_enc_layers == 0),
                         ("enc_embeds", bool(cfg.n_enc_layers))):
        if wanted:
            out[name] = torch.randn(
                (batch, cfg.frontend_tokens, cfg.d_model), generator=gen,
                device=dev).to(dtype_of(cfg.compute_dtype))
    return out


def make_prefill_step(cfg: ArchConfig):
    """prefill_step(params, inputs) -> logits (B, vocab_pad) of the last
    text position: the prompt runs through the whole model (B4 in every
    attention layer -- without the causal mask in an encoder layer and in
    a decoder layer's cross-attention --, B6 once per 128-token chunk in
    every Mamba layer, the mLSTM's chunks and the sLSTM's steps in
    PyTorch, an MoE FFN's routing over all B * S tokens at once, so its
    capacity is the whole prompt's) and only the final position meets
    the LM head.  The MoE aux loss is dropped, as in the reference."""

    def prefill_step(params, inputs):
        x, _ = tr.forward(params, inputs, cfg)
        return lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]

    return prefill_step


def decode_window(cfg: ArchConfig, shape: InputShape) -> int:
    """The decode step's window at ``shape``, as the reference's: past
    65,536 positions (``long_500k``) an architecture with a sliding
    window decodes through a ring buffer of ``cfg.sliding_window``
    slots; every other shape uses the full cache (0)."""
    if shape.seq_len > 65536 and cfg.sliding_window:
        return cfg.sliding_window
    return 0


def make_decode_step(cfg: ArchConfig, window: int = 0):
    """serve_step(params, state, tokens (B, 1), step) -> (logits, state):
    one token for the whole batch against the cache (B5 in every
    attention layer and, in an encoder-decoder, in every cross-attention
    over ``state["memory"]``; a Mamba, mLSTM or sLSTM layer's one-step
    update and an MoE FFN over the B tokens, whose capacity of at least
    8 slots drops nothing for B <= 8, run no kernel of the port)."""

    def serve_step(params, state, tokens, step):
        return tr.decode_step(params, state, tokens, step, cfg,
                              window=window)

    return serve_step


# ===========================================================================
# shape-only structs (meta tensors)
class _OnMeta(TorchFunctionMode):
    """Inside the block every tensor a call makes lands on the ``meta``
    device, whatever device the call names: an init runs for its shapes
    and dtypes alone and allocates nothing (Llama3-405B's tree is ~1.6 TB
    in f32).  Draws from a CPU generator onto meta tensors draw nothing."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ArchConfig, shape: InputShape, n_clients: int
                 ) -> Dict[str, torch.Tensor]:
    """The training batch (:func:`batch_shapes`) as meta tensors."""
    return {k: _meta(s, dt)
            for k, (s, dt) in batch_shapes(cfg, shape, n_clients).items()}


def fed_state_struct(cfg: ArchConfig, fed: FedConfig) -> FedState:
    """``fed``'s federated state of ``cfg``'s LM clients on the meta
    device: ``init_fed_state`` over one ``init_lm_tree`` (shapes only,
    alike for every client)."""
    one = params_struct(cfg)
    with _OnMeta():
        return init_fed_state(torch.Generator(), lambda g: one, fed,
                              device="meta")


def params_struct(cfg: ArchConfig) -> Dict[str, Any]:
    """One model's tree in the reference's ``init_lm`` layout
    (``transformer.lm_tree``) on the meta device, built as the reference's
    ``init_lm`` builds it: the embedding, each unit entry's layer drawn
    once and stacked over the layer groups (a ``vmap`` there), the final
    norm, a VLM's ``frontend_proj``, an encoder-decoder's ``enc_unit``
    (one ATTN layer stacked over the encoder's layers) and
    ``enc_norm``."""
    tr.check_ported(cfg)
    unit, n_groups = tr.factor_pattern(cfg.pattern())
    gen = torch.Generator()

    def stacked(tree, n):
        return tree_map(lambda t: t.expand((n,) + t.shape).contiguous(),
                        tree)

    with _OnMeta():
        out: Dict[str, Any] = {
            "embed": init_embedding(gen, cfg),
            "unit": tuple(stacked(tr.init_sublayer(
                gen, kind, cfg, cross=cfg.n_enc_layers > 0), n_groups)
                for kind in unit),
            "final_norm": init_rmsnorm(cfg.d_model, device="meta")}
        if cfg.frontend != "none":
            out["frontend_proj"] = dense_init(
                gen, (cfg.d_model, cfg.d_model),
                dtype=dtype_of(cfg.param_dtype))
        if cfg.n_enc_layers:
            out["enc_unit"] = stacked(tr.init_sublayer(gen, ATTN, cfg),
                                      cfg.n_enc_layers)
            out["enc_norm"] = init_rmsnorm(cfg.d_model, device="meta")
    return out


def prefill_inputs_struct(cfg: ArchConfig, shape: InputShape
                          ) -> Dict[str, torch.Tensor]:
    """The prefill inputs (:func:`prefill_inputs`) as meta tensors, tokens
    int32 as the reference's."""
    B, cdt = shape.global_batch, dtype_of(cfg.compute_dtype)
    out = {"tokens": _meta((B, text_len(cfg, shape.seq_len)), torch.int32)}
    if cfg.frontend != "none" and cfg.n_enc_layers == 0:
        out["frontend_embeds"] = _meta(
            (B, cfg.frontend_tokens, cfg.d_model), cdt)
    if cfg.n_enc_layers:
        out["enc_embeds"] = _meta((B, cfg.frontend_tokens, cfg.d_model), cdt)
    return out


def stacked_decode_state(state: Dict[str, Any], cfg: ArchConfig
                         ) -> Dict[str, Any]:
    """A per-layer decode state (``transformer.init_decode_state``) in the
    reference's stacked layout: ``layers`` a tuple with one tree per unit
    entry, its leaves stacking that entry's layers on a leading
    (n_groups, ...) dim; ``memory`` as it is."""
    unit, _ = tr.factor_pattern(cfg.pattern())
    U = len(unit)
    layers = state["layers"]
    out = dict(state)
    out["layers"] = tuple(tree_map(lambda *ls: torch.stack(ls),
                                   *layers[j::U]) for j in range(U))
    return out


# ===========================================================================
# the reference's stacked specs in the port's per-layer layout
def _drop_group_dim(tree):
    def drop(spec):
        if spec[0] is not None:
            raise ValueError(f"{spec}: the plan sharded a layer-group dim")
        return P(*spec[1:])

    return map_specs(drop, tree)


def per_layer_param_specs(specs: Dict[str, Any], cfg: ArchConfig
                          ) -> Dict[str, Any]:
    """A params spec tree in the ``init_lm`` layout laid out as
    ``transformer.lm_view`` lays out the params: layer ``g * len(unit) +
    j`` takes ``unit[j]``'s specs, the encoder's layers ``enc_unit``'s,
    each less the leading layer-group dim."""
    unit, n_groups = tr.factor_pattern(cfg.pattern())
    per = [_drop_group_dim(t) for t in specs["unit"]]
    out = {k: v for k, v in specs.items() if k != "unit"}
    out["layers"] = [per[j] for _ in range(n_groups)
                     for j in range(len(unit))]
    if "enc_unit" in specs:
        out["enc_unit"] = [_drop_group_dim(specs["enc_unit"])] \
            * cfg.n_enc_layers
    return out


def per_layer_state_specs(specs: Dict[str, Any], cfg: ArchConfig
                          ) -> Dict[str, Any]:
    """A decode state's spec tree in the stacked layout laid out as
    ``transformer.init_decode_state``'s list: layer ``g * len(unit) + j``
    takes ``layers[j]``'s specs less the leading layer-group dim."""
    unit, n_groups = tr.factor_pattern(cfg.pattern())
    per = [_drop_group_dim(t) for t in specs["layers"]]
    out = dict(specs)
    out["layers"] = [per[j] for _ in range(n_groups)
                     for j in range(len(unit))]
    return out


def _data_axis(mesh):
    return ("pod", "data") if "pod" in tuple(mesh.mesh_dim_names) \
        else "data"


# ===========================================================================
# setups: (step, arg structs, in specs, out specs)
def train_setup(cfg: ArchConfig, shape: InputShape, mesh,
                base_fed: Optional[FedConfig] = None,
                inner_dp: bool = False, n_clients: Optional[int] = None):
    """Returns (train_step, (state, batch, seed) structs, in specs, out
    specs), the reference's ``train_setup``: the federated state and the
    batch placed by ``make_plan(cfg, mesh, inner_dp)``, the seed and the
    metrics replicated.  C is ``n_clients`` when given (an addition of
    the port: the card trains fewer clients than a pod), else the plan's
    federated axis size, as in the reference."""
    plan = make_plan(cfg, mesh, inner_dp=inner_dp)
    fed = fed_config_for(cfg, n_clients or plan.n_clients, base_fed)
    step = make_train_step(cfg, fed)
    state_sds = fed_state_struct(cfg, fed)
    batch_sds = batch_struct(cfg, shape, fed.n_clients)
    state_specs = plan.fed_state_specs(state_sds)
    batch_specs = plan.batch_spec_tree(batch_sds)
    args = (state_sds, batch_sds, _meta((), torch.int32))
    return (step, args, (state_specs, batch_specs, P()),
            (state_specs, P()))


def prefill_setup(cfg: ArchConfig, shape: InputShape, mesh):
    """Returns (prefill_step, (params, inputs) structs, in specs, out
    spec), the reference's ``prefill_setup``: the params in the serving
    layout (``transformer.lm_view`` of :func:`params_struct`) with their
    per-layer specs, every input's batch dim on the data axis, the
    logits (B, vocab_pad) ``P(data_ax, "model")``."""
    plan = make_plan(cfg, mesh)
    p_sds = params_struct(cfg)
    in_sds = prefill_inputs_struct(cfg, shape)
    p_specs = per_layer_param_specs(
        plan.param_spec_tree(p_sds, client_dim=False), cfg)
    data_ax = _data_axis(mesh)
    in_specs = tree_map(lambda l: P(data_ax, *[None] * (l.ndim - 1)),
                        in_sds)
    return (make_prefill_step(cfg), (tr.lm_view(p_sds, cfg), in_sds),
            (p_specs, in_specs), P(data_ax, "model"))


def decode_setup(cfg: ArchConfig, shape: InputShape, mesh):
    """Returns (serve_step, (params, state, tokens, step) structs, in
    specs, out specs), the reference's ``decode_setup``: the window of
    :func:`decode_window`, the per-layer decode state of B =
    ``global_batch`` rows over ``seq_len`` positions with its per-layer
    specs, tokens (B, 1) on the data axis unless B = 1, the logits (B, 1,
    vocab_pad) with the vocabulary on ``"model"``."""
    plan = make_plan(cfg, mesh)
    window = decode_window(cfg, shape)
    B = shape.global_batch
    cdt = dtype_of(cfg.compute_dtype)
    p_sds = params_struct(cfg)
    state_sds = tr.init_decode_state(cfg, B, shape.seq_len, cdt,
                                     window=window, device="meta")
    p_specs = per_layer_param_specs(
        plan.param_spec_tree(p_sds, client_dim=False), cfg)
    s_specs = per_layer_state_specs(plan.decode_state_specs(
        stacked_decode_state(state_sds, cfg), B), cfg)
    data_ax = _data_axis(mesh)
    row = data_ax if B > 1 else None
    args = (tr.lm_view(p_sds, cfg), state_sds, _meta((B, 1), torch.int32),
            _meta((), torch.int32))
    return (make_decode_step(cfg, window), args,
            (p_specs, s_specs, P(row, None), P()),
            (P(row, None, "model"), s_specs))


def input_specs(cfg: ArchConfig, shape: InputShape, mesh,
                base_fed: Optional[FedConfig] = None,
                inner_dp: bool = False):
    """The deliverable entry point: meta-tensor stand-ins + placements
    for every model input of this (arch x shape), dispatched on kind."""
    if shape.kind == "train":
        return train_setup(cfg, shape, mesh, base_fed, inner_dp=inner_dp)
    if shape.kind == "prefill":
        return prefill_setup(cfg, shape, mesh)
    return decode_setup(cfg, shape, mesh)
