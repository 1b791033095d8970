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
from repro_torch.core.privacy import (BlockGenerator, RowGenerators,
                                      gaussian_c3, sigma_for_eps)
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.data_parallel import rank_block
from repro_torch.distributed.sharding import (P, make_plan, map_leaves,
                                              map_specs)
from repro_torch.models import transformer as tr
from repro_torch.models.layers import (dense_init, dtype_of, init_embedding,
                                      init_rmsnorm, lm_logits, rope_freqs)
from repro_torch.tree import generator, tree_map, tree_unstack

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


def noise_shapes(cfg: ArchConfig, b_r: Dict[str, torch.Tensor],
                 rows: int) -> list:
    """The shapes of the LDP noise ``transformer.forward`` draws for one
    client's batch ``b_r`` of ``rows`` sequences, in its order: the token
    embeddings, a VLM's ``frontend_embeds``, an encoder's
    ``enc_embeds``."""
    shapes = [(rows, b_r["tokens"].shape[-1], cfg.d_model)]
    if (cfg.frontend != "none" and "frontend_embeds" in b_r
            and cfg.n_enc_layers == 0):
        shapes.append((rows,) + tuple(b_r["frontend_embeds"].shape[1:]))
    if cfg.n_enc_layers:
        shapes.append((rows,) + tuple(b_r["enc_embeds"].shape[1:]))
    return shapes


def make_local_loss(cfg: ArchConfig, fed: FedConfig, c3: float):
    """The round's ``local_loss(W, batch, gen, eps) -> (C,)``: client
    ``r``'s ``transformer.loss_fn`` on ``lm_view`` of row ``r`` of ``W``
    and of the batch, with the LDP noise ``(gen_r, sigma_for_eps(eps_r,
    c3, eps_min))``; ``gen_r`` is the round's generator itself (its
    draws taken client after client) or row ``r``'s of a
    ``RowGenerators``.  Clients run one at a time: B4 takes one
    client's weights a call.

    A split round's ``privacy.BlockGenerator`` (the rows are this rank's
    clients ``[start, start + rows)`` of C, and under ``inner_dp`` each
    client's batch rows a part of its ``b``): the clients before and
    after the block draw their noise from the round's generator and
    discard it, in the one-rank round's order, and a block client's
    noise is drawn for its whole batch and narrowed to the rank's rows,
    so that every draw matches the one-rank round's."""

    def local_loss(W, batch, gen, eps):
        sigma = sigma_for_eps(eps, c3, fed.eps_min)
        rows = list(tree_unstack(W))
        if not isinstance(gen, BlockGenerator):
            losses = []
            for r, w_r in enumerate(rows):
                g_r = gen.generator(r) if isinstance(gen, RowGenerators) \
                    else gen
                b_r = {k: v[r] for k, v in batch.items()}
                losses.append(tr.loss_fn(tr.lm_view(w_r, cfg), b_r, cfg,
                                         noise=(g_r, sigma[r])))
            return torch.stack(losses)
        (C, c0, n), *inner = gen.spans
        b0 = {k: v[0] for k, v in batch.items()}
        dev = b0["tokens"].device
        b_total = inner[0][0] if inner else b0["tokens"].shape[0]

        def discard():
            for shape in noise_shapes(cfg, b0, b_total):
                torch.randn(shape, generator=gen.gen, dtype=torch.float32,
                            device=dev)

        for _ in range(c0):
            discard()
        losses = []
        for r, w_r in enumerate(rows):
            g_r = BlockGenerator(gen.gen, inner) if inner else gen.gen
            b_r = {k: v[r] for k, v in batch.items()}
            losses.append(tr.loss_fn(tr.lm_view(w_r, cfg), b_r, cfg,
                                     noise=(g_r, sigma[r])))
        for _ in range(C - c0 - n):
            discard()
        return torch.stack(losses)

    return local_loss


def make_train_step(cfg: ArchConfig, fed: FedConfig, ranks=None
                    ) -> Callable[..., Tuple[FedState, Dict[str, Any]]]:
    """``train_step(state, batch, seed, act=None, stale=None) -> (state,
    metrics)``: one ``bafdp_round`` of LM clients from the round
    generator ``torch.Generator(device).manual_seed(seed)``, with the
    reference's ``n_samples`` (4096), ``d_dim`` (d_model) and Byzantine
    mask (the last ``fed.n_byzantine`` clients).  ``batch`` holds
    (C, b, ...) tensors on the state's device; ``act``/``stale`` are an
    external schedule's rows (None: the internal sampler).

    ``ranks`` (``distributed.data_parallel.RankBlock``, more than one
    rank): ``state`` holds this rank's clients
    (``fed_state.shard_clients``) and ``batch`` their (C_r, b_r, ...)
    rows, b_r this rank's share of a client's b sequences under
    ``inner_dp`` (``ranks.batch``, :meth:`RankBlock.with_batch`)."""
    c3 = gaussian_c3(cfg.d_model, fed.dp_delta, fed.dp_sensitivity)
    local_loss = make_local_loss(cfg, fed, c3)

    def train_step(state: FedState, batch, seed, act=None, stale=None):
        dev = state.eps.device
        gen = generator(dev).manual_seed(int(seed))
        return bafdp_lib.bafdp_round(
            state, batch, gen, local_loss=local_loss, fed=fed, c3=c3,
            n_samples=N_SAMPLES, d_dim=cfg.d_model,
            byz_mask=byz_mask(fed.n_clients, fed.n_byzantine, device=dev),
            act=act, stale=stale, ranks=ranks)

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


def make_prefill_step(cfg: ArchConfig, ranks=None):
    """prefill_step(params, inputs) -> logits (B, vocab_pad) of the last
    text position (``ranks``, a rank's block of the plan over a
    ``"model"`` axis: the rank's blocks of the params and rows of the
    inputs in, its (B_r, vocab_pad / M) block of the logits out;
    ``distributed/tensor_parallel.py``): the prompt runs through the
    whole model (B4 in every
    attention layer -- without the causal mask in an encoder layer and in
    a decoder layer's cross-attention --, B6 once per 128-token chunk in
    every Mamba layer, the mLSTM's chunks and the sLSTM's steps in
    PyTorch, an MoE FFN's routing over all B * S tokens at once, so its
    capacity is the whole prompt's) and only the final position meets
    the LM head.  The MoE aux loss is dropped, as in the reference."""

    def prefill_step(params, inputs):
        x, _ = tr.forward(params, inputs, cfg, ranks=ranks)
        return lm_logits(params["embed"], x[:, -1:], cfg,
                         ranks=tp.at(ranks, "embed"))[:, 0]

    return prefill_step


def decode_window(cfg: ArchConfig, shape: InputShape) -> int:
    """The decode step's window at ``shape``, as the reference's: past
    65,536 positions (``long_500k``) an architecture with a sliding
    window decodes through a ring buffer of ``cfg.sliding_window``
    slots; every other shape uses the full cache (0)."""
    if shape.seq_len > 65536 and cfg.sliding_window:
        return cfg.sliding_window
    return 0


def make_decode_step(cfg: ArchConfig, window: int = 0, ranks=None):
    """serve_step(params, state, tokens (B, 1), step) -> (logits, state)
    (``ranks``: a rank's block of the plan, as :func:`make_prefill_step`,
    with ``ranks.state_specs`` the decode state's):
    one token for the whole batch against the cache (B5 in every
    attention layer and, in an encoder-decoder, in every cross-attention
    over ``state["memory"]``; a Mamba, mLSTM or sLSTM layer's one-step
    update and an MoE FFN over the B tokens, whose capacity of at least
    8 slots drops nothing for B <= 8, run no kernel of the port)."""

    def serve_step(params, state, tokens, step):
        return tr.decode_step(params, state, tokens, step, cfg,
                              window=window, ranks=ranks)

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
def mesh_size(mesh) -> int:
    return math.prod(tuple(mesh.shape))


def check_placements(plan, kind: str = "train") -> None:
    """The plans that run on a mesh of several devices.  Training: mode A
    with the clients on ``"data"`` and, over a ``"model"`` axis of more
    than one device, ``inner_dp`` (a client's weights replicated there,
    its batch split); the default plan's ``"model"`` placements raise
    ``NotImplementedError`` naming 7(b) step 3c, mode B's sharded
    parameters over ``"data"`` step 3d.  Serving (``kind`` ``"prefill"``
    or ``"decode"``): the default plan over any ``"data"`` x ``"model"``
    mesh for mode A, for mode B where ``"data"`` has one device (else
    step 3d); over a ``"model"`` axis of more than one device every
    family."""
    if mesh_size(plan.mesh) == 1:
        return
    sizes = dict(zip(plan.mesh.mesh_dim_names, tuple(plan.mesh.shape)))
    model = sizes.get("model", 1)
    data = sizes.get("data", 1) * sizes.get("pod", 1)
    what = (f"{plan.cfg.name} (mode {plan.cfg.fed_mode}, inner_dp="
            f"{plan.inner_dp}, {kind}) on a mesh of {mesh_size(plan.mesh)} "
            "devices")
    if plan.cfg.fed_mode != "A" and data > 1:
        raise NotImplementedError(f"{what}: {tp.STEP3D}")
    if kind == "train" and (plan.cfg.fed_mode != "A"
                            or (model > 1 and not plan.inner_dp)):
        raise NotImplementedError(f"{what}: {tp.STEP3C}")


def runs_ranks(mesh) -> bool:
    """Whether this process runs as one rank of ``mesh``: a ``DeviceMesh``
    of several devices over a real process group (not torch's ``fake``
    backend, over which the placements are only realised)."""
    if mesh_size(mesh) == 1 or not hasattr(mesh, "get_coordinate"):
        return False
    import torch.distributed as dist

    return dist.get_backend() != "fake"


def train_setup(cfg: ArchConfig, shape: InputShape, mesh,
                base_fed: Optional[FedConfig] = None,
                inner_dp: bool = False, n_clients: Optional[int] = None,
                rank_local: Optional[bool] = None):
    """Returns (train_step, (state, batch, seed) structs, in specs, out
    specs), the reference's ``train_setup``: the federated state and the
    batch placed by ``make_plan(cfg, mesh, inner_dp)``, the seed and the
    metrics replicated.  C is ``n_clients`` when given (an addition of
    the port: the card trains fewer clients than a pod), else the plan's
    federated axis size, as in the reference.

    ``rank_local`` (default: :func:`runs_ranks`, a ``DeviceMesh`` of
    several devices over a real process group; the dry-run asks for it
    under the ``fake`` backend): the step is this rank's
    (``data_parallel.rank_block``: its clients, under ``inner_dp`` its
    rows of each client's batch) and the structs are its local ones, the
    state of C_r clients and the batch (C_r, b_r, ...), for the plans
    that run on several devices (:func:`check_placements`).  The specs
    stay the whole tensors'.  Otherwise the step and structs are whole
    whatever the mesh, as the reference's."""
    plan = make_plan(cfg, mesh, inner_dp=inner_dp)
    if rank_local is None:
        rank_local = runs_ranks(mesh)
    if rank_local:
        check_placements(plan, "train")
    fed = fed_config_for(cfg, n_clients or plan.n_clients, base_fed)
    state_sds = fed_state_struct(cfg, fed)
    batch_sds = batch_struct(cfg, shape, fed.n_clients)
    state_specs = plan.fed_state_specs(state_sds)
    batch_specs = plan.batch_spec_tree(batch_sds)
    ranks = None
    if rank_local and mesh_size(mesh) > 1:
        ranks = rank_block(mesh, fed.n_clients)
        b = shape.global_batch // fed.n_clients
        if ranks.model.size > 1:
            ranks = ranks.with_batch(b)
        _, _, rows, _ = ranks.batch or (b, 0, b, 1.0)
        state_sds = fed_state_struct(
            cfg, dataclasses.replace(fed, n_clients=ranks.rows))
        batch_sds = {k: _meta((ranks.rows, rows) + tuple(v.shape[2:]),
                              v.dtype) for k, v in batch_sds.items()}
    step = make_train_step(cfg, fed, ranks=ranks)
    args = (state_sds, batch_sds, _meta((), torch.int32))
    return (step, args, (state_specs, batch_specs, P()),
            (state_specs, P()))


def serving_specs(cfg: ArchConfig, mesh) -> Dict[str, Any]:
    """The default plan's (``make_plan(cfg, mesh)``) specs of the serving
    params, per layer (:func:`per_layer_param_specs`)."""
    plan = make_plan(cfg, mesh)
    return per_layer_param_specs(
        plan.param_spec_tree(params_struct(cfg), client_dim=False), cfg)


def decode_state_specs(cfg: ArchConfig, mesh, batch: int, cache_len: int,
                       window: int = 0) -> Dict[str, Any]:
    """The plan's specs of the per-layer decode state of ``batch`` rows
    over ``cache_len`` positions (the ring's ``window`` slots with a
    window): ``ShardingPlan.decode_state_specs`` on the stacked layout,
    per layer (:func:`per_layer_state_specs`)."""
    state = tr.init_decode_state(cfg, batch, cache_len,
                                 dtype_of(cfg.compute_dtype), window=window,
                                 device="meta")
    return per_layer_state_specs(make_plan(cfg, mesh).decode_state_specs(
        stacked_decode_state(state, cfg), batch), cfg)


def _local_structs(tree, specs, ranks):
    """Meta tensors of this rank's block of every leaf of ``tree``."""
    return map_leaves(lambda t, s: _meta(tp.block_shape(t.shape, s, ranks),
                                         t.dtype), tree, specs)


def _serving_ranks(plan, kind: str, mesh, batch: int, rank_local, specs,
                   state_specs=None):
    """This rank's block for a serving setup, or None for the whole step
    (``rank_local`` False, or one device)."""
    if rank_local is None:
        rank_local = runs_ranks(mesh)
    if not rank_local or mesh_size(mesh) == 1:
        return None
    check_placements(plan, kind)
    return tp.serve_block(mesh, batch, specs, state_specs)


def prefill_setup(cfg: ArchConfig, shape: InputShape, mesh,
                  rank_local: Optional[bool] = None):
    """Returns (prefill_step, (params, inputs) structs, in specs, out
    spec), the reference's ``prefill_setup``: the params in the serving
    layout (``transformer.lm_view`` of :func:`params_struct`) with their
    per-layer specs, every input's batch dim on the data axis, the
    logits (B, vocab_pad) ``P(data_ax, "model")``.

    ``rank_local`` (default: :func:`runs_ranks`; the dry-run asks for it
    under the ``fake`` backend): the step is this rank's
    (``tensor_parallel``: its rows of the batch, its blocks of every
    param, tensor-parallel over ``"model"``) and the structs are its local
    blocks, for the plans that serve on several devices
    (:func:`check_placements`).  The specs stay the whole tensors'."""
    plan = make_plan(cfg, mesh)
    p_sds = tr.lm_view(params_struct(cfg), cfg)
    in_sds = prefill_inputs_struct(cfg, shape)
    p_specs = serving_specs(cfg, mesh)
    data_ax = _data_axis(mesh)
    in_specs = tree_map(lambda l: P(data_ax, *[None] * (l.ndim - 1)),
                        in_sds)
    ranks = _serving_ranks(plan, "prefill", mesh, shape.global_batch,
                           rank_local, p_specs)
    if ranks is not None:
        p_sds = _local_structs(p_sds, p_specs, ranks)
        in_sds = _local_structs(in_sds, in_specs, ranks)
    return (make_prefill_step(cfg, ranks), (p_sds, in_sds),
            (p_specs, in_specs), P(data_ax, "model"))


def decode_setup(cfg: ArchConfig, shape: InputShape, mesh,
                 rank_local: Optional[bool] = None):
    """Returns (serve_step, (params, state, tokens, step) structs, in
    specs, out specs), the reference's ``decode_setup``: the window of
    :func:`decode_window`, the per-layer decode state of B =
    ``global_batch`` rows over ``seq_len`` positions with its per-layer
    specs, tokens (B, 1) on the data axis unless B = 1, the logits (B, 1,
    vocab_pad) with the vocabulary on ``"model"``.  ``rank_local``: as
    :func:`prefill_setup`; the state struct is the rank's block (its rows
    on ``"data"``, its positions on ``"model"``)."""
    plan = make_plan(cfg, mesh)
    window = decode_window(cfg, shape)
    B = shape.global_batch
    cdt = dtype_of(cfg.compute_dtype)
    p_sds = tr.lm_view(params_struct(cfg), cfg)
    state_sds = tr.init_decode_state(cfg, B, shape.seq_len, cdt,
                                     window=window, device="meta")
    p_specs = serving_specs(cfg, mesh)
    s_specs = decode_state_specs(cfg, mesh, B, shape.seq_len, window)
    data_ax = _data_axis(mesh)
    row = data_ax if B > 1 else None
    tok_spec = P(row, None)
    tokens = _meta((B, 1), torch.int32)
    ranks = _serving_ranks(plan, "decode", mesh, B, rank_local, p_specs,
                           s_specs)
    if ranks is not None:
        p_sds = _local_structs(p_sds, p_specs, ranks)
        state_sds = _local_structs(state_sds, s_specs, ranks)
        tokens = _local_structs(tokens, tok_spec, ranks)
    args = (p_sds, state_sds, tokens, _meta((), torch.int32))
    return (make_decode_step(cfg, window, ranks), args,
            (p_specs, s_specs, tok_spec, P()),
            (P(row, None, "model"), s_specs))


def input_specs(cfg: ArchConfig, shape: InputShape, mesh,
                base_fed: Optional[FedConfig] = None,
                inner_dp: bool = False, n_clients: Optional[int] = None,
                rank_local: Optional[bool] = None):
    """The deliverable entry point: meta-tensor stand-ins + placements
    for every model input of this (arch x shape), dispatched on kind
    (``n_clients``: a training round's, as :func:`train_setup`;
    ``rank_local``: as the setup of the shape's kind)."""
    if shape.kind == "train":
        return train_setup(cfg, shape, mesh, base_fed, inner_dp=inner_dp,
                           n_clients=n_clients, rank_local=rank_local)
    if shape.kind == "prefill":
        return prefill_setup(cfg, shape, mesh, rank_local=rank_local)
    return decode_setup(cfg, shape, mesh, rank_local=rank_local)


def warm_device_caches(cfg: ArchConfig, device) -> None:
    """Make on ``device`` the constants a step caches per device on first
    use (RoPE's frequencies, ``layers.rope_freqs``; on the GPU cuBLAS's
    workspace, which the first product of a process allocates through
    the caching allocator and keeps: 32 MiB on an H100), so that a step's
    peak memory does not depend on whether an earlier step on that device
    made them: the dry-run warms them on meta before it counts, a
    measurement on the card before its baseline (a rank process's first
    step is its process's first product)."""
    rope_freqs(cfg.resolved_head_dim, cfg.rope_theta, device)
    if torch.device(device).type == "cuda":
        for dt in (torch.float32, torch.bfloat16):
            one = torch.ones((16, 16), dtype=dt, device=device)
            one @ one
