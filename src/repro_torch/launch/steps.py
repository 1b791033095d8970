"""Step builders (the port of the JAX package's ``launch/steps.py``):
the federated training step over the model zoo, the prefill and decode
bodies, and their inputs' shapes.  Shardings, ``ShapeDtypeStruct``s and
the dry-run lowering have no counterpart: the port runs eagerly on one
card.

* ``make_train_step`` is a full **BAFDP federated round** over LM
  clients: per-client LDP embedding noise, the DRO regularizer, the
  Eq. (20) sign consensus (one B1 launch a round), the dual steps.
* ``make_prefill_step`` / ``make_decode_step`` run the deployment model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, FedConfig, InputShape
from repro_torch.core import bafdp as bafdp_lib
from repro_torch.core.byzantine import byz_mask
from repro_torch.core.fed_state import FedState
from repro_torch.core.privacy import RowGenerators, gaussian_c3, sigma_for_eps
from repro_torch.models import transformer as tr
from repro_torch.models.layers import dtype_of, lm_logits
from repro_torch.tree import tree_unstack

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
