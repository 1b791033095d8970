"""Step builders for serving (the port of the JAX package's
``launch/steps.py``, prefill and decode bodies and their inputs only;
shardings and the training step come with the placement slice)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tr
from repro_torch.models.layers import dtype_of, lm_logits


def text_len(cfg: ArchConfig, seq_len: int) -> int:
    """Text tokens of a ``seq_len``-position input: a VLM's frontend
    prefix takes ``frontend_tokens`` of them; an encoder-decoder's frames
    go to the encoder, beside the ``seq_len`` tokens."""
    if cfg.frontend != "none" and cfg.n_enc_layers == 0:
        return seq_len - cfg.frontend_tokens
    return seq_len


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
