"""Step builders for serving (the port of the JAX package's
``launch/steps.py``, prefill and decode bodies only; shardings and the
training step come with the placement slice)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tr
from repro_torch.models.layers import lm_logits


def make_prefill_step(cfg: ArchConfig):
    """prefill_step(params, inputs) -> logits (B, vocab_pad) of the last
    position: the prompt runs through the whole model (B4 in every
    attention layer, B6 once per 128-token chunk in every Mamba layer,
    an MoE FFN's routing over all B * S tokens at once, so its capacity
    is the whole prompt's) and only the final position meets the LM
    head.  The MoE aux loss is dropped, as in the reference."""

    def prefill_step(params, inputs):
        x, _ = tr.forward(params, inputs, cfg)
        return lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]

    return prefill_step


def make_decode_step(cfg: ArchConfig, window: int = 0):
    """serve_step(params, state, tokens (B, 1), step) -> (logits, state):
    one token for the whole batch against the cache (B5 in every
    attention layer; a Mamba layer's one-step update and an MoE FFN over
    the B tokens, whose capacity of at least 8 slots drops nothing for
    B <= 8, run no kernel of the port)."""

    def serve_step(params, state, tokens, step):
        return tr.decode_step(params, state, tokens, step, cfg,
                              window=window)

    return serve_step
