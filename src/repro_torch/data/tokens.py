"""Synthetic LM data for the assigned-architecture training paths:
Zipf-distributed token streams with local n-gram structure (so loss
actually decreases), plus the stub-frontend embedding generators for the
VLM / audio carve-out.

A copy of the JAX package's ``data/tokens.py``: numpy throughout, so the
same ``RandomState`` gives the same batches bit for bit
(``tests/test_torch_lm_train.py`` holds them equal).  The training step
moves them to the device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, InputShape


def token_stream(rng: np.random.RandomState, n: int, vocab: int,
                 alpha: float = 1.1) -> np.ndarray:
    """Zipf tokens with a copy-back process for learnable structure."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    toks = rng.choice(vocab, size=n, p=p)
    # 30% of positions copy the token 2 back (bigram-ish structure)
    copy = rng.rand(n) < 0.3
    copy[:2] = False
    toks[copy] = toks[np.nonzero(copy)[0] - 2]
    return toks.astype(np.int32)


def lm_batch(rng: np.random.RandomState, cfg: ArchConfig, batch: int,
             seq: int) -> Dict[str, np.ndarray]:
    """One LM batch: tokens + next-token labels (+ stub-frontend embeds)."""
    text_len = seq
    if cfg.frontend != "none" and cfg.n_enc_layers == 0:
        text_len = seq - cfg.frontend_tokens
    stream = token_stream(rng, batch * (text_len + 1), cfg.vocab_size)
    arr = stream.reshape(batch, text_len + 1)
    out: Dict[str, np.ndarray] = {
        "tokens": arr[:, :-1],
        "labels": arr[:, 1:].astype(np.int32),
    }
    if cfg.frontend != "none" and cfg.n_enc_layers == 0:
        out["frontend_embeds"] = frontend_embeds(rng, cfg, batch)
    if cfg.n_enc_layers:
        out["enc_embeds"] = frontend_embeds(rng, cfg, batch)
    return out


def frontend_embeds(rng: np.random.RandomState, cfg: ArchConfig,
                    batch: int) -> np.ndarray:
    """Stub modality frontend: pre-computed patch/frame embeddings of the
    documented shape (the one allowed carve-out).  Smooth over positions so
    they look like real features, not white noise."""
    F, d = cfg.frontend_tokens, cfg.d_model
    z = rng.randn(batch, F, d).astype(np.float32)
    # local smoothing over the position axis (conv-feature-like)
    z = 0.5 * z + 0.25 * np.roll(z, 1, axis=1) + 0.25 * np.roll(z, -1, axis=1)
    return (z * 0.02).astype(np.float32)


def data_iterator(cfg: ArchConfig, shape: InputShape, seed: int = 0,
                  batch_override: Optional[int] = None
                  ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.RandomState(seed)
    b = batch_override or shape.global_batch
    while True:
        yield lm_batch(rng, cfg, b, shape.seq_len)
