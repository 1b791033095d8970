"""Architecture registry (``get_arch(name)`` / ``--arch <id>``) and the
config dataclasses; a copy of the JAX package's ``configs/__init__.py``."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (
    gemma_7b,
    granite_moe_3b_a800m,
    hymba_1_5b,
    llama3_405b,
    llava_next_mistral_7b,
    olmoe_1b_7b,
    phi3_medium_14b,
    seamless_m4t_medium,
    smollm_360m,
    xlstm_1_3b,
)
from repro_torch.configs.base import (
    ATTN,
    FFN_DENSE,
    FFN_MOE,
    FFN_NONE,
    HYMBA,
    INPUT_SHAPES,
    MAMBA,
    MLSTM,
    SLSTM,
    SWA,
    ArchConfig,
    FedConfig,
    InputShape,
    MoEConfig,
)
from repro_torch.configs.forecast import MLP_H1, MLP_H24, ForecastConfig

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        xlstm_1_3b.CONFIG,
        smollm_360m.CONFIG,
        granite_moe_3b_a800m.CONFIG,
        llama3_405b.CONFIG,
        llava_next_mistral_7b.CONFIG,
        hymba_1_5b.CONFIG,
        seamless_m4t_medium.CONFIG,
        olmoe_1b_7b.CONFIG,
        gemma_7b.CONFIG,
        phi3_medium_14b.CONFIG,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced variant of the same family for CPU smoke tests:
    2 layers, d_model<=512, <=4 experts, small vocab."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, max(1, n_heads // 2))
    while n_heads % n_kv:
        n_kv -= 1
    head_dim = 64 if cfg.head_dim else 0
    pattern = cfg.pattern()[:1] + cfg.pattern()[-1:] if cfg.block_pattern else ()
    if pattern and len(set(pattern)) == 1:
        # ensure the smoke variant still exercises both xLSTM block kinds
        kinds = sorted(set(cfg.pattern()))
        pattern = tuple(kinds[:2]) if len(kinds) > 1 else pattern
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(n_experts=4, top_k=2, capacity_factor=cfg.moe.capacity_factor)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        block_pattern=pattern,
        moe=moe,
        mlstm_heads=min(cfg.mlstm_heads, 4) if cfg.mlstm_heads else 0,
        frontend_tokens=min(cfg.frontend_tokens, 16),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )


def scale_cfg(name: str, scale: str) -> ArchConfig:
    """A copy of ``examples/federated_lm_training.py``'s ``scale_cfg``:
    the smoke variant of ``name``, or at ``scale="100m"`` the same widened
    to 8 layers, d 512, 8/4 heads, d_ff 2048, vocab 8192 (f32, head dim
    64, no remat: what ``reduce_for_smoke`` sets stays).  Field for field
    the example's; a family with a ``block_pattern`` keeps the smoke
    variant's two entries, so its ``pattern()`` fails at 8 layers, in the
    example as here."""
    cfg = reduce_for_smoke(ARCHS[name])
    if scale == "100m":
        cfg = dataclasses.replace(
            cfg, name=cfg.name.replace("smoke", "100m"), n_layers=8,
            d_model=512, n_heads=8, n_kv_heads=4, d_ff=2048,
            vocab_size=8192)
    return cfg


__all__ = [
    "ARCHS", "get_arch", "reduce_for_smoke", "scale_cfg", "ArchConfig", "FedConfig",
    "InputShape", "INPUT_SHAPES", "MoEConfig", "ForecastConfig",
    "MLP_H1", "MLP_H24",
    "ATTN", "SWA", "MAMBA", "MLSTM", "SLSTM", "HYMBA",
    "FFN_DENSE", "FFN_MOE", "FFN_NONE",
]
