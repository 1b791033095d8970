"""Hymba-1.5B — parallel attention + mamba heads in every block. [arXiv:2411.13676]"""
from repro_torch.configs.base import HYMBA, ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    block_kind=HYMBA,
    ffn_act="swiglu",
    ssm_state=16,
    sliding_window=2048,   # Hymba uses SWA in most layers; used for long decode
    fed_mode="A",
    compute_dtype="bfloat16",
    citation="arXiv:2411.13676",
)
