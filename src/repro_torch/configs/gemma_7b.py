"""Gemma-7B — GeGLU, head_dim=256. [arXiv:2403.08295]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    head_dim=256,
    vocab_size=256000,
    ffn_act="geglu",
    tie_embeddings=True,
    sliding_window=8192,
    fed_mode="A",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="arXiv:2403.08295",
)
