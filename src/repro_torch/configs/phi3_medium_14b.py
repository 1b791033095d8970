"""Phi-3-medium 14B — RoPE, SwiGLU, GQA. [arXiv:2404.14219]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    ffn_act="swiglu",
    sliding_window=8192,
    fed_mode="B",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="arXiv:2404.14219",
)
