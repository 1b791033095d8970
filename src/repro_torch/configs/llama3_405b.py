"""Llama-3 405B — GQA, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    ffn_act="swiglu",
    rope_theta=500_000.0,
    sliding_window=8192,
    fed_mode="B",          # per-client replicas infeasible; pod-silo BAFDP
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="arXiv:2407.21783",
)
