"""Granite-3.0 MoE 3B-a800m — 40 experts, top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import FFN_MOE, ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    ffn_kind=FFN_MOE,
    ffn_act="swiglu",
    moe=MoEConfig(n_experts=40, top_k=8),
    sliding_window=8192,
    fed_mode="A",
    compute_dtype="bfloat16",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
