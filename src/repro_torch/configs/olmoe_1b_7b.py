"""OLMoE-1B-7B — 64 experts, top-8. [arXiv:2409.02060]"""
from repro_torch.configs.base import FFN_MOE, ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    ffn_kind=FFN_MOE,
    ffn_act="swiglu",
    moe=MoEConfig(n_experts=64, top_k=8),
    sliding_window=8192,
    fed_mode="A",
    compute_dtype="bfloat16",
    citation="arXiv:2409.02060",
)
