"""SmolLM-360M — llama-architecture small dense LM. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    ffn_act="swiglu",
    tie_embeddings=True,
    sliding_window=8192,   # long_500k serving variant only
    fed_mode="A",
    citation="hf:HuggingFaceTB/SmolLM-135M",
)
