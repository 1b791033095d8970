"""LLaVA-NeXT (Mistral-7B backbone) — anyres tiling vision frontend (stubbed).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

The ViT/SigLIP encoder + projector is a stub: ``input_specs`` provides
pre-computed patch embeddings. anyres: base tile (24x24=576 patches) + 4
high-res tiles = 2880 image positions interleaved before the text tokens.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    ffn_act="swiglu",
    frontend="vision",
    frontend_tokens=2880,   # 5 anyres tiles x 576 patches
    sliding_window=8192,
    fed_mode="B",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
