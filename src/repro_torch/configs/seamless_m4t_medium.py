"""SeamlessM4T-medium — encoder-decoder, multimodal (audio frontend stubbed).
[arXiv:2308.11596]

The mel-spectrogram + conv feature extractor is a stub: ``input_specs``
provides pre-computed frame embeddings (1500 frames ~ 30 s of audio).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,            # decoder layers
    n_enc_layers=12,        # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    ffn_act="gelu",
    frontend="audio",
    frontend_tokens=1500,
    sliding_window=8192,
    fed_mode="A",
    citation="arXiv:2308.11596",
)
