"""xLSTM-1.3B — sLSTM + mLSTM blocks, no FFN (d_ff=0). [arXiv:2405.04517]"""
from repro_torch.configs.base import FFN_NONE, MLSTM, SLSTM, ArchConfig

# xLSTM[7:1]: one sLSTM block per 8 layers, the rest mLSTM.
_PATTERN = tuple(SLSTM if (i % 8 == 7) else MLSTM for i in range(48))

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_PATTERN,
    ffn_kind=FFN_NONE,
    mlstm_heads=4,
    tie_embeddings=False,
    fed_mode="A",
    compute_dtype="bfloat16",
    citation="arXiv:2405.04517",
)
