"""xlstm-1.3b [ssm]: 48L d=2048 4H v=50304, d_ff=0 (projection blocks).
mLSTM blocks (chunkwise-parallel matrix memory) with one sLSTM block per 8.
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    attn="none", pos="none", slstm_every=8, mamba_expand=2,
)

REDUCED = ModelConfig(
    name="xlstm-1.3b-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=2, n_kv_heads=2, d_ff=0, vocab=512,
    attn="none", pos="none", slstm_every=2, mamba_expand=2,
)
