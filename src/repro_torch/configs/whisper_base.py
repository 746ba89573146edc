"""whisper-base [audio]: 6L enc + 6L dec, d=512 8H ff=2048 v=51865.
Enc-dec; conv audio frontend is a STUB (input_specs provides mel-frame
embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
    enc_dec=True, n_enc_layers=6, frontend="audio",
    pos="learned", mlp="gelu", norm="layernorm", bias=True,
)

REDUCED = ModelConfig(
    name="whisper-base-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    enc_dec=True, n_enc_layers=2, frontend="audio",
    pos="learned", mlp="gelu", norm="layernorm", bias=True,
)
