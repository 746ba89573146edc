"""stablelm-3b [dense]: 32L d=2560 32H (kv=32, MHA) ff=6912 v=50304.
Partial rotary (25%) per the StableLM-2 family.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912, vocab=50304,
    pos="rope", rope_pct=0.25, mlp="swiglu", norm="layernorm", bias=True,
)

REDUCED = ModelConfig(
    name="stablelm-3b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=160, vocab=512,
    pos="rope", rope_pct=0.25, mlp="swiglu", norm="layernorm", bias=True,
)
