"""minicpm3-4b [dense+MLA]: 62L d=2560 40H ff=6400 v=73448.
Multi-head Latent Attention (q_lora 768, kv_lora 256, nope 64, rope 32).
[hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense", n_layers=62, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=6400, vocab=73448,
    attn="mla", mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                              qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
)

REDUCED = ModelConfig(
    name="minicpm3-4b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=160, vocab=512,
    attn="mla", mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8),
)
