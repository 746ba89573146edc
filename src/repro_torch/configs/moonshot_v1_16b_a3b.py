"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H expert-ff=1408 v=163840,
64 experts top-6 (kimi/moonlight).  [hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert_ff=1408),
)

REDUCED = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=96, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=96),
)
