"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (kv=8) ff=24576 v=65536,
Mamba+attention 1:7 interleave, MoE 16e top-2 every other layer.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert_ff=24576, every=2),
    attn_every=8, mamba_d_state=16, mamba_expand=2, mamba_d_conv=4,
    sliding_window=4096,   # long_500k: attention layers use SWA
    fsdp=True, optimizer_state_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="jamba-1.5-large-398b-smoke", family="hybrid", n_layers=4,
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert_ff=128, every=2),
    attn_every=4, mamba_d_state=8, mamba_expand=2, mamba_d_conv=4,
    sliding_window=64,
)
