"""arctic-480b [moe]: 35L d=7168 56H (kv=8) expert-ff=4864 v=32000,
128 experts top-2 + dense residual FFN.  [hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_expert_ff=4864,
                  dense_residual_ff=4864),
    fsdp=True, optimizer_state_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="arctic-480b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=96,
                  dense_residual_ff=96),
)
