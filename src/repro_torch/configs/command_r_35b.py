"""command-r-35b [dense]: 40L d=8192 64H (kv=8) ff=22528 v=256000.
GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22528, vocab=256000,
    bias=False, fsdp=True,
)

REDUCED = ModelConfig(
    name="command-r-35b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=8, n_kv_heads=2, d_ff=160, vocab=512,
)
