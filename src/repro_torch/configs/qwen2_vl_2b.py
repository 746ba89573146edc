"""qwen2-vl-2b [vlm]: 28L d=1536 12H (kv=2) ff=8960 v=151936.
M-RoPE (3-section temporal/height/width), dynamic-resolution vision
frontend is a STUB (input_specs provides patch embeddings).
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936,
    pos="mrope", frontend="vision", bias=True,
)

REDUCED = ModelConfig(
    name="qwen2-vl-2b-smoke", family="vlm", n_layers=2, d_model=48,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    pos="mrope", frontend="vision", bias=True,
)
