"""Architecture config registry: one module per assigned architecture.

The port's own copy of the JAX package's ``configs/`` (the schema and
the ten architectures' ``CONFIG`` and ``REDUCED``), so that the port
imports nothing of that package; ``shapes.py`` holds the dry run's
input shapes.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig  # noqa: F401


def _module(arch: str):
    import importlib

    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}")


def get_config(arch: str):
    return _module(arch).CONFIG


def reduced_config(arch: str):
    return _module(arch).REDUCED


ARCHS = [
    "stablelm_3b", "minicpm3_4b", "phi3_medium_14b", "command_r_35b",
    "arctic_480b", "moonshot_v1_16b_a3b", "jamba_1_5_large_398b",
    "qwen2_vl_2b", "xlstm_1_3b", "whisper_base",
]
