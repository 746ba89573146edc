"""Gradient compression for the data-parallel all-reduce.

Counterpart of the JAX package's ``train/compression.py``: int8
per-tensor-scaled quantization (4x less traffic at under 0.5% relative
error per tensor, no error feedback).  ``torch.round`` rounds half to
even, as ``jnp.round`` does, so ``q`` and ``scale`` equal the
reference's.  On one card nothing is reduced: the quantize ->
dequantize pair is what the trainer applies.
"""
from __future__ import annotations

import torch

from repro_torch.train.tree import tree_map


def compress_grads_int8(grads):
    """Each leaf -> ``{"q": int8, "scale": float32 scalar}``."""
    def comp(g):
        g32 = g.float()
        scale = torch.clamp_min(g32.abs().max(), 1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}

    return tree_map(comp, grads)


def decompress_grads(comp):
    """The float32 gradients of ``compress_grads_int8``'s output."""
    return tree_map(lambda c: c["q"].float() * c["scale"], comp,
                    is_leaf=lambda x: isinstance(x, dict) and "q" in x)
