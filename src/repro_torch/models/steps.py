"""Serve-step builders: one decode step, one prefill.

Counterpart of ``make_serve_step`` and ``make_prefill_step`` of the JAX
package's ``models/steps.py``.  ``loss_fn`` and ``make_train_step`` wait
for the training slice (ROADMAP A6h); the dry-run's input specs are not
ported.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, batch):
        """One greedy decode step: batch["tokens"] is (B, 1).  Returns the
        next tokens (B,) int32 and the new cache."""
        with torch.no_grad():
            logits, cache = forward(
                params, batch["tokens"], cfg,
                positions=batch.get("positions"), cache=cache,
                embeds=batch.get("embeds"),
            )
        next_tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        return next_tok, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        """The last position's logits (B, vocab) of a full forward."""
        with torch.no_grad():
            logits, _ = forward(
                params, batch["tokens"], cfg,
                positions=batch.get("positions"),
                embeds=batch.get("embeds"),
            )
        return logits[:, -1]

    return prefill_step
