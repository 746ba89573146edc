"""Token data pipeline: deterministic, shardable, restartable.

The port's own copy of the JAX package's ``data/pipeline.py`` (pure
numpy: the port imports nothing of that package).  Synthetic corpus by
default (structured enough that a small LM's loss visibly decreases);
file-backed mode memory-maps a token array.  The iterator state is one
integer (step), so checkpoint/resume is exact.  Batches are numpy
int32 arrays; the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: str | None = None      # memory-mapped token file (int32)


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self._tokens = None
        if cfg.path:
            self._tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Deterministic batch for a global step (restart-exact)."""
        c = self.cfg
        if self._tokens is not None:
            n = len(self._tokens) - c.seq_len - 1
            rng = np.random.default_rng(c.seed + step)
            starts = rng.integers(0, n, c.global_batch)
            toks = np.stack([
                self._tokens[s : s + c.seq_len + 1] for s in starts
            ])
        else:
            toks = self._synthetic(step)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def _synthetic(self, step: int) -> np.ndarray:
        """Structured synthetic stream: arithmetic token sequences with
        noise — learnable next-token structure."""
        c = self.cfg
        rng = np.random.default_rng(c.seed + step)
        B, S = c.global_batch, c.seq_len + 1
        start = rng.integers(0, c.vocab, (B, 1))
        stride = rng.integers(1, 7, (B, 1))
        seq = (start + stride * np.arange(S)[None, :]) % c.vocab
        noise = rng.random((B, S)) < 0.05
        seq = np.where(noise, rng.integers(0, c.vocab, (B, S)), seq)
        return seq
