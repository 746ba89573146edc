"""Assigned input shapes and per-arch applicability (the dry run's cells).

  train_4k     seq 4096,   global_batch 256   (training)
  prefill_32k  seq 32768,  global_batch 32    (inference prefill)
  decode_32k   seq 32768,  global_batch 128   (decode: 1 new token, KV=32k)
  long_500k    seq 524288, global_batch 1     (long-context decode)

long_500k requires sub-quadratic attention: only the hybrid (jamba: Mamba
state + sliding-window attention) and SSM (xlstm: recurrent state) archs
run it; the eight pure full-attention archs skip it (DESIGN.md
§Arch-applicability).  Encoder-only archs would skip decode shapes; none
were assigned (whisper is enc-dec and keeps a decoder KV cache).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SUBQUADRATIC = {"jamba_1_5_large_398b", "xlstm_1_3b"}


def shapes_for(arch: str) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in SUBQUADRATIC:
        out.append("long_500k")
    return out


def skipped_shapes(arch: str) -> list[str]:
    return [] if arch in SUBQUADRATIC else ["long_500k"]


# Reduced shapes for CPU smoke tests.
SMOKE_SHAPES = {
    "train": ShapeSpec("smoke_train", 32, 4, "train"),
    "decode": ShapeSpec("smoke_decode", 64, 2, "decode"),
}
