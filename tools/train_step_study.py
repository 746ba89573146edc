"""Measure what the backward of the stacked layer leaves costs in the
LM training step on the card, beyond ``chip_smoke.py``'s ``lm_train``.

    python3 tools/train_step_study.py [--arch stablelm_3b] [--layers N]

Needs a CUDA card.  Random bf16 weights of the architecture at full
width (cut to ``--layers`` layers if given), ``TokenPipeline`` batch 8,
sequence 128 (``launch/train.py``'s defaults), TF32 off.  Prints one
JSON line with the card's name and power limit: ``value_and_grad``
(forward and backward) with the stacked layer leaves unbound once a
forward (``models/model._unstack``, the port's way), against the same
leaves indexed once a layer (``model._at``), whose backward gives every
layer a zero-filled gradient of the whole stack to add; in turns
(unbind, index, index, unbind), each the median of 3 calls ending in a
synchronize; the gradients of the two held equal.  The parts of the
whole step are in ``chip_smoke.py``'s ``lm_train`` line
(``step_breakdown_ms``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PEAK_BF16_FLOPS = 989e12


def _ms(fn, reps: int = 3) -> float:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def _indexed(tree, reps: int) -> list:
    from repro_torch.models.model import _at

    return [_at(tree, r) for r in range(reps)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_step_study: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models import model
    from repro_torch.models.model import init_params
    from repro_torch.models.steps import value_and_grad
    from repro_torch.train.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    n = sum(t.numel() for t in leaves(params))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenPipeline(
        PipelineConfig(vocab=cfg.vocab, seq_len=128, global_batch=8))
        .batch_at(0).items()}
    unbind = model._unstack
    held = {}

    def grads(kind: str):
        model._unstack = unbind if kind == "unbind" else _indexed
        try:
            held.pop(kind, None)
            held[kind] = value_and_grad(params, batch, cfg)[1]
        finally:
            model._unstack = unbind

    grads("unbind")             # warm-up
    times = {"unbind": [], "index": []}
    for kind in ("unbind", "index", "index", "unbind"):
        times[kind].append(_ms(lambda: grads(kind)))
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(leaves(held["unbind"]),
                                leaves(held["index"])))
    flops = 6 * n * 8 * 128
    print(json.dumps({"study": "stacking", "card": smi, "arch": cfg.name,
                      "n_layers": cfg.n_layers, "n_params": n,
                      "value_and_grad_ms": times,
                      "grad_max_abs_diff": worst,
                      "flop_bound_ms": flops / PEAK_BF16_FLOPS * 1e3}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
