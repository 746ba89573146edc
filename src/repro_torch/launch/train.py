"""Training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \
      [--reduced --device cpu] --steps 100 --batch 8 --seq 128

Counterpart of the JAX package's ``launch/train.py``, with its flags,
for any of the ten architectures.  Runs on the card unless ``--device
cpu`` is given; ``--reduced`` takes the architecture's smoke config.
Weights are random, seeded with 0.  Checkpoints and resume come from
``repro_torch.train.trainer``; ``--ckpt-dir`` defaults to a directory
under the system's temporary directory.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.poly import resolve_device
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models.model import init_params
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    print(f"[train] {cfg.name}: ~{cfg.n_params()/1e6:.1f}M params")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    pipe = TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    trainer = Trainer(cfg, tcfg, AdamW(lr=1e-3, warmup_steps=20))
    params, _, losses = trainer.run(params, pipe,
                                    resume=not args.no_resume)
    n = max(len(losses) // 10, 1)
    print(f"[train] loss {np.mean(losses[:n]):.4f} -> "
          f"{np.mean(losses[-n:]):.4f} over {len(losses)} steps")
    if trainer.stragglers:
        print(f"[train] straggler steps flagged: {trainer.stragglers}")
    return losses


if __name__ == "__main__":
    main()
