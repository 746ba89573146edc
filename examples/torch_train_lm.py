"""End-to-end training on the PyTorch/CUDA port: a language model
trained for a few hundred steps with checkpointing and resume, as
``examples/train_lm.py`` does in the JAX package, on the port's
``Trainer``.

The default is a reduced stablelm-3b; ``--large`` takes a ~100M
parameter stablelm-family config.  Checkpoints go to ``--ckpt-dir``
(required), and a second run with the same directory resumes from its
latest checkpoint.  Weights are random, drawn from a generator seeded
with 0; the batches are the deterministic synthetic stream of
``repro_torch.data.pipeline``.  Runs on ``--device`` (the card by
default; asking for it without one raises).

Run: PYTHONPATH=src python examples/torch_train_lm.py --ckpt-dir DIR \\
         [--large] [--steps 200] [--device cpu]
"""
import argparse
import dataclasses

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
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoint directory (resumed from if it holds one)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 64, or 512 with --large)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cpu: no card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.large:
        # ~100M params: stablelm family scaled down
        cfg = dataclasses.replace(
            get_config("stablelm_3b"), n_layers=8, d_model=768,
            n_heads=12, n_kv_heads=12, d_ff=2048, vocab=32768)
        seq, batch = 512, 8
    else:
        cfg = reduced_config("stablelm_3b")
        seq, batch = 64, 8
    seq = args.seq or seq
    print(f"model: {cfg.n_params()/1e6:.1f}M params on {device.type}")

    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                        global_batch=batch))
    tr = Trainer(cfg, TrainerConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every,
                                    ckpt_dir=args.ckpt_dir, log_every=20),
                 AdamW(lr=1e-3, warmup_steps=20))
    _, _, losses = tr.run(params, pipe, resume=True)
    if losses:
        n = min(10, len(losses))
        print(f"loss: {np.mean(losses[:n]):.3f} -> "
              f"{np.mean(losses[-n:]):.3f} over {len(losses)} steps")
    else:
        print(f"nothing to run: the checkpoint is at step {args.steps}")
    return losses


if __name__ == "__main__":
    main()
