"""Fault-tolerant training loop, on torch tensors.

Counterpart of the JAX package's ``train/trainer.py``:
  * checkpoint every N steps (async, atomic) + checkpoint-on-SIGTERM
  * auto-resume from the latest complete checkpoint
  * step-time watchdog flags stragglers (slow steps)
  * optional int8 gradient compression (quantize -> dequantize)
  * microbatch gradient accumulation in float32, then divided by the
    number of microbatches, as the reference's ``lax.scan`` over float32
    zeros does

The step is eager: the parameters and the optimizer state are updated
in place (the reference donates them to its jitted step).  ``mesh`` (a
``DeviceMesh``, ``launch.mesh``) is kept for the caller, as the
reference keeps its mesh; a resume places the checkpoint on the
parameters' device.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.steps import value_and_grad
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import (
    compress_grads_int8, decompress_grads,
)
from repro_torch.train.optimizer import AdamW
from repro_torch.train.tree import leaves, tree_map


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    microbatches: int = 1
    grad_compression: bool = False
    straggler_factor: float = 3.0   # step slower than 3x median -> flag


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 optimizer: AdamW | None = None, mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt = optimizer or AdamW(
            state_dtype=cfg.optimizer_state_dtype)
        self.mesh = mesh
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self._stop = False
        self.step_times: list[float] = []
        self.stragglers: list[int] = []

    # ------------------------------------------------------------------
    def _train_step(self):
        """The step function ``(params, opt_state, batch) -> (params,
        opt_state, loss)``; ``batch`` holds tensors on the parameters'
        device."""
        opt, cfg, tcfg = self.opt, self.cfg, self.tcfg

        def step_fn(params, opt_state, batch):
            if tcfg.microbatches > 1:
                n = tcfg.microbatches
                mb = {k: v.reshape((n, -1) + tuple(v.shape[1:]))
                      for k, v in batch.items()}
                gsum = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
                lsum = 0.0
                for i in range(n):
                    loss_i, g = value_and_grad(
                        params, {k: v[i] for k, v in mb.items()}, cfg)
                    for acc, gi in zip(leaves(gsum), leaves(g)):
                        acc.add_(gi)
                    lsum = lsum + loss_i
                grads = tree_map(lambda g: g / n, gsum)
                loss = lsum / n
            else:
                loss, grads = value_and_grad(params, batch, cfg)
            if tcfg.grad_compression:
                grads = decompress_grads(compress_grads_int8(grads))
            params, opt_state = opt.update(params, grads, opt_state)
            return params, opt_state, loss

        return step_fn

    # ------------------------------------------------------------------
    def run(self, params, pipeline: TokenPipeline, start_step: int = 0,
            resume: bool = True):
        """Train from ``start_step`` (or the latest complete checkpoint)
        to ``total_steps``; returns ``(params, opt_state, losses)``, the
        losses as Python floats, one a step run here."""
        device = leaves(params)[0].device
        opt_state = self.opt.init(params)
        step = start_step
        if resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                step, state = self.ckpt.restore(latest, device=device)
                params, opt_state = state["params"], state["opt"]
                print(f"[trainer] resumed from step {step}")

        old = signal.signal(signal.SIGTERM, self._on_sigterm)
        step_fn = self._train_step()
        losses = []
        try:
            while step < self.tcfg.total_steps and not self._stop:
                t0 = time.time()
                batch = {
                    k: torch.from_numpy(v).to(device)
                    for k, v in pipeline.batch_at(step).items()
                }
                params, opt_state, loss = step_fn(params, opt_state, batch)
                loss = float(loss)
                dt = time.time() - t0
                self.step_times.append(dt)
                med = float(np.median(self.step_times))
                if (len(self.step_times) > 5
                        and dt > self.tcfg.straggler_factor * med):
                    # single-controller mitigation: record + keep going
                    self.stragglers.append(step)
                step += 1
                losses.append(loss)
                if step % self.tcfg.log_every == 0:
                    print(f"[trainer] step {step} loss {loss:.4f} "
                          f"({dt*1e3:.0f} ms)")
                if step % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(step, {"params": params,
                                          "opt": opt_state})
        finally:
            signal.signal(signal.SIGTERM, old)
        self.ckpt.save(step, {"params": params, "opt": opt_state},
                       block=True)
        self.ckpt.wait()
        return params, opt_state, losses

    def _on_sigterm(self, *_):
        print("[trainer] SIGTERM — checkpointing before exit")
        self._stop = True
