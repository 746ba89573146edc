"""AdamW on pytrees of torch tensors, with dtype-configurable moments.

Counterpart of the JAX package's ``train/optimizer.py``, with its
arithmetic: the global-norm clip over all leaves in float32, the linear
warmup ``lr * min(step / warmup, 1)``, bias corrections ``1 - b^step``
in float32, ``delta = mhat / (sqrt(vhat) + eps) + wd * p``, moments
stored in ``state_dtype`` (bf16 for arctic and jamba) and parameters
cast back to their own dtype.  ``step`` is an int32 scalar tensor.

Unlike the reference's functional update, ``update`` writes the
parameters and moments IN PLACE (the counterpart of the reference
trainer's ``donate_argnums=(0, 1)``), a leaf at a time, and a leaf of
more than ``CHUNK`` elements a slice of its leading axis at a time, so
that its float32 temporaries stay small.  The arithmetic is elementwise,
so the slices give the whole leaf's result.  Every scalar (the norm, the
learning rate, the corrections) stays a tensor on the parameters'
device: an update has no host sync.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.train.tree import leaves, tree_map

# elements of a leaf's slice in one update pass
CHUNK = 1 << 24


def chunks(t: torch.Tensor) -> list[torch.Tensor]:
    """``t`` whole, or views of slices of its leading axis of about
    CHUNK elements each."""
    if t.ndim == 0 or t.numel() <= CHUNK:
        return [t]
    rows = max(1, CHUNK // (t.numel() // t.shape[0]))
    return list(t.split(rows, 0))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over the leaves (in ``jax.tree.leaves`` order) of
    each leaf's float32 sum of squares, as a float32 scalar tensor."""
    total = None
    for g in leaves(grads):
        s = None
        for c in chunks(g):
            part = torch.square(c.float()).sum()
            s = part if s is None else s + part
        total = s if total is None else total + s
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100

    def init(self, params) -> dict:
        """Zero moments in ``state_dtype`` beside each parameter, and
        step 0 (int32) on the first parameter's device."""
        dt = getattr(torch, self.state_dtype)

        def zeros(p):
            return torch.zeros(p.shape, dtype=dt, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves(params)[0].device)}

    def _schedule(self, step):
        warm = torch.clamp_max(step.float() / self.warmup_steps, 1.0)
        return self.lr * warm

    @torch.no_grad()
    def update(self, params, grads, state):
        """One AdamW step; returns ``(params, state)``, the same trees,
        updated in place (``state["step"]`` too)."""
        step = state["step"]
        step.add_(1)
        gnorm = global_norm(grads)
        scale = torch.clamp_max(self.grad_clip / (gnorm + 1e-9), 1.0)
        lr = self._schedule(step)
        b1c = 1 - torch.pow(self.b1, step.float())
        b2c = 1 - torch.pow(self.b2, step.float())
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["m"]), leaves(state["v"])):
            for pc, gc, mc, vc in zip(chunks(p), chunks(g), chunks(m),
                                      chunks(v)):
                g32 = gc.float() * scale
                m32 = self.b1 * mc.float() + (1 - self.b1) * g32
                v32 = self.b2 * vc.float() + (1 - self.b2) * g32 * g32
                mhat = m32 / b1c
                vhat = v32 / b2c
                p32 = pc.float()
                delta = mhat / (torch.sqrt(vhat) + self.eps) \
                    + self.weight_decay * p32
                pc.copy_(p32 - lr * delta)
                mc.copy_(m32)
                vc.copy_(v32)
        return params, state
