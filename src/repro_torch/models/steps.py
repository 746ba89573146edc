"""Train- and serve-step builders.

Counterpart of ``loss_fn``, ``make_train_step``, ``make_serve_step`` and
``make_prefill_step`` of the JAX package's ``models/steps.py``, and of
the dry run's shape-only stand-ins (``input_specs``, ``cache_specs``,
``param_shapes``): where the reference calls ``jax.eval_shape``, these
build the same trees under a ``FakeTensorMode``, which allocates
nothing.

Gradients come from plain autograd, where the reference takes
``jax.value_and_grad``: ``value_and_grad`` marks the parameter leaves
``requires_grad`` for one forward and ``torch.autograd.grad``, and then
restores their flags.  Each gradient keeps its leaf's dtype (bf16 for a
bf16 leaf, float32 for the float32 router, ``A_log``, ``D``, ``dt_bias``
and ``wif``), as the reference's do.

On DTensors (the dry run) the loss over the vocabulary and the greedy
pick run as ``models.partition`` partitions them, and each gradient is
brought to its parameter's placements once (``partition.sync_grad``).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.models import partition
from repro_torch.models.model import forward, init_cache, init_params
from repro_torch.train.tree import leaves, unflatten_like


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross-entropy over the positions whose label is
    >= 0, as a float32 scalar tensor.  ``cfg.ce_impl`` picks the full
    log-softmax (``"softmax"``) or logsumexp and a gather (``"gather"``),
    as in the reference."""
    logits, _ = forward(
        params, batch["tokens"], cfg,
        positions=batch.get("positions"),
        embeds=batch.get("embeds"),
    )
    labels = batch["labels"].long()
    if partition.applies(logits):
        ll = partition.token_log_likelihood(logits, labels, cfg.ce_impl)
    else:
        ll = log_likelihood(logits, labels, cfg.ce_impl)
    mask = (labels >= 0).float()
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def log_likelihood(logits, labels, ce_impl: str):
    """Each position's log-probability of its label (float32 (B, S)); a
    masked label (< 0) picks column 0, and ``loss_fn`` weights it 0."""
    picked_at = labels.clamp_min(0)[..., None]
    if ce_impl == "softmax":      # baseline: full (B,S,V) log-softmax
        logp = torch.log_softmax(logits, -1)
        return logp.gather(-1, picked_at)[..., 0]
    # logsumexp + gather: no (B, S, V) log-softmax array
    lse = torch.logsumexp(logits, -1)
    return logits.gather(-1, picked_at)[..., 0] - lse


def value_and_grad(params, batch, cfg: ModelConfig):
    """(loss, grads): ``loss_fn`` and its gradient with respect to every
    parameter leaf, a tree of ``params``' structure (zeros for a leaf
    the loss does not reach)."""
    flat = leaves(params)
    flags = [t.requires_grad for t in flat]
    for t in flat:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for t, flag in zip(flat, flags):
            t.requires_grad_(flag)
    grads = [torch.zeros_like(t) if g is None else partition.sync_grad(g, t)
             for t, g in zip(flat, grads)]
    return loss.detach(), unflatten_like(params, grads)


def make_train_step(cfg: ModelConfig, optimizer):
    """optimizer: ``repro_torch.train.optimizer.AdamW``-like (init /
    update).  The step updates ``params`` and ``opt_state`` in place and
    returns them with the loss (a float32 scalar tensor)."""

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch, cfg)
        params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    return train_step


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
        if partition.applies(logits):
            next_tok = partition.greedy_tokens(logits[:, -1])
        else:
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


# ------------------------- input specs (dry-run) --------------------------

def batch_specs(cfg: ModelConfig, sh: ShapeSpec, device="cuda",
                fake_mode: FakeTensorMode | None = None) -> dict:
    """Shape-only batch of ``cfg`` at shape ``sh``: fake tensors of
    ``fake_mode`` (a new one if None) on ``device``, with the
    reference's shapes.  Tokens and labels of a training batch are
    int32 (``data.pipeline``'s), the tokens of a prefill or decode step
    int64 (``launch.serve``'s), M-RoPE positions int64 (what
    ``forward`` builds itself), stub vision / audio embeds bf16."""
    B, S = sh.global_batch, sh.seq_len
    i32, i64 = torch.int32, torch.int64
    with fake_mode or FakeTensorMode():
        def sds(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device)

        out: dict = {}
        if sh.kind == "train":
            out["tokens"] = sds((B, S), i32)
            out["labels"] = sds((B, S), i32)
        elif sh.kind == "prefill":
            out["tokens"] = sds((B, S), i64)
        else:  # decode: one new token against an S-long cache
            out["tokens"] = sds((B, 1), i64)
        if cfg.pos == "mrope":
            ps = (B, S) if sh.kind != "decode" else (B, 1)
            out["positions"] = sds((3,) + ps, i64)
        if cfg.frontend == "vision" and sh.kind != "decode":
            n_patch = min(256, S // 2)
            out["embeds"] = sds((B, n_patch, cfg.d_model), torch.bfloat16)
        if cfg.frontend == "audio":
            t_audio = min(1500, S)
            out["embeds"] = sds((B, t_audio, cfg.d_model), torch.bfloat16)
    return out


def input_specs(arch: str, shape_name: str, device="cuda",
                fake_mode: FakeTensorMode | None = None) -> dict:
    """Shape-only stand-ins for one (arch x shape) cell
    (``batch_specs``)."""
    return batch_specs(get_config(arch), SHAPES[shape_name], device,
                       fake_mode)


def cache_specs(arch: str, shape_name: str, device="cuda",
                fake_mode: FakeTensorMode | None = None):
    """Shape-only decode cache of one cell (``init_cache`` under a
    fake mode)."""
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    with fake_mode or FakeTensorMode():
        return init_cache(cfg, sh.global_batch, sh.seq_len, device=device)


def param_shapes(cfg: ModelConfig, device="cuda",
                 fake_mode: FakeTensorMode | None = None):
    """Shape-only parameter tree of ``cfg`` (``init_params`` under a
    fake mode): the full width of any architecture in no memory."""
    with fake_mode or FakeTensorMode():
        return init_params(cfg, device=device)
