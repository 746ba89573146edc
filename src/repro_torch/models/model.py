"""Architecture assembly of the dense decoder family: init, decode cache
and forward, on torch tensors.

Counterpart of the decoder-only part of the JAX package's
``models/model.py``.  The parameters keep that package's pytree: layers
are grouped into a repeating pattern of slots (period 1 for a dense
stack), and ``params["blocks"][s]`` holds slot ``s`` of every repetition
stacked on a leading axis, so layer ``r * len(pattern) + s`` is
``params["blocks"][s][...][r]``.  The reference scans over that axis;
here a Python loop indexes it (a view, no copy).

Entry points take an explicit ``device`` (the card by default; asking
for it without one raises) and an explicit ``torch.Generator``.  Families
and mixers not ported yet raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.poly import resolve_device
from repro_torch.models import layers as L

# what is not ported yet, and where ROADMAP.md queues it
UNPORTED = {
    "mla": "MLA attention (minicpm3): ROADMAP A6b",
    "moe": "the MoE FFN (arctic, moonshot): ROADMAP A6c",
    "hybrid": "the hybrid Mamba/attention stack (jamba): ROADMAP A6d",
    "ssm": "the xLSTM blocks (xlstm): ROADMAP A6e",
    "vlm": "M-RoPE and stub embeddings (qwen2-vl): ROADMAP A6f",
    "enc_dec": "the encoder-decoder forward (whisper): ROADMAP A6g",
}


def check_ported(cfg: ModelConfig, embeds=None) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense decoder
    with (partial) RoPE, GQA and a dense FFN."""
    what = None
    if cfg.enc_dec:
        what = "enc_dec"
    elif cfg.family == "ssm" or cfg.attn == "none":
        what = "ssm"
    elif cfg.attn_every:
        what = "hybrid"
    elif cfg.attn == "mla":
        what = "mla"
    elif cfg.moe:
        what = "moe"
    elif cfg.pos not in ("rope", "none") or embeds is not None:
        what = "vlm"
    if what:
        raise NotImplementedError(f"{cfg.name}: {UNPORTED[what]}")


# --------------------------- layer pattern -------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str   # attn | mla | mamba | mlstm | slstm
    ffn: str     # dense | moe | none


def layer_pattern(cfg: ModelConfig) -> tuple[list[LayerSpec], int]:
    """(pattern, n_reps) with n_layers == len(pattern) * n_reps."""
    specs = []
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            mixer = ("slstm" if cfg.slstm_every and
                     i % cfg.slstm_every == cfg.slstm_every - 1 else "mlstm")
            ffn = "none"
        elif cfg.attn_every:
            mixer = ("attn" if i % cfg.attn_every == cfg.attn_every - 1
                     else "mamba")
            ffn = ("moe" if cfg.moe and i % cfg.moe.every == 0 else "dense")
        else:
            mixer = cfg.attn if cfg.attn in ("mla",) else "attn"
            ffn = ("moe" if cfg.moe and i % cfg.moe.every == 0 else "dense")
        specs.append(LayerSpec(mixer, ffn))
    # smallest period
    for period in range(1, cfg.n_layers + 1):
        if cfg.n_layers % period == 0 and all(
            specs[i] == specs[i % period] for i in range(cfg.n_layers)
        ):
            return specs[:period], cfg.n_layers // period
    return specs, 1


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------ init --------------------------------------

def _init_layer(cfg: ModelConfig, reps: int, dtype, generator, device):
    """One attention + dense FFN layer slot (the only kind ported), its
    ``reps`` repetitions stacked on a leading axis and drawn in place."""
    lead = (reps,)
    return {"norm1": _norm_p(cfg, dtype, device, lead),
            "attn": L.init_attention(cfg, dtype, generator, device, lead),
            "norm2": _norm_p(cfg, dtype, device, lead),
            "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                              generator, device, cfg.bias, lead)}


def _norm_p(cfg, dtype, device, lead=()):
    shape = tuple(lead) + (cfg.d_model,)
    p = {"w": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda"):
    """Random parameters of ``cfg`` on ``device``, in the JAX package's
    pytree (``embed``, ``final_norm``, ``blocks``, and ``lm_head`` when
    the embeddings are not tied), drawn from ``generator`` (a generator
    on ``device`` seeded with 0 if None).  Not the JAX package's values:
    the two generators differ, so tests carry weights across instead."""
    check_ported(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = dtype_of(cfg)
    pattern, reps = layer_pattern(cfg)
    params = {
        "embed": L._normal((cfg.vocab, cfg.d_model), 0.02, dtype, generator,
                           device),
        "final_norm": _norm_p(cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal((cfg.d_model, cfg.vocab), 0.02, dtype,
                                      generator, device)
    params["blocks"] = [_init_layer(cfg, reps, dtype, generator, device)
                        for _ in pattern]
    return params


# ------------------------------ caches ------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda"):
    """Stacked per-slot caches for decode, matching ``layer_pattern``:
    ``{"slots": [{"k", "v": (reps, batch, Sc, kv_heads, head_dim)}],
    "idx": 0}``, Sc the window or ``max_seq``.  ``idx`` is a Python int
    (the JAX package keeps a scalar array)."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg)
    pattern, reps = layer_pattern(cfg)
    # a ring buffer of the window when sliding-window attention is on and
    # the sequence outgrows it
    window = cfg.sliding_window if (cfg.sliding_window and
                                    max_seq > cfg.sliding_window) else 0
    Sc = window or max_seq
    shape = (reps, batch, Sc, cfg.n_kv_heads, cfg.hd)
    slots = [{"k": torch.zeros(shape, dtype=dtype, device=device),
              "v": torch.zeros(shape, dtype=dtype, device=device)}
             for _ in pattern]
    return {"slots": slots, "idx": 0}


# ------------------------------ forward -----------------------------------

def _at(tree, r: int):
    """Repetition ``r`` of a stacked pytree (views)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


def _apply_layer(p, x, cfg, pos, cache, window):
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    o, _ = L.attention(p["attn"], h, cfg, pos, cache, window)
    x = x + o
    h2 = L.apply_norm(x, p["norm2"], cfg.norm)
    return x + L.mlp(p["mlp"], h2, cfg.mlp)


def forward(params, tokens, cfg: ModelConfig, positions=None, cache=None,
            embeds=None):
    """tokens: (B, S) integer.  cache=None -> full causal pass (prefill);
    cache -> one decode step (S == 1), which writes the step's keys and
    values into the cache's tensors in place.

    Returns (logits float32 (B, S, vocab), new cache or None).  The new
    cache holds the same tensors as ``cache`` and ``idx + 1``."""
    check_ported(cfg, embeds)
    B, S = tokens.shape
    dtype = dtype_of(cfg)
    x = params["embed"][tokens].to(dtype)
    idx = None if cache is None else int(cache["idx"])
    if positions is None:
        base = (torch.arange(S, device=x.device) if cache is None
                else torch.full((S,), idx, device=x.device))
        positions = base[None].expand(B, S)

    pattern, reps = layer_pattern(cfg)
    window = _active_window(cfg, cache, S)
    for r in range(reps):
        for s in range(len(pattern)):
            c = (None if cache is None
                 else {**_at(cache["slots"][s], r), "idx": idx})
            x = _apply_layer(_at(params["blocks"][s], r), x, cfg, positions,
                             c, window)
    new_cache = None
    if cache is not None:
        new_cache = {"slots": cache["slots"], "idx": idx + 1}

    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    logits = (x @ head).float()
    return logits, new_cache


def _active_window(cfg: ModelConfig, cache, S: int) -> int:
    """Sliding-window attention is active when configured AND either the
    decode cache is window-sized (ring buffer) or a full pass exceeds the
    window."""
    if not cfg.sliding_window:
        return 0
    if cache is None:
        return cfg.sliding_window if S > cfg.sliding_window else 0
    sc = cache["slots"][0]["k"].shape[2]
    return cfg.sliding_window if sc == cfg.sliding_window else 0
