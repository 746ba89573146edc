"""Architecture assembly of the LM zoo: init, decode cache and forward,
on torch tensors, for all ten architectures.

Counterpart of the JAX package's ``models/model.py``.  The parameters
keep that package's pytree: layers are grouped into a repeating pattern
of slots (period 1 for a homogeneous stack, 8 for jamba's and xlstm's
interleaves), and ``params["blocks"][s]`` holds slot ``s`` of every
repetition stacked on a leading axis, so layer ``r * len(pattern) + s``
is ``params["blocks"][s][...][r]``.  The reference scans over that
axis; here a Python loop runs over its ``unbind`` (views, no copy).
Whisper's encoder layers and the decoder's cross-attentions are lists,
one entry a layer, as there.

Entry points take an explicit ``device`` (the card by default; asking
for it without one raises) and an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.poly import resolve_device
from repro_torch.models import layers as L


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

def _init_layer(cfg: ModelConfig, spec: LayerSpec, reps: int, dtype,
                generator, device):
    """One layer slot of kind ``spec``, its ``reps`` repetitions stacked
    on a leading axis and drawn in place."""
    lead = (reps,)
    p = {"norm1": _norm_p(cfg, dtype, device, lead)}
    args = (cfg, dtype, generator, device, lead)
    if spec.mixer == "attn":
        p["attn"] = L.init_attention(*args)
    elif spec.mixer == "mla":
        p["attn"] = L.init_mla(*args)
    elif spec.mixer == "mamba":
        p["mamba"] = L.init_mamba(*args)
    elif spec.mixer == "mlstm":
        p["mlstm"] = L.init_mlstm(*args)
    elif spec.mixer == "slstm":
        p["slstm"] = L.init_slstm(*args)
    if spec.ffn != "none":
        p["norm2"] = _norm_p(cfg, dtype, device, lead)
        if spec.ffn == "moe":
            p["moe"] = L.init_moe(cfg.d_model, cfg.moe, cfg.mlp, dtype,
                                  generator, device, lead)
        else:
            p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                                  generator, device, cfg.bias, lead)
    return p


def _norm_p(cfg, dtype, device, lead=()):
    shape = tuple(lead) + (cfg.d_model,)
    p = {"w": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda"):
    """Random parameters of ``cfg`` on ``device``, in the JAX package's
    pytree (``embed``, ``final_norm``, ``blocks``, ``lm_head`` when the
    embeddings are not tied, and ``encoder`` / ``cross`` for an
    encoder-decoder), drawn from ``generator`` (a generator on
    ``device`` seeded with 0 if None).  Not the JAX package's values:
    the two generators differ, so tests carry weights across instead."""
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
    params["blocks"] = [_init_layer(cfg, spec, reps, dtype, generator, device)
                        for spec in pattern]
    if cfg.enc_dec:
        params["encoder"] = [
            {"norm1": _norm_p(cfg, dtype, device),
             "attn": L.init_attention(cfg, dtype, generator, device),
             "norm2": _norm_p(cfg, dtype, device),
             "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                               generator, device, cfg.bias)}
            for _ in range(cfg.n_enc_layers)]
        # one cross-attention a decoder layer
        params["cross"] = [
            {"norm": _norm_p(cfg, dtype, device),
             "attn": L.init_attention(cfg, dtype, generator, device)}
            for _ in range(cfg.n_layers)]
    return params


# ------------------------------ caches ------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda"):
    """Stacked per-slot caches for decode, matching ``layer_pattern``,
    with the reference's shapes and dtypes (``reps`` leads each):
    ``attn`` ``k``, ``v`` (batch, Sc, kv_heads, head_dim), Sc the window
    (a ring buffer) or ``max_seq``; ``mla`` ``c_kv`` (batch, max_seq,
    kv_lora_rank) and ``k_rope`` (batch, max_seq, 1, qk_rope_dim);
    ``mamba`` ``conv`` (batch, d_conv - 1, d_inner) in ``dtype`` and
    ``ssm`` (batch, d_inner, d_state) float32; ``mlstm`` ``C`` (batch,
    heads, hd, hd) and ``n`` (batch, heads, hd) float32; ``slstm`` ``h``
    (batch, d_model) in ``dtype`` and ``c`` float32.  ``idx`` is a
    Python int (the JAX package keeps a scalar array)."""
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg)
    f32 = torch.float32
    pattern, reps = layer_pattern(cfg)
    di = cfg.mamba_expand * cfg.d_model
    hd_i = di // cfg.n_heads
    # a ring buffer of the window when sliding-window attention is on and
    # the sequence outgrows it
    window = cfg.sliding_window if (cfg.sliding_window and
                                    max_seq > cfg.sliding_window) else 0

    def zeros(*shape, dt=dtype):
        return torch.zeros((reps, batch) + shape, dtype=dt, device=device)

    slots = []
    for spec in pattern:
        if spec.mixer == "attn":
            Sc = window or max_seq
            c = {"k": zeros(Sc, cfg.n_kv_heads, cfg.hd),
                 "v": zeros(Sc, cfg.n_kv_heads, cfg.hd)}
        elif spec.mixer == "mla":
            m = cfg.mla
            c = {"c_kv": zeros(max_seq, m.kv_lora_rank),
                 "k_rope": zeros(max_seq, 1, m.qk_rope_dim)}
        elif spec.mixer == "mamba":
            c = {"conv": zeros(cfg.mamba_d_conv - 1, di),
                 "ssm": zeros(di, cfg.mamba_d_state, dt=f32)}
        elif spec.mixer == "mlstm":
            c = {"C": zeros(cfg.n_heads, hd_i, hd_i, dt=f32),
                 "n": zeros(cfg.n_heads, hd_i, dt=f32)}
        else:  # slstm
            c = {"h": zeros(cfg.d_model), "c": zeros(cfg.d_model, dt=f32)}
        slots.append(c)
    return {"slots": slots, "idx": 0}


# ------------------------------ forward -----------------------------------

def _at(tree, r: int):
    """Repetition ``r`` of a stacked pytree (views)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


def _unstack(tree, reps: int) -> list:
    """Every repetition of a stacked pytree, as views: one ``unbind`` a
    leaf, whose backward stacks the layers' gradients once.  Indexing
    the leaf once a layer (``_at``) would give each layer's backward a
    zero-filled gradient of the whole stack to add: reps times the
    leaf's bytes, for every leaf."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, reps) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(reps)]
    return tree.unbind(0)


def _apply_layer(p, x, cfg, spec: LayerSpec, pos, cache, window):
    """One layer: ``cache`` is this layer's slot cache with ``idx``, or
    None for a full pass.  A decode step updates the cache in place."""
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    if spec.mixer == "attn":
        o, _ = L.attention(p["attn"], h, cfg, pos, cache, window)
    elif spec.mixer == "mla":
        o, _ = L.mla_attention(p["attn"], h, cfg, pos, cache)
    elif spec.mixer == "mamba":
        o, _ = L.mamba(p["mamba"], h, cfg, cache)
    elif spec.mixer == "mlstm":
        o, _ = L.mlstm(p["mlstm"], h, cfg, cache)
    else:
        o, _ = L.slstm(p["slstm"], h, cfg, cache)
    x = x + o
    if spec.ffn != "none":
        h2 = L.apply_norm(x, p["norm2"], cfg.norm)
        if spec.ffn == "moe":
            x = x + L.moe(p["moe"], h2, cfg.moe, cfg.mlp)
        else:
            x = x + L.mlp(p["mlp"], h2, cfg.mlp)
    return x


def _layer_cache(cache, s: int, r: int, idx):
    return None if cache is None else {**_at(cache["slots"][s], r),
                                       "idx": idx}


def _logits(params, x, cfg):
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    if L.partition.applies(x):
        return L.partition.head_logits(x, head)
    return (x @ head).float()


def forward(params, tokens, cfg: ModelConfig, positions=None, cache=None,
            embeds=None):
    """tokens: (B, S) integer.  cache=None -> full causal pass (prefill);
    cache -> one decode step (S == 1), which writes the step's keys,
    latents or states into the cache's tensors in place.  ``positions``:
    (B, S), or (3, B, S) under M-RoPE (by default the token's index,
    the same in all three streams).  ``embeds``: stub modality
    embeddings (B, n, d_model) that replace the first ``n`` token
    embeddings (vlm), or the encoder's input frames (audio).

    Returns (logits float32 (B, S, vocab), new cache or None).  The new
    cache holds the same tensors as ``cache`` and ``idx + 1``."""
    if cfg.enc_dec:
        return _forward_encdec(params, tokens, cfg, cache, embeds)
    B, S = tokens.shape
    dtype = dtype_of(cfg)
    x = L.embed(params["embed"], tokens, dtype)
    if embeds is not None:
        n_p = embeds.shape[1]
        x = torch.cat([embeds.to(dtype), x[:, n_p:]], 1)
    idx = None if cache is None else int(cache["idx"])
    if positions is None:
        base = (torch.arange(S, device=x.device) if cache is None
                else torch.full((S,), idx, device=x.device))
        positions = base[None].expand(B, S)
        if cfg.pos == "mrope":
            positions = positions[None].expand(3, B, S)
    if cfg.pos == "learned":
        # sinusoidal (shape-agnostic: Whisper's encoder convention)
        pos0 = (torch.arange(S, device=x.device) if cache is None
                else torch.full((1,), idx, device=x.device))
        x = x + _sinusoid(pos0, cfg.d_model, x.dtype)[None]

    pattern, reps = layer_pattern(cfg)
    window = _active_window(cfg, pattern, cache, S)
    layers = [_unstack(slot, reps) for slot in params["blocks"]]
    for r in range(reps):
        for s, spec in enumerate(pattern):
            x = _apply_layer(layers[s][r], x, cfg, spec,
                             positions, _layer_cache(cache, s, r, idx),
                             window if spec.mixer == "attn" else 0)
    new_cache = None
    if cache is not None:
        new_cache = {"slots": cache["slots"], "idx": idx + 1}
    return _logits(params, x, cfg), new_cache


def _sinusoid(pos, d: int, dtype):
    """(S,) -> (S, d) sinusoidal position embedding (shape-agnostic),
    computed in float32 as the reference does."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=pos.device) / max(half - 1, 1))
    ang = pos[:, None].float() * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _active_window(cfg: ModelConfig, pattern, cache, S: int) -> int:
    """Sliding-window attention is active when configured AND either the
    decode cache is window-sized (ring buffer) or a full pass exceeds the
    window.  The cache's size is read from the first attention slot."""
    if not cfg.sliding_window:
        return 0
    if cache is None:
        return cfg.sliding_window if S > cfg.sliding_window else 0
    for i, spec in enumerate(pattern):
        if spec.mixer == "attn" and "k" in cache["slots"][i]:
            sc = cache["slots"][i]["k"].shape[2]
            return cfg.sliding_window if sc == cfg.sliding_window else 0
    return 0


def _forward_encdec(params, tokens, cfg, cache, embeds):
    """Whisper: ``embeds`` (B, T_audio, d_model) are stub frame
    embeddings (zeros (B, 128, d_model) if None).  As in the reference,
    the encoder runs again at every decode step: there is no
    cross-attention cache."""
    dtype = dtype_of(cfg)
    B, S = tokens.shape
    dev = tokens.device
    if embeds is None:
        embeds = torch.zeros((B, 128, cfg.d_model), dtype=dtype, device=dev)
    Ta = embeds.shape[1]
    e = embeds.to(dtype) + _sinusoid(torch.arange(Ta, device=dev),
                                     cfg.d_model, dtype)[None]
    full = torch.ones((B, Ta, Ta), dtype=torch.bool, device=dev)
    for lp in params["encoder"]:
        h = L.apply_norm(e, lp["norm1"], cfg.norm)
        e = e + _bidir_attention(lp["attn"], h, cfg, full)
        e = e + L.mlp(lp["mlp"], L.apply_norm(e, lp["norm2"], cfg.norm),
                      cfg.mlp)

    x = L.embed(params["embed"], tokens, dtype)
    idx = None if cache is None else int(cache["idx"])
    pos0 = (torch.arange(S, device=dev) if cache is None
            else torch.full((1,), idx, device=dev))
    x = x + _sinusoid(pos0, cfg.d_model, dtype)[None]
    pattern, _ = layer_pattern(cfg)
    layers = _unstack(params["blocks"][0], cfg.n_layers)
    for i in range(cfg.n_layers):
        x = _apply_layer(layers[i], x, cfg, pattern[0],
                         None, _layer_cache(cache, 0, i, idx), 0)
        # cross-attention to the encoder's output
        cp = params["cross"][i]
        h = L.apply_norm(x, cp["norm"], cfg.norm)
        x = x + _cross_attention(cp["attn"], h, e, cfg)
    new_cache = None
    if cache is not None:
        new_cache = {"slots": cache["slots"], "idx": idx + 1}
    return _logits(params, x, cfg), new_cache


def _bidir_attention(p, x, cfg, mask):
    if L.partition.applies(x):
        return L.partition.cross_attention(p, x, x, cfg)
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    out = L._sdpa(q, k, v, mask)
    return out.reshape(B, S, H * hd) @ p["wo"]


def _cross_attention(p, x, enc, cfg):
    if L.partition.applies(x):
        return L.partition.cross_attention(p, x, enc, cfg)
    B, S, d = x.shape
    Ta = enc.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (enc @ p["wk"]).reshape(B, Ta, KV, hd)
    v = (enc @ p["wv"]).reshape(B, Ta, KV, hd)
    mask = torch.ones((B, S, Ta), dtype=torch.bool, device=x.device)
    out = L._sdpa(q, k, v, mask)
    return out.reshape(B, S, H * hd) @ p["wo"]


# --------------------------- sharding specs --------------------------------

def param_specs(cfg: ModelConfig, params=None):
    """Sharding spec tree mirroring ``init_params``: the JAX package's
    ``param_specs`` with each ``PartitionSpec`` as a plain tuple whose
    entries are ``None`` or a mesh axis name, one entry a dimension.

    'model' = tensor/expert parallel, 'data' = FSDP when cfg.fsdp.
    Stacked blocks get a leading None (rep) axis.  ``params`` only lends
    its leaves' ``ndim`` (shape-only trees from
    ``models.steps.param_shapes`` will do); by default that tree is
    built for ``cfg``.
    """
    f = "data" if cfg.fsdp else None

    def spec_for(path: str, ndim: int, stacked: bool):
        lead = (None,) if stacked else ()
        name = path.split("/")[-1]
        table = {
            "wq": (*lead, f, "model"), "wk": (*lead, f, "model"),
            "wv": (*lead, f, "model"), "wo": (*lead, "model", f),
            "bq": (*lead, "model"), "bk": (*lead, "model"),
            "bv": (*lead, "model"),
            "wq_a": (*lead, f, None), "wq_b": (*lead, None, "model"),
            "wkv_a": (*lead, f, None), "wkv_b": (*lead, None, "model"),
            "up": (*lead, f, "model"), "gate": (*lead, f, "model"),
            "down": (*lead, "model", f),
            "b_up": (*lead, "model"), "b_down": (*lead, None),
            "router": (*lead, None, None),
            "in_proj": (*lead, f, "model"),
            "conv_w": (*lead, None, "model"),
            "x_proj": (*lead, "model", None),
            "out_proj": (*lead, "model", f),
            "A_log": (*lead, "model", None), "D": (*lead, "model"),
            "dt_bias": (*lead, "model"),
            "w": (*lead, None) if ndim == 1 + len(lead)
            else (*lead, f, "model"),
            "r": (*lead, f, "model"),
            "b": (*lead, None),
            "q_norm": (*lead, None), "kv_norm": (*lead, None),
            "wif": (*lead, "model", None),
        }
        # MoE expert tensors carry a leading expert axis -> expert-parallel
        if name in ("up", "gate", "down") and ndim == 3 + len(lead):
            if cfg.expert_shard == "ff" and f:
                # FSDP axis on the expert HIDDEN dim: the dispatch product
                # contracts an unsharded d_model
                return {"up": (*lead, "model", None, f),
                        "gate": (*lead, "model", None, f),
                        "down": (*lead, "model", f, None)}[name]
            return {"up": (*lead, "model", f, None),
                    "gate": (*lead, "model", f, None),
                    "down": (*lead, "model", None, f)}[name]
        return table.get(name, (*lead, *([None] * (ndim - len(lead)))))

    if params is None:
        from repro_torch.models.steps import param_shapes

        params = param_shapes(cfg, device="cpu")

    def walk(tree, stacked, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, stacked, f"{prefix}/{k}") for k, v in
                    tree.items()}
        if isinstance(tree, list):
            return [walk(v, stacked, prefix) for v in tree]
        return spec_for(prefix, tree.ndim, stacked)

    out = {}
    for k, v in params.items():
        if k == "embed":
            out[k] = ("model", None)
        elif k == "lm_head":
            out[k] = (None, "model")
        elif k == "blocks":
            out[k] = [walk(b, True) for b in v]
        else:
            out[k] = walk(v, False)
    return out
