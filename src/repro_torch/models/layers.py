"""Model building blocks of the dense decoder family, on torch tensors.

Counterpart of the dense part of the JAX package's ``models/layers.py``:
norms, RoPE, grouped-query attention (prefill, decode, and the
sliding-window ring buffer) and the MLPs.  Parameters are plain dicts of
tensors with the JAX package's names and layouts (``wq`` is
``(d_model, heads * head_dim)``, and so on), so that weights carry
across as they are (``convert.lm_params_from_numpy``).

Dtypes follow the reference: weights and activations in the config's
dtype (bf16 by default), norms, softmax and logits in float32, and RoPE's
cos/sin cast to the activation dtype.  The matrix products are
``torch.matmul`` / ``torch.einsum``, as the reference leaves them to XLA:
the LM zoo has no Pallas kernel.

MLA, MoE, Mamba and the xLSTM blocks are not ported yet (ROADMAP A6).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def rms_norm(x, w, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def layer_norm(x, w, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def apply_norm(x, p, kind):
    if kind == "rmsnorm":
        return rms_norm(x, p["w"])
    return layer_norm(x, p["w"], p["b"])


# ------------------------------ RoPE -------------------------------------

def _rope_cos_sin(pos, rot_dim, theta, dtype):
    """pos: (..., S) int -> cos/sin (..., S, rot_dim/2).

    The angles are float32, as the reference computes them with JAX's
    64-bit mode off."""
    inv = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float64,
                                        device=pos.device) / rot_dim))
    ang = pos[..., None].float() * inv.float()
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, pos, rope_pct=1.0, theta=10000.0, mrope_sections=None):
    """x: (B, S, H, hd); pos: (B, S) or (3, B, S) for M-RoPE."""
    hd = x.shape[-1]
    rot = int(hd * rope_pct) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    if mrope_sections is not None:
        # M-RoPE: split the rotary dim into (t, h, w) sections, each with
        # its own position stream (identical streams for text tokens).
        cos_parts, sin_parts = [], []
        start = 0
        for i, sec in enumerate(mrope_sections):
            c, s = _rope_cos_sin(pos[i], rot, theta, x.dtype)
            cos_parts.append(c[..., start // 2:(start + sec) // 2])
            sin_parts.append(s[..., start // 2:(start + sec) // 2])
            start += sec
        cos = torch.cat(cos_parts, -1)
        sin = torch.cat(sin_parts, -1)
    else:
        cos, sin = _rope_cos_sin(pos, rot, theta, x.dtype)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
    xrot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([xrot, xp], -1) if rot < hd else xrot


def mrope_sections(rot_dim):
    """(t, h, w) rotary sections -- Qwen2-VL convention (16/24/24 scaled)."""
    t = rot_dim // 4 * 2
    rem = rot_dim - t
    h = rem // 2 // 2 * 2
    return (t, h, rot_dim - t - h)


# --------------------------- dense attention -----------------------------

def _normal(shape, std, dtype, generator, device):
    """N(0, std^2) samples of ``dtype``, drawn from ``generator``."""
    out = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return out.mul_(std)


def init_attention(cfg: ModelConfig, dtype, generator, device, lead=()):
    """Attention weights; ``lead`` is a leading shape (the stacked
    repetitions of a layer slot)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lead = tuple(lead)
    std = d ** -0.5
    p = {
        "wq": _normal(lead + (d, H * hd), std, dtype, generator, device),
        "wk": _normal(lead + (d, KV * hd), std, dtype, generator, device),
        "wv": _normal(lead + (d, KV * hd), std, dtype, generator, device),
        "wo": _normal(lead + (H * hd, d), std, dtype, generator, device),
    }
    if cfg.bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype, device=device)
    return p


def _sdpa(q, k, v, mask):
    """q: (B,Sq,H,hd); k/v: (B,Sk,KV,hd) -- GQA via head grouping."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    q = q.reshape(B, Sq, KV, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
    logits = logits / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    w = torch.softmax(logits, -1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def attention(p, x, cfg: ModelConfig, pos, cache=None, window=0):
    """Returns (out, new_cache).

    Without a cache: causal (optionally windowed) self-attention over the
    whole sequence; the new cache is this pass's keys and values.  With
    ``cache = {"k", "v": (B, Sc, KV, hd), "idx": int}``: one decode step
    (S == 1) that writes its key and value into the cache's tensors IN
    PLACE at ``idx`` (``idx % Sc`` in a sliding-window ring buffer) and
    attends to the filled slots; the new cache holds the same tensors and
    ``idx + 1``."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    sections = mrope_sections(int(hd * cfg.rope_pct)) \
        if cfg.pos == "mrope" else None
    if cfg.pos in ("rope", "mrope"):
        q = apply_rope(q, pos, cfg.rope_pct, cfg.rope_theta, sections)
        k = apply_rope(k, pos, cfg.rope_pct, cfg.rope_theta, sections)

    if cache is None:
        ar = torch.arange(S, device=x.device)
        mask = ar[:, None] >= ar[None, :]
        if window:
            mask &= ar[:, None] - ar[None, :] < window
        out = _sdpa(q, k, v, mask[None].expand(B, S, S))
        new_cache = {"k": k, "v": v}
    else:
        if S != 1:
            raise ValueError(f"a decode step takes one token, got {S}")
        ck, cv = cache["k"], cache["v"]
        Sc = ck.shape[1]
        idx = int(cache["idx"])
        slot = idx % Sc if window else idx
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        ar = torch.arange(Sc, device=x.device)
        valid = ar < min(idx + 1, Sc) if window else ar <= idx
        mask = valid[None, None, :].expand(B, 1, Sc)
        out = _sdpa(q, ck, cv, mask)
        new_cache = {"k": ck, "v": cv, "idx": idx + 1}
    return out.reshape(B, S, H * hd) @ p["wo"], new_cache


# ------------------------------- MLPs ------------------------------------

def init_mlp(d, d_ff, kind, dtype, generator, device, bias=False, lead=()):
    lead = tuple(lead)
    std = d ** -0.5
    p = {"up": _normal(lead + (d, d_ff), std, dtype, generator, device),
         "down": _normal(lead + (d_ff, d), d_ff ** -0.5, dtype, generator,
                         device)}
    if kind == "swiglu":
        p["gate"] = _normal(lead + (d, d_ff), std, dtype, generator, device)
    if bias:
        p["b_up"] = torch.zeros(lead + (d_ff,), dtype=dtype, device=device)
        p["b_down"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


def mlp(p, x, kind):
    """SwiGLU (which, as in the reference, has no up bias) or GELU (tanh
    approximation, JAX's default)."""
    if kind == "swiglu":
        h = F.silu(x @ p["gate"]) * (x @ p["up"])
    else:
        h = x @ p["up"]
        if "b_up" in p:
            h = h + p["b_up"]
        h = F.gelu(h, approximate="tanh")
    out = h @ p["down"]
    if "b_down" in p:
        out = out + p["b_down"]
    return out
