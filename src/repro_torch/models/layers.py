"""Model building blocks of the LM zoo, on torch tensors.

Counterpart of the JAX package's ``models/layers.py``: norms, RoPE
(full, partial and M-RoPE), grouped-query attention (prefill, decode,
and the sliding-window ring buffer), MLA with its latent cache, the
MLPs, the sort-based top-k MoE, the Mamba selective SSM, and the xLSTM
blocks (mLSTM, sLSTM).  Parameters are plain dicts of tensors with the
JAX package's names and layouts (``wq`` is ``(d_model, heads *
head_dim)``, and so on), so that weights carry across as they are
(``convert.lm_params_from_numpy``).

Dtypes follow the reference: weights and activations in the config's
dtype (bf16 by default), norms, softmax, logits, the router, the SSM and
xLSTM states and gates in float32, and RoPE's cos/sin cast to the
activation dtype.  The matrix products are ``torch.matmul`` /
``torch.einsum``, as the reference leaves them to XLA: the LM zoo has no
Pallas kernel.

A decode step (``cache`` given, one token) writes its keys, latents or
recurrent states into the cache's tensors IN PLACE and returns them, so
that a step has no data-dependent shape and no host sync, and can be
captured in a CUDA graph.

On DTensors (the dry run) the embedding lookup, attention, MLA, the MLP,
the MoE, Mamba and the mLSTM and sLSTM blocks run as
``models.partition`` partitions them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import partition


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


def embed(table, tokens, dtype):
    """Rows ``tokens`` of the embedding ``table``, cast to ``dtype``."""
    if partition.applies(table):
        return partition.embed_lookup(table, tokens, dtype)
    return table[tokens].to(dtype)


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


def attn_logits(q, k, mask):
    """Scaled float32 logits (B, KV, g, Sq, Sk) of queries q (B, Sq, H,
    hd) against keys k (B, Sk, KV, hd), query head h reading key head
    h // g; -1e30 where ``mask`` (broadcast to (B, Sq, Sk)) is False."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    q = q.reshape(B, Sq, KV, H // KV, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
    logits = logits / math.sqrt(hd)
    return torch.where(mask[:, None, None, :, :], logits, -1e30)


def attn_values(w, v):
    """Attention weights w (B, KV, g, Sq, Sk) applied to values v (B, Sk,
    KV, vd): (B, Sq, KV * g, vd)."""
    B, KV, g, Sq, _ = w.shape
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, Sq, KV * g, v.shape[-1])


def _sdpa(q, k, v, mask):
    """q: (B,Sq,H,hd); k/v: (B,Sk,KV,hd) -- GQA via head grouping."""
    return attn_values(torch.softmax(attn_logits(q, k, mask), -1), v)


def rope_qk(q, k, pos_q, pos_k, cfg: ModelConfig):
    """RoPE (or M-RoPE) of queries and keys at their positions, as
    ``cfg.pos`` asks; unchanged otherwise."""
    if cfg.pos not in ("rope", "mrope"):
        return q, k
    sections = mrope_sections(int(cfg.hd * cfg.rope_pct)) \
        if cfg.pos == "mrope" else None
    return (apply_rope(q, pos_q, cfg.rope_pct, cfg.rope_theta, sections),
            apply_rope(k, pos_k, cfg.rope_pct, cfg.rope_theta, sections))


def causal_mask(q_idx, Sk: int, window: int = 0):
    """(len(q_idx), Sk): the query at position ``q_idx[i]`` sees keys
    0..q_idx[i], the last ``window`` of them when ``window`` > 0."""
    ki = torch.arange(Sk, device=q_idx.device)
    mask = q_idx[:, None] >= ki[None, :]
    if window:
        mask &= q_idx[:, None] - ki[None, :] < window
    return mask


def cache_slot(idx: int, Sc: int, window: int) -> int:
    """The cache slot a decode step at ``idx`` writes (a ring buffer
    when ``window``)."""
    return idx % Sc if window else idx


def cache_valid(slots, idx: int, Sc: int, window: int):
    """Which of cache slots ``slots`` a decode step at ``idx`` reads."""
    return slots < min(idx + 1, Sc) if window else slots <= idx


def attention(p, x, cfg: ModelConfig, pos, cache=None, window=0):
    """Returns (out, new_cache).

    Without a cache: causal (optionally windowed) self-attention over the
    whole sequence; the new cache is this pass's keys and values.  With
    ``cache = {"k", "v": (B, Sc, KV, hd), "idx": int}``: one decode step
    (S == 1) that writes its key and value into the cache's tensors IN
    PLACE at ``idx`` (``idx % Sc`` in a sliding-window ring buffer) and
    attends to the filled slots; the new cache holds the same tensors and
    ``idx + 1``."""
    if partition.applies(x):
        return partition.attention(p, x, cfg, pos, cache, window)
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
    q, k = rope_qk(q, k, pos, pos, cfg)

    if cache is None:
        mask = causal_mask(torch.arange(S, device=x.device), S, window)
        out = _sdpa(q, k, v, mask[None].expand(B, S, S))
        new_cache = {"k": k, "v": v}
    else:
        if S != 1:
            raise ValueError(f"a decode step takes one token, got {S}")
        ck, cv = cache["k"], cache["v"]
        Sc = ck.shape[1]
        idx = int(cache["idx"])
        slot = cache_slot(idx, Sc, window)
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        valid = cache_valid(torch.arange(Sc, device=x.device), idx, Sc,
                            window)
        mask = valid[None, None, :].expand(B, 1, Sc)
        out = _sdpa(q, ck, cv, mask)
        new_cache = {"k": ck, "v": cv, "idx": idx + 1}
    return out.reshape(B, S, H * hd) @ p["wo"], new_cache


# ------------------------------- MLA -------------------------------------

def init_mla(cfg: ModelConfig, dtype, generator, device, lead=()):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    lead = tuple(lead)
    std = d ** -0.5
    qk = m.qk_nope_dim + m.qk_rope_dim

    def w(*shape):
        return _normal(lead + shape, std, dtype, generator, device)

    return {
        "wq_a": w(d, m.q_lora_rank),
        "wq_b": w(m.q_lora_rank, H * qk),
        "wkv_a": w(d, m.kv_lora_rank + m.qk_rope_dim),
        "wkv_b": w(m.kv_lora_rank, H * (m.qk_nope_dim + m.v_head_dim)),
        "wo": w(H * m.v_head_dim, d),
        "q_norm": torch.ones(lead + (m.q_lora_rank,), dtype=dtype,
                             device=device),
        "kv_norm": torch.ones(lead + (m.kv_lora_rank,), dtype=dtype,
                              device=device),
    }


def mla_attention(p, x, cfg: ModelConfig, pos, cache=None):
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek style).

    The cache holds only the compressed latent ``c_kv`` (B, Sc,
    kv_lora_rank) and the shared rope key ``k_rope`` (B, Sc, 1,
    qk_rope_dim); a decode step writes both at ``idx`` in place and
    attends to slots ``0..idx``."""
    if partition.applies(x):
        return partition.mla_attention(p, x, cfg, pos, cache)
    m = cfg.mla
    B, S, d = x.shape
    H = cfg.n_heads
    nope = m.qk_nope_dim

    qa, c_kv, k_rope = mla_latents(p, x, m)
    q = (qa @ p["wq_b"]).reshape(B, S, H, nope + m.qk_rope_dim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, pos, 1.0, cfg.rope_theta)
    k_rope = apply_rope(k_rope, pos, 1.0, cfg.rope_theta)

    if cache is None:
        new_cache = {"c_kv": c_kv, "k_rope": k_rope}
        mask = causal_mask(torch.arange(S, device=x.device), S)
        mask = mask[None].expand(B, S, S)
    else:
        if S != 1:
            raise ValueError(f"a decode step takes one token, got {S}")
        idx = int(cache["idx"])
        cache["c_kv"][:, idx] = c_kv[:, 0]
        cache["k_rope"][:, idx] = k_rope[:, 0]
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        Sk = c_kv.shape[1]
        valid = torch.arange(Sk, device=x.device) <= idx
        mask = valid[None, None, :].expand(B, 1, Sk)
        new_cache = {"c_kv": c_kv, "k_rope": k_rope, "idx": idx + 1}

    k, v = mla_keys(c_kv, k_rope, p["wkv_b"], m)
    out = _sdpa(torch.cat([q_nope, q_rope], -1), k, v, mask)
    return out.reshape(B, S, H * m.v_head_dim) @ p["wo"], new_cache


def mla_latents(p, x, m):
    """MLA's latents of ``x``: the query's ``rms_norm(x @ wq_a)``, and
    the cached ``c_kv`` and (not yet rotated) ``k_rope``."""
    B, S, _ = x.shape
    qa = rms_norm(x @ p["wq_a"], p["q_norm"])
    kv_a = x @ p["wkv_a"]
    c_kv = rms_norm(kv_a[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = kv_a[..., m.kv_lora_rank:].reshape(B, S, 1, m.qk_rope_dim)
    return qa, c_kv, k_rope


def mla_keys(c_kv, k_rope, wkv_b, m):
    """Keys and values of the heads whose columns ``wkv_b`` holds, from
    the latents ``c_kv`` (B, Sk, rank) and the rotated ``k_rope``."""
    B, Sk = c_kv.shape[:2]
    nope = m.qk_nope_dim
    kv = (c_kv @ wkv_b).reshape(B, Sk, -1, nope + m.v_head_dim)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(B, Sk, kv.shape[2],
                                         m.qk_rope_dim)], -1)
    return k, v


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
    if partition.applies(x):
        return partition.mlp(p, x, kind)
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


# ------------------------------- MoE --------------------------------------

def init_moe(d, mo: MoEConfig, kind, dtype, generator, device, lead=()):
    lead = tuple(lead)
    E, f = mo.n_experts, mo.d_expert_ff
    std = d ** -0.5
    p = {
        "router": _normal(lead + (d, E), std, torch.float32, generator,
                          device),
        "up": _normal(lead + (E, d, f), std, dtype, generator, device),
        "gate": _normal(lead + (E, d, f), std, dtype, generator, device),
        "down": _normal(lead + (E, f, d), f ** -0.5, dtype, generator,
                        device),
    }
    if mo.dense_residual_ff:
        p["dense"] = init_mlp(d, mo.dense_residual_ff, kind, dtype,
                              generator, device, lead=lead)
    return p


def moe_route(router, xt, mo: MoEConfig, n_tokens: int | None = None,
              before=None) -> dict:
    """Top-k routing of ``xt`` (T, d) with static capacity.

    The router is float32; the gates are the top-k softmax probabilities
    renormalised.  The (token, choice) pairs are sorted by expert with a
    STABLE sort, so within an expert the earlier pair keeps its slot and
    the pairs past ``cap`` are dropped, as with the reference's
    ``jnp.argsort``.  Returns ``gates``, ``eidx`` (T, k); ``order``,
    ``sorted_e``, ``slot``, ``keep``, ``tok`` (T*k,) in sorted order,
    ``slot`` being the pair's place in its expert's buffer (``cap - 1``
    for a dropped pair); and ``cap``, the static slots per expert, in
    Python floats as the reference computes it.  No host sync, no
    data-dependent shape.  ``xt`` may be one shard of a batch of
    ``n_tokens`` rows, whose capacity then holds, and ``before(counts)``
    the pairs per expert of the shards ahead of it (their slots come
    first)."""
    T = xt.shape[0]
    E, k = mo.n_experts, mo.top_k
    probs = torch.softmax(xt.float() @ router, -1)
    gates, eidx = torch.topk(probs, k, -1)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = max(int(math.ceil((n_tokens or T) * k / E * mo.capacity_factor)),
              1)
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(E, dtype=flat_e.dtype, device=xt.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    if before is not None:
        starts = starts - before(counts)
    pos = torch.arange(T * k, device=xt.device) - starts[sorted_e]
    keep = pos < cap
    return {"gates": gates, "eidx": eidx, "order": order,
            "sorted_e": sorted_e, "slot": torch.where(keep, pos, cap - 1),
            "keep": keep, "tok": order // k, "cap": cap}


def moe_experts(p, xt, r: dict, e0: int = 0):
    """(T, d): each kept pair's output from its expert, weighted by its
    gate and added to its token.  ``p`` holds experts e0, e0 + 1, ...
    (all of them by default); pairs routed elsewhere add nothing."""
    El = p["up"].shape[0]
    le = r["sorted_e"] - e0
    mine = r["keep"] & (le >= 0) & (le < El)
    le = torch.where(mine, le, 0)
    slot, tok = r["slot"], r["tok"]
    d = xt.shape[-1]
    buf = torch.zeros((El, r["cap"], d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((le, slot), torch.where(mine[:, None], xt[tok], 0),
                   accumulate=True)
    h = F.silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    out_e = torch.bmm(h, p["down"])                        # (El, cap, d)
    y_flat = torch.where(mine[:, None], out_e[le, slot], 0)
    gate_flat = r["gates"].reshape(-1)[r["order"]]
    return torch.zeros_like(xt).index_put_(
        (tok,), y_flat * gate_flat[:, None].to(xt.dtype), accumulate=True)


def moe(p, x, mo: MoEConfig, kind):
    """Sort-based top-k dispatch with static capacity.

    x: (B, S, d) -> (B, S, d).  The kept pairs are scattered into an
    (E, cap, d) buffer (a dropped pair adds zero at slot ``cap - 1``),
    every expert runs its SwiGLU on its ``cap`` rows, and each pair's
    output, weighted by its gate, is added back to its token."""
    if partition.applies(x):
        return partition.moe(p, x, mo, kind)
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    y = moe_experts(p, xt, moe_route(p["router"], xt, mo)).reshape(B, S, d)
    if "dense" in p:
        y = y + mlp(p["dense"], x, kind)
    return y


# ------------------------------- Mamba ------------------------------------

def init_mamba(cfg: ModelConfig, dtype, generator, device, lead=()):
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    lead = tuple(lead)
    std = d ** -0.5
    f32 = torch.float32
    a_log = torch.log(torch.arange(1, ds + 1, dtype=f32, device=device))
    return {
        "in_proj": _normal(lead + (d, 2 * di), std, dtype, generator, device),
        "conv_w": _normal(lead + (dc, di), 0.1, dtype, generator, device),
        "x_proj": _normal(lead + (di, ds * 2 + 1), std, dtype, generator,
                          device),
        "dt_bias": torch.zeros(lead + (di,), dtype=f32, device=device),
        "A_log": a_log.expand(lead + (di, ds)).clone(),
        "D": torch.ones(lead + (di,), dtype=f32, device=device),
        "out_proj": _normal(lead + (di, d), std, dtype, generator, device),
    }


def mamba(p, x, cfg: ModelConfig, cache=None):
    """Selective SSM (Mamba-1 style).

    The recurrence h_t = a_t * h_{t-1} + b_t runs in float32: over the
    sequence by a sequential loop (the reference uses an associative
    scan, which multiplies in another order: equal within float32
    rounding), or one step from the cache's ``ssm`` (B, di, ds) and
    ``conv`` (B, dc - 1, di) states, both updated in place."""
    if partition.applies(x):
        return partition.mamba(p, x, cfg, cache)
    B, S, d = x.shape
    di = cfg.mamba_expand * d
    if cache is not None and S != 1:
        raise ValueError(f"a decode step takes one token, got {S}")
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    u = mamba_conv(xi, p["conv_w"], None if cache is None else cache["conv"])
    y = mamba_scan(p, u, z, u @ p["x_proj"], cfg.mamba_d_state,
                   None if cache is None else cache["ssm"])
    new_cache = None if cache is None else {
        "conv": cache["conv"], "ssm": cache["ssm"],
        "idx": int(cache["idx"]) + 1}
    return y @ p["out_proj"], new_cache


def mamba_conv(xi, conv_w, state=None):
    """SiLU of the causal depthwise convolution of ``xi`` (B, S, di) with
    ``conv_w`` (dc, di) over the sequence: zero history, or the decode
    state ``state`` (B, dc - 1, di), which is updated in place."""
    B, S, di = xi.shape
    dc = conv_w.shape[0]
    if state is None:
        pad = torch.zeros((B, dc - 1, di), dtype=xi.dtype, device=xi.device)
        hist = torch.cat([pad, xi], 1)
    else:
        hist = torch.cat([state, xi], 1)                   # (B, dc, di)
        state.copy_(hist[:, 1:])
    return F.silu(sum(hist[:, i:i + S] * conv_w[i] for i in range(dc)))


def mamba_scan(p, u, z, proj, ds: int, state=None):
    """The selective scan of ``u`` (B, S, di) gated by ``z``: ``proj`` =
    ``u @ x_proj`` holds B (ds), C (ds) and dt (1); ``p`` the per-channel
    ``dt_bias``, ``A_log`` and ``D`` of ``u``'s channels.  Over the
    sequence from a zero state, or one step from ``state`` (B, di, ds),
    updated in place.  Returns the gated output (B, S, di) in ``z``'s
    dtype."""
    dt = F.softplus(proj[..., -1:].float() + p["dt_bias"])
    Bm = proj[..., :ds].float()                            # (B, S, ds)
    Cm = proj[..., ds:2 * ds].float()
    A = -torch.exp(p["A_log"])                             # (di, ds)
    a = torch.exp(dt[..., None] * A)                       # (B, S, di, ds)
    b = (dt[..., None] * Bm[:, :, None, :]) * u.float()[..., None]
    if state is None:
        h = torch.zeros_like(b[:, 0])
        hs = []
        for t in range(u.shape[1]):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        hh = torch.stack(hs, 1)
    else:
        hh = a * state[:, None] + b
        state.copy_(hh[:, -1])
    y = torch.einsum("bsdn,bsn->bsd", hh, Cm)
    y = y + u.float() * p["D"]
    return y.to(z.dtype) * F.silu(z)


# ------------------------------- xLSTM ------------------------------------

def init_mlstm(cfg: ModelConfig, dtype, generator, device, lead=()):
    d = cfg.d_model
    di = cfg.mamba_expand * d
    H = cfg.n_heads
    lead = tuple(lead)
    std, si = d ** -0.5, di ** -0.5
    return {
        "up": _normal(lead + (d, 2 * di), std, dtype, generator, device),
        "wq": _normal(lead + (di, di), si, dtype, generator, device),
        "wk": _normal(lead + (di, di), si, dtype, generator, device),
        "wv": _normal(lead + (di, di), si, dtype, generator, device),
        "wif": _normal(lead + (di, 2 * H), std, torch.float32, generator,
                       device),
        "down": _normal(lead + (di, d), si, dtype, generator, device),
    }


def mlstm(p, x, cfg: ModelConfig, cache=None):
    """mLSTM block (matrix memory, exponential gating).

    Prefill: the parallel form, quadratic in the sequence, with the
    log-gate matrix stabilised by its row max.  Decode: the recurrent
    form on the cache's ``C`` (B, H, hd, hd) and ``n`` (B, H, hd),
    float32, updated in place.  As in the reference, the two forms'
    normalisers differ (max(|sum|, exp(-m)) against max(|n q|, 1)), so
    decode does not reproduce prefill."""
    if partition.applies(x):
        return partition.mlstm(p, x, cfg, cache)
    B, S, d = x.shape
    di = cfg.mamba_expand * d
    H = cfg.n_heads
    hd = di // H
    uz = x @ p["up"]
    u, z = uz[..., :di], uz[..., di:]
    q, k, v = mlstm_heads(u @ p["wq"], u @ p["wk"], u @ p["wv"], H, hd)
    ig, fg = mlstm_gates(u @ p["wif"].to(u.dtype), H)

    if cache is None:
        w = mlstm_weights(torch.einsum("bqhd,bshd->bhqs", q.float(), k),
                          ig, fg)
        out = torch.einsum("bhqs,bshd->bqhd", w.to(v.dtype), v)
        new_cache = None
    else:
        if S != 1:
            raise ValueError(f"a decode step takes one token, got {S}")
        i_t, f_t = torch.exp(ig[:, 0]), torch.exp(fg[:, 0])  # (B, H)
        k0, q0 = k[:, 0], q[:, 0].float()
        C, num = mlstm_matrix_step(cache["C"], k0, v[:, 0].float(), q0,
                                   i_t, f_t)
        n, nq = mlstm_norm_step(cache["n"], k0, q0, i_t, f_t)
        out = (num / nq.abs().clamp_min(1.0)[..., None]).to(x.dtype)[:, None]
        cache["C"].copy_(C)
        cache["n"].copy_(n)
        new_cache = {"C": cache["C"], "n": cache["n"],
                     "idx": int(cache["idx"]) + 1}
    out = out.reshape(B, S, -1) * F.silu(z)
    return out @ p["down"], new_cache


def mlstm_heads(q, k, v, heads: int, hd: int):
    """Projected queries, keys and values (B, S, heads * w) as (B, S,
    heads, w), the keys in float32 scaled by 1 / sqrt(hd) (float32, as
    the reference's division by a numpy scalar promotes them); ``w`` is
    ``hd`` or, where the columns hold a slice of each head, less."""
    B, S = q.shape[:2]
    return (q.reshape(B, S, heads, -1),
            k.reshape(B, S, heads, -1).float() / math.sqrt(hd),
            v.reshape(B, S, heads, -1))


def mlstm_gates(g, H: int):
    """Input gates and log forget gates (B, S, H), float32, from the
    gate pre-activations ``g`` = u @ wif (B, S, 2H)."""
    g = g.float()
    return g[..., :H], F.logsigmoid(g[..., H:])


def mlstm_weights(s, ig, fg):
    """The parallel form's normalised weights (B, H, S, S), float32, from
    the logits ``s`` = q k (B, H, S, S), the input gates ``ig`` and the
    log forget gates ``fg`` (B, S, H): D[b,h,t,s] = F_t - F_s + i_s
    (s <= t), stabilised by its row max m; the weights s exp(D - m)
    divided by max(|row sum|, exp(-m))."""
    S = s.shape[-1]
    Ft = torch.cumsum(fg, 1).transpose(1, 2)               # (B, H, S)
    D = Ft[..., :, None] - Ft[..., None, :] + ig.transpose(1, 2)[..., None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=s.device).tril()
    D = torch.where(mask, D, -math.inf)
    m = D.amax(-1, keepdim=True)
    att = s * torch.exp(D - m)
    norm = torch.maximum(att.sum(-1, keepdim=True).abs(), torch.exp(-m))
    return att / norm


def mlstm_matrix_step(C, k0, v0, q0, i_t, f_t):
    """One recurrent step of the matrix memory C (B, H, dv, dk): f C + i
    v k^T for the step's keys k0 (B, H, dk) and values v0 (B, H, dv);
    returns it and its read-out C q0 (B, H, dv)."""
    C = C * f_t[..., None, None] + i_t[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", v0, k0)
    return C, torch.einsum("bhde,bhe->bhd", C, q0)


def mlstm_norm_step(n, k0, q0, i_t, f_t):
    """One recurrent step of the normaliser n (B, H, dk): f n + i k0;
    returns it and n . q0 (B, H) (the step's denominator before its
    absolute value)."""
    n = n * f_t[..., None] + i_t[..., None] * k0
    return n, torch.einsum("bhd,bhd->bh", n, q0)


def init_slstm(cfg: ModelConfig, dtype, generator, device, lead=()):
    d = cfg.d_model
    lead = tuple(lead)
    std = d ** -0.5
    return {"w": _normal(lead + (d, 4 * d), std, dtype, generator, device),
            "r": _normal(lead + (d, 4 * d), std, dtype, generator, device)}


def slstm_cell(g, c, dtype):
    """The sLSTM cell on the gate pre-activations ``g`` (B, 4 w), columns
    [i | f | z | o], and the float32 memory ``c`` (B, w): the new ``h``
    (in ``dtype``) and ``c``."""
    i, f, z, o = g.float().chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.exp(i.clamp_max(0.0)) * torch.tanh(z)
    h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype)
    return h, c


def slstm(p, x, cfg: ModelConfig, cache=None):
    """sLSTM (scalar memory): a sequential scan over the tokens, or one
    step from the cache's ``h`` (B, d) and float32 ``c`` (B, d), updated
    in place."""
    if partition.applies(x):
        return partition.slstm(p, x, cfg, cache)
    B, S, d = x.shape
    if cache is None:
        h = torch.zeros((B, d), dtype=x.dtype, device=x.device)
        c = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        ys = []
        for t in range(S):
            h, c = slstm_cell(x[:, t] @ p["w"] + h @ p["r"], c, x.dtype)
            ys.append(h)
        return torch.stack(ys, 1), None
    if S != 1:
        raise ValueError(f"a decode step takes one token, got {S}")
    h, c = slstm_cell(x[:, 0] @ p["w"] + cache["h"] @ p["r"], cache["c"],
                      x.dtype)
    cache["h"].copy_(h)
    cache["c"].copy_(c)
    return h[:, None], {"h": cache["h"], "c": cache["c"],
                        "idx": int(cache["idx"]) + 1}
