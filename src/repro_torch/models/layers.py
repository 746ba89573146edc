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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig


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
    m = cfg.mla
    B, S, d = x.shape
    H = cfg.n_heads
    nope = m.qk_nope_dim

    q = rms_norm(x @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    q = q.reshape(B, S, H, nope + m.qk_rope_dim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = x @ p["wkv_a"]
    c_kv = rms_norm(kv_a[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = kv_a[..., m.kv_lora_rank:].reshape(B, S, 1, m.qk_rope_dim)

    q_rope = apply_rope(q_rope, pos, 1.0, cfg.rope_theta)
    k_rope = apply_rope(k_rope, pos, 1.0, cfg.rope_theta)

    if cache is None:
        new_cache = {"c_kv": c_kv, "k_rope": k_rope}
        Sk = S
        ar = torch.arange(S, device=x.device)
        mask = (ar[:, None] >= ar[None, :])[None].expand(B, S, S)
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

    kv = (c_kv @ p["wkv_b"]).reshape(B, Sk, H, nope + m.v_head_dim)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(B, Sk, H, m.qk_rope_dim)], -1)
    out = _sdpa(torch.cat([q_nope, q_rope], -1), k, v, mask)
    return out.reshape(B, S, H * m.v_head_dim) @ p["wo"], new_cache


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


def moe_route(router, xt, mo: MoEConfig) -> dict:
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
    data-dependent shape."""
    T = xt.shape[0]
    E, k = mo.n_experts, mo.top_k
    probs = torch.softmax(xt.float() @ router, -1)
    gates, eidx = torch.topk(probs, k, -1)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = max(int(math.ceil(T * k / E * mo.capacity_factor)), 1)
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(E, dtype=flat_e.dtype, device=xt.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=xt.device) - starts[sorted_e]
    keep = pos < cap
    return {"gates": gates, "eidx": eidx, "order": order,
            "sorted_e": sorted_e, "slot": torch.where(keep, pos, cap - 1),
            "keep": keep, "tok": order // k, "cap": cap}


def moe(p, x, mo: MoEConfig, kind):
    """Sort-based top-k dispatch with static capacity.

    x: (B, S, d) -> (B, S, d).  The kept pairs are scattered into an
    (E, cap, d) buffer (a dropped pair adds zero at slot ``cap - 1``),
    every expert runs its SwiGLU on its ``cap`` rows, and each pair's
    output, weighted by its gate, is added back to its token."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    r = moe_route(p["router"], xt, mo)
    sorted_e, slot, keep, tok = r["sorted_e"], r["slot"], r["keep"], r["tok"]
    buf = torch.zeros((mo.n_experts, r["cap"], d), dtype=xt.dtype,
                      device=x.device)
    buf.index_put_((sorted_e, slot), torch.where(keep[:, None], xt[tok], 0),
                   accumulate=True)
    h = F.silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    out_e = torch.bmm(h, p["down"])                        # (E, cap, d)
    y_flat = torch.where(keep[:, None], out_e[sorted_e, slot], 0)
    gate_flat = r["gates"].reshape(-1)[r["order"]]
    y = torch.zeros((T, d), dtype=xt.dtype, device=x.device).index_put_(
        (tok,), y_flat * gate_flat[:, None].to(xt.dtype), accumulate=True)
    y = y.reshape(B, S, d)
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
    B, S, d = x.shape
    di = cfg.mamba_expand * d
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]

    if cache is None:
        pad = torch.zeros((B, dc - 1, di), dtype=xi.dtype, device=x.device)
        hist = torch.cat([pad, xi], 1)
    else:
        if S != 1:
            raise ValueError(f"a decode step takes one token, got {S}")
        hist = torch.cat([cache["conv"], xi], 1)           # (B, dc, di)
    conv = sum(hist[:, i:i + S] * p["conv_w"][i] for i in range(dc))
    u = F.silu(conv)

    proj = u @ p["x_proj"]
    dt = F.softplus(proj[..., -1:].float() + p["dt_bias"])
    Bm = proj[..., :ds].float()                            # (B, S, ds)
    Cm = proj[..., ds:2 * ds].float()
    A = -torch.exp(p["A_log"])                             # (di, ds)
    a = torch.exp(dt[..., None] * A)                       # (B, S, di, ds)
    b = (dt[..., None] * Bm[:, :, None, :]) * u.float()[..., None]
    if cache is None:
        h = torch.zeros_like(b[:, 0])
        hs = []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        hh = torch.stack(hs, 1)
        new_cache = None
    else:
        hh = a * cache["ssm"][:, None] + b
        cache["ssm"].copy_(hh[:, -1])
        cache["conv"].copy_(hist[:, 1:])
        new_cache = {"conv": cache["conv"], "ssm": cache["ssm"],
                     "idx": int(cache["idx"]) + 1}
    y = torch.einsum("bsdn,bsn->bsd", hh, Cm)
    y = y + u.float() * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], new_cache


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
    B, S, d = x.shape
    di = cfg.mamba_expand * d
    H = cfg.n_heads
    hd = di // H
    uz = x @ p["up"]
    u, z = uz[..., :di], uz[..., di:]
    q = (u @ p["wq"]).reshape(B, S, H, hd)
    # float32, as the reference's division by a numpy scalar promotes it
    k = (u @ p["wk"]).reshape(B, S, H, hd).float() / math.sqrt(hd)
    v = (u @ p["wv"]).reshape(B, S, H, hd)
    gates = (u @ p["wif"].to(u.dtype)).float()
    ig = gates[..., :H]                                    # input gate
    fg = F.logsigmoid(gates[..., H:])                      # log forget gate

    if cache is None:
        # D[b,h,t,s] = F_t - F_s + i_s  (s <= t), stabilised by row max
        Ft = torch.cumsum(fg, 1).transpose(1, 2)           # (B, H, S)
        D = Ft[..., :, None] - Ft[..., None, :] \
            + ig.transpose(1, 2)[..., None, :]
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        D = torch.where(mask, D, -math.inf)
        m = D.amax(-1, keepdim=True)
        att = torch.einsum("bqhd,bshd->bhqs", q.float(), k) \
            * torch.exp(D - m)
        norm = torch.maximum(att.sum(-1, keepdim=True).abs(), torch.exp(-m))
        out = torch.einsum("bhqs,bshd->bqhd", (att / norm).to(v.dtype), v)
        new_cache = None
    else:
        if S != 1:
            raise ValueError(f"a decode step takes one token, got {S}")
        i_t = torch.exp(ig[:, 0])                          # (B, H)
        f_t = torch.exp(fg[:, 0])
        k0, q0 = k[:, 0], q[:, 0].float()
        C = cache["C"] * f_t[..., None, None] + i_t[..., None, None] * \
            torch.einsum("bhd,bhe->bhde", v[:, 0].float(), k0)
        n = cache["n"] * f_t[..., None] + i_t[..., None] * k0
        num = torch.einsum("bhde,bhe->bhd", C, q0)
        den = torch.einsum("bhd,bhd->bh", n, q0).abs().clamp_min(1.0)
        out = (num / den[..., None]).to(x.dtype)[:, None]
        cache["C"].copy_(C)
        cache["n"].copy_(n)
        new_cache = {"C": cache["C"], "n": cache["n"],
                     "idx": int(cache["idx"]) + 1}
    out = out.reshape(B, S, di) * F.silu(z)
    return out @ p["down"], new_cache


def init_slstm(cfg: ModelConfig, dtype, generator, device, lead=()):
    d = cfg.d_model
    lead = tuple(lead)
    std = d ** -0.5
    return {"w": _normal(lead + (d, 4 * d), std, dtype, generator, device),
            "r": _normal(lead + (d, 4 * d), std, dtype, generator, device)}


def _slstm_step(p, h, c, xt):
    g = xt @ p["w"] + h @ p["r"]
    i, f, z, o = g.float().chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.exp(i.clamp_max(0.0)) * torch.tanh(z)
    h = (torch.sigmoid(o) * torch.tanh(c)).to(xt.dtype)
    return h, c


def slstm(p, x, cfg: ModelConfig, cache=None):
    """sLSTM (scalar memory): a sequential scan over the tokens, or one
    step from the cache's ``h`` (B, d) and float32 ``c`` (B, d), updated
    in place."""
    B, S, d = x.shape
    if cache is None:
        h = torch.zeros((B, d), dtype=x.dtype, device=x.device)
        c = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        ys = []
        for t in range(S):
            h, c = _slstm_step(p, h, c, x[:, t])
            ys.append(h)
        return torch.stack(ys, 1), None
    if S != 1:
        raise ValueError(f"a decode step takes one token, got {S}")
    h, c = _slstm_step(p, cache["h"], cache["c"], x[:, 0])
    cache["h"].copy_(h)
    cache["c"].copy_(c)
    return h[:, None], {"h": cache["h"], "c": cache["c"],
                        "idx": int(cache["idx"]) + 1}
