"""The port's dense LM family against the JAX package's ``models/``.

At the three dense ``REDUCED`` configs (``stablelm_3b``: layernorm, bias,
``rope_pct=0.25``; ``phi3_medium_14b``; ``command_r_35b``), the JAX
package's ``init_params`` weights are carried into the port with
``convert.lm_params_from_numpy``, and the same tokens go through both
``forward``s: the full causal pass (prefill) and one decode step from a
cache carried across mid-sequence, then a sliding-window decode against
the reference's ring buffer.

Tolerances: float32 (``dtype="float32"``) at rtol = atol = 1e-4, the
order of float32 rounding over two layers; bf16 at rtol = atol = 0.02,
about five bf16 ulps of these logits (|logit| < 1), well inside the
reference's own decode-vs-prefill bound of 0.15
(``tests/test_models_smoke.py:91-95``).  The reference's RoPE angles and
attention logits are float64 when JAX's 64-bit mode is on (another test
module may have turned it on) and float32 otherwise; both hold.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.configs.base import n_active_params as ref_n_active  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs.base import n_active_params  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402

DENSE = ["stablelm_3b", "phi3_medium_14b", "command_r_35b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 0.02}
B, S = 2, 8
CPU = torch.device("cpu")


def _cfgs(arch, dtype="bfloat16", **kw):
    """(reference, port) reduced configs with ``dtype`` and overrides."""
    return (dataclasses.replace(ref_configs.reduced_config(arch), dtype=dtype,
                                **kw),
            dataclasses.replace(configs.reduced_config(arch), dtype=dtype,
                                **kw))


def _both_params(arch, dtype, seed, **kw):
    rcfg, cfg = _cfgs(arch, dtype, **kw)
    rp = ref_model.init_params(rcfg, jax.random.PRNGKey(seed))
    pp = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rp), CPU)
    return rcfg, cfg, rp, pp


def _ref_step(rcfg):
    """The reference's decode step under one ``jax.jit``, as its
    ``launch/serve.py`` runs it: compiled once for every step."""
    return jax.jit(lambda p, c, t: ref_model.forward(p, t, rcfg, cache=c))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape) \
        .astype(np.int32)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_configs_equal(arch):
    """The port's config copies equal the JAX package's, field by field,
    with the same parameter counts."""
    for get in ("get_config", "reduced_config"):
        ref = getattr(ref_configs, get)(arch)
        port = getattr(configs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.hd == ref.hd
        assert port.n_params() == ref.n_params()
        assert n_active_params(port) == ref_n_active(ref)
        pat, reps = model.layer_pattern(port)
        rpat, rreps = ref_model.layer_pattern(ref)
        assert [dataclasses.asdict(s) for s in pat] == \
            [dataclasses.asdict(s) for s in rpat] and reps == rreps


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_tree_matches(arch):
    """The port's own random init has the reference's pytree: the same
    keys, shapes and dtypes, and its draws have the reference's scales."""
    rcfg, cfg = _cfgs(arch)
    ref = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: ref_model.init_params(rcfg)))[0]
    gen = torch.Generator().manual_seed(0)
    port = model.init_params(cfg, gen, CPU)
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            flat[path] = t

    walk(port, ())
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
            (tuple(a.shape), str(a.dtype)) for p, a in ref}
    assert {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in flat.items()} == want
    std = float(port["blocks"][0]["attn"]["wq"].float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_decode_step(arch, dtype):
    """Prefill logits, then one decode step from the reference's cache
    after S - 1 steps carried across, against the reference; the port's
    cache after the step equals the reference's."""
    rcfg, cfg, rp, pp = _both_params(arch, dtype, seed=3)
    toks = _tokens(cfg, 3)
    want, _ = ref_model.forward(rp, jnp.asarray(toks), rcfg)
    with torch.no_grad():
        got, none = model.forward(pp, torch.from_numpy(toks).long(), cfg)
    assert none is None and got.dtype == torch.float32
    assert got.shape == (B, S, cfg.vocab)
    _close(got, want, dtype)

    step = _ref_step(rcfg)
    rc = ref_model.init_cache(rcfg, B, S)
    for t in range(S - 1):
        _, rc = step(rp, rc, jnp.asarray(toks[:, t:t + 1]))
    pc = convert.lm_cache_from_numpy(
        cfg, jax.tree.map(np.asarray, rc), CPU)
    assert pc["idx"] == S - 1
    want, rc = step(rp, rc, jnp.asarray(toks[:, -1:]))
    with torch.no_grad():
        got, pc = model.forward(pp, torch.from_numpy(toks[:, -1:]).long(),
                                cfg, cache=pc)
    _close(got, want, dtype)
    mine = convert.lm_cache_to_numpy(pc)
    assert int(mine["idx"]) == int(rc["idx"]) == S
    for m, r in zip(mine["slots"], rc["slots"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(m[key], np.asarray(r[key], np.float32),
                                       rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("arch", ["phi3_medium_14b", "stablelm_3b"])
def test_sliding_window_decode(arch):
    """``sliding_window=4`` with ``max_seq=8``: the cache is a ring of 4
    and every step's logits equal the reference's; the prefill of 8
    tokens (which exceeds the window) equals the reference's windowed
    prefill."""
    rcfg, cfg, rp, pp = _both_params(arch, "float32", seed=5,
                                     sliding_window=4)
    toks = _tokens(cfg, 5)
    step = _ref_step(rcfg)
    rc = ref_model.init_cache(rcfg, B, S)
    pc = model.init_cache(cfg, B, S, device=CPU)
    assert pc["slots"][0]["k"].shape[2] == rc["slots"][0]["k"].shape[2] == 4
    with torch.no_grad():
        for t in range(S):
            want, rc = step(rp, rc, jnp.asarray(toks[:, t:t + 1]))
            got, pc = model.forward(pp, torch.from_numpy(toks[:, t:t + 1])
                                    .long(), cfg, cache=pc)
            _close(got, want, "float32")
        want, _ = ref_model.forward(rp, jnp.asarray(toks), rcfg)
        got, _ = model.forward(pp, torch.from_numpy(toks).long(), cfg)
    _close(got, want, "float32")


def test_decode_matches_prefill_dense():
    """tests/test_models_smoke.py:77's check on the port alone:
    teacher-forced decode equals the full forward, in bf16, within that
    test's bound."""
    cfg = configs.reduced_config("phi3_medium_14b")
    params = model.init_params(cfg, torch.Generator().manual_seed(3), CPU)
    toks = torch.from_numpy(_tokens(cfg, 3, (1, 8))).long()
    with torch.no_grad():
        full, _ = model.forward(params, toks, cfg)
        cache = model.init_cache(cfg, 1, 8, device=CPU)
        outs = []
        for t in range(8):
            lg, cache = model.forward(params, toks[:, t:t + 1], cfg,
                                      cache=cache)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=0.15, atol=0.15)


def test_rope_and_norms_equal():
    """RoPE (full, partial and M-RoPE sections) and both norms on the
    same random inputs, in float32."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5)[None], (2, 5)).astype(np.int32)
    tx = torch.from_numpy(x)
    tp = torch.from_numpy(pos.copy()).long()
    for pct in (1.0, 0.25):
        want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), pct)
        np.testing.assert_allclose(layers.apply_rope(tx, tp, pct).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
    sec = layers.mrope_sections(16)
    assert sec == ref_layers.mrope_sections(16)
    pos3 = np.stack([pos, pos + 1, pos + 2])
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos3), 1.0,
                                 mrope_sections=sec)
    got = layers.apply_rope(tx, torch.from_numpy(pos3).long(), 1.0,
                            mrope_sections=sec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    h = rng.normal(size=(3, 16)).astype(np.float32)
    w, b = rng.normal(size=16).astype(np.float32), \
        rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(h), torch.from_numpy(w)).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(h), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layers.layer_norm(torch.from_numpy(h), torch.from_numpy(w),
                          torch.from_numpy(b)).numpy(),
        np.asarray(ref_layers.layer_norm(jnp.asarray(h), jnp.asarray(w),
                                         jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)


def test_params_round_trip():
    """numpy -> port -> numpy gives the reference's bf16 weights back,
    exactly (as float32)."""
    rcfg, cfg = _cfgs("stablelm_3b")
    rp = jax.tree.map(np.asarray, ref_model.init_params(rcfg,
                                                        jax.random.PRNGKey(1)))
    back = convert.lm_params_to_numpy(convert.lm_params_from_numpy(cfg, rp,
                                                                   CPU))
    flat_back = jax.tree_util.tree_leaves(back)
    flat_ref = jax.tree_util.tree_leaves(rp)
    assert len(flat_back) == len(flat_ref)
    for a, r in zip(flat_back, flat_ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, r.astype(np.float32))


def test_entry_points_raise_without_a_card(monkeypatch):
    """The default device is the card; with none, the entry points raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.reduced_config("phi3_medium_14b")
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(cfg, 1, 4)
    tree = jax.tree.map(np.asarray, ref_model.init_params(
        ref_configs.reduced_config("phi3_medium_14b")))
    with pytest.raises(RuntimeError, match="cuda"):
        convert.lm_params_from_numpy(cfg, tree)
