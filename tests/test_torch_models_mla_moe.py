"""The port's MLA and MoE families against the JAX package's ``models/``.

At the ``REDUCED`` configs of minicpm3-4b (MLA), moonshot-v1-16b-a3b
(MoE, top-6 of 8) and arctic-480b (MoE, top-2 of 8, with the dense
residual FFN), the JAX package's ``init_params`` weights are carried
into the port with ``convert.lm_params_from_numpy`` (the float32 router
stays float32 under a bf16 config), and the same tokens go through both
``forward``s: the full causal pass (prefill), then one decode step from
the reference's cache after S - 1 steps, carried across.  The reference
runs under one ``jax.jit`` for each config and call kind.

Tolerances: logits in float32 at rtol = atol = 1e-4 (float32 rounding
over two layers) and in bf16 at rtol = atol = 0.02 (a few bf16 ulps of
logits below 1).  In a bf16 model every cache leaf (the float32 states
too, which are computed from bf16 activations) is held at rtol = 0.02
and atol = 0.02 x the leaf's largest magnitude: its elements carry the
rounding of the activations that produced them, whose ulp is set by the
leaf's scale, not by each element (a 4-layer bf16 hybrid differs by
0.03 to 0.05 on leaves of magnitude 3.5).  In a float32 model the
leaves are held at 1e-4.

MoE routing is held exactly: the top-k experts of every token and the
mask of the (token, choice) pairs that keep an expert slot, at the
config's capacity factor and at a factor of 0.5 that overflows the
experts' capacity.  A flipped near-tie would fail the test, which names
the gap between the k-th and the next probability.  MoE decode is not
held against prefill: capacity depends on the number of tokens, so a
pair kept in a decode step may be dropped in a prefill.

The helpers here are shared with ``test_torch_models_recurrent.py`` and
``test_torch_models_vlm_encdec.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402
from test_torch_models import _both_params, _cfgs, _tokens  # noqa: E402

ARCHS = ["minicpm3_4b", "moonshot_v1_16b_a3b", "arctic_480b"]
MOE = ["moonshot_v1_16b_a3b", "arctic_480b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 0.02}
B, S = 2, 8
CPU = torch.device("cpu")


def flat(tree, path=()) -> dict:
    """{path: leaf} of a pytree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, path + (k,)))
    return out


def signature(tree) -> dict:
    """{path: (shape, dtype name)} of a torch, numpy or abstract tree."""
    return {p: (tuple(a.shape), str(a.dtype).split(".")[-1])
            for p, a in flat(tree).items()}


def check_tree(arch):
    """The port's own init and the reference's weights carried across
    both have the reference's pytree: paths, shapes and dtypes, float32
    leaves included.  Returns the reference's signature."""
    rcfg, cfg = _cfgs(arch)
    want = signature(jax.eval_shape(lambda: ref_model.init_params(rcfg)))
    own = model.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    assert signature(own) == want
    rp = jax.tree.map(np.asarray, ref_model.init_params(
        rcfg, jax.random.PRNGKey(1)))
    carried = convert.lm_params_from_numpy(cfg, rp, CPU)
    assert signature(carried) == want
    rflat = flat(rp)
    for p, t in flat(carried).items():
        np.testing.assert_array_equal(t.float().numpy(),
                                      rflat[p].astype(np.float32))
    return want


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def close_cache(mine, ref, dtype):
    """The port's cache (as numpy) against the reference's, leaf by
    leaf, at the module docstring's tolerances for a ``dtype`` model."""
    rflat = flat(ref["slots"])
    mflat = flat(mine["slots"])
    assert mflat.keys() == rflat.keys()
    tol = TOL[dtype]
    for p, r in rflat.items():
        r = np.asarray(r, dtype=np.float32)
        atol = tol * max(1.0, float(np.abs(r).max())) \
            if dtype == "bfloat16" else tol
        np.testing.assert_allclose(mflat[p], r, rtol=tol, atol=atol,
                                   err_msg=str(p))
    assert int(mine["idx"]) == int(ref["idx"])


def ref_prefill(rcfg):
    return jax.jit(lambda p, t, kw: ref_model.forward(p, t, rcfg, **kw))


def ref_step(rcfg):
    return jax.jit(lambda p, c, t, kw: ref_model.forward(p, t, rcfg,
                                                         cache=c, **kw))


def check_forward_and_decode(arch, dtype, seed, prefill_kw=None,
                             step_kw=None, **over):
    """Prefill logits against the reference's; then one decode step
    from the reference's cache after S - 1 steps carried across, logits
    and the cache after the step against the reference's.
    ``prefill_kw``: numpy keyword inputs of the full pass; ``step_kw(t)``
    those of decode step ``t``."""
    rcfg, cfg, rp, pp = _both_params(arch, dtype, seed, **over)
    toks = _tokens(cfg, seed)
    pkw = prefill_kw or {}
    want, _ = ref_prefill(rcfg)(rp, jnp.asarray(toks),
                                {k: jnp.asarray(v) for k, v in pkw.items()})
    with torch.no_grad():
        got, none = model.forward(pp, torch.from_numpy(toks).long(), cfg,
                                  **{k: torch.from_numpy(v)
                                     for k, v in pkw.items()})
    assert none is None and got.dtype == torch.float32
    assert got.shape == (B, S, cfg.vocab)
    close(got, want, dtype)

    def skw(t, lib):
        kw = step_kw(t) if step_kw else {}
        return {k: (jnp.asarray(v) if lib == "jax" else torch.from_numpy(v))
                for k, v in kw.items()}

    step = ref_step(rcfg)
    rc = ref_model.init_cache(rcfg, B, S)
    for t in range(S - 1):
        _, rc = step(rp, rc, jnp.asarray(toks[:, t:t + 1]), skw(t, "jax"))
    pc = convert.lm_cache_from_numpy(cfg, jax.tree.map(np.asarray, rc), CPU)
    assert signature(pc["slots"]) == signature(rc["slots"])
    assert pc["idx"] == S - 1
    want, rc = step(rp, rc, jnp.asarray(toks[:, -1:]), skw(S - 1, "jax"))
    with torch.no_grad():
        got, pc = model.forward(pp, torch.from_numpy(toks[:, -1:]).long(),
                                cfg, cache=pc, **skw(S - 1, "torch"))
    close(got, want, dtype)
    close_cache(convert.lm_cache_to_numpy(pc), rc, dtype)


def check_generate(arch, seed=0, gen=4):
    """``launch/serve.generate`` in float32 gives the reference's greedy
    tokens."""
    rcfg, cfg, rp, pp = _both_params(arch, "float32", seed)
    prompts = _tokens(cfg, seed, (B, 4))
    want = ref_serve.generate(rcfg, rp, prompts, gen)
    got = serve.generate(cfg, pp, prompts, gen)
    assert got.dtype == np.int32 and got.shape == (B, 4 + gen)
    np.testing.assert_array_equal(got, want)


def check_main_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "3", "--gen", "2"])
    assert out.shape == (2, 5)
    assert ((out >= 0) & (out < configs.reduced_config(arch).vocab)).all()
    name = configs.reduced_config(arch).name
    assert f"{name} on cpu: generated 4 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches(arch):
    want = check_tree(arch)
    if arch in MOE:
        routers = [v for p, v in want.items() if p[-1] == "router"]
        assert routers and all(dt == "float32" for _, dt in routers)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_step(arch, dtype):
    check_forward_and_decode(arch, dtype, seed=3)


def _ref_route(router, xt, mo):
    """The reference's routing, as ``layers.moe`` computes it
    (``src/repro/models/layers.py:300-318``): top-k experts, and the
    kept mask in the (token, choice) order."""
    T, k = xt.shape[0], mo.top_k
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router, axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    cap = max(int(np.ceil(T * k / mo.n_experts * mo.capacity_factor)), 1)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e)
    counts = jnp.bincount(flat_e, length=mo.n_experts)
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    pos = jnp.arange(T * k, dtype=jnp.int32) - starts[flat_e[order]]
    keep = np.zeros(T * k, bool)
    keep[np.asarray(order)] = np.asarray(pos < cap)
    return np.asarray(probs), np.asarray(eidx), keep.reshape(T, k), cap


@pytest.mark.parametrize("capacity_factor", [None, 0.5],
                         ids=["config", "overflow"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_equal(arch, capacity_factor):
    """Layer 0's MoE on the same activations (bf16, B=4, S=8): the
    routing equals the reference's exactly, and the outputs agree."""
    rcfg, cfg, rp, pp = _both_params(arch, "bfloat16", seed=11)
    mo = cfg.moe if capacity_factor is None else dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor)
    rmo = rcfg.moe if capacity_factor is None else dataclasses.replace(
        rcfg.moe, capacity_factor=capacity_factor)
    rm = jax.tree.map(lambda a: a[0], rp["blocks"][0]["moe"])
    pm = {k: (v[0] if not isinstance(v, dict)
              else {kk: vv[0] for kk, vv in v.items()})
          for k, v in pp["blocks"][0]["moe"].items()}
    x = np.random.default_rng(11).normal(size=(4, 8, cfg.d_model)) \
        .astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)

    probs, eidx, keep, cap = _ref_route(rm["router"], xj.reshape(32, -1), rmo)
    route = layers.moe_route(pm["router"], xt.reshape(32, -1), mo)
    assert route["cap"] == cap
    top = np.sort(probs, -1)[:, ::-1]
    gap = float((top[:, mo.top_k - 1] - top[:, mo.top_k]).min())
    np.testing.assert_array_equal(
        route["eidx"].numpy(), eidx,
        err_msg=f"top-{mo.top_k} differs; smallest k-th/next gap {gap}")
    mine = np.zeros(32 * mo.top_k, bool)
    mine[route["order"].numpy()] = route["keep"].numpy()
    np.testing.assert_array_equal(mine.reshape(32, mo.top_k), keep)
    if capacity_factor is not None:
        assert not keep.all()            # some pairs overflow and drop

    want = ref_layers.moe(rm, xj, rmo, rcfg.mlp)
    got = layers.moe(pm, xt, mo, cfg.mlp)
    close(got, want, "bfloat16")


def test_mla_decode_matches_prefill():
    """tests/test_models_smoke.py:98's check on the port alone:
    teacher-forced decode equals the full forward within that test's
    bound (0.2), in bf16."""
    cfg = configs.reduced_config("minicpm3_4b")
    params = model.init_params(cfg, torch.Generator().manual_seed(4), CPU)
    toks = torch.from_numpy(_tokens(cfg, 4, (1, 6))).long()
    with torch.no_grad():
        full, _ = model.forward(params, toks, cfg)
        cache = model.init_cache(cfg, 1, 6, device=CPU)
        outs = []
        for t in range(6):
            lg, cache = model.forward(params, toks[:, t:t + 1], cfg,
                                      cache=cache)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=0.2, atol=0.2)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference(arch):
    check_generate(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_main_on_cpu(arch, capsys):
    check_main_on_cpu(arch, capsys)
