"""The port's ``loss_fn``, its gradients and ``make_train_step`` against
the JAX package's ``jax.value_and_grad(loss_fn)`` and
``make_train_step``: the dense (stablelm-3b, phi3-medium-14b,
command-r-35b), MLA (minicpm3-4b) and MoE (moonshot-v1-16b-a3b,
arctic-480b) families at their ``REDUCED`` configs.

The reference's weights are carried into the port with
``convert.lm_params_from_numpy``; the same batch (labels the next
tokens, the last two positions masked with -1) goes through both.  The
reference's gradient is compiled once per architecture and dtype under
``jax.jit``.

Tolerances.  Every gradient leaf has the reference's dtype and is held
at atol = tol x its scale, the scale being the leaf's largest magnitude
or, if larger, 1e-3 x the largest of the whole tree: a leaf whose
gradient is zero in exact arithmetic (the key bias of attention without
RoPE, whose shift cancels in the softmax) holds only rounding noise.
- float32: tol = 1e-4; the loss within 1e-5.
- bf16: tol = 0.05, the loss within 0.01.  The reference's bf16 chains
  of elementwise ops round where XLA's fusions end, the port's after
  every op, so the two packages' bf16 gradients differ by a few
  percent of a leaf's scale, while the port's lie as far from the
  float32 gradients as the reference's do
  (``test_bf16_as_close_to_float32_as_reference``).  The MoE families
  are not held in bf16: a routing near-tie decided the other way moves
  whole expert rows.
- One ``make_train_step`` step (AdamW, float32): the loss within 1e-5,
  the first moment (0.1 x the clipped gradient) at 1e-4 x its scale, a
  parameter within 2 x lr: Adam's first update is nearly ``lr *
  sign(g)``, so a gradient near zero may flip the sign.

The helpers here are shared with ``test_torch_train_steps_recurrent.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import steps as ref_steps  # noqa: E402
from repro.train import optimizer as ref_optimizer  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

ARCHS = ["stablelm_3b", "phi3_medium_14b", "command_r_35b", "minicpm3_4b",
         "moonshot_v1_16b_a3b", "arctic_480b"]
TOL = {"float32": 1e-4, "bfloat16": 0.05}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 0.01}
B, S = 2, 16
CPU = torch.device("cpu")
LR = 1e-2


def pair(arch, dtype, seed, **kw):
    """(reference config, port config, reference params, port params):
    the reference's ``init_params`` carried across."""
    rcfg = dataclasses.replace(ref_configs.reduced_config(arch), dtype=dtype,
                               **kw)
    cfg = dataclasses.replace(configs.reduced_config(arch), dtype=dtype,
                              **kw)
    rp = ref_model.init_params(rcfg, jax.random.PRNGKey(seed))
    pp = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rp), CPU)
    return rcfg, cfg, rp, pp


def batches(cfg, seed):
    """(reference batch, port batch) of the same seeded inputs: tokens,
    next-token labels with the last two masked (-1), and where the
    family takes them three different M-RoPE position streams and stub
    patch (vision) or frame (audio) embeddings in the model's dtype."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -2:] = -1
    out = {"tokens": toks[:, :-1].copy(), "labels": labels}
    if cfg.pos == "mrope":
        t = np.arange(S)
        out["positions"] = np.broadcast_to(
            np.stack([t, t // 2, t % 3])[:, None], (3, B, S)).astype(
                np.int32)
    n = {"vision": 4, "audio": 8}.get(cfg.frontend)
    ref = {k: jnp.asarray(v) for k, v in out.items()}
    port = {k: torch.from_numpy(v) for k, v in out.items()}
    if n:
        e = jnp.asarray(rng.normal(size=(B, n, cfg.d_model)),
                        dtype=jnp.dtype(cfg.dtype))
        ref["embeds"] = e
        a = np.array(e)
        port["embeds"] = (torch.from_numpy(a.view(np.int16))
                          .view(torch.bfloat16) if cfg.dtype == "bfloat16"
                          else torch.from_numpy(a.copy()))
    return ref, port


def ref_value_and_grad(rcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_steps.loss_fn(p, b, rcfg)))


def scales(ref_leaves) -> list[float]:
    """Each leaf's scale: its max magnitude, floored at 1e-3 x the
    tree's largest (module docstring)."""
    maxes = [float(np.abs(np.asarray(r, np.float32)).max()) for r in
             ref_leaves]
    top = max(maxes)
    return [max(m, 1e-3 * top) for m in maxes]


def worst_gap(got_leaves, want_leaves) -> float:
    """The largest |got - want| of any leaf, in units of that leaf's
    scale (``scales`` of ``want``)."""
    return max(float(np.abs(np.asarray(g, np.float32)
                            - np.asarray(w, np.float32)).max()) / sc
               for g, w, sc in zip(got_leaves, want_leaves,
                                   scales(want_leaves)))


def close_tree(got_tree, want_tree, tol) -> None:
    """Leaf by leaf: the same dtype, and within tol x the leaf's scale."""
    got, want = leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for (g, w), sc in zip(zip(got, want), scales(want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=tol * sc)


def check_loss_and_grads(arch, dtype, seed=0, **kw):
    rcfg, cfg, rp, pp = pair(arch, dtype, seed, **kw)
    rb, pb = batches(cfg, seed)
    rloss, rgrads = ref_value_and_grad(rcfg)(rp, rb)
    loss, grads = steps.value_and_grad(pp, pb, cfg)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL[dtype]
    close_tree(grads, rgrads, TOL[dtype])
    # the loss alone, as loss_fn gives it, and the flags restored
    np.testing.assert_allclose(float(steps.loss_fn(pp, pb, cfg)),
                               float(loss), rtol=1e-6)
    assert not any(t.requires_grad for t in leaves(pp))


def check_train_step(arch, seed=0, state_dtype="float32"):
    """One make_train_step step in both packages from the same float32
    weights (module docstring's tolerances); moments in
    ``state_dtype``, held in bf16 within one bf16 ulp more."""
    rcfg, cfg, rp, pp = pair(arch, "float32", seed)
    rb, pb = batches(cfg, seed)
    kw = dict(lr=LR, warmup_steps=1, state_dtype=state_dtype)
    ropt, opt = ref_optimizer.AdamW(**kw), AdamW(**kw)
    p0 = jax.tree.map(np.asarray, rp)
    rp2, rs2, rloss = jax.jit(ref_steps.make_train_step(rcfg, ropt))(
        rp, ropt.init(rp), rb)
    state = opt.init(pp)
    pp2, s2, loss = steps.make_train_step(cfg, opt)(pp, state, pb)
    assert pp2 is pp and s2 is state
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL["float32"]
    assert int(s2["step"]) == int(rs2["step"]) == 1
    m_ref = jax.tree.leaves(rs2["m"])
    ulp = 2.0 ** -7 if state_dtype == "bfloat16" else 0.0
    for g, w, sc in zip(leaves(s2["m"]), m_ref, scales(m_ref)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype) == state_dtype
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=ulp,
                                   atol=TOL["float32"] * sc)
    for g, w, w0 in zip(leaves(pp2), jax.tree.leaves(rp2),
                        jax.tree.leaves(p0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2 * LR)
        assert (g.numpy() != w0).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_float32(arch):
    check_loss_and_grads(arch, "float32")


@pytest.mark.parametrize("ce_impl", ["gather", "softmax"])
def test_ce_impl_branches(ce_impl):
    """Both cross-entropy branches at phi3's REDUCED config (float32);
    they give the same loss in each package."""
    check_loss_and_grads("phi3_medium_14b", "float32", seed=1,
                         ce_impl=ce_impl)


def test_sliding_window_grads():
    """phi3's REDUCED config with an 8-token window over 16 tokens: the
    windowed causal mask, backward (float32)."""
    check_loss_and_grads("phi3_medium_14b", "float32", seed=3,
                         sliding_window=8)


def test_loss_and_grads_bf16():
    check_loss_and_grads("stablelm_3b", "bfloat16")


def test_bf16_as_close_to_float32_as_reference():
    """At stablelm's REDUCED config, the port's bf16 gradients lie about
    as far from the float32 gradients of the same weights (upcast) as
    the reference's bf16 gradients do: within 1.5 x, worst leaf against
    worst leaf (the worst leaf's rounding error moves with the order of
    the roundings).  So what the 0.05 tolerance covers is bf16
    rounding, not a fault."""
    rcfg, cfg, rp, pp = pair("stablelm_3b", "bfloat16", 0)
    rb, pb = batches(cfg, 0)
    _, g16 = ref_value_and_grad(rcfg)(rp, rb)
    _, g32 = ref_value_and_grad(dataclasses.replace(rcfg, dtype="float32"))(
        jax.tree.map(lambda a: a.astype(jnp.float32), rp), rb)
    _, mine = steps.value_and_grad(pp, pb, cfg)
    exact = jax.tree.leaves(g32)
    port_err = worst_gap([t.float().numpy() for t in leaves(mine)], exact)
    ref_err = worst_gap(jax.tree.leaves(g16), exact)
    assert port_err <= 1.5 * ref_err, (port_err, ref_err)


def test_all_labels_masked():
    """With every label masked the loss is 0 (the mean over
    max(mask.sum(), 1)) and so is every gradient, as in the reference."""
    rcfg, cfg, rp, pp = pair("phi3_medium_14b", "float32", 2)
    rb, pb = batches(cfg, 2)
    rb["labels"] = jnp.full_like(rb["labels"], -1)
    pb["labels"] = torch.full_like(pb["labels"], -1)
    rloss, _ = ref_value_and_grad(rcfg)(rp, rb)
    loss, grads = steps.value_and_grad(pp, pb, cfg)
    assert float(loss) == float(rloss) == 0.0
    assert all(float(g.abs().max()) == 0.0 for g in leaves(grads))


def test_train_step_moe():
    """make_train_step at moonshot's REDUCED config (MoE, top-2 of 8):
    the routing, dispatch and expert products backward, then AdamW."""
    check_train_step("moonshot_v1_16b_a3b")
