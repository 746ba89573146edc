"""The port's recurrent families against the JAX package's ``models/``:
the jamba hybrid (Mamba and MoE layers around one sliding-window
attention layer a period) and xLSTM (mLSTM and sLSTM blocks).

At the ``REDUCED`` configs, the reference's weights are carried across
(Mamba's ``dt_bias``, ``A_log``, ``D`` and the mLSTM's ``wif`` stay
float32 under a bf16 config), and prefill and one decode step from the
reference's cache (``conv``, float32 ``ssm``, ``C``, ``n`` and the
sLSTM's ``c``) are held as ``test_torch_models_mla_moe.py`` holds MLA
and MoE, at its tolerances.

The port's Mamba prefill runs the recurrence h_t = a_t h_{t-1} + b_t
as a sequential loop in float32, where the reference runs an
associative scan; over 64 tokens the two agree at rtol = atol = 1e-5
(float32 rounding of products taken in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402
from test_torch_models import _both_params, _tokens  # noqa: E402
from test_torch_models_mla_moe import (  # noqa: E402
    B, CPU, DTYPES, S, check_forward_and_decode, check_generate,
    check_main_on_cpu, check_tree, close, ref_step,
)

ARCHS = ["jamba_1_5_large_398b", "xlstm_1_3b"]
F32_LEAVES = {"jamba_1_5_large_398b": {"dt_bias", "A_log", "D", "router"},
              "xlstm_1_3b": {"wif"}}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches(arch):
    want = check_tree(arch)
    f32 = {p[-1] for p, (_, dt) in want.items() if dt == "float32"}
    assert f32 == F32_LEAVES[arch]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_step(arch, dtype):
    check_forward_and_decode(arch, dtype, seed=3)


def test_jamba_sliding_window_decode():
    """``sliding_window=4`` with ``max_seq=8`` through the hybrid
    pattern (Mamba + MoE, Mamba + dense, Mamba + MoE, attention +
    dense): the attention slot's cache is a ring of 4, found past the
    Mamba slots, and every step's logits equal the reference's; the
    8-token prefill (over the window) equals the reference's windowed
    prefill.  float32."""
    rcfg, cfg, rp, pp = _both_params("jamba_1_5_large_398b", "float32",
                                     seed=5, sliding_window=4)
    pattern, _ = model.layer_pattern(cfg)
    assert [s.mixer for s in pattern] == ["mamba"] * 3 + ["attn"]
    toks = _tokens(cfg, 5)
    step = ref_step(rcfg)
    rc = ref_model.init_cache(rcfg, B, S)
    pc = model.init_cache(cfg, B, S, device=CPU)
    assert pc["slots"][3]["k"].shape[2] == rc["slots"][3]["k"].shape[2] == 4
    assert model._active_window(cfg, pattern, pc, 1) == 4
    with torch.no_grad():
        for t in range(S):
            want, rc = step(rp, rc, jnp.asarray(toks[:, t:t + 1]), {})
            got, pc = model.forward(pp, torch.from_numpy(toks[:, t:t + 1])
                                    .long(), cfg, cache=pc)
            close(got, want, "float32")
        want, _ = ref_model.forward(rp, jnp.asarray(toks), rcfg)
        got, _ = model.forward(pp, torch.from_numpy(toks).long(), cfg)
    close(got, want, "float32")


def test_mamba_scan_equals_associative_scan():
    """Layer 0's Mamba alone over 64 tokens in float32: the port's
    sequential loop against the reference's associative scan."""
    rcfg, cfg, rp, pp = _both_params("jamba_1_5_large_398b", "float32",
                                     seed=7)
    rm = jax.tree.map(lambda a: a[0], rp["blocks"][0]["mamba"])
    pm = {k: v[0] for k, v in pp["blocks"][0]["mamba"].items()}
    x = np.random.default_rng(7).normal(size=(2, 64, cfg.d_model)) \
        .astype(np.float32)
    want, _ = ref_layers.mamba(rm, jnp.asarray(x), rcfg)
    got, none = layers.mamba(pm, torch.from_numpy(x), cfg)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_slstm_mlstm_decode_chain():
    """xLSTM decode over a whole sequence from an empty cache: every
    step's logits equal the reference's, float32 (the mLSTM's recurrent
    form and the sLSTM's step)."""
    rcfg, cfg, rp, pp = _both_params("xlstm_1_3b", "float32", seed=9)
    assert [s.mixer for s in model.layer_pattern(cfg)[0]] == \
        ["mlstm", "slstm"]
    toks = _tokens(cfg, 9)
    step = ref_step(rcfg)
    rc = ref_model.init_cache(rcfg, B, S)
    pc = model.init_cache(cfg, B, S, device=CPU)
    with torch.no_grad():
        for t in range(S):
            want, rc = step(rp, rc, jnp.asarray(toks[:, t:t + 1]), {})
            got, pc = model.forward(pp, torch.from_numpy(toks[:, t:t + 1])
                                    .long(), cfg, cache=pc)
            close(got, want, "float32")
    assert pc["slots"][0]["C"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference(arch):
    check_generate(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_main_on_cpu(arch, capsys):
    check_main_on_cpu(arch, capsys)


def test_decode_needs_one_token():
    """A decode step of the recurrent mixers takes one token."""
    cfg = configs.reduced_config("xlstm_1_3b")
    params = model.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    cache = model.init_cache(cfg, 1, 4, device=CPU)
    with pytest.raises(ValueError, match="one token"):
        model.forward(params, torch.zeros((1, 2), dtype=torch.long), cfg,
                      cache=cache)
