"""The port's VLM and encoder-decoder families against the JAX package's
``models/``: qwen2-vl-2b (M-RoPE over three position streams, stub
patch embeddings in place of the first tokens' embeddings, biased
attention) and whisper-base (a bidirectional encoder over stub frame
embeddings, a decoder with cross-attention to it, sinusoidal positions,
layernorm and GELU).

At the ``REDUCED`` configs the reference's weights are carried across,
and prefill and one decode step from the reference's cache are held as
``test_torch_models_mla_moe.py`` holds MLA and MoE, at its tolerances:
once with the defaults (positions from the token index, the same in all
three streams; a zero encoder input of 128 frames), once with stub
embeddings and, for qwen2-vl, three different position streams.  As in
the reference, whisper's encoder runs again at every decode step.  The
decoder-only ``pos="learned"`` branch is held at the dense reduced
config.  Last, no module of the port, and not ``chip_smoke.py``,
imports JAX or the JAX package.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import steps as ref_steps  # noqa: E402
from repro_torch.models import model, steps  # noqa: E402
from test_torch_models import _both_params, _tokens  # noqa: E402
from test_torch_models_mla_moe import (  # noqa: E402
    B, CPU, DTYPES, S, check_forward_and_decode, check_generate,
    check_main_on_cpu, check_tree,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["qwen2_vl_2b", "whisper_base"]
N_PATCH, T_AUDIO = 3, 12


def _streams(start, n):
    """Three different M-RoPE position streams (3, B, n) from ``start``:
    temporal, and two spatial ones."""
    t = np.arange(start, start + n)
    pos = np.stack([t, t // 2, t % 3]).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, n)))


def _embeds(d, n, seed):
    return np.random.default_rng(seed).normal(size=(B, n, d)) \
        .astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches(arch):
    want = check_tree(arch)
    if arch == "whisper_base":
        assert {p[0] for p in want} >= {"encoder", "cross"}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_step(arch, dtype):
    check_forward_and_decode(arch, dtype, seed=3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_embeds_and_position_streams(dtype):
    """Stub patch embeddings over the first N_PATCH tokens and three
    different position streams in prefill; the decode steps pass their
    own three streams."""
    d = 48  # the reduced config's width
    check_forward_and_decode(
        "qwen2_vl_2b", dtype, seed=13,
        prefill_kw={"positions": _streams(0, S),
                    "embeds": _embeds(d, N_PATCH, 13)},
        step_kw=lambda t: {"positions": _streams(t, 1)})


@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_with_embeds(dtype):
    """Whisper over stub frame embeddings (B, T_AUDIO, d): the encoder
    output feeds every decoder layer's cross-attention, in prefill and
    at every decode step."""
    emb = _embeds(64, T_AUDIO, 17)
    check_forward_and_decode("whisper_base", dtype, seed=17,
                             prefill_kw={"embeds": emb},
                             step_kw=lambda t: {"embeds": emb})


def test_learned_positions_decoder_only():
    """The decoder-only ``pos="learned"`` branch (sinusoidal positions
    added to the embeddings) at the dense reduced config."""
    check_forward_and_decode("phi3_medium_14b", "float32", seed=19,
                             pos="learned")


def test_steps_pass_positions_and_embeds():
    """``make_prefill_step`` and ``make_serve_step`` pass a batch's
    ``positions`` and ``embeds`` through: qwen2-vl's prefill with stub
    patches and three streams, then greedy decode steps with their own
    streams, against the reference's steps (float32)."""
    rcfg, cfg, rp, pp = _both_params("qwen2_vl_2b", "float32", seed=23)
    toks = _tokens(cfg, 23)
    batch = {"tokens": toks, "positions": _streams(0, S),
             "embeds": _embeds(cfg.d_model, N_PATCH, 23)}
    want = ref_steps.make_prefill_step(rcfg)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = steps.make_prefill_step(cfg)(
        pp, {k: torch.from_numpy(v).long() if k == "tokens"
             else torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    rstep = jax.jit(ref_steps.make_serve_step(rcfg))
    pstep = steps.make_serve_step(cfg)
    rc = ref_model.init_cache(rcfg, B, 4)
    pc = model.init_cache(cfg, B, 4, device=CPU)
    rt, pt = jnp.asarray(toks[:, :1]), torch.from_numpy(toks[:, :1]).long()
    for t in range(4):
        pos = _streams(t, 1)
        rnext, rc = rstep(rp, rc, {"tokens": rt,
                                   "positions": jnp.asarray(pos)})
        pnext, pc = pstep(pp, pc, {"tokens": pt,
                                   "positions": torch.from_numpy(pos)})
        np.testing.assert_array_equal(pnext.numpy(), np.asarray(rnext))
        rt, pt = rnext[:, None], pnext[:, None].long()


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference(arch):
    check_generate(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_main_on_cpu(arch, capsys):
    check_main_on_cpu(arch, capsys)


@pytest.mark.parametrize("arch", ["stablelm_3b", "command_r_35b"])
def test_main_on_cpu_dense(arch, capsys):
    """The two dense architectures whose command line no other file
    runs (phi3's is in ``test_torch_lm_serve.py``): with the seven
    families' ``test_main_on_cpu`` cases, all ten run on the CPU."""
    check_main_on_cpu(arch, capsys)


def test_port_and_chip_smoke_import_no_jax():
    """Every module of ``repro_torch`` and ``chip_smoke.py`` load without
    JAX, ``jaxlib``, ``ml_dtypes`` or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 40 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
