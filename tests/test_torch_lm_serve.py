"""The port's LM serving path against the JAX package's.

``launch/serve.generate`` at phi3-medium-14b's ``REDUCED`` config in
float32, on weights carried across from the JAX package's
``init_params``, must give the same greedy tokens as the JAX package's
``generate`` on the same prompts; ``make_serve_step`` and
``make_prefill_step`` likewise (tokens equal, logits within rtol = atol =
1e-4, float32 rounding over two layers).  The serving modules must load
without JAX, and the entry points must refuse to run on a missing card.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import steps as ref_steps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model, steps  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "phi3_medium_14b"
CPU = torch.device("cpu")
B, P, GEN = 2, 8, 8


@pytest.fixture(scope="module")
def pair():
    rcfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(reduced_config(ARCH), dtype="float32")
    rp = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    pp = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rp), CPU)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (B, P)).astype(np.int32)
    return {"rcfg": rcfg, "cfg": cfg, "rp": rp, "pp": pp,
            "prompts": prompts}


def test_generate_equals_reference(pair):
    want = ref_serve.generate(pair["rcfg"], pair["rp"], pair["prompts"], GEN)
    times = {}
    got = serve.generate(pair["cfg"], pair["pp"], pair["prompts"], GEN, times)
    assert got.dtype == np.int32 and got.shape == (B, P + GEN)
    np.testing.assert_array_equal(got, want)
    assert times["prefill_s"] > 0 and times["decode_s"] > 0


def test_prefill_step_equals_reference(pair):
    toks = pair["prompts"]
    want = ref_steps.make_prefill_step(pair["rcfg"])(
        pair["rp"], {"tokens": jnp.asarray(toks)})
    got = steps.make_prefill_step(pair["cfg"])(
        pair["pp"], {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, pair["cfg"].vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_serve_step_equals_reference(pair):
    """Greedy decode steps from empty caches, feeding each step's token
    to the next, in both packages."""
    rcfg, cfg = pair["rcfg"], pair["cfg"]
    rstep = jax.jit(ref_steps.make_serve_step(rcfg))
    pstep = steps.make_serve_step(cfg)
    rc = ref_model.init_cache(rcfg, B, P)
    pc = model.init_cache(cfg, B, P, device=CPU)
    rt = jnp.asarray(pair["prompts"][:, :1])
    pt = torch.from_numpy(pair["prompts"][:, :1]).long()
    for _ in range(P):
        rnext, rc = rstep(pair["rp"], rc, {"tokens": rt})
        pnext, pc = pstep(pair["pp"], pc, {"tokens": pt})
        assert pnext.dtype == torch.int32
        np.testing.assert_array_equal(pnext.numpy(), np.asarray(rnext))
        rt, pt = rnext[:, None], pnext[:, None].long()
    assert pc["idx"] == int(rc["idx"]) == P


def test_main_on_cpu(capsys):
    """The command line at the reduced config on the CPU."""
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert out.shape == (2, 7)
    assert "phi3-medium-14b-smoke on cpu: generated 6 tokens" in \
        capsys.readouterr().out


def test_serving_modules_import_no_jax():
    code = ("import sys; import repro_torch.models, repro_torch.models.steps, "
            "repro_torch.launch.serve, repro_torch.configs, repro_torch.convert; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


def test_serve_raises_without_a_card(monkeypatch):
    """``launch/serve`` runs on the card by default; with none it raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", ARCH, "--reduced"])
