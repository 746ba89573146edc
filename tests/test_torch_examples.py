"""The port's examples (``examples/torch_*.py``) run on the CPU and agree
with the JAX package's.

Each example runs in a subprocess with ``--device cpu`` at small
settings, while a third subprocess computes what the reference's
``examples/quickstart.py`` prints for its steps 1 to 4 with the JAX
package (its step 5, the compiled bootstrap, costs the reference about
two minutes of compilation, so the port's step 5 is held to its own
invariants instead).  The port is bit-exact with the reference at the
same parameters and seeds, so:

- step 1: the decryption error of the hoisted rotation sum equals the
  reference's to the 7 digits printed, with 1 ModUp and 1 ModDown;
- step 2: the eager, compiled and fused ModUp counts equal the
  reference's; the compiled run is bit-exact with eager, the report
  reconciles, the batched run equals the single runs;
- steps 3 and 4: the PKBs, the fusion plan and the simulated latencies
  (the modelled accelerators', numpy on both sides) are the same lines;
- step 5: compiled == eager bit for bit with fewer ModUps, and the
  bootstrap decrypts within 2e-2 of its input (the tolerance of a
  degree-27 EvalMod at logN = 6; the reference's own run prints about
  7e-3).

The LM examples' weights come from torch's generator, not JAX's, so
they are held to their own outputs: the generated shape and token
range, and a training run whose loss falls and that resumes from its
checkpoint.  No example imports ``repro`` or ``jax``, and each refuses
to run without a card unless it is given ``--device cpu``.
"""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = {name: REPO / "examples" / f"torch_{name}.py"
            for name in ("quickstart", "serve_decode", "train_lm")}

# runs an example as __main__, then reports which packages it imported
WRAP = textwrap.dedent("""
    import json
    import runpy
    import sys

    path, argv = sys.argv[1], sys.argv[2:]
    sys.argv = [path] + argv
    runpy.run_path(path, run_name="__main__")
    mods = [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    print(json.dumps({"foreign_modules": sorted(mods)}))
""")

REFERENCE = textwrap.dedent("""
    import json

    import jax
    import numpy as np

    jax.config.update("jax_disable_most_optimizations", True)

    from repro.core import linear
    from repro.core.ckks import CKKSContext
    from repro.core.params import CKKSParams
    from repro.dfg.fusion import optimal_fusion
    from repro.dfg.pkb import identify_pkbs
    from repro.dfg.programs import bootstrapping_dfg, convbn_example
    from repro.runtime import ProgramExecutor, TraceContext, compile_program
    from repro.sim import HE2_LM, SHARP
    from repro.sim.engine import simulate_program

    params = CKKSParams(logN=9, L=5, alpha=2, k=3, q_bits=29, scale_bits=29)
    ctx = CKKSContext(params, seed=1)
    nh = params.num_slots
    rng = np.random.default_rng(0)
    z = rng.normal(size=nh)
    ct = ctx.encrypt(z)
    steps = [1, 2, 4]
    ptvals = [rng.normal(size=nh) for _ in steps]
    pts = [ctx.encode(v) for v in ptvals]
    s0 = ctx.counters.snapshot()
    out = ctx.hoisted_rotation_sum(ct, steps, pts)
    d = ctx.counters.delta(s0)
    expect = sum(np.roll(z, -s) * v for s, v in zip(steps, ptvals))
    err = float(np.abs(ctx.decrypt(out) - expect).max())

    diags = {k: rng.normal(size=nh) for k in range(8)}
    tc = TraceContext(params)
    h = tc.input("x", level=params.L, scale=params.scale)
    tc.output(linear.matvec_bsgs(tc, h, diags, bs=4), "y")
    ex = ProgramExecutor(ctx)

    def modups(fn):
        s = ctx.counters.snapshot()
        fn()
        return ctx.counters.delta(s).modup

    m = [modups(lambda: linear.matvec_bsgs(ctx, ct, diags, bs=4)),
         modups(lambda: ex.run(compile_program(tc), {"x": ct})),
         modups(lambda: ex.run(compile_program(tc, fusion=True),
                               {"x": ct}))]

    pkbs = identify_pkbs(convbn_example().g)
    plan = optimal_fusion(pkbs, k=12, alpha=12, nh=1 << 15,
                          capacity_words=8e9 / 8)
    sharp = simulate_program(bootstrapping_dfg(bsgs_bs=4).g, SHARP,
                             "minks", "EVF")
    he2 = simulate_program(bootstrapping_dfg(bsgs_bs=0).g, HE2_LM,
                           "hoist", "hybrid", fusion=True)
    print(json.dumps({
        "err": err, "modup": d.modup, "moddown": d.moddown, "modups": m,
        "pkbs": [p.n_rot for p in pkbs],
        "degrees": [[p.indeg, p.outdeg] for p in pkbs],
        "groups": plan.groups, "saving_us": round(plan.score * 1e6),
        "keys": len(set(plan.fused[0].steps)),
        "sharp_ms": sharp.latency_s * 1e3, "he2_ms": he2.latency_s * 1e3,
        "stall": he2.comm_stall_frac}))
""")


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def _example(name: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", WRAP, str(EXAMPLES[name]), *args],
        env=_env(), capture_output=True, text=True, timeout=600)


def _ok(out: subprocess.CompletedProcess) -> str:
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def _train_twice(ckpt: str) -> tuple:
    args = ("--device", "cpu", "--ckpt-dir", ckpt, "--steps", "24",
            "--seq", "16", "--ckpt-every", "12")
    return _example("train_lm", *args), _example("train_lm", *args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("train_lm_ckpt"))
    with ThreadPoolExecutor(4) as pool:
        ref = pool.submit(subprocess.run, [sys.executable, "-c", REFERENCE],
                          env=_env(), capture_output=True, text=True,
                          timeout=600)
        quick = pool.submit(_example, "quickstart", "--device", "cpu")
        serve = pool.submit(_example, "serve_decode", "--device", "cpu",
                            "--gen", "8")
        train = pool.submit(_train_twice, ckpt)
        out = {"reference": json.loads(
            _ok(ref.result()).strip().splitlines()[-1])}
        out["quickstart"] = _ok(quick.result())
        out["serve_decode"] = _ok(serve.result())
        first, second = train.result()
        out["train_lm"] = (_ok(first), _ok(second))
    return out


def _line(text: str, tag: str) -> str:
    return next(x for x in text.splitlines() if x.startswith(tag))


def test_quickstart_steps_1_to_4_match_reference(runs):
    ref, text = runs["reference"], runs["quickstart"]
    m = re.search(r"max err (\S+) \((\d+) ModUp \+ (\d+) ModDown",
                  _line(text, "[1]"))
    assert float(m.group(1)) == pytest.approx(ref["err"], rel=1e-6)
    assert (int(m.group(2)), int(m.group(3))) == (ref["modup"],
                                                  ref["moddown"]) == (1, 1)
    two = _line(text, "[2]")
    assert "bit-exact=True" in two and "reconciled=True" in two
    e, c, f = ref["modups"]
    assert f"ModUps eager={e} compiled={c} fused={f}" in two
    assert "equal to single runs=True" in text
    assert _line(text, "[3]") == (
        f"[3] ConvBN PKBs: {ref['pkbs']} rotations (in/out degree "
        f"{[tuple(d) for d in ref['degrees']]})")
    assert (f"HERO fuses groups {ref['groups']}, saving {ref['saving_us']} "
            f"us/block; fused evk set: {ref['keys']} keys") in text
    m = re.search(r"SHARP (\S+) ms vs HE2-LM (\S+) ms", _line(text, "[4]"))
    assert float(m.group(1)) == pytest.approx(ref["sharp_ms"], abs=1e-6)
    assert float(m.group(2)) == pytest.approx(ref["he2_ms"], abs=1e-6)
    assert f"comm stalls {ref['stall'] * 100:.1f}%" in text


def test_quickstart_compiled_bootstrap(runs):
    five = _line(runs["quickstart"], "[5]")
    m = re.search(r"bit-exact=(\w+); ModUps eager=(\d+) compiled=(\d+); "
                  r"levels 0 -> (\d+); max err (\S+)", five)
    assert m.group(1) == "True"
    assert int(m.group(3)) < int(m.group(2))
    assert int(m.group(4)) > 0
    assert float(m.group(5)) < 2e-2


def test_serve_decode_generates(runs):
    m = re.search(r"generated \((\d+), (\d+)\) tokens on cpu.*first row: "
                  r"\[([\d, ]+)\]", runs["serve_decode"])
    assert (int(m.group(1)), int(m.group(2))) == (2, 8 + 8)
    row = [int(t) for t in m.group(3).split(",")]
    assert len(row) == 16 and all(0 <= t < 512 for t in row)


def test_train_lm_learns_and_resumes(runs):
    first, second = runs["train_lm"]
    m = re.search(r"loss: (\S+) -> (\S+) over 24 steps", first)
    assert float(m.group(2)) < float(m.group(1))
    assert "[trainer] resumed from step 24" in second
    assert "nothing to run: the checkpoint is at step 24" in second


def test_examples_import_neither_repro_nor_jax(runs):
    for name, path in EXAMPLES.items():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("repro", "jax"), (name, n)
    for text in (runs["quickstart"], runs["serve_decode"],
                 *runs["train_lm"]):
        last = json.loads(text.strip().splitlines()[-1])
        assert last["foreign_modules"] == []


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_need_a_card_unless_cpu(name, tmp_path):
    """Without ``--device cpu`` an example asks for the card, and raises
    where there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    args = ("--ckpt-dir", str(tmp_path)) if name == "train_lm" else ()
    out = _example(name, *args)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
