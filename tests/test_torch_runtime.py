"""The port's compiled runtime against the JAX package's, bit for bit.

The same programs are traced in both packages, compiled with ``fusion``
and ``exact`` each both ways, and run with ``run`` and ``run_batched``
(B=2).  This file holds the matvec programs of ``tests/test_runtime.py``
(by diagonals, and BSGS with ``bs=4``), the ``validate=`` errors and the
package boundary; ``test_torch_runtime_cheb.py`` holds the Chebyshev
programs and imports the helpers below.

Both contexts get the same parameters and seed and do the same
operations in the same order, so they draw the same keys and masks: the
compiled programs, the outputs (residues, level, scale), the
``reconcile()`` dicts and the engines' ``trace_counts`` must be equal.
The port runs on the CPU (the kernels' plain versions).  The reference
runs each distinct lowered plan once per mode: variants that lower to
the same steps (``fusion`` on a program without a PKB to fuse, say) are
compared with that one run, and the port runs every variant.
"""
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.core import linear as ref_linear  # noqa: E402
from repro.core import polyeval as ref_polyeval  # noqa: E402
from repro.core.ckks import CKKSContext as RefContext  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.runtime import ProgramExecutor as RefExecutor  # noqa: E402
from repro.runtime import TraceContext as RefTrace  # noqa: E402
from repro.runtime import compile_program as ref_compile  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import linear, polyeval  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ProgramExecutor, TraceContext, compile_program,
)

# tests/test_runtime.py's parameters; the Chebyshev programs need L=9
KW = dict(logN=9, L=5, alpha=2, k=3, q_bits=29, scale_bits=29)
KW_CHEB = dict(KW, L=9)

REF = dict(trace=RefTrace, compile=ref_compile, linear=ref_linear,
           polyeval=ref_polyeval, params=RefParams)
PORT = dict(trace=TraceContext, compile=compile_program, linear=linear,
            polyeval=polyeval, params=CKKSParams)

PROGRAMS = {
    "diag": lambda pkg, cx, h, case: pkg["linear"].matvec_diag(
        cx, h, case["diags"]),
    "bsgs": lambda pkg, cx, h, case: pkg["linear"].matvec_bsgs(
        cx, h, case["diags"], bs=4),
    "cheb": lambda pkg, cx, h, case: pkg["polyeval"].eval_chebyshev(
        cx, h, case["coeffs"]),
    "cheb_bsgs": lambda pkg, cx, h, case: pkg["polyeval"].eval_chebyshev_bsgs(
        cx, h, case["coeffs"]),
}
VARIANTS = [(f, e) for f in (False, True) for e in (True, False)]


def cases(names):
    """(name, fusion, exact) parameters and their ids."""
    out = [(n, f, e) for n in names for f, e in VARIANTS]
    ids = [f"{n}-{'fused' if f else 'unfused'}-"
           f"{'exact' if e else 'inexact'}" for n, f, e in out]
    return out, ids


MATVEC, MATVEC_IDS = cases(["diag", "bsgs"])


@contextlib.contextmanager
def unoptimized_reference_compiles():
    """XLA compiles the reference's programs with most optimizations off
    while the block runs, and the setting is restored after it.  Nearly
    all of a first reference run is the compilation of small eager
    programs, which this makes cheaper; their arithmetic is integer, so
    every result is the same."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", old)


def make_pair(kw, seed):
    """Both contexts, and one executor each: an executor keeps its
    plaintext encodings, and the reference's its compiled batched
    rescales, from one test to the next."""
    ref = RefContext(RefParams(**kw), seed=seed)
    port = CKKSContext(CKKSParams(**kw), seed=seed, device="cpu")
    return {"ref": ref, "port": port, "kw": kw, "compiled": {},
            "ref_runs": {},
            "ref_ex": RefExecutor(ref), "port_ex": ProgramExecutor(port)}


def encrypt_both(pair, values):
    """Encrypt every value on both sides, in the same order."""
    pair["ref_in"] = [pair["ref"].encrypt(z) for z in values]
    pair["port_in"] = [pair["port"].encrypt(z) for z in values]


@pytest.fixture(scope="module")
def small():
    pair = make_pair(KW, seed=7)
    rng = np.random.default_rng(5)
    nh = pair["port"].params.num_slots
    pair["diags"] = {d: rng.normal(size=nh) for d in range(8)}
    encrypt_both(pair, [rng.normal(size=nh) + 1j * rng.normal(size=nh)
                         for _ in range(2)])
    return pair


def _trace(pkg, pair, name):
    tc = pkg["trace"](pkg["params"](**pair["kw"]))
    h = tc.input("x", level=pair["kw"]["L"], scale=tc.params.scale)
    tc.output(PROGRAMS[name](pkg, tc, h, pair), "y")
    return tc


def compiled(pair, name, fusion, exact):
    """(reference, port) compiled programs, cached per module."""
    key = (name, fusion, exact)
    if key not in pair["compiled"]:
        pair["compiled"][key] = tuple(
            pkg["compile"](_trace(pkg, pair, name), fusion=fusion,
                           exact=exact)
            for pkg in (REF, PORT))
    return pair["compiled"][key]


def _ref_numpy(ct) -> dict:
    return {"c0": np.asarray(ct.c0), "c1": np.asarray(ct.c1),
            "level": ct.level, "scale": ct.scale}


def _np(ct) -> dict:
    """Either package's ciphertext as numpy."""
    if isinstance(ct.c0, torch.Tensor):
        return convert.ciphertext_to_numpy(ct)
    return _ref_numpy(ct)


def _assert_ct_dict_equal(got: dict, want: dict) -> None:
    assert got["level"] == want["level"]
    assert got["scale"] == want["scale"]
    np.testing.assert_array_equal(got["c0"], want["c0"])
    np.testing.assert_array_equal(got["c1"], want["c1"])


def _assert_outputs_equal(ref_res, port_res) -> None:
    got = convert.exec_result_to_numpy(port_res)
    assert set(got) == set(ref_res.outputs)
    for tag, ref_out in ref_res.outputs.items():
        if isinstance(ref_out, list):
            assert len(got[tag]) == len(ref_out)
            for g, r in zip(got[tag], ref_out):
                _assert_ct_dict_equal(g, _ref_numpy(r))
        else:
            _assert_ct_dict_equal(got[tag], _ref_numpy(ref_out))


def _steps(comp) -> list:
    return [(type(s).__name__, getattr(s, "level", None),
             getattr(s, "out", getattr(s, "nid", None))) for s in comp.steps]


def _nodes(comp) -> list:
    return [(n.id, n.op.value, n.args, n.limbs, n.ext_limbs, n.attrs)
            for n in comp.dfg.nodes.values()]


def _plan_key(comp) -> tuple:
    """Everything the executor's dispatches depend on."""
    return (repr(comp.steps), repr(_nodes(comp)),
            tuple((s.level, s.scale, np.asarray(s.values).tobytes())
                  for s in comp.pt_specs))


def ref_run(pair, rc, batched: bool):
    """The reference's run of ``rc`` (with its report), once per plan."""
    key = (_plan_key(rc), batched)
    if key not in pair["ref_runs"]:
        ex = pair["ref_ex"]
        pair["ref_runs"][key] = (
            ex.run_batched(rc, {"x": pair["ref_in"]}, with_report=True)
            if batched else
            ex.run(rc, {"x": pair["ref_in"][0]}, with_report=True))
    return pair["ref_runs"][key]


# ------------------------- checks, per program --------------------------

def check_compile(pair, name, fusion, exact):
    """Same DFG, plaintext specs, lowered steps and summary."""
    rc, pc = compiled(pair, name, fusion, exact)
    assert pc.summary() == rc.summary()
    assert _steps(pc) == _steps(rc)
    assert _nodes(pc) == _nodes(rc)
    assert len(pc.pt_specs) == len(rc.pt_specs)
    for a, b in zip(pc.pt_specs, rc.pt_specs):
        assert (a.level, a.scale) == (b.level, b.scale)
        np.testing.assert_array_equal(a.values, b.values)
    assert pc.inputs == rc.inputs and pc.outputs == rc.outputs


def check_run(pair, name, fusion, exact, batched: bool):
    """Equal outputs and reports; after a batched run, equal
    ``trace_counts`` (the same dispatch shapes counted as new)."""
    rc, pc = compiled(pair, name, fusion, exact)
    ref_res = ref_run(pair, rc, batched)
    ex = pair["port_ex"]
    port_res = (
        ex.run_batched(pc, {"x": pair["port_in"]}, with_report=True)
        if batched else
        ex.run(pc, {"x": pair["port_in"][0]}, with_report=True))
    _assert_outputs_equal(ref_res, port_res)
    ref_rep, port_rep = ref_res.report, port_res.report
    assert port_rep.reconcile() == ref_rep.reconcile()
    assert port_rep.reconcile()["counts_match"]
    assert port_rep.plan_shapes == ref_rep.plan_shapes
    assert port_rep.batch == ref_rep.batch == (2 if batched else 1)
    assert port_rep.lowering == rc.summary()
    assert port_rep.validate_plan_shapes(pair["port"].params)
    if batched:
        assert (pair["port"].engine.trace_counts
                == pair["ref"].engine.trace_counts)


def check_eager(pair, name):
    """``fusion=False, exact=True`` replays the port's eager run, which
    therefore equals the reference's compiled run too."""
    rc, pc = compiled(pair, name, False, True)
    port, ct = pair["port"], pair["port_in"][0]
    got = pair["port_ex"].run(pc, {"x": ct})["y"]
    want = PROGRAMS[name](PORT, port, ct, pair)
    _assert_ct_dict_equal(_np(got), _np(want))
    _assert_ct_dict_equal(_np(got), _ref_numpy(ref_run(pair, rc, False)["y"]))


# ------------------------------- matvec ---------------------------------

@pytest.mark.parametrize("name,fusion,exact", MATVEC, ids=MATVEC_IDS)
def test_compile_equal(small, name, fusion, exact):
    check_compile(small, name, fusion, exact)


@pytest.mark.parametrize("name,fusion,exact", MATVEC, ids=MATVEC_IDS)
def test_run_equal(small, name, fusion, exact):
    check_run(small, name, fusion, exact, batched=False)


@pytest.mark.parametrize("name,fusion,exact", MATVEC, ids=MATVEC_IDS)
def test_run_batched_equal(small, name, fusion, exact):
    check_run(small, name, fusion, exact, batched=True)


def test_batched_rescale_is_one_poly_call(small, monkeypatch):
    """A batch's rescale goes through ``poly.rescale`` once, with both
    components of every ciphertext along its leading axes."""
    from repro_torch.runtime import exec as port_exec

    seen = []
    real = port_exec.poly.rescale

    def spy(x, level, pc, *a, **kw):
        seen.append(tuple(x.shape))
        return real(x, level, pc, *a, **kw)

    rc, pc = compiled(small, "diag", False, True)
    ref_res = ref_run(small, rc, batched=True)
    monkeypatch.setattr(port_exec.poly, "rescale", spy)
    port_res = small["port_ex"].run_batched(
        pc, {"x": small["port_in"]})
    n_rescale = sum(1 for s in pc.steps
                    if getattr(s, "nid", None) is not None
                    and pc.dfg.nodes[s.nid].op.value == "rescale")
    assert n_rescale >= 1
    N = small["port"].params.N
    assert seen == [(2, 2, KW["L"] + 1, N)] * n_rescale
    _assert_outputs_equal(ref_res, port_res)


# --------------------------- validate= errors ---------------------------

def _corrupt(ct, pkg_is_ref: bool, q: int):
    """A copy of ``ct`` with residue (0, 0) of c0 set to ``q``."""
    if pkg_is_ref:
        return type(ct)(ct.c0.at[0, 0].set(q), ct.c1, ct.level, ct.scale)
    c0 = ct.c0.clone()
    c0[0, 0] = q
    return type(ct)(c0, ct.c1, ct.level, ct.scale)


def _poison_input(kind, ct, is_ref, pair):
    q0 = pair["port"].params.q_primes[0]
    if kind == "corrupt_input":
        return {"x": _corrupt(ct, is_ref, q0)}
    if kind == "wrong_level":
        return {"x": type(ct)(ct.c0[:-1], ct.c1[:-1], ct.level - 1,
                              ct.scale)}
    if kind == "scale_drift":
        return {"x": type(ct)(ct.c0, ct.c1, ct.level, ct.scale * 2.0)}
    assert kind == "missing_tag"
    return {"other": ct}


@pytest.mark.parametrize("kind", ["corrupt_input", "wrong_level",
                                  "scale_drift", "missing_tag"])
def test_validate_same_typed_error(small, kind):
    rc, pc = compiled(small, "bsgs", False, True)
    errs = []
    for is_ref, ex, comp, ct in (
            (True, small["ref_ex"], rc, small["ref_in"][0]),
            (False, small["port_ex"], pc, small["port_in"][0])):
        with pytest.raises(Exception) as info:
            ex.run(comp, _poison_input(kind, ct, is_ref, small),
                   validate=True)
        errs.append(info.value)
    ref_err, port_err = errs
    assert type(port_err).__name__ == type(ref_err).__name__
    assert type(port_err).__module__ == "repro_torch.errors"
    assert str(port_err) == str(ref_err)


def test_validate_mixed_batch_same_error(small):
    rc, pc = compiled(small, "diag", False, True)
    errs = []
    for ctx, ex, comp, cts in (
            (small["ref"], small["ref_ex"], rc, small["ref_in"]),
            (small["port"], small["port_ex"], pc, small["port_in"])):
        low = ctx.level_down(cts[1], cts[1].level - 1)
        with pytest.raises(Exception) as info:
            ex.run_batched(comp, {"x": [cts[0], low]}, validate=True)
        errs.append(info.value)
    assert type(errs[1]).__name__ == type(errs[0]).__name__ \
        == "ModulusChainMismatchError"
    assert str(errs[1]) == str(errs[0])


def test_validate_poisoned_block_same_error(small, monkeypatch):
    """A hoisted block whose output leaves [0, q) is caught at the block
    boundary, with the same typed error on both sides."""
    rc, pc = compiled(small, "diag", False, True)
    q0 = small["port"].params.q_primes[0]
    errs = []
    for is_ref, ctx, ex, comp, ct in (
            (True, small["ref"], small["ref_ex"], rc, small["ref_in"][0]),
            (False, small["port"], small["port_ex"], pc,
             small["port_in"][0])):
        real = ctx.add_zero_step_terms

        def poisoned(*a, _real=real, _is_ref=is_ref, **kw):
            return _corrupt(_real(*a, **kw), _is_ref, q0)

        monkeypatch.setattr(ctx, "add_zero_step_terms", poisoned)
        with pytest.raises(Exception) as info:
            ex.run(comp, {"x": ct}, validate=True)
        errs.append(info.value)
    assert type(errs[1]).__name__ == type(errs[0]).__name__ \
        == "CorruptCiphertextError"
    assert str(errs[1]) == str(errs[0])
    assert "HoistedStep" in str(errs[1])


# --------------------------- package boundary ---------------------------

def test_runtime_imports_no_jax():
    """The runtime, dfg and obs of the port load neither JAX nor any
    module of the JAX package."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys\n"
        "import repro_torch.runtime, repro_torch.dfg, repro_torch.obs\n"
        "import repro_torch.core.linear, repro_torch.core.polyeval\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=src,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"


# the eager replays run on the port alone, so they come last: the tests
# above compare the two engines' trace_counts
@pytest.mark.parametrize("name", ["diag", "bsgs"])
def test_unfused_equals_eager(small, name):
    check_eager(small, name)
