"""The port's EvalMod against the JAX package's.

``tests/test_runtime_bootstrap.py:28``'s chain is too short for EvalMod
(its pre- and post-scaling take 2 levels and the Chebyshev polynomial
about 4 more), so this runs at ``tests/test_runtime_bootstrap.py:157``'s
parameters (logN=8, L=19, ``cheb_degree=27``) on a fresh encryption at
the level EvalMod enters with in the whole pipeline there: ModRaise
lifts to L, C2S takes one level per stage group, and the re/im split
one more.  The slots hold what C2S leaves there, (q0 / scale) * (I + m /
q0) with I a small integer, and EvalMod returns about (q0 / scale) *
sin(2 pi x) / (2 pi).

The reference runs EvalMod once, eagerly (some 65 s of JAX compilation
on a CPU), with most of XLA's optimizations off
(``unoptimized_reference_compiles``): its programs are integer, so the
results are the same.  The port's eager run, and its compiled run (``fusion=False,
exact=True`` replays the eager run bit for bit), must give its residues.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.bootstrap import Bootstrapper as RefBootstrapper  # noqa: E402
from repro.core.ckks import CKKSContext as RefContext  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro_torch.core.bootstrap import Bootstrapper  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ProgramExecutor, TraceContext, compile_program,
)
from test_torch_bootstrap import BTP_BOOT, KW_BOOT  # noqa: E402
from test_torch_runtime import (  # noqa: E402
    _assert_ct_dict_equal, _np, unoptimized_reference_compiles,
)

# ModRaise -> level L; C2S -> L - n_groups; the re/im split's rescale -> 1 less
LEVEL_IN = KW_BOOT["L"] - BTP_BOOT["n_groups"] - 1
# slot error of EvalMod's output against (q0 / scale) sin(2 pi x) / (2 pi):
# the degree-27 approximation on [-3.5, 3.5] at scale 2^29 (2.4e-3 on
# this input)
MAX_ERR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_reference():
    with unoptimized_reference_compiles():
        yield


@pytest.fixture(scope="module")
def evalmod():
    rng = np.random.default_rng(157)
    p = CKKSParams(**KW_BOOT)
    q0_over_scale = p.q_primes[0] / p.scale
    x = (rng.integers(-BTP_BOOT["mod_K"], BTP_BOOT["mod_K"] + 1, p.num_slots)
         + rng.normal(size=p.num_slots) * 0.01)
    out = {"x": x, "q0_over_scale": q0_over_scale}
    ref = RefContext(RefParams(**KW_BOOT), seed=7, hamming_weight=8)
    ct = ref.encrypt(x * q0_over_scale, level=LEVEL_IN)
    out["ref"] = {"ctx": ref, "ct": ct, "out": RefBootstrapper(
        ref, **BTP_BOOT).eval_mod(ct, q0_over_scale)}
    port = CKKSContext(p, seed=7, hamming_weight=8, device="cpu")
    btp = Bootstrapper(port, **BTP_BOOT)
    ct = port.encrypt(x * q0_over_scale, level=LEVEL_IN)
    before = port.counters.snapshot()
    eager = btp.eval_mod(ct, q0_over_scale)
    eager_ops = port.counters.delta(before)
    tc = TraceContext(p)
    h = tc.input("x", level=LEVEL_IN, scale=ct.scale)
    tc.output(btp.eval_mod(h, q0_over_scale, ctx=tc), "y")
    comp = compile_program(tc)
    before = port.counters.snapshot()
    res = ProgramExecutor(port).run(comp, {"x": ct}, with_report=True)
    out["port"] = {"ctx": port, "ct": ct, "out": eager, "ops": eager_ops,
                   "comp": comp, "res": res,
                   "comp_ops": port.counters.delta(before)}
    return out


def test_input_equal(evalmod):
    _assert_ct_dict_equal(_np(evalmod["port"]["ct"]),
                          _np(evalmod["ref"]["ct"]))


def test_eager_eval_mod_equal(evalmod):
    ref, port = evalmod["ref"], evalmod["port"]
    got, want = port["out"], ref["out"]
    _assert_ct_dict_equal(_np(got), _np(want))
    assert got.level < LEVEL_IN
    assert port["ops"].relin > 0


def test_compiled_eval_mod_equal(evalmod):
    """Compiled without fusion and exact, EvalMod replays the eager run:
    the reference's residues again, with ``counts_match``."""
    ref, port = evalmod["ref"], evalmod["port"]
    _assert_ct_dict_equal(_np(port["res"]["y"]), _np(ref["out"]))
    rep = port["res"].report
    assert rep.reconcile()["counts_match"]
    assert rep.validate_plan_shapes(port["ctx"].params)
    assert port["comp_ops"].relin == port["ops"].relin
    assert port["comp"].n_relin > 0


def test_eval_mod_decrypts(evalmod):
    """Both packages decrypt alike, near the scaled sine."""
    ref, port = evalmod["ref"], evalmod["port"]
    got = port["ctx"].decrypt(port["out"])
    assert np.abs(got - ref["ctx"].decrypt(ref["out"])).max() < 1e-9
    want = (evalmod["q0_over_scale"] * np.sin(2 * np.pi * evalmod["x"])
            / (2 * np.pi))
    assert np.abs(got.real - want).max() < MAX_ERR
