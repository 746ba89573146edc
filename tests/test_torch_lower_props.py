"""Property test of the port's lowering: compiled output equals the
reference's compiled output on random programs.

Programs are drawn with the strategy of ``tests/test_lower_props.py``
(random diagonal sums, BSGS splits, relin chains, bare rotations, random
input levels), traced in both packages, compiled with ``fusion=False``
and run in each.  The property is port == reference, bit for bit, with
equal reconciliation: not compiled == eager, which the reference itself
fails on a drawn program (kept below as a deterministic case, where the
port shows the same gap).

The hypothesis sweep neither reads nor writes an example database and
draws the same cases in every run (``database=None, derandomize=True``
on the test itself); nothing is set at import time.  The reference's
programs compile with most of XLA's optimizations off
(``unoptimized_reference_compiles``, restored after the module); they
are integer, so their results are the same.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import linear as ref_linear  # noqa: E402
from repro.core.ckks import CKKSContext as RefContext  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.runtime import ProgramExecutor as RefExecutor  # noqa: E402
from repro.runtime import TraceContext as RefTrace  # noqa: E402
from repro.runtime import compile_program as ref_compile  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import linear  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ProgramExecutor, TraceContext, compile_program,
)
from test_torch_runtime import unoptimized_reference_compiles  # noqa: E402

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

# tests/test_lower_props.py's parameters
KW = dict(logN=7, L=6, alpha=2, k=3, q_bits=29, scale_bits=29)


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_reference():
    with unoptimized_reference_compiles():
        yield


@pytest.fixture(scope="module")
def pair():
    ref = RefContext(RefParams(**KW), seed=17)
    port = CKKSContext(CKKSParams(**KW), seed=17, device="cpu")
    return {"ref": ref, "port": port, "ref_ex": RefExecutor(ref),
            "port_ex": ProgramExecutor(port)}


def _diags(nh: int, steps, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {int(s): rng.normal(size=nh) for s in steps}


def _apply_blocks(lin, cx, h, blocks, nh):
    """Replay a drawn op sequence on any context (eager or tracing)."""
    for b in blocks:
        kind = b[0]
        if kind == "diag":
            h = lin.matvec_diag(cx, h, _diags(nh, b[1], b[2]))
        elif kind == "bsgs":
            h = lin.matvec_bsgs(cx, h, _diags(nh, b[1], b[2]), bs=b[3])
        elif kind == "square":
            h = cx.multiply(h, h)
        elif kind == "rot":
            h = cx.rotate(h, b[1])
        else:                                      # pragma: no cover
            raise AssertionError(kind)
    return h


def _levels_needed(blocks) -> int:
    return sum(1 for b in blocks if b[0] in ("diag", "bsgs", "square"))


def _np(ct) -> dict:
    if hasattr(ct.c0, "cpu"):
        return convert.ciphertext_to_numpy(ct)
    return {"c0": np.asarray(ct.c0), "c1": np.asarray(ct.c1),
            "level": ct.level, "scale": ct.scale}


def _equal(a: dict, b: dict) -> bool:
    return (a["level"] == b["level"] and a["scale"] == b["scale"]
            and np.array_equal(a["c0"], b["c0"])
            and np.array_equal(a["c1"], b["c1"]))


def _check(pair, blocks, input_level: int, seed: int = 7) -> bool:
    """Port == reference on the compiled output and the reconciliation.
    Returns whether the port's compiled output equals its eager one."""
    nh = pair["port"].params.num_slots
    assert input_level >= _levels_needed(blocks)
    z = np.random.default_rng(seed).normal(size=nh)
    outs = []
    for side, lin, trace, comp in (
            ("ref", ref_linear, RefTrace, ref_compile),
            ("port", linear, TraceContext, compile_program)):
        ctx = pair[side]
        tc = trace(ctx.params)
        h = tc.input("x", level=input_level, scale=ctx.params.scale)
        tc.output(_apply_blocks(lin, tc, h, blocks, nh), "y")
        ct = ctx.encrypt(z, level=input_level)
        res = pair[f"{side}_ex"].run(comp(tc), {"x": ct}, with_report=True)
        outs.append((ctx, lin, ct, res))
    (_, _, _, ref_res), (port, lin, ct, port_res) = outs
    assert _equal(_np(port_res["y"]), _np(ref_res["y"])), \
        "port's compiled output != reference's"
    assert port_res.report.reconcile() == ref_res.report.reconcile()
    assert port_res.report.reconcile()["counts_match"]
    eager = _apply_blocks(lin, port, ct, blocks, nh)
    return _equal(_np(port_res["y"]), _np(eager))


CASES = [
    # zero-step diagonal inside a PKB (the identity-rotation fold)
    [("diag", (0, 1, 5), 1)],
    # BSGS baby/giant split feeding a relin
    [("bsgs", (0, 1, 2, 3, 9, 11), 2, 2), ("square",)],
    # bare rotation between keyed sums — anchor is a rotation output
    [("diag", (1, 3), 4), ("rot", 7), ("diag", (0, 2), 5)],
    # relin chain then a sum at the lowered level
    [("square",), ("square",), ("diag", (2, 6), 6)],
]


@pytest.mark.parametrize("blocks", CASES, ids=lambda b: b[0][0] + str(len(b)))
def test_port_equals_reference_representatives(pair, blocks):
    assert _check(pair, blocks, input_level=KW["L"])


def test_reference_compiled_eager_gap_shows_on_port(pair):
    """The program on which the reference's own property fails (compiled
    != eager): a bare rotation feeding a step-0-only diagonal sum, at
    input level 1.  The port's compiled output equals the reference's,
    and the port shows the same gap to its eager replay."""
    blocks = [("rot", 1), ("diag", (0,), 0)]
    assert not _check(pair, blocks, input_level=1)


if HAVE_HYPOTHESIS:
    def _block_st(nh):
        steps = st.lists(st.integers(0, nh - 1), min_size=1, max_size=4,
                         unique=True).map(tuple)
        seeds = st.integers(0, 2**16)
        return st.one_of(
            st.tuples(st.just("diag"), steps, seeds),
            st.tuples(st.just("bsgs"), steps, seeds,
                      st.sampled_from((2, 4))),
            st.tuples(st.just("square")),
            st.tuples(st.just("rot"), st.integers(1, nh - 1)),
        )

    @st.composite
    def _programs(draw, nh, L):
        blocks = draw(st.lists(_block_st(nh), min_size=1, max_size=4))
        lo = max(_levels_needed(blocks), 1)
        level = draw(st.integers(lo, L))
        return blocks, level

    @settings(database=None, derandomize=True, deadline=None,
              max_examples=8, suppress_health_check=list(HealthCheck))
    @given(data=st.data())
    def test_port_equals_reference_random_graphs(pair, data):
        nh, L = pair["port"].params.num_slots, pair["port"].params.L
        blocks, level = data.draw(_programs(nh, L))
        _check(pair, blocks, input_level=level)
