"""The port's compiled Chebyshev programs against the JAX package's.

The dense Chebyshev of ``tests/test_runtime.py`` and the BSGS Chebyshev
of ``tests/test_relin.py``, whose CMULTs lower to ``RelinStep`` (and,
with ``exact=False``, to ``MultiRelinStep``), at ``L=9``: traced in both
packages, compiled with ``fusion`` and ``exact`` each both ways, run
with ``run`` and ``run_batched`` (B=2) and held bit for bit, as
``test_torch_runtime.py`` (whose helpers this file uses) holds the
matvec programs.  Nearly all of the file's time is the reference's first
run: some 1,200 small eager programs that XLA compiles, here with most
optimizations off (``unoptimized_reference_compiles``); they are integer
programs, so the results are the same.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import polyeval as ref_polyeval  # noqa: E402
from repro_torch.core import polyeval  # noqa: E402
from repro_torch.dfg.graph import OpKind  # noqa: E402
from repro_torch.runtime.lower import MultiRelinStep, RelinStep  # noqa: E402
from test_torch_runtime import (  # noqa: E402
    KW, cases, check_compile, check_eager, check_run, compiled,
    encrypt_both, make_pair, unoptimized_reference_compiles,
)

CHEB, CHEB_IDS = cases(["cheb", "cheb_bsgs"])


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_reference():
    with unoptimized_reference_compiles():
        yield


@pytest.fixture(scope="module")
def cheb():
    pair = make_pair(dict(KW, L=9), seed=11)
    rng = np.random.default_rng(9)
    nh = pair["port"].params.num_slots
    fn = lambda t: np.sin(2 * np.pi * 1.5 * t) / (2 * np.pi)  # noqa: E731
    pair["coeffs"] = polyeval.chebyshev_coeffs(fn, 15)
    np.testing.assert_array_equal(pair["coeffs"],
                                  ref_polyeval.chebyshev_coeffs(fn, 15))
    encrypt_both(pair, [rng.uniform(-1, 1, nh) for _ in range(2)])
    return pair


@pytest.mark.parametrize("name,fusion,exact", CHEB, ids=CHEB_IDS)
def test_compile_equal(cheb, name, fusion, exact):
    check_compile(cheb, name, fusion, exact)


@pytest.mark.parametrize("exact", [True, False])
def test_cheb_bsgs_relin_steps(cheb, exact):
    """Every CMULT lowers to a RelinStep, or with ``exact=False`` merges
    into a MultiRelinStep, in both packages alike."""
    rc, pc = compiled(cheb, "cheb_bsgs", False, exact)
    n_relin = sum(isinstance(s, RelinStep) for s in pc.steps)
    n_multi = sum(isinstance(s, MultiRelinStep) for s in pc.steps)
    merged = sum(s.n_relin for s in pc.steps if isinstance(s, MultiRelinStep))
    assert n_relin + merged == pc.dfg.count(OpKind.CMULT)
    assert (n_multi > 0) == (not exact)
    assert pc.summary()["merged_relins"] == rc.summary()["merged_relins"]


@pytest.mark.parametrize("name,fusion,exact", CHEB, ids=CHEB_IDS)
def test_run_equal(cheb, name, fusion, exact):
    check_run(cheb, name, fusion, exact, batched=False)


@pytest.mark.parametrize("name,fusion,exact", CHEB, ids=CHEB_IDS)
def test_run_batched_equal(cheb, name, fusion, exact):
    check_run(cheb, name, fusion, exact, batched=True)


# the eager replays run on the port alone, so they come last: the tests
# above compare the two engines' trace_counts
@pytest.mark.parametrize("name", ["cheb", "cheb_bsgs"])
def test_unfused_equals_eager(cheb, name):
    check_eager(cheb, name)
