"""The port's workload models against the JAX package's, and one run.

- The models: the port's ``Dense`` layers hold their diagonals, never
  the dense matrix; they equal ``matrix_diagonals(_band_matrix(...))``
  of the JAX package bit for bit, and the construction at nh = 2^13
  allocates no nh x nh array.
- One reference run, the cheapest (logreg of degree 7 at L=8, the shape
  of ``test_workload_backed_serving``): the port's compiled output equals
  the JAX package's residue for residue.  The JAX package's compiled
  workloads cost a minute or more of XLA compilation each, so this file
  runs one, and ``test_torch_workloads_chain.py`` holds the planner, the
  compiled chains and the port's own runs.
"""
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.workloads as ref_wl  # noqa: E402
from repro.core import linear as ref_linear  # noqa: E402
from repro.core.ckks import CKKSContext as RefContext  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.workloads import models as ref_models  # noqa: E402
import repro_torch.workloads as wl  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import linear  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.workloads import models  # noqa: E402

# tests/test_workloads.py's serving shape (test_workload_backed_serving)
SERVE_KW = dict(logN=8, L=8, alpha=2, k=3, q_bits=29, scale_bits=29)

MODEL_FNS = ["logreg", "mlp", "mlp_bootstrap"]


def _ref_diags(layer) -> dict:
    return ref_linear.matrix_diagonals(layer.A)


# ------------------------------- models ----------------------------------

@pytest.mark.parametrize("nh", [128, 512])
@pytest.mark.parametrize("name", MODEL_FNS)
def test_band_diagonals_equal(name, nh):
    """Every layer's diagonals (offsets and values), bias and activation
    coefficients equal the JAX package's bit for bit, and the banded
    reference is within 1e-12 of its dense one."""
    want = getattr(ref_models, name)(nh)
    got = getattr(models, name)(nh)
    assert (got.name, got.nh, got.input_mag, got.tolerance) == (
        want.name, nh, want.input_mag, want.tolerance)
    for g, w in zip(got.layers, want.layers, strict=True):
        wd = _ref_diags(w)
        assert list(g.diags) == list(wd)
        for d in wd:
            np.testing.assert_array_equal(g.diags[d], wd[d])
        if w.bias is None:
            assert g.bias is None
        else:
            np.testing.assert_array_equal(g.bias, w.bias)
        if w.act is None:
            assert g.act is None
        else:
            assert (g.act.name, g.act.degree) == (w.act.name, w.act.degree)
            np.testing.assert_array_equal(g.act.coeffs, w.act.coeffs)
    x = want.sample(np.random.default_rng(nh))
    np.testing.assert_array_equal(got.sample(np.random.default_rng(nh)), x)
    assert np.abs(got.reference(x) - want.reference(x)).max() < 1e-12


@pytest.mark.parametrize("rows", [1, 7, 512])
def test_row_sums_independent_of_block(rows):
    """The band's row sums do not depend on how many rows a block holds:
    each equals ``np.abs(A).sum(axis=1)`` of the dense matrix."""
    nh = 512
    rng = np.random.default_rng(3)
    band = {d: rng.uniform(-1, 1, nh) for d in range(8)}
    A = np.zeros((nh, nh))
    idx = np.arange(nh)
    for d, v in band.items():
        A[idx, (idx + d) % nh] = v
    np.testing.assert_array_equal(
        models._row_abs_sums(nh, band, block_words=rows * nh),
        np.abs(A).sum(axis=1))


def test_wrapped_offsets_overwrite():
    """With more offsets than slots the offsets wrap, and a later draw
    overwrites an earlier one, as the dense assignment does."""
    for name in ("logreg", "mlp"):
        want = getattr(ref_models, name)(4)
        got = getattr(models, name)(4)
        for g, w in zip(got.layers, want.layers, strict=True):
            wd = _ref_diags(w)
            assert list(g.diags) == list(wd)
            for d in wd:
                np.testing.assert_array_equal(g.diags[d], wd[d])


def test_construction_allocates_no_dense_matrix():
    """At nh = 2^13 the dense matrix would be 512 MiB; the construction's
    peak stays under an eighth of it."""
    nh = 1 << 13
    tracemalloc.start()
    try:
        m = models.mlp(nh)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < nh * nh * 8 // 8, peak
    assert all(len(layer.diags) == 8 for layer in m.layers)


@pytest.mark.parametrize("nh", [16, 128])
def test_matrix_diagonals_equal(nh):
    """The gathered diagonals equal the JAX package's element loop,
    all-zero and below-tolerance diagonals dropped alike."""
    rng = np.random.default_rng(nh)
    A = rng.normal(size=(nh, nh))
    idx = np.arange(nh)
    A[idx, (idx + 3) % nh] = 0.0              # an all-zero diagonal
    A[idx, (idx + 5) % nh] = 1e-13            # below the tolerance
    want = ref_linear.matrix_diagonals(A)
    got = linear.matrix_diagonals(A)
    assert list(got) == list(want)
    assert 3 not in got and 5 not in got
    for d in want:
        np.testing.assert_array_equal(got[d], want[d])
    assert list(linear.matrix_diagonals(A, tol=0.0)) == list(
        ref_linear.matrix_diagonals(A, tol=0.0))


def test_workload_from_numpy_equal():
    """``convert.workload_from_numpy`` of the JAX package's diagonals,
    bias and activation gives the port's own workload."""
    want = ref_models.mlp_bootstrap(64)
    layers = [dict(name=w.name, diags=_ref_diags(w), bias=w.bias,
                   act=None if w.act is None else dict(
                       name=w.act.name, degree=w.act.degree,
                       coeffs=w.act.coeffs), bs=w.bs)
              for w in want.layers]
    got = convert.workload_from_numpy(want.name, layers, want.input_mag,
                                      want.tolerance)
    own = models.mlp_bootstrap(64)
    x = own.sample(np.random.default_rng(0))
    np.testing.assert_array_equal(got.reference(x), own.reference(x))
    for g, o in zip(got.layers, own.layers, strict=True):
        assert g.diags.keys() == o.diags.keys() and g.bs == o.bs
        assert (g.act is None) == (o.act is None)


# ----------------------------- reference run -----------------------------

def test_compiled_logreg_equals_reference():
    """logreg of degree 7 at L=8 (``test_workload_backed_serving``'s
    shape), compiled and run once in each package on the same seeded
    context and input: the same residues, level and scale, and the
    decryption within the tolerance."""
    rp, pp = RefParams(**SERVE_KW), CKKSParams(**SERVE_KW)
    rm = ref_models.logreg(rp.num_slots, degree=7, bs=4)
    pm = models.logreg(pp.num_slots, degree=7, bs=4)
    rwp, pwp = ref_wl.compile_workload(rm, rp), wl.compile_workload(pm, pp)
    assert pwp.summary() == rwp.summary()
    ref = RefContext(rp, seed=3)
    port = CKKSContext(pp, seed=3, device="cpu")
    x = pm.sample(np.random.default_rng(1))
    want = ref_wl.WorkloadExecutor(ref).run(rwp, ref.encrypt(x)).output
    got = wl.WorkloadExecutor(port).run(pwp, port.encrypt(x),
                                        with_report=True)
    assert got.reconcile()["counts_match"]
    out = convert.ciphertext_to_numpy(got.output)
    np.testing.assert_array_equal(out["c0"], np.asarray(want.c0))
    np.testing.assert_array_equal(out["c1"], np.asarray(want.c1))
    assert (out["level"], out["scale"]) == (want.level, want.scale)
    err = np.abs(port.decrypt(got.output).real - pm.reference(x)).max()
    assert err < pm.tolerance
