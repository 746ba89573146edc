"""The port's bootstrapping against the JAX package's: what needs no run.

The stage matrices and the EvalMod coefficients are a deterministic
numpy function of the parameters, so both packages' ``Bootstrapper``
must hold the same arrays.  ``Bootstrapper.compile`` traces the same
pipeline in both, so the compiled programs (DFG, steps, plaintext
specs, summary, the hoist model's predicted volumes and the simulator's
blocks) must be equal for every ``fusion`` x ``exact``, at three shapes:

- ``tests/test_runtime_bootstrap.py:28`` (logN=8, L=5), whose chain only
  holds C2S and S2C: each stage alone, and the whole pipeline raising
  the same error in both;
- ``tests/test_runtime_bootstrap.py:157`` (logN=8, L=19), the whole
  pipeline, with the derived block sizes and with the dense paths;
- ``tests/test_bootstrap.py:19`` (logN=10, L=23), the whole pipeline at
  the repo's bootstrap configuration.

Tracing and lowering run no JAX program, so this file is cheap.  The one
run here is ``mod_raise`` at logN=10.  The stages run against the
reference in ``test_torch_bootstrap_stages.py`` (C2S, S2C) and
``test_torch_bootstrap_evalmod.py`` (EvalMod); the whole pipeline runs on
the port in ``test_torch_bootstrap_run.py``.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.bootstrap import Bootstrapper as RefBootstrapper  # noqa: E402
from repro.core.bootstrap import auto_bsgs_bs as ref_auto_bs  # noqa: E402
from repro.core.ckks import CKKSContext as RefContext  # noqa: E402
from repro.core.encoding import Encoder as RefEncoder  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.runtime import TraceContext as RefTrace  # noqa: E402
from repro.runtime import compile_program as ref_compile  # noqa: E402
from repro.runtime import report as ref_report  # noqa: E402
from repro_torch.core.bootstrap import Bootstrapper, auto_bsgs_bs  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.encoding import Encoder  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.runtime import TraceContext, compile_program  # noqa: E402
from repro_torch.runtime import report  # noqa: E402
from test_torch_runtime import _assert_ct_dict_equal, _np, _nodes, _steps  # noqa: E402
from test_torch_sim import _block  # noqa: E402

# tests/test_runtime_bootstrap.py:28 (C2S / S2C only)
KW_SMALL = dict(logN=8, L=5, alpha=2, k=3, q_bits=29, scale_bits=29)
BTP_SMALL = dict(n_groups=2, mod_K=3, cheb_degree=15)
# tests/test_runtime_bootstrap.py:157 (the whole pipeline)
KW_BOOT = dict(logN=8, L=19, alpha=4, k=4, q_bits=29, scale_bits=29,
               q0_bits=30)
BTP_BOOT = dict(n_groups=2, mod_K=3, cheb_degree=27)
# tests/test_bootstrap.py:19
KW_10 = dict(logN=10, L=23, alpha=3, k=4, q_bits=29, scale_bits=29,
             q0_bits=30)
BTP_10 = dict(n_groups=3, mod_K=5, cheb_degree=59)
SHAPES = {"logN8_L5": (KW_SMALL, BTP_SMALL), "logN8_L19": (KW_BOOT, BTP_BOOT),
          "logN10_L23": (KW_10, BTP_10)}
VARIANTS = [(f, e) for f in (False, True) for e in (True, False)]
VARIANT_IDS = [f"{'fused' if f else 'unfused'}-{'exact' if e else 'inexact'}"
               for f, e in VARIANTS]


def _bootstrappers(kw, btp_kw, **extra):
    """Both packages' Bootstrapper on an encoder-only context: the stage
    matrices, the coefficients and ``compile`` need nothing else."""
    out = []
    for params, enc, cls in ((RefParams, RefEncoder, RefBootstrapper),
                             (CKKSParams, Encoder, Bootstrapper)):
        p = params(**kw)
        ctx = types.SimpleNamespace(params=p, encoder=enc(p))
        out.append(cls(ctx, **btp_kw, **extra))
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_stage_matrices_equal(shape):
    rb, pb = _bootstrappers(*SHAPES[shape])
    assert len(pb.c2s_groups) == len(rb.c2s_groups) == rb.n_groups
    assert len(pb.s2c_groups) == len(rb.s2c_groups) == rb.n_groups
    for a, b in zip(pb.c2s_groups + pb.s2c_groups,
                    rb.c2s_groups + rb.s2c_groups):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pb.cheb, rb.cheb)
    assert pb.eval_range == rb.eval_range


@pytest.mark.parametrize("seed", range(12))
def test_auto_bsgs_bs_equal(seed):
    rng = np.random.default_rng(seed)
    nh = 1 << int(rng.integers(6, 12))
    gap = 1 << int(rng.integers(0, 5))
    n = int(rng.integers(1, 40))
    offs = sorted({int(v) for v in rng.integers(0, nh // gap, n) * gap})
    assert auto_bsgs_bs(offs, nh) == ref_auto_bs(offs, nh)
    strided = [(j * gap) % nh for j in range(n)]
    assert auto_bsgs_bs(strided, nh) == ref_auto_bs(strided, nh)


def _trace_stage(trace, params, kw, btp, stage):
    tc = trace(params(**kw))
    h = tc.input("x", level=kw["L"], scale=tc.params.scale)
    fn = btp.coeff_to_slot if stage == "c2s" else btp.slot_to_coeff
    tc.output(fn(h, tc), "y")
    return tc


def _assert_compiled_equal(rc, pc):
    """Equal programs, and equal inputs to the performance model: the
    hoist model's volumes and the simulator's blocks."""
    assert pc.summary() == rc.summary()
    assert (pc.n_hoisted, pc.n_multi, pc.n_relin) == (
        rc.n_hoisted, rc.n_multi, rc.n_relin)
    assert _steps(pc) == _steps(rc)
    assert _nodes(pc) == _nodes(rc)
    assert len(pc.pt_specs) == len(rc.pt_specs)
    for a, b in zip(pc.pt_specs, rc.pt_specs):
        assert (a.level, a.scale) == (b.level, b.scale)
        np.testing.assert_array_equal(a.values, b.values)
    assert pc.inputs == rc.inputs and pc.outputs == rc.outputs
    for shared in (True, False):
        assert dataclasses.asdict(report.predicted_volumes(pc, shared)) == \
            dataclasses.asdict(ref_report.predicted_volumes(rc, shared))
    for batch in (1, 2):
        got = [_block(b) for b in report.program_blocks(pc, batch)]
        assert got == [_block(b) for b in ref_report.program_blocks(rc, batch)]
        assert sum(b[0]["modup_count"] for b in got) > 0


@pytest.mark.parametrize("fusion,exact", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("stage", ["c2s", "s2c"])
def test_compile_stage_equal(stage, fusion, exact):
    """C2S and S2C at tests/test_runtime_bootstrap.py:28's shape."""
    rb, pb = _bootstrappers(KW_SMALL, BTP_SMALL)
    rc = ref_compile(_trace_stage(RefTrace, RefParams, KW_SMALL, rb, stage),
                     fusion=fusion, exact=exact)
    pc = compile_program(_trace_stage(TraceContext, CKKSParams, KW_SMALL,
                                      pb, stage), fusion=fusion, exact=exact)
    _assert_compiled_equal(rc, pc)
    assert pc.n_hoisted + pc.n_multi > 0


def test_compile_bootstrap_short_chain_same_error():
    """At L=5 the chain cannot hold the whole pipeline: both packages'
    tracers refuse it with the same error."""
    errors = []
    for b in _bootstrappers(KW_SMALL, BTP_SMALL):
        with pytest.raises(ValueError) as e:
            b.compile()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("fusion,exact", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("shape,extra", [
    ("logN8_L19", {}), ("logN8_L19", {"bsgs_bs": 0, "cheb_bs": 0}),
    ("logN10_L23", {})], ids=["logN8_L19-auto", "logN8_L19-dense",
                              "logN10_L23-auto"])
def test_compile_bootstrap_equal(shape, extra, fusion, exact):
    """The whole pipeline, with the derived block sizes and with the
    dense paths."""
    kw, btp_kw = SHAPES[shape]
    rb, pb = _bootstrappers(kw, btp_kw, **extra)
    scale = float(2 ** kw["scale_bits"])
    rc = rb.compile(input_scale=scale, fusion=fusion, exact=exact)
    pc = pb.compile(input_scale=scale, fusion=fusion, exact=exact)
    _assert_compiled_equal(rc, pc)
    assert pc.exact == exact and pc.fused == fusion
    if not (extra or fusion):
        # the derived BSGS split leaves multi-anchor giant steps
        assert (pc.n_multi > 0) == (not exact)


def test_mod_raise_equal():
    """ModRaise at logN=10, L=23: the same level-0 encryption lifts to the
    same residues over the whole chain (both lift through
    ``centered_crt`` on the host)."""
    rng = np.random.default_rng(23)
    nh = 1 << (KW_10["logN"] - 1)
    z = (rng.normal(size=nh) + 1j * rng.normal(size=nh)) * 0.01
    ref = RefContext(RefParams(**KW_10), seed=7, hamming_weight=8)
    port = CKKSContext(CKKSParams(**KW_10), seed=7, hamming_weight=8,
                       device="cpu")
    cts = [ref.encrypt(z, level=0), port.encrypt(z, level=0)]
    _assert_ct_dict_equal(_np(cts[1]), _np(cts[0]))
    want, got = ref.mod_raise(cts[0]), port.mod_raise(cts[1])
    assert got.level == want.level == KW_10["L"]
    _assert_ct_dict_equal(_np(got), _np(want))
    rb, pb = RefBootstrapper(ref, **BTP_10), Bootstrapper(port, **BTP_10)
    _assert_ct_dict_equal(_np(pb.mod_raise(cts[1])), _np(rb.mod_raise(cts[0])))
