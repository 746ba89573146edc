"""The port's CoeffToSlot and SlotToCoeff runs against the JAX package's.

At ``tests/test_runtime_bootstrap.py:28``'s shape (logN=8, L=5, two stage
groups), where the reference's own tier-1 compiles C2S.  Each stage is
traced once per package, compiled for every ``fusion`` x ``exact``, and
run once per variant, then eagerly: each output (residues, level,
scale), each run's op counts and each ``reconcile()`` must be equal.
The reference's first compiled C2S costs some 30 s of JAX compilation on
a CPU; everything else reuses its plans.

Both contexts get the same parameters and seed and do the same
operations in the same order (all of it in the module fixture), so they
draw the same keys and masks.  The port runs on the CPU (the kernels'
plain versions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.bootstrap import Bootstrapper as RefBootstrapper  # noqa: E402
from repro.core.ckks import CKKSContext as RefContext  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.runtime import ProgramExecutor as RefExecutor  # noqa: E402
from repro.runtime import TraceContext as RefTrace  # noqa: E402
from repro.runtime import compile_program as ref_compile  # noqa: E402
from repro_torch.core.bootstrap import Bootstrapper  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ProgramExecutor, TraceContext, compile_program,
)
from test_torch_bootstrap import (  # noqa: E402
    BTP_SMALL, KW_SMALL, VARIANT_IDS, VARIANTS, _trace_stage,
)
from test_torch_runtime import _assert_ct_dict_equal, _np  # noqa: E402

STAGES = ["c2s", "s2c"]
SIDES = {
    "ref": dict(ctx=lambda: RefContext(RefParams(**KW_SMALL), seed=7),
                btp=RefBootstrapper, ex=RefExecutor, trace=RefTrace,
                params=RefParams, compile=ref_compile),
    "port": dict(ctx=lambda: CKKSContext(CKKSParams(**KW_SMALL), seed=7,
                                         device="cpu"),
                 btp=Bootstrapper, ex=ProgramExecutor, trace=TraceContext,
                 params=CKKSParams, compile=compile_program),
}


@pytest.fixture(scope="module")
def stages():
    """side -> {"ctx", "btp", "ct", (stage, fusion, exact): (compiled,
    result with report, op counts), (stage, "eager"): (output, op
    counts)}, built in the same order on both sides."""
    rng = np.random.default_rng(28)
    nh = 1 << (KW_SMALL["logN"] - 1)
    z = (rng.normal(size=nh) + 1j * rng.normal(size=nh)) * 0.01
    out = {"z": z}
    for side, s in SIDES.items():
        ctx = s["ctx"]()
        btp = s["btp"](ctx, **BTP_SMALL)
        ct = ctx.encrypt(z)
        ex = s["ex"](ctx)
        rec = {"ctx": ctx, "btp": btp, "ct": ct}
        for stage in STAGES:
            for fusion, exact in VARIANTS:
                comp = s["compile"](
                    _trace_stage(s["trace"], s["params"], KW_SMALL, btp,
                                 stage), fusion=fusion, exact=exact)
                before = ctx.counters.snapshot()
                res = ex.run(comp, {"x": ct}, with_report=True)
                rec[stage, fusion, exact] = (comp, res,
                                             ctx.counters.delta(before))
            fn = btp.coeff_to_slot if stage == "c2s" else btp.slot_to_coeff
            before = ctx.counters.snapshot()
            rec[stage, "eager"] = (fn(ct), ctx.counters.delta(before))
        out[side] = rec
    return out


@pytest.mark.parametrize("fusion,exact", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("stage", STAGES)
def test_compiled_stage_equal(stages, stage, fusion, exact):
    """The port's compiled stage gives the reference's residues, op
    counts and reconciliation, at fewer ModUps than eager."""
    rc, rres, rops = stages["ref"][stage, fusion, exact]
    pc, pres, pops = stages["port"][stage, fusion, exact]
    assert pc.summary() == rc.summary()
    _assert_ct_dict_equal(_np(pres["y"]), _np(rres["y"]))
    assert pops.as_dict() == rops.as_dict()
    assert pres.report.reconcile() == rres.report.reconcile()
    assert pres.report.reconcile()["counts_match"]
    assert pres.report.plan_shapes == rres.report.plan_shapes
    assert pres.report.validate_plan_shapes(stages["port"]["ctx"].params)
    eager_ops = stages["port"][stage, "eager"][1]
    assert pops.modup < eager_ops.modup


@pytest.mark.parametrize("stage", STAGES)
def test_eager_stage_equal(stages, stage):
    """The eager stage equals the reference's eager stage and, bit for
    bit, the port's compiled ``fusion=False, exact=True`` run; both
    packages decrypt it alike."""
    ref, port = stages["ref"], stages["port"]
    got, ops = port[stage, "eager"]
    want, ref_ops = ref[stage, "eager"]
    _assert_ct_dict_equal(_np(got), _np(want))
    assert ops.as_dict() == ref_ops.as_dict()
    _assert_ct_dict_equal(_np(port[stage, False, True][1]["y"]), _np(got))
    assert port[stage, False, True][2].moddown == ops.moddown
    diff = np.abs(port["ctx"].decrypt(got) - ref["ctx"].decrypt(want))
    assert diff.max() < 1e-9


@pytest.mark.parametrize("stage", STAGES)
def test_inexact_stage_bound(stages, stage):
    """``exact=False`` merges giant-step ModDowns: fewer of them at the
    same ModUps, a different bitstream, and within
    tests/test_runtime_bootstrap.py:125-131's merged-ModDown bound of
    the exact output."""
    port = stages["port"]
    p = port["ctx"].params
    exact_out, exact_ops = port[stage, False, True][1]["y"], \
        port[stage, False, True][2]
    comp, res, ops = port[stage, False, False]
    assert comp.n_multi > 0 and not comp.exact
    assert ops.moddown < exact_ops.moddown
    assert ops.modup == exact_ops.modup
    assert not torch.equal(res["y"].c0, exact_out.c0)
    n_merged = exact_ops.moddown - ops.moddown
    bound = n_merged * p.N * (p.k + 1) / p.scale
    diff = np.abs(port["ctx"].decrypt(res["y"])
                  - port["ctx"].decrypt(exact_out)).max()
    assert diff < bound, (diff, bound)


def test_c2s_s2c_identity(stages):
    """S2C of C2S gives the input slots back on the port, as
    tests/test_bootstrap.py:50 checks at logN=10 on the reference."""
    port = stages["port"]
    ctx, btp = port["ctx"], port["btp"]
    out = btp.slot_to_coeff(port["c2s", "eager"][0])
    assert np.abs(ctx.decrypt(out) - stages["z"]).max() < 1e-3
