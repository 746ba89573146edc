"""The port's whole bootstrap, compiled and eager, on the CPU.

At ``tests/test_runtime_bootstrap.py:157``'s shape (logN=8, L=19, two
stage groups, K=3, Chebyshev degree 27) from a level-0 encryption:
ModRaise -> C2S -> re/im split -> EvalMod x2 -> merge -> S2C.  Every
stage is held against the JAX package elsewhere (``mod_raise`` and the
compiled programs in ``test_torch_bootstrap.py``, C2S and S2C in
``test_torch_bootstrap_stages.py``, EvalMod in
``test_torch_bootstrap_evalmod.py``); here the port's compiled pipeline
must equal its eager ``bootstrap`` bit for bit, and its other lowerings
must keep their contracts.  The port runs on the CPU (the kernels'
plain versions) in seconds.

``test_whole_bootstrap_equals_reference`` holds the whole pipeline
against the reference, whose one compiled bootstrap costs over two
minutes of JAX compilation on a CPU.  It is marked ``slow``, as the
reference's own ``test_full_compiled_bootstrap`` is; run it with
``-m slow``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.bootstrap import Bootstrapper  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.runtime import ProgramExecutor  # noqa: E402
from repro_torch.sim import HE2_SM, HE2_LM  # noqa: E402
from test_torch_bootstrap import BTP_BOOT, KW_BOOT  # noqa: E402
from test_torch_runtime import _assert_ct_dict_equal, _np  # noqa: E402

# tests/test_runtime_bootstrap.py:188's decryption bound at this shape
MAX_ERR = 5e-2


def _inputs():
    rng = np.random.default_rng(157)
    nh = 1 << (KW_BOOT["logN"] - 1)
    return [(rng.normal(size=nh) + 1j * rng.normal(size=nh)) * 0.01
            for _ in range(2)]


def _err(ctx, ct, z) -> float:
    return float(np.abs(ctx.decrypt(ct) - z).max())


@pytest.fixture(scope="module")
def boot():
    """The port at :157's shape: two level-0 encryptions, the compiled
    bootstrap (``fusion=False``, ``exact=True``) run on the first with
    its report, and the eager ``bootstrap`` of the same input."""
    zs = _inputs()
    ctx = CKKSContext(CKKSParams(**KW_BOOT), seed=7, hamming_weight=8,
                      device="cpu")
    btp = Bootstrapper(ctx, **BTP_BOOT)
    cts = [ctx.encrypt(z, level=0) for z in zs]
    comp = btp.compile(input_scale=cts[0].scale)
    ex = ProgramExecutor(ctx)
    before = ctx.counters.snapshot()
    res = ex.run(comp, {"ct": cts[0]}, with_report=True)
    ops = ctx.counters.delta(before)
    before = ctx.counters.snapshot()
    eager = btp.bootstrap(cts[0])
    eager_ops = ctx.counters.delta(before)
    return {"zs": zs, "ctx": ctx, "btp": btp, "cts": cts, "comp": comp,
            "ex": ex, "res": res, "ops": ops, "eager": eager,
            "eager_ops": eager_ops,
            "err": _err(ctx, res["out"], zs[0])}


def test_compiled_equals_eager(boot):
    """Bit for bit, with the same scale and level, at fewer ModUps."""
    out, eager = boot["res"]["out"], boot["eager"]
    _assert_ct_dict_equal(_np(out), _np(eager))
    assert out.level >= 1
    assert boot["ops"].modup < boot["eager_ops"].modup
    assert boot["ops"].moddown == boot["eager_ops"].moddown


def test_report_reconciles(boot):
    rep = boot["res"].report
    assert rep.reconcile()["counts_match"], rep.reconcile()
    assert rep.validate_plan_shapes(boot["ctx"].params)
    assert rep.batch == 1


def test_decryption_error(boot):
    assert boot["err"] < MAX_ERR, boot["err"]


def test_run_batched_slots_equal(boot):
    """B=2: each slot equals the single run of its input."""
    ex, comp, cts = boot["ex"], boot["comp"], boot["cts"]
    res = ex.run_batched(comp, {"ct": cts}, with_report=True)
    assert res.report.batch == 2
    assert res.report.reconcile()["counts_match"]
    _assert_ct_dict_equal(_np(res["out"][0]), _np(boot["res"]["out"]))
    _assert_ct_dict_equal(_np(res["out"][1]),
                          _np(ex.run(comp, {"ct": cts[1]})["out"]))


def test_inexact_bootstrap(boot):
    """``exact=False``: merged giant-step ModDowns, fewer of them, within
    tests/test_runtime_bootstrap.py:198's error bound."""
    ctx, btp, ct = boot["ctx"], boot["btp"], boot["cts"][0]
    multi = btp.compile(input_scale=ct.scale, exact=False)
    assert multi.n_multi > 0
    before = ctx.counters.snapshot()
    res = boot["ex"].run(multi, {"ct": ct}, with_report=True)
    ops = ctx.counters.delta(before)
    assert ops.moddown < boot["ops"].moddown
    assert res.report.reconcile()["counts_match"]
    assert _err(ctx, res["out"], boot["zs"][0]) <= 1.5 * boot["err"] + 1e-3


def test_fused_bootstrap(boot):
    """``fusion=True`` compiles, runs, reconciles and decrypts within the
    bound of ``exact=True``."""
    ctx, btp, ct = boot["ctx"], boot["btp"], boot["cts"][0]
    fused = btp.compile(input_scale=ct.scale, fusion=True)
    assert fused.fused
    before = ctx.counters.snapshot()
    res = boot["ex"].run(fused, {"ct": ct}, with_report=True)
    ops = ctx.counters.delta(before)
    assert res.report.reconcile()["counts_match"]
    assert ops.modup <= boot["ops"].modup
    assert res["out"].level == boot["res"]["out"].level
    assert _err(ctx, res["out"], boot["zs"][0]) < MAX_ERR


@pytest.mark.parametrize("hw", [HE2_SM, HE2_LM], ids=lambda h: h.name)
def test_scheduled_result(boot, hw):
    """The executed plan feeds the simulator: a latency of the modelled
    accelerator (not of the device that ran the plan)."""
    sched = boot["res"].report.scheduled_result(boot["comp"], hw)
    assert sched.latency_s > 0 and sched.timelines


@pytest.mark.slow
def test_whole_bootstrap_equals_reference():
    """The reference's compiled bootstrap at this shape against the
    port's compiled, batched and eager ones, residue for residue, with
    equal op counts, reconciliation and simulator latency."""
    from repro.core.bootstrap import Bootstrapper as RefBootstrapper
    from repro.core.ckks import CKKSContext as RefContext
    from repro.core.params import CKKSParams as RefParams
    from repro.runtime import ProgramExecutor as RefExecutor
    from repro.sim import HE2_SM as REF_HE2_SM

    zs = _inputs()
    sides = {}
    for side, ctx, cls, ex_cls in (
            ("ref", RefContext(RefParams(**KW_BOOT), seed=7,
                               hamming_weight=8), RefBootstrapper,
             RefExecutor),
            ("port", CKKSContext(CKKSParams(**KW_BOOT), seed=7,
                                 hamming_weight=8, device="cpu"),
             Bootstrapper, ProgramExecutor)):
        btp = cls(ctx, **BTP_BOOT)
        cts = [ctx.encrypt(z, level=0) for z in zs]
        comp = btp.compile(input_scale=cts[0].scale)
        before = ctx.counters.snapshot()
        res = ex_cls(ctx).run(comp, {"ct": cts[0]}, with_report=True)
        sides[side] = {"ctx": ctx, "btp": btp, "cts": cts, "comp": comp,
                       "res": res, "ops": ctx.counters.delta(before)}
    ref, port = sides["ref"], sides["port"]
    want = _np(ref["res"]["out"])
    _assert_ct_dict_equal(_np(port["res"]["out"]), want)
    assert port["ops"].as_dict() == ref["ops"].as_dict()
    rep, ref_rep = port["res"].report, ref["res"].report
    assert rep.reconcile() == ref_rep.reconcile()
    assert rep.plan_shapes == ref_rep.plan_shapes
    got = rep.scheduled_result(port["comp"], HE2_SM)
    assert got.latency_s == ref_rep.scheduled_result(
        ref["comp"], REF_HE2_SM).latency_s > 0
    _assert_ct_dict_equal(_np(port["btp"].bootstrap(port["cts"][0])), want)
    batched = ProgramExecutor(port["ctx"]).run_batched(
        port["comp"], {"ct": port["cts"]})
    _assert_ct_dict_equal(_np(batched["out"][0]), want)
    dec = port["ctx"].decrypt(port["res"]["out"])
    assert np.abs(dec - ref["ctx"].decrypt(ref["res"]["out"])).max() < 1e-9
    assert np.abs(dec - zs[0]).max() < MAX_ERR
