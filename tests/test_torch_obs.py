"""The port's tracing against the JAX package's: same spans and events.

With tracing on in both packages, tracing, compiling and running the
same program must record the same spans and events, in the same order,
with the same non-timing attributes: the compiler's spans, the
executor's ``exec.run``/``exec.step.*`` spans, and the engine's
``engine.kernel_dispatch``/``engine.jit_trace``/``engine.evk_admit``
events.  The reference runs its ``backend="pallas"`` engine, whose
attributes the port's engine mirrors except two that name the device:
``backend`` (the port's device type) and ``interpret`` (always False on
the port), on ``engine.kernel_dispatch`` and on the ``exec.step.*``
spans.

Each package has its own global tracer.  The ``tracing`` fixture turns
both on for one test and puts both back as it found them.  The
reference's programs compile with most of XLA's optimizations off
(``unoptimized_reference_compiles``, restored after the module); they
are integer, so their results are the same.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import obs as ref_obs  # noqa: E402
from repro.core import linear as ref_linear  # noqa: E402
from repro.core.ckks import CKKSContext as RefContext  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.runtime import ProgramExecutor as RefExecutor  # noqa: E402
from repro.runtime import TraceContext as RefTrace  # noqa: E402
from repro.runtime import compile_program as ref_compile  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import linear  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.obs.tracer import NULL_SPAN  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ProgramExecutor, TraceContext, compile_program,
)
from test_torch_runtime import unoptimized_reference_compiles  # noqa: E402

# tests/test_obs.py's parameters
KW = dict(logN=8, L=4, alpha=2, k=2, q_bits=29, scale_bits=29)
DEVICE_KEYS = ("backend", "interpret")
VARIANTS = [(f, e) for f in (False, True) for e in (True, False)]
VARIANT_IDS = [f"{'fused' if f else 'unfused'}-{'exact' if e else 'inexact'}"
               for f, e in VARIANTS]


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_reference():
    with unoptimized_reference_compiles():
        yield


def _saved(tracer):
    return (tracer.enabled, tracer.finished, tracer.instants,
            tracer._next_id, tracer._tls)


@pytest.fixture()
def tracing():
    """Both tracers on and empty for one test; afterwards each is put
    back exactly as it was (enabled flag and collected spans)."""
    tracers = (ref_obs.TRACER, obs.TRACER)
    saved = [_saved(t) for t in tracers]
    for t in tracers:
        t.reset()
        t.enable()
    try:
        yield tracers
    finally:
        for t, s in zip(tracers, saved):
            t.disable()
            t.reset()
            (t.enabled, t.finished, t.instants, t._next_id, t._tls) = s


@pytest.fixture(scope="module")
def pair():
    ref = RefContext(RefParams(**KW), seed=17, backend="pallas")
    port = CKKSContext(CKKSParams(**KW), seed=17, device="cpu")
    rng = np.random.default_rng(5)
    nh = port.params.num_slots
    diags = {d: rng.normal(size=nh) for d in range(4)}
    zs = [rng.normal(size=nh) for _ in range(2)]
    return {"ref": ref, "port": port, "diags": diags,
            "ref_in": [ref.encrypt(z) for z in zs],
            "port_in": [port.encrypt(z) for z in zs],
            "ref_ex": RefExecutor(ref), "port_ex": ProgramExecutor(port),
            "compiled": {}}


def _trace(trace_cls, params_cls, lin, diags):
    tc = trace_cls(params_cls(**KW))
    h = tc.input("x", level=KW["L"], scale=tc.params.scale)
    tc.output(lin.matvec_bsgs(tc, h, diags, bs=2), "y")
    return tc


def _compile_both(pair, fusion, exact):
    key = (fusion, exact)
    if key not in pair["compiled"]:
        pair["compiled"][key] = (
            ref_compile(_trace(RefTrace, RefParams, ref_linear,
                               pair["diags"]), fusion=fusion, exact=exact),
            compile_program(_trace(TraceContext, CKKSParams, linear,
                                   pair["diags"]), fusion=fusion,
                            exact=exact))
    return pair["compiled"][key]


def _attrs(name, attrs) -> dict:
    if name == "engine.kernel_dispatch" or name.startswith("exec.step."):
        return {k: v for k, v in attrs.items() if k not in DEVICE_KEYS}
    return dict(attrs)


def _log(tracer) -> tuple:
    """Spans in the order they finished, with parents and events, and
    the standalone events; no timestamps."""
    spans = [(s.name, s.span_id, s.parent_id, _attrs(s.name, s.attrs),
              [(n, _attrs(n, a)) for n, _, a in s.events])
             for s in tracer.spans()]
    instants = [(n, _attrs(n, a)) for n, _, _, a in tracer.instants]
    return spans, instants


def _events(tracer, name) -> list:
    return [a for s in tracer.spans() for n, _, a in s.events if n == name]


@pytest.mark.parametrize("fusion,exact", VARIANTS, ids=VARIANT_IDS)
def test_compile_spans_equal(pair, tracing, fusion, exact):
    ref_tr, port_tr = tracing
    ref_compile(_trace(RefTrace, RefParams, ref_linear, pair["diags"]),
                fusion=fusion, exact=exact)
    compile_program(_trace(TraceContext, CKKSParams, linear,
                           pair["diags"]), fusion=fusion, exact=exact)
    assert _log(port_tr) == _log(ref_tr)
    names = [s[0] for s in _log(port_tr)[0]]
    assert "compile.program" in names and "compile.identify_pkbs" in names
    assert ("compile.fusion" in names) == fusion
    assert [n for n, _ in _log(port_tr)[1]] == ["trace.input", "trace.output"]


@pytest.mark.parametrize("fusion,exact", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("batched", [False, True], ids=["run", "batched"])
def test_run_spans_equal(pair, tracing, fusion, exact, batched):
    rc, pc = _compile_both(pair, fusion, exact)
    ref_tr, port_tr = tracing
    if batched:
        pair["ref_ex"].run_batched(rc, {"x": pair["ref_in"]})
        pair["port_ex"].run_batched(pc, {"x": pair["port_in"]})
    else:
        pair["ref_ex"].run(rc, {"x": pair["ref_in"][0]})
        pair["port_ex"].run(pc, {"x": pair["port_in"][0]})
    assert _log(port_tr) == _log(ref_tr)
    steps = [s for s in port_tr.spans() if s.name.startswith("exec.step.")]
    assert len(steps) == len(pc.steps)
    assert {(s.attrs["backend"], s.attrs["interpret"]) for s in steps} \
        == {("cpu", False)}
    dispatch = _events(port_tr, "engine.kernel_dispatch")
    assert dispatch and all(
        (d["backend"], d["modup"], d["interpret"]) == ("cpu", "fused", False)
        for d in dispatch)
    assert {d["modup"] for d in _events(ref_tr, "engine.kernel_dispatch")} \
        == {"fused"}
    # each plan counted as new is one jit_trace event, on both sides
    traces = [(e["key"], e["count"]) for e in
              _events(port_tr, "engine.jit_trace")]
    assert len(traces) == len(set(traces))
    assert pair["port"].engine.trace_counts == pair["ref"].engine.trace_counts


def test_validate_failure_event_equal(pair, tracing, monkeypatch):
    """A poisoned hoisted block: both executors attach the same
    ``exec.validate_failure`` event before raising the same error."""
    rc, pc = _compile_both(pair, False, True)
    q0 = pair["port"].params.q_primes[0]
    for side, ctx in (("ref", pair["ref"]), ("port", pair["port"])):
        real = ctx.add_zero_step_terms

        def poisoned(*a, _real=real, _ref=side == "ref", **kw):
            ct = _real(*a, **kw)
            if _ref:
                return type(ct)(ct.c0.at[0, 0].set(q0), ct.c1, ct.level,
                                ct.scale)
            c0 = ct.c0.clone()
            c0[0, 0] = q0
            return type(ct)(c0, ct.c1, ct.level, ct.scale)

        monkeypatch.setattr(ctx, "add_zero_step_terms", poisoned)
    ref_tr, port_tr = tracing
    errs = []
    for ex, comp, ct in ((pair["ref_ex"], rc, pair["ref_in"][0]),
                         (pair["port_ex"], pc, pair["port_in"][0])):
        with pytest.raises(Exception) as info:
            ex.run(comp, {"x": ct}, validate=True)
        errs.append(info.value)
    assert type(errs[1]).__name__ == type(errs[0]).__name__
    assert str(errs[1]) == str(errs[0])
    fails = _events(port_tr, "exec.validate_failure")
    assert len(fails) == 1 and fails[0]["error"] == "CorruptCiphertextError"
    assert fails == _events(ref_tr, "exec.validate_failure")
    assert _log(port_tr) == _log(ref_tr)


def test_tracers_are_separate():
    """Each package has its own tracer, off unless a caller turns it on;
    turning the port's on leaves the reference's as it was."""
    assert not obs.TRACER.enabled
    assert obs.TRACER is not ref_obs.TRACER
    assert obs.span("x") is NULL_SPAN
    saved = _saved(obs.TRACER)
    ref_before = ref_obs.enabled()
    try:
        obs.enable()
        assert obs.enabled() and ref_obs.enabled() == ref_before
        with obs.span("only.port", k=1):
            obs.event("tick")
        assert [s.name for s in obs.TRACER.spans()] == ["only.port"]
        assert ref_obs.TRACER.spans("only.port") == []
    finally:
        obs.disable()
        obs.TRACER.reset()
        (obs.TRACER.enabled, obs.TRACER.finished, obs.TRACER.instants,
         obs.TRACER._next_id, obs.TRACER._tls) = saved
    assert not obs.TRACER.enabled
