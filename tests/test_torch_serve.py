"""The port's serving layer against the JAX package's.

The scenarios of ``tests/test_serving.py`` and ``tests/test_faults.py``
run at their shape (``logN=8, L=4, alpha=2, k=2``, 29-bit primes and
scale, context seed 3) in both packages, on traces whose arrivals are
all at t = 0, so that batching does not depend on the measured time.
Both contexts do the same operations in the same order, so they draw the
same keys and masks, and the servers must agree on:

- the outcome of every request, and the batch log (rids, widths,
  ``plan_hit``, ``ok``, ``error``, ``attempt``);
- every ``ServingReport`` field that does not come from wall time
  (latency, span and throughput are measured, and left out);
- the fault injector's ``injected`` counts;
- every output, residue for residue (and it decrypts under its own
  tenant's key to the program's answer).

The pure-logic classes are driven by one seeded call sequence in both
packages, and the registry's eviction is shown to drop every reference
to a tenant's evk tensors in the port's engine.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as ref_serve  # noqa: E402
from repro.core import linear as ref_linear  # noqa: E402
from repro.core.ckks import CKKSContext as RefContext  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.runtime import TraceContext as RefTrace  # noqa: E402
from repro.runtime import compile_program as ref_compile  # noqa: E402
from repro.serve import faults as ref_faults  # noqa: E402
from repro.serve import metrics as ref_metrics  # noqa: E402
import repro_torch.serve as serve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import linear  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.runtime import TraceContext, compile_program  # noqa: E402
from repro_torch.serve import faults, metrics  # noqa: E402

KW = dict(logN=8, L=4, alpha=2, k=2, q_bits=29, scale_bits=29)
N_DIAG_A, BS_A = 4, 2           # program "a": BSGS matvec
N_DIAG_B = 3                    # program "b": single-block matvec

# BatchRecord and ServingReport fields that are measured wall time
TIMED_RECORD = {"start_s", "duration_s"}
TIMED_REPORT = {"span_s", "latencies_s", "tenants"}
TENANT_COUNTS = ("completed", "rejected", "failed", "shed")


@dataclasses.dataclass
class Side:
    """One package's context, programs and serving module."""

    ctx: object
    serve: object
    corrupt: object
    programs: dict
    diags: dict


def _side(ctx, serve_mod, corrupt, trace_cls, compile_fn, lin) -> Side:
    params = ctx.params
    nh = params.num_slots
    rng = np.random.default_rng(11)
    diags = {"a": {d: rng.normal(size=nh) for d in range(N_DIAG_A)},
             "b": {d: rng.normal(size=nh) for d in range(N_DIAG_B)}}
    programs = {}
    for pid, body in (("a", lambda tc, h: lin.matvec_bsgs(
            tc, h, diags["a"], bs=BS_A)),
                      ("b", lambda tc, h: lin.matvec_diag(tc, h,
                                                          diags["b"]))):
        tc = trace_cls(params)
        h = tc.input("x", level=params.L, scale=params.scale)
        tc.output(body(tc, h), "y")
        programs[pid] = compile_fn(tc)
    return Side(ctx, serve_mod, corrupt, programs, diags)


@pytest.fixture(scope="module")
def sides():
    """(reference, port): one context each for the whole module, so that
    the two draw the same keys and masks scenario after scenario."""
    ref = _side(RefContext(RefParams(**KW), seed=3), ref_serve,
                ref_faults._corrupt_limb, RefTrace, ref_compile, ref_linear)
    port = _side(CKKSContext(CKKSParams(**KW), seed=3, device="cpu"),
                 serve, faults._corrupt_limb, TraceContext, compile_program,
                 linear)
    return ref, port


def _arrivals(S, spec) -> list:
    return [S.Arrival(0.0, t, p) for t, p in spec["trace"]]


def _run(side: Side, spec: dict) -> dict:
    """Serve ``spec``'s trace on a fresh server over ``side``'s context;
    return what must agree between the packages."""
    S, ctx = side.serve, side.ctx
    kw = dict(max_batch=2, max_wait_s=0.0)
    kw.update(spec.get("server", {}))
    injector = (S.FaultInjector(S.FaultPlan(**spec["faults"]))
                if "faults" in spec else None)
    if "breaker" in spec:
        kw["breaker"] = S.CircuitBreaker(**spec["breaker"])
    server = S.FHEServer(ctx, faults=injector, **kw)
    for pid, comp in side.programs.items():
        server.register_program(pid, comp)
    if spec.get("warm"):
        with server.registry.lease("warm"):
            ct0 = ctx.encrypt(np.zeros(ctx.params.num_slots))
        for pid, widths in spec["warm"].items():
            for w in widths:
                server.warmup("warm", pid, {"x": ct0}, width=w)
    before = dict(ctx.engine.trace_counts)
    nh = ctx.params.num_slots
    rng = np.random.default_rng(29)
    sent = []
    poison = spec.get("poison", ())

    def inputs_for(a):
        z = rng.normal(size=nh) + 1j * rng.normal(size=nh)
        ct = ctx.encrypt(z)
        if len(sent) in poison:
            side.corrupt(ct)
        sent.append((a, z))
        return {"x": ct}

    rep = server.run_trace(_arrivals(S, spec), inputs_for,
                           **spec.get("run", {}))
    retraced = dict(ctx.engine.trace_counts) != before
    outputs = {}
    for rid, outs in sorted(server.outputs.items()):
        a, z = sent[rid]
        ct = outs["y"]
        ctx.check_ciphertext(ct)
        with server.registry.lease(a.tenant):
            got = ctx.decrypt(ct)
        want = sum(np.asarray(v) * np.roll(z, -d)
                   for d, v in side.diags[a.program_id].items())
        np.testing.assert_allclose(got, want, atol=1e-3)
        outputs[rid] = {"c0": np.asarray(_numpy(ct.c0), dtype=np.uint64),
                        "c1": np.asarray(_numpy(ct.c1), dtype=np.uint64),
                        "level": ct.level, "scale": ct.scale}
    report = convert.serving_to_dicts(rep)
    tenants = {t: {k: s[k] for k in TENANT_COUNTS}
               for t, s in report["tenants"].items()}
    return {
        "outcomes": dict(server.outcomes),
        "records": [{k: v for k, v in r.items() if k not in TIMED_RECORD}
                    for r in convert.serving_to_dicts(server.records)],
        "durations": [r.duration_s for r in server.records],
        "report": {k: v for k, v in report.items() if k not in TIMED_REPORT},
        "tenants": tenants,
        "accounted": rep.accounted == rep.submitted,
        "injected": injector.injected if injector is not None else None,
        "retraced": retraced,
        "outputs": outputs,
    }


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mixed_trace(n: int, seed: int, tenants, programs) -> list:
    rng = np.random.default_rng(seed)
    return [(tenants[int(rng.integers(len(tenants)))],
             programs[int(rng.integers(len(programs)))]) for _ in range(n)]


# name -> spec; every arrival at t = 0 (test_serving.py, test_faults.py)
SCENARIOS = {
    "mixed": dict(trace=_mixed_trace(12, 5, ["t0", "t1", "t2"], ["a", "b"]),
                  warm={"a": [2], "b": [2]}),
    "backpressure": dict(trace=[(f"t{i % 2}", "a") for i in range(8)],
                         server=dict(queue_size=3), warm={"a": [2]}),
    "tenant_keys": dict(trace=[(t, "a") for t in
                               ("alice", "bob", "alice", "bob")],
                        warm={"a": [2]}),
    "transient": dict(trace=[(f"t{i % 2}", "a") for i in range(8)],
                      faults=dict(seed=21, p_transient=0.35),
                      server=dict(max_retries=4), warm={"a": [1, 2]}),
    "evict": dict(trace=[(t, "a") for t in
                         ["alice", "bob", "alice", "bob", "alice", "bob"]],
                  faults=dict(seed=5, p_evict=0.4),
                  server=dict(max_retries=4), warm={"a": [1, 2]}),
    "corrupt": dict(trace=[("t0", "a")] * 6, faults=dict(seed=3,
                                                         p_corrupt=0.5),
                    warm={"a": [1, 2]}),
    "spike": dict(trace=[("t0", "a")] * 4,
                  faults=dict(seed=7, p_spike=1.0, spike_s=0.5),
                  warm={"a": [1, 2]}),
    "chaos": dict(trace=_mixed_trace(10, 8, ["alice", "bob"], ["a"]),
                  faults=dict(seed=10, p_transient=0.25, p_evict=0.25,
                              p_corrupt=0.25, p_spike=0.25, spike_s=0.05),
                  server=dict(max_retries=4), warm={"a": [1, 2]},
                  run=dict(validate=True)),
    "quarantine": dict(trace=[("t0", "a")] * 4, server=dict(max_batch=4),
                       warm={"a": [1, 2, 4]}, poison={2},
                       run=dict(validate=True)),
    "breaker": dict(trace=[("evil", "a")] * 3 + [("good", "a")] * 2,
                    server=dict(max_batch=1), warm={"a": [1]},
                    breaker=dict(threshold=2, cooldown_s=1e9),
                    poison={0, 1, 2}, run=dict(validate=True)),
    "deadline": dict(trace=[("t0", "a")] * 4, server=dict(max_batch=1),
                     warm={"a": [1]}, run=dict(deadline_s=1e-9)),
    "strict": dict(trace=[("t0", "a")], server=dict(strict_plans=True)),
    "validate": dict(trace=[("t0", "a")] * 6, warm={"a": [1, 2]},
                     run=dict(validate=True)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_equal(sides, name):
    spec = SCENARIOS[name]
    ref_side, port_side = sides
    want = _run(ref_side, spec)
    got = _run(port_side, spec)
    for key in ("outcomes", "records", "report", "tenants", "injected"):
        assert got[key] == want[key], key
    assert got["outputs"].keys() == want["outputs"].keys()
    for rid, w in want["outputs"].items():
        g = got["outputs"][rid]
        np.testing.assert_array_equal(g["c0"], w["c0"])
        np.testing.assert_array_equal(g["c1"], w["c1"])
        assert (g["level"], g["scale"]) == (w["level"], w["scale"])
    # every request reaches exactly one terminal outcome, and a warmed
    # server never retraces (both packages)
    for res in (got, want):
        assert res["accounted"]
        if spec.get("warm"):
            assert not res["retraced"]
    _scenario_gates(name, got)


def _scenario_gates(name: str, res: dict) -> None:
    """What ``tests/test_serving.py`` and ``tests/test_faults.py`` assert
    of each scenario, on the port's run."""
    rep, inj, out = res["report"], res["injected"], res["outcomes"]
    if name == "mixed":
        assert rep["completed"] == 12
        assert rep["plan_cache"]["hits"] == rep["batches"]
        assert rep["plan_cache"]["misses"] == 2
        done: dict = {}
        for r in res["records"]:
            done.setdefault((r["tenant"], r["program_id"]), []).extend(
                r["rids"])
        for rids in done.values():
            assert rids == sorted(rids)
    elif name == "backpressure":
        assert (rep["completed"], rep["rejected"]) == (3, 5)
        assert rep["queue"]["max_depth"] <= 3
    elif name == "tenant_keys":
        assert rep["completed"] == 4
    elif name == "transient":
        assert inj["transient"] >= 1 and rep["completed"] == 8
        assert rep["retries"] == inj["transient"]
    elif name == "evict":
        assert inj["evict"] >= 1 and rep["completed"] == 6
        assert rep["registry"]["evictions"] >= 1
    elif name == "corrupt":
        assert inj["corrupt"] >= 1 and rep["failed"] == inj["corrupt"]
        assert rep["errors"] == {"CorruptCiphertextError": rep["failed"]}
    elif name == "spike":
        assert rep["completed"] == 4
        assert all(d >= 0.5 for d in res["durations"])
    elif name == "chaos":
        assert all(v >= 1 for v in inj.values()), inj
        assert rep["failed"] == inj["corrupt"]
        assert rep["retries"] == inj["transient"] + inj["evict"]
    elif name == "quarantine":
        assert (rep["completed"], rep["failed"]) == (3, 1)
        assert rep["quarantine_splits"] == 2
        assert out[2] == "failed:CorruptCiphertextError"
        assert set(res["outputs"]) == {0, 1, 3}
    elif name == "breaker":
        assert (rep["failed"], rep["shed"], rep["breaker_trips"]) == (2, 1, 1)
        assert res["tenants"]["good"]["completed"] == 2
    elif name == "deadline":
        assert (rep["completed"], rep["shed_reasons"]) == (
            1, {"deadline": 3})
        assert {r for rec in res["records"] for r in rec["rids"]} == {0}
    elif name == "strict":
        assert rep["errors"] == {"PlanCacheMissError": 1}
    elif name == "validate":
        assert rep["completed"] == 6


def test_overload_shed_equal(sides):
    """The overload shed at submit gives the same refusal and counts."""
    got = []
    for side in sides:
        server = side.serve.FHEServer(side.ctx, max_batch=2, max_wait_s=0.0)
        server.register_program("a", side.programs["a"])
        ct = side.ctx.encrypt(np.zeros(side.ctx.params.num_slots))
        server._ewma_service_s = 100.0
        ok = server.submit("t0", "a", {"x": ct}, arrival=0.0, deadline=1.0)
        got.append((ok, dict(server.shed_reasons), server.submitted,
                    server._stats("t0").shed))
    assert got[0] == got[1] == (False, {"overload": 1}, 1, 1)


# ------------------------------ pure logic -------------------------------

def _logic_trace(S, M, seed: int) -> list:
    """One seeded call sequence through ``RequestQueue``,
    ``ContinuousBatcher``, ``PlanCache``, ``CircuitBreaker``,
    ``percentile`` and ``TenantStats``; returns every result."""
    rng = np.random.default_rng(seed)
    out = []
    q = S.RequestQueue(maxsize=6)
    b = S.ContinuousBatcher(max_batch=3, max_wait_s=0.1)
    pc = S.PlanCache()
    br = S.CircuitBreaker(threshold=2, cooldown_s=0.3)
    st = M.TenantStats()
    now = 0.0
    for _ in range(300):
        op = int(rng.integers(9))
        now += float(rng.uniform(0, 0.05))
        tenant = f"t{int(rng.integers(3))}"
        if op == 0:
            r = q.offer(tenant, f"p{int(rng.integers(2))}", {}, now)
            out.append(("offer", None if r is None else r.rid, len(q)))
        elif op == 1:
            got = b.pick(q, now, drain=bool(rng.integers(2)))
            out.append(("pick", None if got is None else
                        (got.group, [r.rid for r in got.requests])))
            out.append(("flush", b.next_flush_time(q)))
        elif op == 2:
            out.append(("groups", {g: [r.rid for r in rs]
                                   for g, rs in q.groups().items()}))
        elif op == 3:
            sig, width = (f"s{int(rng.integers(3))}",), int(rng.integers(1, 4))
            out.append(("admit", pc.admit(sig, width), pc.warm_widths(sig)))
            try:
                pc.require((f"s{int(rng.integers(4))}",), width)
                out.append(("require", True))
            except Exception as e:  # noqa: BLE001 - the type is compared
                out.append(("require", type(e).__name__))
        elif op == 4:
            out.append(("allow", br.allow(tenant, now)))
        elif op == 5:
            br.record_failure(tenant, now)
            out.append(("open", br.is_open(tenant, now), br.stats()))
        elif op == 6:
            br.record_success(tenant)
            out.append(("closed", br.stats()))
        elif op == 7:
            vals = list(rng.uniform(0, 1, int(rng.integers(0, 12))))
            p = float(rng.choice([0.1, 1, 50, 51, 99, 100]))
            out.append(("pct", M.percentile(vals, p)))
        else:
            st.record(float(rng.uniform(0, 2)))
            st.rejected += int(rng.integers(2))
            out.append(("stats", st.summary(float(rng.uniform(0.5, 3)))))
    out.append(("final", pc.stats(), q.rejected, q.depth_samples))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pure_logic_equal(seed):
    assert (_logic_trace(serve, metrics, seed)
            == _logic_trace(ref_serve, ref_metrics, seed))


def test_errors_equal():
    """The serving branch of the error taxonomy and the retry policy."""
    from repro import errors as ref_errors
    from repro_torch import errors

    names = ("KeyUnavailableError", "PlanCacheMissError",
             "TransientEngineError", "RequestTimeout", "CircuitOpenError",
             "InvalidRequestError", "ConfigError", "CorruptCiphertextError")
    for name in names:
        cls, ref_cls = getattr(errors, name), getattr(ref_errors, name)
        assert [c.__name__ for c in cls.__mro__] == [
            c.__name__ for c in ref_cls.__mro__]
        err = cls("x", hint="h", tenant="t0")
        assert str(err) == str(ref_cls("x", hint="h", tenant="t0"))
        assert errors.is_retryable(err) == ref_errors.is_retryable(
            ref_cls("x"))
    assert [c.__name__ for c in errors.RETRYABLE_ERRORS] == [
        c.__name__ for c in ref_errors.RETRYABLE_ERRORS]


# ------------------------------- eviction --------------------------------

def test_eviction_frees_evk_tensors():
    """Evicting a tenant empties the engine's three evk caches of its
    keys, and nothing else holds its evk tensors: once the caller drops
    its own reference to the keychain, every tensor is freed (on the
    card, its memory goes back to the allocator)."""
    ctx = CKKSContext(CKKSParams(**KW), seed=3, device="cpu")
    engine = ctx.engine
    registry = serve.TenantRegistry(ctx, capacity=2, base_seed=7000)
    nh = ctx.params.num_slots
    with registry.lease("A") as kc:
        ct = ctx.encrypt(np.ones(nh))
        pts = [ctx.encode(np.ones(nh), level=ct.level) for _ in range(2)]
        ctx.hoisted_rotation_sum(ct, [1, 2], pts)
        ctx.multiply(ct, ct)
        ids = {id(k) for k in kc._rot_keys.values()} | {id(kc._mult_key)}
        tensors = [d for k in [*kc._rot_keys.values(), kc._mult_key]
                   for d in k.digits]
    cached = ([v[1] for k, v in engine._evk_full.items() if k in ids]
              + [v for k, v in engine._evk_level.items() if k[0] in ids]
              + [v for k, v in engine._evk_group.items()
                 if set(k[0]) & ids])
    assert len(cached) >= len(ids) + 2      # full, level and group stacks
    refs = [weakref.ref(t) for t in tensors + cached]
    del kc, tensors, cached
    assert registry.evict("A")
    assert not [k for k in engine._evk_full if k in ids]
    assert not [k for k in engine._evk_level if k[0] in ids]
    assert not [k for k in engine._evk_group if set(k[0]) & ids]
    gc.collect()
    assert all(r() is None for r in refs)
    assert registry.stats()["evictions"] == 1


def test_sparse_tenant_secrets():
    """``hamming_weight`` gives every tenant a sparse secret."""
    ctx = CKKSContext(CKKSParams(**KW), seed=3, device="cpu")
    registry = serve.TenantRegistry(ctx, hamming_weight=8)
    for t in ("A", "B"):
        s = registry.keychain(t).s_coeffs
        assert np.count_nonzero(s) == 8
    dense = serve.TenantRegistry(ctx).keychain("A").s_coeffs
    assert np.count_nonzero(dense) > 8


def test_corrupt_limb_clones():
    """The injected corruption writes to a clone: a tensor shared with
    another slot or a cache keeps its residues, and the corrupted
    ciphertext fails the health check alone."""
    from repro_torch.errors import CorruptCiphertextError

    ctx = CKKSContext(CKKSParams(**KW), seed=3, device="cpu")
    ct = ctx.encrypt(np.ones(ctx.params.num_slots))
    twin = dataclasses.replace(ct)
    shared = ct.c0
    faults._corrupt_limb(twin)
    assert twin.c0 is not shared and ct.c0 is shared
    assert int(twin.c0[0, 0]) == torch.iinfo(torch.int64).max
    ctx.check_ciphertext(ct)
    with pytest.raises(CorruptCiphertextError):
        ctx.check_ciphertext(twin)
    f = dataclasses.replace(ct, c0=ct.c0.double())
    faults._corrupt_limb(f)
    assert torch.isnan(f.c0[0, 0])
