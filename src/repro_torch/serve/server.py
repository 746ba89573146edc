"""The serving loop: open-loop arrivals -> queue -> packed batches.

``FHEServer`` binds the pieces together on ONE shared
``CKKSContext``/``KeyswitchEngine``:

    arrivals (serve.workload)  --admit-->  RequestQueue (bounded FIFO)
        --pick-->  ContinuousBatcher (max-batch / max-wait, per
                   (tenant, program) groups, oldest-head-first)
        --admission-->  PlanCache ((signature, batch) warm set)
        --lease-->  TenantRegistry (per-tenant keys on the shared ctx)
        --execute-->  ProgramExecutor.run_batched (one batched dispatch,
                      padded to the warmed batch shape)
        --record-->  ServingReport + BatchRecord log (simfeed replays
                     the log onto the sim.schedule timelines)

Time model: a **virtual clock**.  Arrival timestamps come from the
open-loop trace; every executed batch advances the clock by its
*measured* wall-clock duration (kernel launches + device sync).  Request
latency = completion - arrival on that clock, so queueing delay and
engine time land in the same unit while the arrival process stays
deterministic and replayable (same ``--seed``, same trace, both
baselines, and the simulator half all see identical traffic).

Failure model: every submitted request reaches exactly one terminal
outcome — ``completed``, ``failed`` (permanent typed error), ``shed``
(never executed: deadline expired, breaker open, overload), or
``rejected`` (bounded-queue backpressure).  The recovery machinery:

* **retry with capped exponential backoff** for retryable errors
  (:data:`repro_torch.errors.RETRYABLE_ERRORS` — transient engine faults,
  evicted keys that deterministic re-keygen restores).  Backoff time is
  virtual-clock time, so chaos runs replay exactly.
* **quarantine bisect** for permanent ciphertext errors in a multi-
  request batch: the batch splits in half and each half re-dispatches,
  recursively, until the poisoned request(s) fail alone — co-batched
  victims complete instead of failing collaterally.
* **per-tenant circuit breaker** (:class:`~repro_torch.serve.scheduler.
  CircuitBreaker`): a tenant failing repeatedly is shed without
  touching the engine until a cooldown elapses.
* **overload shedding** at submit: when the EWMA service-time estimate
  says the queue wait already blows the request's deadline headroom,
  the request is shed with reason ``overload`` instead of queued.

The serial baseline (:meth:`FHEServer.run_serial`) answers the gate
question: same trace, same virtual clock, but every request executes
alone (batch slots = 1) in strict arrival order — what a
one-request-at-a-time service would do with the same traffic.

The port of the JAX package's ``serve/server.py``: a dispatch ends in
a synchronize of the context's device (the JAX package blocks on the
first output), and spans and events go to the port's ``obs``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import obs
from repro_torch.core.ckks import CKKSContext, Ciphertext
from repro_torch.errors import (
    CiphertextError, InvalidRequestError, ReproError, is_retryable,
)
from repro_torch.runtime import CompiledProgram, ProgramExecutor
from repro_torch.serve.metrics import ServingReport, TenantStats
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.serve.registry import TenantRegistry
from repro_torch.serve.scheduler import (
    CircuitBreaker, ContinuousBatcher, PackedBatch, PlanCache,
    plan_signature,
)
from repro_torch.serve.workload import Arrival


@dataclasses.dataclass
class BatchRecord:
    """One executed batch on the virtual timeline (simfeed's input)."""

    start_s: float                # virtual launch time
    duration_s: float             # measured wall-clock service time
    tenant: str
    program_id: str
    n_real: int                   # requests actually served
    batch: int                    # padded dispatch width
    plan_hit: bool                # admission policy verdict
    rids: list[int]
    ok: bool = True               # dispatch finished without error
    error: str | None = None      # typed error class name when not ok
    attempt: int = 0              # 0 = first try, >0 = retry number


class FHEServer:
    """Multi-tenant continuous-batching server over compiled programs."""

    def __init__(self, ctx: CKKSContext, max_batch: int = 4,
                 max_wait_s: float = 0.05, queue_size: int = 256,
                 registry: TenantRegistry | None = None,
                 keep_outputs: bool = True,
                 default_deadline_s: float | None = None,
                 max_retries: int = 2,
                 backoff_base_s: float = 0.01,
                 backoff_cap_s: float = 0.25,
                 breaker: CircuitBreaker | None = None,
                 strict_plans: bool = False,
                 faults=None):
        if not ctx.use_engine:
            raise NotImplementedError(
                "serving requires the batched engine (use_engine=True)")
        self.ctx = ctx
        self.executor = ProgramExecutor(ctx)
        self.registry = registry if registry is not None \
            else TenantRegistry(ctx)
        self.queue = RequestQueue(queue_size)
        self.batcher = ContinuousBatcher(max_batch, max_wait_s)
        self.plan_cache = PlanCache()
        self.programs: dict[str, CompiledProgram] = {}
        self._signatures: dict[str, tuple] = {}
        self.records: list[BatchRecord] = []
        self.keep_outputs = keep_outputs
        self.outputs: dict[int, dict[str, Ciphertext]] = {}
        self._tenants: dict[str, TenantStats] = {}
        # ---- fault tolerance -------------------------------------------
        self.default_deadline_s = default_deadline_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.breaker = breaker
        self.strict_plans = strict_plans
        self.faults = faults            # FaultInjector | None (duck-typed)
        self.submitted = 0
        self.retries = 0
        self.quarantine_splits = 0
        self.shed_reasons: dict[str, int] = {}
        self.errors: dict[str, int] = {}
        self.outcomes: dict[int, str] = {}   # rid -> terminal outcome
        self._dispatch_idx = 0               # fault-plan index
        self._ewma_service_s: float | None = None
        # ---- observability (obs-gated; empty when tracing is off) ------
        # request_log: per-request lifecycle rows on the VIRTUAL clock,
        # rendered as per-tenant Perfetto lanes by obs.export.
        self.request_log: list[dict] = []
        self._first_dispatch: dict[int, float] = {}  # rid -> virtual t0

    def _log_terminal(self, req: Request, end_s: float,
                      outcome: str) -> None:
        """obs-gated request-lifecycle row (virtual clock)."""
        self.request_log.append({
            "rid": req.rid, "tenant": req.tenant,
            "program": req.program_id, "arrival_s": req.arrival,
            "start_s": self._first_dispatch.get(req.rid),
            "end_s": end_s, "outcome": outcome,
        })
        obs.event("serve.request", rid=req.rid, tenant=req.tenant,
                  outcome=outcome)

    # ------------------------- programs --------------------------------
    def register_program(self, program_id: str,
                         compiled: CompiledProgram) -> tuple:
        """Admit a compiled program; returns its engine-plan signature."""
        self.programs[program_id] = compiled
        self._signatures[program_id] = plan_signature(compiled)
        return self._signatures[program_id]

    def warmup(self, tenant: str, program_id: str,
               inputs: dict[str, Ciphertext],
               width: int | None = None) -> None:
        """Warm the program's engine plans at the serving batch shape by
        executing one padded batch (admission-policy MISS paid here, so
        live traffic is retrace-free from the first request).
        ``width`` defaults to the scheduler's max_batch; pass 1 to warm
        the serial baseline's shape."""
        B = self.batcher.max_batch if width is None else width
        self.plan_cache.admit(self._signatures[program_id], B)
        with self.registry.lease(tenant):
            self.executor.run_batched(
                self.programs[program_id],
                {tag: [ct] * B for tag, ct in inputs.items()})

    # ------------------------- submission ------------------------------
    def _stats(self, tenant: str) -> TenantStats:
        if tenant not in self._tenants:
            self._tenants[tenant] = TenantStats()
        return self._tenants[tenant]

    def submit(self, tenant: str, program_id: str,
               inputs: dict[str, Ciphertext], arrival: float,
               deadline: float | None = None,
               validate: bool = False) -> bool:
        """Queue one request; False = not admitted (backpressure
        rejection or overload shed, tallied per tenant).

        Malformed requests raise :class:`InvalidRequestError` — a
        client error is a typed refusal, not an assert that vanishes
        under ``python -O`` or a crash inside a shared batch later.
        """
        if program_id not in self.programs:
            raise InvalidRequestError(
                "unknown program id",
                hint="register_program() the compiled program first",
                program_id=program_id, known=sorted(self.programs))
        compiled = self.programs[program_id]
        missing = [t for t in compiled.inputs if t not in inputs]
        if missing:
            raise InvalidRequestError(
                "request is missing input ciphertexts",
                program_id=program_id, missing=missing)
        self.submitted += 1
        if deadline is None and self.default_deadline_s is not None:
            deadline = arrival + self.default_deadline_s
        # Overload shed: if the queue wait we can already predict blows
        # the deadline headroom, refuse now instead of executing a
        # result nobody will accept.
        if deadline is not None and self._ewma_service_s is not None:
            est_wait = ((self.queue.depth / self.batcher.max_batch + 1.0)
                        * self._ewma_service_s)
            if arrival + est_wait > deadline:
                self._shed_unqueued(tenant, "overload")
                return False
        req = self.queue.offer(tenant, program_id, inputs, arrival,
                               deadline=deadline, validate=validate)
        if req is None:
            self._stats(tenant).rejected += 1
            obs.event("serve.reject", tenant=tenant, program=program_id,
                      depth=self.queue.depth)
            return False
        obs.event("serve.submit", rid=req.rid, tenant=tenant,
                  program=program_id, arrival=arrival)
        return True

    # ------------------------- outcomes --------------------------------
    def _shed_unqueued(self, tenant: str, reason: str) -> None:
        self._stats(tenant).shed += 1
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1
        obs.event("serve.shed", tenant=tenant, reason=reason, queued=False)

    def _shed(self, reqs: list[Request], reason: str,
              now: float | None = None) -> None:
        self.shed_reasons[reason] = (self.shed_reasons.get(reason, 0)
                                     + len(reqs))
        tracing = obs.TRACER.enabled
        for r in reqs:
            self._stats(r.tenant).shed += 1
            self.outcomes[r.rid] = f"shed:{reason}"
            if tracing:
                self._log_terminal(r, now if now is not None
                                   else r.arrival, f"shed:{reason}")

    def _fail(self, reqs: list[Request], err: ReproError,
              now: float) -> None:
        name = type(err).__name__
        self.errors[name] = self.errors.get(name, 0) + len(reqs)
        tracing = obs.TRACER.enabled
        for r in reqs:
            self._stats(r.tenant).failed += 1
            self.outcomes[r.rid] = f"failed:{name}"
            if tracing:
                self._log_terminal(r, now, f"failed:{name}")
        if self.breaker is not None and reqs:
            self.breaker.record_failure(reqs[0].tenant, now)

    # ------------------------- execution -------------------------------
    def _dispatch_once(self, reqs: list[Request], tenant: str,
                       program_id: str, now: float, width: int | None,
                       attempt: int):
        """One engine dispatch, padded to ``width`` slots.

        ``width=None`` picks the smallest already-warm bucket that fits
        the real requests (falling back to max_batch), so a partial
        batch only pays for the nearest warmed shape, never a retrace.
        Returns ``(dt, error, outputs)`` — errors are *returned*, not
        raised, because the failed attempt's measured duration must
        still advance the virtual clock.
        """
        compiled = self.programs[program_id]
        sig = self._signatures[program_id]
        if width is None:
            fits = [w for w in self.plan_cache.warm_widths(sig)
                    if w >= len(reqs)]
            B = min(fits) if fits else self.batcher.max_batch
        else:
            B = width
        validate = any(r.validate for r in reqs)
        idx = self._dispatch_idx
        self._dispatch_idx += 1
        err, res, hit = None, None, False
        if obs.TRACER.enabled:
            for r in reqs:
                self._first_dispatch.setdefault(r.rid, now)
            sp = obs.span("serve.dispatch", tenant=tenant,
                          program=program_id, n_real=len(reqs), batch=B,
                          attempt=attempt, virtual_start_s=now,
                          rids=[r.rid for r in reqs])
        else:
            sp = obs.NULL_SPAN
        sp.__enter__()
        t0 = time.perf_counter()
        try:
            if self.strict_plans:
                self.plan_cache.require(sig, B)
            hit = self.plan_cache.admit(sig, B)
            if self.faults is not None:
                self.faults.before_dispatch(idx, self, tenant)
            pad = B - len(reqs)
            stacked = {
                tag: ([r.inputs[tag] for r in reqs]
                      + [reqs[-1].inputs[tag]] * pad)
                for tag in compiled.inputs
            }
            with self.registry.lease(tenant):
                res = self.executor.run_batched(compiled, stacked,
                                                validate=validate)
                self._synchronize()
        except ReproError as e:
            err = e
        dt = time.perf_counter() - t0
        sp.set_attrs(plan_hit=hit, ok=err is None,
                     error=type(err).__name__ if err is not None else None)
        sp.__exit__(None, None, None)
        if self.faults is not None:
            dt += self.faults.extra_latency(idx)
            if err is None and res is not None:
                self.faults.corrupt_outputs(idx, res.outputs,
                                            n_real=len(reqs))
        if err is None:
            e = self._ewma_service_s
            self._ewma_service_s = dt if e is None else 0.8 * e + 0.2 * dt
        self.records.append(BatchRecord(
            start_s=now, duration_s=dt, tenant=tenant,
            program_id=program_id, n_real=len(reqs), batch=B,
            plan_hit=hit, rids=[r.rid for r in reqs],
            ok=err is None,
            error=type(err).__name__ if err is not None else None,
            attempt=attempt,
        ))
        return dt, err, (res.outputs if res is not None else None)

    def _synchronize(self) -> None:
        """Wait for the context's device: kernel launches return before
        the card finishes, and the virtual clock must advance by the
        work, not by its launches."""
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _deliver(self, reqs: list[Request], outputs, now: float,
                 tenant: str) -> None:
        """Terminal accounting for a successful dispatch: per-slot
        output health checks (a corrupted slot fails ONLY its own
        request — zero silently-wrong results), then completion."""
        ok: list[Request] = []
        check = self.faults is not None
        for j, r in enumerate(reqs):
            outs = {tag: cts[j] for tag, cts in outputs.items()}
            slot_err = None
            if r.validate or check:
                try:
                    for tag, ct in outs.items():
                        self.ctx.check_ciphertext(
                            ct, where=f"output[{tag}] rid={r.rid}")
                except CiphertextError as e:
                    slot_err = e
            if slot_err is not None:
                self._fail([r], slot_err, now)
                continue
            if self.keep_outputs:
                self.outputs[r.rid] = outs
            ok.append(r)
        tracing = obs.TRACER.enabled
        for r in ok:
            self._stats(r.tenant).record(now - r.arrival)
            self.outcomes[r.rid] = "completed"
            if tracing:
                self._log_terminal(r, now, "completed")
        if ok and self.breaker is not None:
            self.breaker.record_success(tenant)

    def _serve_requests(self, reqs: list[Request], tenant: str,
                        program_id: str, now: float,
                        width: int | None) -> float:
        """Dispatch + recover: retry/backoff on transient errors,
        quarantine bisect on permanent ciphertext errors.  Returns the
        advanced virtual clock; every request in ``reqs`` reaches a
        terminal outcome before this returns."""
        attempt = 0
        while True:
            dt, err, outputs = self._dispatch_once(
                reqs, tenant, program_id, now, width, attempt)
            now += dt
            if err is None:
                self._deliver(reqs, outputs, now, tenant)
                return now
            if is_retryable(err) and attempt < self.max_retries:
                backoff = min(self.backoff_cap_s,
                              self.backoff_base_s * (2 ** attempt))
                now += backoff
                self.retries += 1
                attempt += 1
                obs.event("serve.retry", tenant=tenant,
                          program=program_id, attempt=attempt,
                          backoff_s=backoff,
                          error=type(err).__name__,
                          rids=[r.rid for r in reqs])
                continue
            # Permanent error (or retries exhausted).  A poisoned
            # ciphertext in a shared batch must not fail its co-batched
            # victims: bisect and re-dispatch each half until the
            # poison fails alone.
            if isinstance(err, (CiphertextError, InvalidRequestError)) \
                    and len(reqs) > 1:
                self.quarantine_splits += 1
                mid = len(reqs) // 2
                obs.event("serve.quarantine_split",
                          error=type(err).__name__,
                          rids=[r.rid for r in reqs], mid=mid)
                now = self._serve_requests(reqs[:mid], tenant,
                                           program_id, now, width)
                now = self._serve_requests(reqs[mid:], tenant,
                                           program_id, now, width)
                return now
            self._fail(reqs, err, now)
            return now

    def _serve_batch(self, batch: PackedBatch, now: float,
                     width: int | None = None) -> float:
        """Serve one packed batch through the full degradation ladder:
        breaker gate -> deadline shed -> dispatch with recovery."""
        if self.breaker is not None \
                and not self.breaker.allow(batch.tenant, now):
            self._shed(batch.requests, "breaker_open", now)
            return now
        live: list[Request] = []
        expired: list[Request] = []
        for r in batch.requests:
            (expired if r.deadline is not None and now > r.deadline
             else live).append(r)
        if expired:
            self._shed(expired, "deadline", now)
        if not live:
            return now
        return self._serve_requests(live, batch.tenant,
                                    batch.program_id, now, width)

    # ------------------------- serving loops ---------------------------
    def run_trace(self, trace: list[Arrival], inputs_for,
                  deadline_s: float | None = None,
                  validate: bool = False) -> ServingReport:
        """Serve an open-loop arrival trace to completion.

        ``inputs_for(arrival) -> {tag: Ciphertext}`` materializes each
        request's ciphertexts; it runs under the tenant's key lease (so
        ``ctx.encrypt`` uses the right secret) and OFF the virtual
        clock — encryption is client-side work, not server time.
        ``deadline_s`` gives every request a relative deadline
        (overriding ``default_deadline_s``); ``validate`` opts every
        request into the executor's invariant checker.
        """
        arr = sorted(trace, key=lambda a: a.t)
        i, now = 0, 0.0
        while True:
            while i < len(arr) and arr[i].t <= now:
                a = arr[i]
                with self.registry.lease(a.tenant):
                    inputs = inputs_for(a)
                dl = a.t + deadline_s if deadline_s is not None else None
                self.submit(a.tenant, a.program_id, inputs, a.t,
                            deadline=dl, validate=validate)
                i += 1
            drain = i >= len(arr)
            batch = self.batcher.pick(self.queue, now, drain=drain)
            if batch is None:
                if drain and not self.queue:
                    break
                targets = [arr[i].t] if i < len(arr) else []
                flush = self.batcher.next_flush_time(self.queue)
                if flush is not None:
                    targets.append(flush)
                now = max(now, min(targets))
                continue
            now = self._serve_batch(batch, now)
        return self.report(span_s=now)

    def run_serial(self, trace: list[Arrival], inputs_for,
                   deadline_s: float | None = None,
                   validate: bool = False) -> ServingReport:
        """Baseline: the same trace, one request at a time (no packing),
        strict arrival order, on the same virtual clock."""
        arr = sorted(trace, key=lambda a: a.t)
        now = 0.0
        for a in arr:
            with self.registry.lease(a.tenant):
                inputs = inputs_for(a)
            dl = a.t + deadline_s if deadline_s is not None else None
            if not self.submit(a.tenant, a.program_id, inputs, a.t,
                               deadline=dl, validate=validate):
                continue
            req = self.queue.oldest()
            self.queue.take([req])
            now = max(now, a.t)
            batch = PackedBatch((a.tenant, a.program_id), [req])
            now = self._serve_batch(batch, now, width=1)
        return self.report(span_s=now)

    # ------------------------- reporting -------------------------------
    def report(self, span_s: float) -> ServingReport:
        lat_all = [v for s in self._tenants.values() for v in s.latencies]
        depths = self.queue.depth_samples
        occ = ([r.n_real / r.batch for r in self.records]
               if self.records else [])
        return ServingReport(
            span_s=span_s,
            completed=sum(s.completed for s in self._tenants.values()),
            rejected=sum(s.rejected for s in self._tenants.values()),
            batches=len(self.records),
            batch_occupancy=(sum(occ) / len(occ)) if occ else 0.0,
            plan_cache=self.plan_cache.stats(),
            registry=self.registry.stats(),
            queue={
                "maxsize": self.queue.maxsize,
                "max_depth": max(depths) if depths else 0,
                "mean_depth": (sum(depths) / len(depths)) if depths
                              else 0.0,
                "rejected": self.queue.rejected,
            },
            tenants={t: s.summary(span_s)
                     for t, s in sorted(self._tenants.items())},
            submitted=self.submitted,
            failed=sum(s.failed for s in self._tenants.values()),
            shed=sum(s.shed for s in self._tenants.values()),
            retries=self.retries,
            quarantine_splits=self.quarantine_splits,
            breaker_trips=(self.breaker.trips
                           if self.breaker is not None else 0),
            shed_reasons=dict(self.shed_reasons),
            errors=dict(self.errors),
            latencies_s=lat_all,
        )
