"""Continuous-batching scheduler + plan-cache admission policy.

The engine caches ONE jit trace per ``(op, level, shape)`` plan, and
retraces whenever a dispatch arrives with a shape it has not seen —
including a new leading batch size.  The serving layer therefore treats
"which plans does this program touch, at which batch size" as an
explicit admission object:

* :func:`plan_signature` names the engine plans a compiled program will
  dispatch: one ``(kind, level, dnum, n_terms)`` entry per
  keyswitch-family step, where ``(level, dnum)`` identifies the
  ``KeyswitchPlan`` (the traced ModUp/IP/ModDown constants) and
  ``n_terms`` the hoisted shape (rotation count / merged-relin width).
* :class:`PlanCache` is the admission policy: a ``(signature, batch)``
  pair seen before is a HIT (dispatch is retrace-free by construction);
  a new pair is a MISS whose first execution pays the jit traces and
  warms the plans for every later request — from ANY tenant, since the
  plans carry no key material.

Batching policy (:class:`ContinuousBatcher`): requests are packed by
group — ``(tenant, program_id)``, the unit that can share one vmap
batch (same compiled plan AND same evk tensors) — and a batch launches
when the group reaches ``max_batch`` or its head request has waited
``max_wait`` virtual seconds (or the trace is draining).  Among ready
groups, the one with the OLDEST head request wins: per-tenant FIFO,
no group starvation.  Batches are right-padded to exactly
``max_batch`` slots by repeating the last request's ciphertexts, so
every dispatch reuses the single warmed batch shape — the padding cost
is the occupancy gap the ``batch_occupancy`` metric reports, the
retrace cost it avoids is a full program trace.

A copy of the JAX package's ``serve/scheduler.py`` over the port's
``runtime.lower.KeyswitchFamilyStep``.  The port compiles nothing at
dispatch: its "trace" is the first dispatch of a (plan, batch width)
pair, which ``engine.trace_counts`` counts as the JAX package counts
its jit traces, so the admission policy reads the same.
"""
from __future__ import annotations

import dataclasses

from repro_torch.errors import ConfigError, PlanCacheMissError
from repro_torch.runtime.compile import CompiledProgram
from repro_torch.runtime.lower import KeyswitchFamilyStep
from repro_torch.serve.queue import GroupKey, Request, RequestQueue


def plan_signature(compiled: CompiledProgram) -> tuple:
    """Engine-plan fingerprint of a compiled program.

    One entry per keyswitch-family step: ``(kind, level, dnum,
    n_terms)``.  ``(level, dnum)`` names the engine ``KeyswitchPlan``
    the step dispatches on; ``n_terms`` (rotation count, or merged
    relin width) pins the traced hoisted shape.  Two programs with
    equal signatures exercise exactly the same jit plans.
    """
    params = compiled.params
    sig = []
    for step in compiled.steps:
        if not isinstance(step, KeyswitchFamilyStep):
            continue
        dnum = len(params.digit_groups(step.level))
        if hasattr(step, "n_relin"):
            n = step.n_relin
        elif hasattr(step, "n_rot"):
            n = step.n_rot
        else:
            n = 1
        sig.append((type(step).__name__, step.level, dnum, n))
    return tuple(sig)


class PlanCache:
    """Admission policy over ``(plan signature, batch size)`` pairs."""

    def __init__(self):
        self._warm: set[tuple] = set()
        self.hits = 0
        self.misses = 0

    def admit(self, signature: tuple, batch: int) -> bool:
        """True = warm (retrace-free dispatch); False = first admission
        at this shape, the execution about to run pays the traces."""
        key = (signature, batch)
        if key in self._warm:
            self.hits += 1
            return True
        self.misses += 1
        self._warm.add(key)
        return False

    def is_warm(self, signature: tuple, batch: int) -> bool:
        return (signature, batch) in self._warm

    def require(self, signature: tuple, batch: int) -> None:
        """Strict admission: raise :class:`PlanCacheMissError` when a
        live dispatch would have to pay a jit trace.  Servers running
        with ``strict_plans=True`` call this before executing, so a
        cold shape becomes an accounted request failure instead of a
        silent multi-second trace stall inside the batch."""
        if not self.is_warm(signature, batch):
            raise PlanCacheMissError(
                "dispatch shape was never warmed",
                hint="warm this (program, width) via FHEServer.warmup "
                     "before serving, or run with strict_plans=False",
                batch=batch, warm_widths=self.warm_widths(signature))

    def warm_widths(self, signature: tuple) -> list[int]:
        """Batch sizes this signature has been traced at, ascending —
        the server pads a partial batch up to the SMALLEST warm width
        that fits instead of always paying the full max-batch shape."""
        return sorted(b for s, b in self._warm if s == signature)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "warm_plans": len(self._warm),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 1.0,
        }


@dataclasses.dataclass
class PackedBatch:
    """A scheduler decision: FIFO slice of one group, ready to launch."""

    group: GroupKey
    requests: list[Request]

    @property
    def tenant(self) -> str:
        return self.group[0]

    @property
    def program_id(self) -> str:
        return self.group[1]


class ContinuousBatcher:
    """Max-batch / max-wait continuous batching over the request queue."""

    def __init__(self, max_batch: int = 4, max_wait_s: float = 0.05):
        if max_batch <= 0:
            raise ConfigError("max_batch must be positive",
                              max_batch=max_batch)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s

    def _ready(self, reqs: list[Request], now: float, drain: bool) -> bool:
        return (len(reqs) >= self.max_batch or drain
                or now - reqs[0].arrival >= self.max_wait_s)

    def pick(self, queue: RequestQueue, now: float,
             drain: bool = False) -> PackedBatch | None:
        """The next batch to launch, or None if every group should keep
        accumulating.  Among ready groups the oldest head request wins
        (per-tenant FIFO; no group starves)."""
        best: tuple[int, GroupKey, list[Request]] | None = None
        for group, reqs in queue.groups().items():
            if not self._ready(reqs, now, drain):
                continue
            if best is None or reqs[0].rid < best[0]:
                best = (reqs[0].rid, group, reqs)
        if best is None:
            return None
        _, group, reqs = best
        picked = reqs[: self.max_batch]
        queue.take(picked)
        return PackedBatch(group, picked)

    def next_flush_time(self, queue: RequestQueue) -> float | None:
        """Virtual time at which the oldest queued request forces a
        (possibly partial) batch — the clock's idle-advance target."""
        head = queue.oldest()
        return None if head is None else head.arrival + self.max_wait_s


class CircuitBreaker:
    """Per-tenant failure isolation on the virtual clock.

    One tenant repeatedly submitting poisoned requests (corrupt inputs,
    wrong-level ciphertexts) must not keep burning engine time and
    bisect passes for everyone else.  Classic three-state breaker:

    * **closed** — normal service; consecutive request failures are
      counted, any success resets the count;
    * **open** — tripped after ``threshold`` consecutive failures: the
      tenant's requests are shed (``CircuitOpenError`` reason) without
      touching the engine, until ``cooldown_s`` virtual seconds pass;
    * **half-open** — after the cooldown, exactly one probe batch is
      allowed through: success closes the breaker, failure re-opens it
      (a fresh trip, a fresh cooldown).

    All timing is virtual-clock, so chaos schedules replay exactly.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 0.5):
        if threshold <= 0:
            raise ConfigError("breaker threshold must be positive",
                              threshold=threshold)
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._fails: dict[str, int] = {}       # consecutive failures
        self._open_until: dict[str, float] = {}
        self._probing: set[str] = set()        # half-open probe let through
        self.trips = 0

    def allow(self, tenant: str, now: float) -> bool:
        """May this tenant's batch dispatch at virtual time ``now``?"""
        until = self._open_until.get(tenant)
        if until is None:
            return True
        if now < until:
            return False
        # cooldown elapsed: half-open — let one probe batch through
        if tenant in self._probing:
            return False
        self._probing.add(tenant)
        return True

    def record_success(self, tenant: str) -> None:
        self._fails.pop(tenant, None)
        self._open_until.pop(tenant, None)
        self._probing.discard(tenant)

    def record_failure(self, tenant: str, now: float) -> None:
        if tenant in self._probing:            # failed half-open probe
            self._probing.discard(tenant)
            self._open_until[tenant] = now + self.cooldown_s
            self.trips += 1
            return
        n = self._fails.get(tenant, 0) + 1
        self._fails[tenant] = n
        if n >= self.threshold and tenant not in self._open_until:
            self._open_until[tenant] = now + self.cooldown_s
            self._fails[tenant] = 0
            self.trips += 1

    def is_open(self, tenant: str, now: float) -> bool:
        until = self._open_until.get(tenant)
        return until is not None and now < until

    def stats(self) -> dict:
        return {"trips": self.trips,
                "open_tenants": sorted(self._open_until)}
