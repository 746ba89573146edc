"""Serving metrics: latency percentiles, throughput, occupancy, caches.

All latencies live on the server's virtual clock (arrival timestamps
from the open-loop trace; service time measured wall-clock per executed
batch and added to the clock), so ``latency = completion - arrival``
mixes queueing delay and real engine time in the same unit (seconds).

Percentiles use the nearest-rank definition
(``sorted[ceil(p/100 * n) - 1]``) — exact on small samples, so the
metrics-arithmetic test can assert them from first principles.

``ServingReport`` is the ``ExecutionReport``-style structured record:
one aggregate view plus a per-tenant breakdown, each a plain dict ready
for ``BENCH_serving.json``.

A copy of the JAX package's ``serve/metrics.py``.
"""
from __future__ import annotations

import dataclasses
import math


def percentile(values: list[float], p: float) -> float | None:
    """Nearest-rank percentile: ``sorted[max(1, ceil(p/100 * n)) - 1]``.

    ``None`` on an empty sample — a percentile of nothing is not 0.0
    (0.0 reads as "zero latency" in dashboards and summaries).  A
    single-sample list returns that sample for every p: ceil clamps the
    rank into [1, n] from below via ``max`` and from above via ``min``,
    so no p in (0, 100] can index off either end.
    """
    if not values:
        return None
    s = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(s)))
    return s[min(rank, len(s)) - 1]


@dataclasses.dataclass
class TenantStats:
    """Per-tenant accumulator: latencies in virtual seconds.

    Every submitted request reaches exactly ONE terminal counter:
    ``completed`` (result delivered), ``failed`` (permanent typed error
    after retries), ``shed`` (never executed: deadline expired, breaker
    open, or overload), or ``rejected`` (bounded-queue backpressure at
    submit).  The accounting identity the chaos gate checks is
    ``completed + failed + shed + rejected == submitted``.
    """

    completed: int = 0
    rejected: int = 0
    failed: int = 0
    shed: int = 0
    latencies: list[float] = dataclasses.field(default_factory=list)

    def record(self, latency_s: float) -> None:
        self.completed += 1
        self.latencies.append(latency_s)

    def summary(self, span_s: float) -> dict:
        return {
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failed,
            "shed": self.shed,
            "throughput_ops": (self.completed / span_s) if span_s else 0.0,
            "p50_latency_s": percentile(self.latencies, 50),
            "p99_latency_s": percentile(self.latencies, 99),
            "mean_latency_s": (sum(self.latencies) / len(self.latencies)
                               if self.latencies else 0.0),
        }


@dataclasses.dataclass
class ServingReport:
    """Structured record of one serving run (per tenant + aggregate)."""

    span_s: float                     # virtual makespan of the run
    completed: int
    rejected: int
    batches: int
    batch_occupancy: float            # mean real/max slots per batch
    plan_cache: dict                  # admission-policy hits/misses
    registry: dict                    # TenantRegistry.stats()
    queue: dict                       # depth stats + rejections
    tenants: dict[str, dict]          # tenant -> TenantStats.summary()
    submitted: int = 0                # valid submit() calls observed
    failed: int = 0                   # permanent typed failures
    shed: int = 0                     # never executed (deadline/breaker/load)
    retries: int = 0                  # re-dispatches after transient faults
    quarantine_splits: int = 0        # bisect passes over failed batches
    breaker_trips: int = 0            # circuit-breaker open transitions
    shed_reasons: dict = dataclasses.field(default_factory=dict)
    errors: dict = dataclasses.field(default_factory=dict)  # type -> count
    latencies_s: list[float] = dataclasses.field(default_factory=list,
                                                 repr=False)

    @property
    def throughput_ops(self) -> float:
        return self.completed / self.span_s if self.span_s else 0.0

    @property
    def p50_latency_s(self) -> float | None:
        return percentile(self.latencies_s, 50)

    @property
    def p99_latency_s(self) -> float | None:
        return percentile(self.latencies_s, 99)

    @property
    def accounted(self) -> int:
        """Requests with a terminal outcome — the chaos gate asserts
        this equals the number submitted (nothing lost, nothing
        double-counted)."""
        return self.completed + self.rejected + self.failed + self.shed

    def to_dict(self) -> dict:
        return {
            "span_s": self.span_s,
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failed,
            "shed": self.shed,
            "accounted": self.accounted,
            "retries": self.retries,
            "quarantine_splits": self.quarantine_splits,
            "breaker_trips": self.breaker_trips,
            "shed_reasons": self.shed_reasons,
            "errors": self.errors,
            "batches": self.batches,
            "throughput_ops": self.throughput_ops,
            "p50_latency_s": self.p50_latency_s,
            "p99_latency_s": self.p99_latency_s,
            "batch_occupancy": self.batch_occupancy,
            "plan_cache": self.plan_cache,
            "registry": self.registry,
            "queue": self.queue,
            "tenants": self.tenants,
        }
