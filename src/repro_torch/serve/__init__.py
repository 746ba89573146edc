"""repro_torch.serve — multi-tenant continuous-batching FHE serving layer.

The compiled runtime executes ONE ciphertext program at a time; this
package turns it into a *server*: an open-loop Poisson arrival stream of
``(tenant, program_id, ct)`` jobs is queued, packed into the engine's
``*_batched`` entry points at dispatch shapes it has already seen
(``engine.trace_counts`` stays flat), executed under per-tenant keys on
the context's device, measured, and replayed onto the paper's hardware
timelines.

  workload  (serve.workload)  — seeded open-loop Poisson traces:
            ``Arrival(t, tenant, program_id)``;
  queue     (serve.queue)     — bounded FIFO with (tenant, program)
            batch-class views; rejection = backpressure;
  scheduler (serve.scheduler) — continuous batching (max-batch /
            max-wait, oldest-head-first groups) + the plan-cache
            admission policy over ``(level, dnum)`` plan signatures;
  registry  (serve.registry)  — per-tenant KeyChains on ONE shared
            engine, bounded LRU eviction that never touches an
            in-flight tenant, evk tensor caches purged on eviction;
  server    (serve.server)    — the virtual-clock serving loop +
            serial baseline; logs every batch as a ``BatchRecord``;
  metrics   (serve.metrics)   — throughput, nearest-rank p50/p99
            latency, batch occupancy, cache hit rates, queue depth —
            per tenant and aggregate (``ServingReport``);
  simfeed   (serve.simfeed)   — replay the batch log onto the
            ``sim.schedule`` group-pipeline timelines: what would the
            HE^2 hardware do with this traffic;
  faults    (serve.faults)    — deterministic seeded fault injection
            (transient engine faults, mid-flight key evictions,
            corrupted output limbs, latency spikes) driving the
            server's retry / quarantine-bisect / breaker / shedding
            recovery paths.

The port of the JAX package's ``repro.serve``, with the same public
names: the modules are copies pointed at the port, except ``faults``
(the corruption is a torch write) and ``server`` (a dispatch ends in a
device synchronize); the registry can give tenants sparse secrets
(``hamming_weight``) so that a bootstrapping program serves them.
``chip_smoke.py``'s ``serve`` phase drives it on the card.
"""
from repro_torch.serve.faults import FaultInjector, FaultPlan  # noqa: F401
from repro_torch.serve.metrics import ServingReport, percentile  # noqa: F401
from repro_torch.serve.queue import Request, RequestQueue  # noqa: F401
from repro_torch.serve.registry import TenantRegistry  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    CircuitBreaker, ContinuousBatcher, PlanCache, plan_signature,
)
from repro_torch.serve.server import BatchRecord, FHEServer  # noqa: F401
from repro_torch.serve.simfeed import replay_on_hardware  # noqa: F401
from repro_torch.serve.workload import (  # noqa: F401
    Arrival, poisson_trace, workload_request_programs,
)
