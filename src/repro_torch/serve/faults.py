"""Deterministic fault injection for the serving layer.

Chaos testing an FHE server has one special requirement: **replay**.  A
fault schedule that depends on wall-clock timing or global RNG state
cannot be bisected when a recovery path regresses.  So faults here are
a pure function of ``(plan seed, dispatch index)``:

    rng = np.random.default_rng([seed, dispatch_index])

Each dispatch gets its own independent generator, and every fault kind
consumes a fixed draw from it — the schedule is identical no matter how
many retries, bisect splits, or reorderings happen in between (those
*shift* later dispatch indices, which is exactly the point: the
recovery machinery's own dispatches roll fresh dice, deterministically).

Fault kinds, mirroring the error taxonomy:

* **transient engine fault** — the dispatch raises
  :class:`TransientEngineError` before touching the engine (a lost
  device, a flaky interconnect).  Retryable; the server's
  backoff-retry path must absorb these.
* **key eviction mid-flight** — the tenant's keys are force-evicted
  from the registry and the dispatch raises
  :class:`KeyUnavailableError` (a key-store read failing under the
  running request).  Retryable because re-keygen is deterministic.
* **corrupted output limb** — one slot of the batch output gets a
  residue ``>= q`` (or NaN for float limbs) written into it after
  execution.  NOT an exception: this is the silent-corruption case the
  per-slot health checks exist to catch — exactly one request must
  fail, never a wrong answer, never a co-batched victim.
* **latency spike** — extra virtual seconds added to the dispatch's
  measured duration (GC pause, noisy neighbor).  No error; exercises
  deadline shedding and timeout accounting.

The injector wraps the server from the *outside* (the server calls
``before_dispatch`` / ``corrupt_outputs`` / ``extra_latency`` hooks);
engine, executor and registry code carry no fault-injection branches.

The port of the JAX package's ``serve/faults.py``: ``FaultPlan.draws``
stays numpy, so a seed gives the same schedule in both packages, and
``_corrupt_limb`` writes int64 max (NaN for a float tensor) into a clone
of the limb.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.errors import KeyUnavailableError, TransientEngineError


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded chaos schedule: per-dispatch fault probabilities."""

    seed: int = 0
    p_transient: float = 0.0    # raise TransientEngineError pre-dispatch
    p_evict: float = 0.0        # force-evict keys + KeyUnavailableError
    p_corrupt: float = 0.0      # corrupt one output slot's limb
    p_spike: float = 0.0        # add spike_s to the dispatch duration
    spike_s: float = 0.05       # virtual seconds per latency spike

    def draws(self, idx: int) -> dict:
        """The fault decisions for dispatch ``idx`` — a pure function
        of ``(seed, idx)``; draw order is fixed so decisions for one
        fault kind never perturb another's."""
        rng = np.random.default_rng([self.seed, idx])
        u = rng.random(4)       # transient, evict, corrupt, spike
        slot = int(rng.integers(0, 2 ** 31))
        return {
            "transient": bool(u[0] < self.p_transient),
            "evict": bool(u[1] < self.p_evict),
            "corrupt": bool(u[2] < self.p_corrupt),
            "spike": bool(u[3] < self.p_spike),
            "slot": slot,       # corrupt-target selector (mod n_real)
        }


def _corrupt_limb(ct) -> None:
    """Write an out-of-range residue (or NaN) into limb 0, slot 0.

    The write goes to a clone: a batch slot's ``c0`` is a view of the
    batch's stacked output, and an input may be shared by padding slots
    or cached, so writing in place would corrupt them too."""
    arr = ct.c0.clone()
    if arr.is_floating_point():
        arr[0, 0] = float("nan")
    else:
        arr[0, 0] = torch.iinfo(arr.dtype).max
    ct.c0 = arr


class FaultInjector:
    """Applies a :class:`FaultPlan` to a server's dispatch stream.

    Pass an instance as ``FHEServer(..., faults=injector)``.  The
    ``injected`` counters record what actually fired, so tests and the
    chaos bench can assert the schedule against the recovery metrics.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.injected = {"transient": 0, "evict": 0,
                         "corrupt": 0, "spike": 0}

    # ---- hooks the server calls ---------------------------------------
    def before_dispatch(self, idx: int, server, tenant: str) -> None:
        """Pre-dispatch faults: may raise a retryable typed error."""
        d = self.plan.draws(idx)
        if d["transient"]:
            self.injected["transient"] += 1
            raise TransientEngineError(
                "injected engine fault",
                hint="retryable; the dispatch never ran",
                dispatch=idx)
        if d["evict"]:
            self.injected["evict"] += 1
            server.registry.evict(tenant, force=True)
            raise KeyUnavailableError(
                "injected key-store loss mid-flight",
                hint="retryable; re-keygen on the retry lease is "
                     "bit-identical from the tenant seed",
                tenant=tenant, dispatch=idx)

    def corrupt_outputs(self, idx: int, outputs, n_real: int) -> None:
        """Post-dispatch fault: silently corrupt ONE real slot's output
        ciphertext.  The server's per-slot health check must turn this
        into exactly one request failure — never a wrong result."""
        d = self.plan.draws(idx)
        if not d["corrupt"] or n_real <= 0 or not outputs:
            return
        self.injected["corrupt"] += 1
        j = d["slot"] % n_real
        tag = sorted(outputs)[0]
        _corrupt_limb(outputs[tag][j])

    def extra_latency(self, idx: int) -> float:
        """Virtual seconds to add to this dispatch's duration."""
        d = self.plan.draws(idx)
        if d["spike"]:
            self.injected["spike"] += 1
            return self.plan.spike_s
        return 0.0
