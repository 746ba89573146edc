"""Bounded FIFO request queue with per-(tenant, program) group views.

The queue is the server's only admission point: ``offer`` either
accepts a request (global FIFO order, stamped with a monotone id) or
rejects it when the bound is reached — bounded-queue *backpressure*, so
an open-loop arrival burst cannot grow server memory without limit.
Rejections are the caller's to count (``FHEServer`` reports them as
``rejected`` per tenant).

Fairness model: requests keep their global arrival order, and the
continuous-batching scheduler always serves the *group* — a
``(tenant, program_id)`` batch class — whose HEAD request is oldest.
Within a group requests are packed strictly FIFO.  Together this gives
per-tenant FIFO (a tenant's own requests complete in submission order)
and no group starvation (a group's head request ages until it is the
oldest head and must be picked next).

A copy of the JAX package's ``serve/queue.py``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.ckks import Ciphertext
from repro_torch.errors import ConfigError

# A batch class: requests sharing (tenant, program) can batch together —
# same compiled plan AND same evk set (keys are per-tenant).
GroupKey = tuple[str, str]


@dataclasses.dataclass
class Request:
    """One in-flight job: ``(tenant, program_id, ct inputs)``.

    ``deadline`` is an absolute virtual-clock time: past it the server
    sheds the request (``RequestTimeout``) instead of executing it.
    ``validate`` opts this request into the executor's per-step
    invariant checker (ciphertext health guards); a batch validates if
    ANY member requests it.
    """

    rid: int
    tenant: str
    program_id: str
    inputs: dict[str, Ciphertext]
    arrival: float                  # virtual-clock submission time (s)
    deadline: float | None = None   # absolute virtual-clock cutoff (s)
    validate: bool = False          # opt-in invariant checking

    @property
    def group(self) -> GroupKey:
        return (self.tenant, self.program_id)


class RequestQueue:
    """Bounded FIFO of :class:`Request` with group (batch-class) views."""

    def __init__(self, maxsize: int = 256):
        if maxsize <= 0:
            raise ConfigError("queue maxsize must be positive",
                              hint="pick a bound; backpressure needs one",
                              maxsize=maxsize)
        self.maxsize = maxsize
        self._items: list[Request] = []
        self._next_rid = 0
        self.rejected = 0
        self.depth_samples: list[int] = []

    def __len__(self) -> int:
        return len(self._items)

    @property
    def depth(self) -> int:
        return len(self._items)

    def offer(self, tenant: str, program_id: str,
              inputs: dict[str, Ciphertext], arrival: float,
              deadline: float | None = None,
              validate: bool = False) -> Request | None:
        """Admit a request, or return None (backpressure) when full."""
        if len(self._items) >= self.maxsize:
            self.rejected += 1
            return None
        req = Request(self._next_rid, tenant, program_id, inputs, arrival,
                      deadline=deadline, validate=validate)
        self._next_rid += 1
        self._items.append(req)
        self.depth_samples.append(len(self._items))
        return req

    # ------------------------- group views -----------------------------
    def groups(self) -> dict[GroupKey, list[Request]]:
        """Queued requests per batch class, FIFO order preserved."""
        out: dict[GroupKey, list[Request]] = {}
        for r in self._items:
            out.setdefault(r.group, []).append(r)
        return out

    def oldest(self) -> Request | None:
        return self._items[0] if self._items else None

    def take(self, reqs: list[Request]) -> None:
        """Remove a packed batch from the queue."""
        gone = {r.rid for r in reqs}
        self._items = [r for r in self._items if r.rid not in gone]
