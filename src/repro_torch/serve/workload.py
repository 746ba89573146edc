"""Open-loop arrival generation for the serving layer.

Production FHE traffic (the ROADMAP's millions-of-users north star) is
an *open loop*: requests arrive on their own schedule regardless of
whether the server has finished the previous ones — the load regime
where continuous batching wins and a serial request loop collapses.
The generator here is a seeded Poisson process: exponential
inter-arrival gaps at ``rate_rps``, each arrival stamped with a tenant
and a program id drawn from (optionally weighted) mixes, so deep
(Chebyshev/bootstrap-shaped) and shallow (matvec) programs interleave
the way FLASH-FHE argues real deployments do.

Determinism matters twice: the benchmark gate replays the same trace
through the continuous-batching and serial baselines, and the simulator
half (``repro_torch.serve.simfeed``) replays the very same arrivals onto the
``sim.schedule`` timelines.  Everything is derived from the single
``seed`` argument.

A copy of the JAX package's ``serve/workload.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def workload_request_programs(models, params, btp=None,
                              input_level: int | None = None,
                              fusion: bool = False, exact: bool = True):
    """Compile inference workloads into servable request programs.

    The server dispatches ONE :class:`~repro_torch.runtime.CompiledProgram`
    per request, so a single-segment workload (no bootstrap inserted)
    maps 1:1 — its program id is the workload name and its tags are the
    trace tags (``"x"`` in, ``"y"`` out).  A bootstrap-inserted
    workload publishes one program per segment (``"name/0"``,
    ``"name/1"``, ...); a client or gateway chains them by feeding each
    segment's output into the next segment's input tag — the ids stay
    stable so every hop still rides plan-cache admission.

    Returns ``(programs, chains)``: ``programs`` maps program id to
    CompiledProgram (feed to ``FHEServer.register_program``);
    ``chains`` maps each workload name to its ordered hop list of
    ``(program_id, in_tag, out_tag)``.
    """
    from repro_torch.workloads import compile_workload

    programs, chains = {}, {}
    for model in models:
        wp = compile_workload(model, params, btp=btp,
                              input_level=input_level, fusion=fusion,
                              exact=exact)
        if len(wp.segments) == 1:
            seg = wp.segments[0]
            programs[model.name] = seg.compiled
            chains[model.name] = [(model.name, seg.in_tag, seg.out_tag)]
        else:
            hops = []
            for i, seg in enumerate(wp.segments):
                pid = f"{model.name}/{i}"
                programs[pid] = seg.compiled
                hops.append((pid, seg.in_tag, seg.out_tag))
            chains[model.name] = hops
    return programs, chains


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop arrival: WHO asks for WHAT and WHEN (seconds)."""

    t: float
    tenant: str
    program_id: str


def _probs(names: list[str],
           weights: dict[str, float] | None) -> np.ndarray | None:
    if not weights:
        return None
    p = np.array([float(weights.get(n, 0.0)) for n in names])
    if p.sum() <= 0:
        raise ValueError("weights must have positive mass on the names")
    return p / p.sum()


def poisson_trace(rate_rps: float, n: int, tenants: list[str],
                  programs: list[str], seed: int = 0,
                  tenant_weights: dict[str, float] | None = None,
                  program_weights: dict[str, float] | None = None,
                  ) -> list[Arrival]:
    """``n`` Poisson arrivals at ``rate_rps`` requests/second.

    Inter-arrival gaps are iid Exponential(1/rate); tenant and program
    of each arrival are drawn independently from the (optionally
    weighted) name lists.  Fully determined by ``seed``.
    """
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    times = np.cumsum(gaps)
    t_idx = rng.choice(len(tenants), size=n,
                       p=_probs(tenants, tenant_weights))
    p_idx = rng.choice(len(programs), size=n,
                       p=_probs(programs, program_weights))
    return [
        Arrival(float(times[i]), tenants[int(t_idx[i])],
                programs[int(p_idx[i])])
        for i in range(n)
    ]
