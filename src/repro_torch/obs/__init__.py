"""Observability of the port: spans, metrics, Perfetto export.

A copy of the JAX package's ``obs/`` (stdlib only), with its own
process-global tracer and metrics registry: enabling one package's
tracer leaves the other's off.  Instrumented modules (``runtime``,
``core.keyswitch``) call the module-level helpers here; when disabled
each call is a branch and a no-op return.

Typical use::

    from repro_torch import obs

    obs.enable()
    ... run workload ...
    obs.export.write_trace("trace.json", tracer=obs.TRACER,
                           timelines=sim_result.timelines)
    print(obs.METRICS.to_text())
"""

from . import budget, export, registry, tracer  # noqa: F401  (re-export)
from .budget import PAPER_STALL_BUDGET, StallBudget, analyze  # noqa: F401
from .registry import (  # noqa: F401
    MetricsRegistry,
    publish_counters,
    publish_energy,
    publish_serving,
)
from .tracer import NULL_SPAN, Span, Tracer  # noqa: F401

#: Process-global tracer; disabled until :func:`enable` is called.
TRACER = Tracer()

#: Process-global metrics registry.
METRICS = MetricsRegistry()


def enabled() -> bool:
    return TRACER.enabled


def enable() -> None:
    """Turn on span collection (idempotent)."""
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def reset() -> None:
    """Drop collected spans and metrics; keeps the enabled flag."""
    TRACER.reset()
    METRICS.reset()


def span(name: str, **attrs):
    """Open a span on the global tracer (``NULL_SPAN`` when disabled)."""
    return TRACER.span(name, **attrs)


def event(name: str, **attrs) -> None:
    """Record a point event on the global tracer's current span."""
    TRACER.event(name, **attrs)


def metrics() -> MetricsRegistry:
    return METRICS
