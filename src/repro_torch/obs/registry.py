"""Label-aware metrics registry: counters, gauges, histograms.

One process-global :class:`MetricsRegistry` (held by :mod:`repro_torch.obs`)
receives published numbers from the subsystems that already count things
— ``OpCounters`` (core), ``ServingReport`` (serve) and
``Schedule.energy_breakdown`` (sim) — so a single ``snapshot()`` shows
the whole system and can be reconciled exactly against those sources.

Metric keys are ``(name, labels)`` where labels is a sorted tuple of
``(key, value)`` pairs, so ``counter("fhe.modup", level=3)`` and
``counter("fhe.modup", level=5)`` are distinct series.  Stdlib-only.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter; one value per label set."""

    __slots__ = ("name", "help", "_values")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def series(self) -> Dict[LabelKey, float]:
        return dict(self._values)


class Gauge:
    """Point-in-time value; ``set`` overwrites."""

    __slots__ = ("name", "help", "_values")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        self._values[_label_key(labels)] = float(value)

    def value(self, **labels: Any) -> Optional[float]:
        return self._values.get(_label_key(labels))

    def series(self) -> Dict[LabelKey, float]:
        return dict(self._values)


class Histogram:
    """Fixed-bucket histogram with count/sum, per label set."""

    __slots__ = ("name", "help", "buckets", "_counts", "_sums", "_ns")

    DEFAULT_BUCKETS = (
        1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
        1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    )

    def __init__(self, name: str, help: str = "", buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}
        self._ns: Dict[LabelKey, int] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        counts = self._counts.get(key)
        if counts is None:
            counts = [0] * (len(self.buckets) + 1)  # +1 = overflow bucket
            self._counts[key] = counts
        i = 0
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                counts[i] += 1
                break
        else:
            counts[len(self.buckets)] += 1
        self._sums[key] = self._sums.get(key, 0.0) + value
        self._ns[key] = self._ns.get(key, 0) + 1

    def count(self, **labels: Any) -> int:
        return self._ns.get(_label_key(labels), 0)

    def sum(self, **labels: Any) -> float:
        return self._sums.get(_label_key(labels), 0.0)

    def series(self) -> Dict[LabelKey, Dict[str, Any]]:
        out: Dict[LabelKey, Dict[str, Any]] = {}
        for key, counts in self._counts.items():
            out[key] = {
                "count": self._ns[key],
                "sum": self._sums[key],
                "buckets": list(zip(self.buckets, counts)),
                "overflow": counts[-1],
            }
        return out


class MetricsRegistry:
    """Named metric families; thread-safe creation, single snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets=Histogram.DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def reset(self) -> None:
        with self._lock:
            self._metrics = {}

    # -- exposition ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """All series as a plain dict: {name: {labelstr: value-or-hist}}."""
        out: Dict[str, Any] = {}
        with self._lock:
            metrics = dict(self._metrics)
        for name, m in sorted(metrics.items()):
            series: Dict[str, Any] = {}
            for key, val in m.series().items():
                label_str = ",".join(f"{k}={v}" for k, v in key)
                series[label_str] = val
            out[name] = {
                "type": type(m).__name__.lower(),
                "help": m.help,
                "series": series,
            }
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_text(self) -> str:
        """Prometheus-flavoured text exposition (subset, for grepping)."""
        lines: List[str] = []
        snap = self.snapshot()
        for name, fam in snap.items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for label_str, val in sorted(fam["series"].items()):
                tag = "{" + label_str + "}" if label_str else ""
                if isinstance(val, dict):  # histogram
                    lines.append(f"{name}_count{tag} {val['count']}")
                    lines.append(f"{name}_sum{tag} {val['sum']}")
                else:
                    lines.append(f"{name}{tag} {val}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Publishers: adapt the repo's existing accounting objects into the registry.
# Imported lazily by callers; take plain objects so this module stays
# dependency-free (duck-typed against OpCounters / ServingReport).
# ---------------------------------------------------------------------------

def publish_counters(reg: MetricsRegistry, counters, prefix: str = "fhe") -> None:
    """Publish an ``OpCounters`` snapshot as gauges ``fhe.<field>``.

    Gauges, not counters: OpCounters is itself cumulative and resettable,
    so we mirror its current value rather than re-accumulate.
    """
    for field, value in counters.as_dict().items():
        reg.gauge(f"{prefix}.{field}", help=f"OpCounters.{field}").set(value)


def publish_serving(reg: MetricsRegistry, report) -> None:
    """Publish a ``ServingReport`` so outcomes reconcile with ``accounted``."""
    g = reg.gauge
    g("serving.submitted", help="requests submitted").set(report.submitted)
    g("serving.completed", help="requests completed").set(report.completed)
    g("serving.rejected", help="requests rejected at submit").set(report.rejected)
    g("serving.failed", help="requests failed after retries").set(report.failed)
    g("serving.shed", help="requests shed (overload/deadline)").set(report.shed)
    g("serving.accounted", help="completed+rejected+failed+shed").set(report.accounted)
    g("serving.batches", help="batches dispatched").set(report.batches)
    g("serving.retries", help="re-dispatches after transient faults").set(report.retries)
    lat = reg.histogram("serving.latency_s", help="per-request latency (s)")
    for v in report.latencies_s:
        lat.observe(v)
    # report.tenants holds TenantStats.summary() dicts, not the stats
    # objects, so per-tenant terminal outcomes publish as labeled gauges
    done = g("serving.tenant_completed", help="completed per tenant")
    for tenant, summ in report.tenants.items():
        done.set(summ["completed"], tenant=tenant)


def publish_energy(reg: MetricsRegistry, breakdown: Dict[str, float], config: str = "") -> None:
    """Publish ``Schedule.energy_breakdown(hw)`` joules per engine."""
    g = reg.gauge("sim.energy_j", help="modeled energy per engine (J)")
    for engine, joules in breakdown.items():
        if config:
            g.set(joules, engine=engine, config=config)
        else:
            g.set(joules, engine=engine)
