"""Zero-dependency span tracer for the HE^2 hot path.

Copied from the JAX package's ``obs/tracer.py`` (stdlib only).
Design constraints:

* **Opt-in** — the tracer is disabled by default.  A disabled
  ``tracer.span(...)`` call costs one attribute load, one branch and the
  return of a shared no-op singleton.
* **No device work** — instrumentation only reads the wall clock and
  Python-side counters; it launches nothing and synchronizes nothing.
* **Thread-safe context propagation** — the current-span stack lives in
  ``threading.local`` so serve-loop worker threads nest correctly, while
  finished spans land in one lock-guarded list for export.

Spans record ``time.perf_counter_ns`` timestamps, structured attributes
(``set_attrs``) and point events (``event``).  Export to Perfetto is in
:mod:`repro_torch.obs.export`; this module is stdlib-only.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class Span:
    """A finished-or-open span.  Use as a context manager.

    Truthy (unlike :class:`_NullSpan`) so call sites can branch on
    ``if span:`` to skip attribute computation when tracing is off.
    """

    __slots__ = (
        "name",
        "span_id",
        "parent_id",
        "thread",
        "start_ns",
        "end_ns",
        "attrs",
        "events",
        "_tracer",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        span_id: int,
        parent_id: Optional[int],
        thread: int,
        attrs: Dict[str, Any],
    ):
        self._tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.thread = thread
        self.start_ns = tracer.clock()
        self.end_ns: Optional[int] = None
        self.attrs = attrs
        self.events: List[Tuple[str, int, Dict[str, Any]]] = []

    # -- structured payload -------------------------------------------------
    def set_attrs(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs: Any) -> None:
        """Attach a point-in-time event to this span."""
        self.events.append((name, self._tracer.clock(), attrs))

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self) -> "Span":
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end_ns = self._tracer.clock()
        self._tracer._pop(self)

    @property
    def duration_ns(self) -> int:
        end = self.end_ns if self.end_ns is not None else self._tracer.clock()
        return end - self.start_ns

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Span({self.name!r}, id={self.span_id}, attrs={self.attrs})"


class _NullSpan:
    """Falsy no-op span returned while tracing is disabled.

    A single shared instance; every method is a no-op so instrumented
    code never needs its own ``if enabled`` guard around attribute or
    event calls.
    """

    __slots__ = ()

    def set_attrs(self, **attrs: Any) -> "_NullSpan":
        return self

    def event(self, name: str, **attrs: Any) -> None:
        return None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "NullSpan"


NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans and instant events from any number of threads."""

    def __init__(self, clock=time.perf_counter_ns):
        self.enabled = False
        self.clock = clock
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._next_id = 0
        self.finished: List[Span] = []
        # Standalone instants: (name, ts_ns, thread_id, attrs).
        self.instants: List[Tuple[str, int, int, Dict[str, Any]]] = []

    # -- control ------------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self.finished = []
            self.instants = []
            self._next_id = 0
        self._tls = threading.local()

    # -- span API -----------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """Open a span; returns ``NULL_SPAN`` when disabled.

        This is the hot-path entry point: when disabled it does one
        branch and returns a shared singleton.
        """
        if not self.enabled:
            return NULL_SPAN
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        stack = getattr(self._tls, "stack", None)
        parent = stack[-1].span_id if stack else None
        return Span(self, name, sid, parent, threading.get_ident(), attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Record a point event on the current span, or standalone."""
        if not self.enabled:
            return
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack[-1].event(name, **attrs)
        else:
            with self._lock:
                self.instants.append((name, self.clock(), threading.get_ident(), attrs))

    def current(self) -> Optional[Span]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    # -- internals ----------------------------------------------------------
    def _push(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:  # mismatched exit order; be forgiving
            stack.remove(span)
        with self._lock:
            self.finished.append(span)

    # -- inspection ---------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Finished spans, optionally filtered by name (prefix match on '*')."""
        with self._lock:
            out = list(self.finished)
        if name is None:
            return out
        if name.endswith("*"):
            pre = name[:-1]
            return [s for s in out if s.name.startswith(pre)]
        return [s for s in out if s.name == name]
