"""Perfetto / Chrome-trace export.

Renders heterogeneous timelines into one ``trace.json`` (Chrome Trace
Event Format, the JSON flavour ui.perfetto.dev opens directly):

* **Real wall-clock spans** from :class:`repro_torch.obs.tracer.Tracer` —
  executor steps, compile phases, serve-loop activity — one track per
  Python thread under a per-process group.
* **Virtual scheduled timelines** from ``sim/schedule.py`` — one lane
  per engine (xpu/xmu/link/evk) plus an explicit ``stall`` lane whose
  slices are the exposed communication-stall intervals from
  :mod:`repro_torch.obs.budget`.
* **Virtual serving clock** — per-tenant request lanes built from the
  server's batch records, linked by request id.

All timestamps are emitted in microseconds as the format requires; the
virtual and real domains get separate pids so Perfetto shows them as
side-by-side process groups rather than falsely aligned clocks.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .budget import stall_intervals
from .tracer import Tracer

# Fixed pid blocks: real spans are pid >= 1000 (one per Python process
# group we name), virtual timelines sit below.
PID_SIM = 1
PID_SERVE_VCLOCK = 2
PID_REAL = 1000

_LANE_ORDER = ("xpu", "xmu", "link", "evk", "stall")


class TraceBuilder:
    """Accumulates Chrome trace events; ``write`` emits the JSON file."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._named_procs: Dict[int, str] = {}
        self._named_threads: Dict[Tuple[int, int], str] = {}

    # -- naming -------------------------------------------------------------
    def _name_process(self, pid: int, name: str, sort_index: Optional[int] = None) -> None:
        if self._named_procs.get(pid) == name:
            return
        self._named_procs[pid] = name
        self.events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": name},
        })
        if sort_index is not None:
            self.events.append({
                "ph": "M", "name": "process_sort_index", "pid": pid, "tid": 0,
                "args": {"sort_index": sort_index},
            })

    def _name_thread(self, pid: int, tid: int, name: str,
                     sort_index: Optional[int] = None) -> None:
        if self._named_threads.get((pid, tid)) == name:
            return
        self._named_threads[(pid, tid)] = name
        self.events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": name},
        })
        if sort_index is not None:
            self.events.append({
                "ph": "M", "name": "thread_sort_index", "pid": pid, "tid": tid,
                "args": {"sort_index": sort_index},
            })

    # -- primitives ---------------------------------------------------------
    def slice(self, pid: int, tid: int, name: str, ts_us: float, dur_us: float,
              args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {
            "ph": "X", "pid": pid, "tid": tid, "name": name,
            "ts": ts_us, "dur": max(dur_us, 0.0), "cat": "span",
        }
        if args:
            ev["args"] = _jsonable(args)
        self.events.append(ev)

    def instant(self, pid: int, tid: int, name: str, ts_us: float,
                args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {
            "ph": "i", "pid": pid, "tid": tid, "name": name,
            "ts": ts_us, "s": "t", "cat": "event",
        }
        if args:
            ev["args"] = _jsonable(args)
        self.events.append(ev)

    # -- sources ------------------------------------------------------------
    def add_tracer(self, tracer: Tracer, process: str = "executor (wall clock)") -> None:
        """Render finished tracer spans, one track per Python thread."""
        spans = tracer.spans()
        if not spans and not tracer.instants:
            return
        pid = PID_REAL
        self._name_process(pid, process, sort_index=PID_REAL)
        t0 = min(
            [s.start_ns for s in spans] + [ts for _n, ts, _t, _a in tracer.instants],
            default=0,
        )
        tids: Dict[int, int] = {}

        def lane(thread_ident: int) -> int:
            tid = tids.get(thread_ident)
            if tid is None:
                tid = len(tids) + 1
                tids[thread_ident] = tid
                label = "main" if tid == 1 else f"thread-{tid}"
                self._name_thread(pid, tid, label, sort_index=tid)
            return tid

        for s in spans:
            if s.end_ns is None:
                continue
            tid = lane(s.thread)
            args = dict(s.attrs)
            if s.parent_id is not None:
                args["parent_span"] = s.parent_id
            args["span_id"] = s.span_id
            self.slice(pid, tid, s.name, (s.start_ns - t0) / 1e3,
                       (s.end_ns - s.start_ns) / 1e3, args)
            for name, ts, attrs in s.events:
                self.instant(pid, tid, name, (ts - t0) / 1e3, attrs or None)
        for name, ts, thread_ident, attrs in tracer.instants:
            self.instant(pid, lane(thread_ident), name, (ts - t0) / 1e3, attrs or None)

    def add_timelines(self, timelines: Dict[str, Sequence[Tuple[float, float, str]]],
                      process: str = "sim schedule (virtual clock)",
                      pid: int = PID_SIM) -> None:
        """Render a virtual ``{engine: [(start, end, label)]}`` schedule.

        Engine lanes keep their scheduler order; a synthetic ``stall``
        lane holds the exposed communication-stall intervals so the gaps
        the budget gate measures are visible slices, not inferred blanks.
        """
        self._name_process(pid, process, sort_index=pid)
        lanes = [e for e in _LANE_ORDER if e in timelines]
        lanes += [e for e in timelines if e not in lanes]
        for i, eng in enumerate(lanes):
            self._name_thread(pid, i + 1, eng, sort_index=i + 1)
            for start, end, label in timelines[eng]:
                self.slice(pid, i + 1, label, start * 1e6, (end - start) * 1e6,
                           {"engine": eng})
        stall_tid = len(lanes) + 1
        self._name_thread(pid, stall_tid, "stall (comm exposed)", sort_index=stall_tid)
        for start, end in stall_intervals(timelines):
            self.slice(pid, stall_tid, "comm-stall", start * 1e6,
                       (end - start) * 1e6, {"kind": "link busy, compute idle"})

    def add_serving_vclock(self, request_log: Iterable[Dict[str, Any]],
                           process: str = "serving (virtual clock)") -> None:
        """Render per-request lifecycle lanes from the server's request log.

        Each entry: {rid, tenant, program, arrival_s, start_s, end_s,
        outcome, ...}.  One lane per tenant; queue wait and service are
        separate slices linked by rid in args.
        """
        pid = PID_SERVE_VCLOCK
        entries = list(request_log)
        if not entries:
            return
        self._name_process(pid, process, sort_index=pid)
        tids: Dict[str, int] = {}
        for r in entries:
            tenant = str(r.get("tenant", "?"))
            tid = tids.get(tenant)
            if tid is None:
                tid = len(tids) + 1
                tids[tenant] = tid
                self._name_thread(pid, tid, f"tenant {tenant}", sort_index=tid)
            arrival = r.get("arrival_s")
            start = r.get("start_s")
            end = r.get("end_s")
            args = {k: v for k, v in r.items()
                    if k not in ("arrival_s", "start_s", "end_s")}
            if arrival is not None and start is not None and start > arrival:
                self.slice(pid, tid, f"queued rid={r.get('rid')}",
                           arrival * 1e6, (start - arrival) * 1e6, args)
            if start is not None and end is not None:
                name = f"{r.get('outcome', 'run')} rid={r.get('rid')}"
                self.slice(pid, tid, name, start * 1e6, (end - start) * 1e6, args)
            elif arrival is not None and end is not None:
                self.slice(pid, tid, f"{r.get('outcome', 'done')} rid={r.get('rid')}",
                           arrival * 1e6, (end - arrival) * 1e6, args)

    # -- output -------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": {"generator": "repro_torch.obs.export"},
        }

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion of span attrs to JSON-safe values."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def write_trace(path: str,
                tracer: Optional[Tracer] = None,
                timelines: Optional[Dict[str, Sequence[Tuple[float, float, str]]]] = None,
                request_log: Optional[Iterable[Dict[str, Any]]] = None,
                sim_process: str = "sim schedule (virtual clock)") -> str:
    """One-call export: any subset of sources into a single trace.json."""
    b = TraceBuilder()
    if timelines:
        b.add_timelines(timelines, process=sim_process)
    if request_log:
        b.add_serving_vclock(request_log)
    if tracer is not None:
        b.add_tracer(tracer)
    return b.write(path)
