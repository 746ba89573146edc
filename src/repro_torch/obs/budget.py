"""Communication-stall budget analysis.

The paper's headline observation (§VI) is that under group-level
pipelined execution, communication stalls — intervals where the
inter-chiplet link is busy but *neither* compute engine (XPU/XMU) is —
account for only **6.67%** of total latency on HE^2-SM.  This module
recomputes that fraction from scheduled engine timelines and exposes a
gate on that fraction.

Works on the plain ``{engine: [(start, end, label), ...]}`` dict that
``sim.schedule.Schedule.timelines()`` (and ``SimResult.timelines``)
produce, so it stays stdlib-only and usable on deserialized JSON.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]

#: Paper §VI: comm stalls <= 6.67% of latency for HE2-SM pipelined runs.
PAPER_STALL_BUDGET = 0.0667


def merge_intervals(intervals: Sequence[Interval]) -> List[Interval]:
    """Union of possibly-overlapping [start, end) intervals."""
    out: List[Interval] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def subtract_intervals(base: Sequence[Interval], cover: Sequence[Interval]) -> List[Interval]:
    """Parts of ``base`` not covered by ``cover`` (both pre-merged or not)."""
    base = merge_intervals(base)
    cover = merge_intervals(cover)
    out: List[Interval] = []
    ci = 0
    for s, e in base:
        cur = s
        while ci < len(cover) and cover[ci][1] <= cur:
            ci += 1
        j = ci
        while j < len(cover) and cover[j][0] < e:
            cs, ce = cover[j]
            if cs > cur:
                out.append((cur, cs))
            cur = max(cur, ce)
            if cur >= e:
                break
            j += 1
        if cur < e:
            out.append((cur, e))
    return out


def total(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in merge_intervals(intervals))


def busy_intervals(timelines: Dict[str, Sequence[Tuple[float, float, str]]],
                   engines: Sequence[str]) -> List[Interval]:
    """Merged busy intervals across the named engine lanes."""
    raw: List[Interval] = []
    for eng in engines:
        for s, e, _label in timelines.get(eng, ()):
            raw.append((s, e))
    return merge_intervals(raw)


def stall_intervals(timelines: Dict[str, Sequence[Tuple[float, float, str]]],
                    engines: Sequence[str] = ("link",),
                    hidden_by: Sequence[str] = ("xpu", "xmu")) -> List[Interval]:
    """Intervals where ``engines`` are busy but none of ``hidden_by`` is.

    With the defaults this is exactly the paper's communication-stall
    definition, mirroring ``Schedule.exposed_time`` but returning the
    intervals themselves so the exporter can render them as slices.
    """
    return subtract_intervals(
        busy_intervals(timelines, engines),
        busy_intervals(timelines, hidden_by),
    )


@dataclass(frozen=True)
class StallBudget:
    """Result of a stall-budget analysis for one scheduled timeline."""

    name: str
    latency_s: float
    comm_stall_s: float
    budget: float  # allowed fraction

    @property
    def fraction(self) -> float:
        return self.comm_stall_s / self.latency_s if self.latency_s > 0 else 0.0

    @property
    def within(self) -> bool:
        return self.fraction <= self.budget

    def as_dict(self) -> Dict[str, float]:
        return {
            "latency_s": self.latency_s,
            "comm_stall_s": self.comm_stall_s,
            "comm_stall_frac": self.fraction,
            "budget_frac": self.budget,
            "within_budget": self.within,
        }

    def describe(self) -> str:
        status = "within" if self.within else "OVER"
        return (
            f"{self.name}: comm stall {self.comm_stall_s * 1e3:.3f} ms "
            f"/ {self.latency_s * 1e3:.3f} ms = {self.fraction * 100:.2f}% "
            f"({status} {self.budget * 100:.2f}% budget)"
        )


def analyze(timelines: Dict[str, Sequence[Tuple[float, float, str]]],
            latency_s: Optional[float] = None,
            name: str = "schedule",
            budget: float = PAPER_STALL_BUDGET) -> StallBudget:
    """Compute the comm-stall fraction of a scheduled timeline."""
    stalls = stall_intervals(timelines)
    if latency_s is None:
        ends = [e for lane in timelines.values() for _s, e, _l in lane]
        latency_s = max(ends) if ends else 0.0
    return StallBudget(
        name=name,
        latency_s=latency_s,
        comm_stall_s=total(stalls),
        budget=budget,
    )


def check(budget: StallBudget) -> None:
    """CI gate: raise if the stall fraction exceeds the budget."""
    if not budget.within:
        raise RuntimeError(f"stall budget exceeded: {budget.describe()}")
