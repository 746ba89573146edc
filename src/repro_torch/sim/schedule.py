"""Event-driven group-level pipeline scheduler (paper Sec. V).

Each keyswitch block is expanded into its 2*dnum pipeline groups; every
group contributes a chain of tasks across the five hardware engines

    xpu   — ModUp legs (INTT/BConv/NTT) and, after the down transfer,
            ModDown legs + internal sub/scale
    link  — the heterogeneous xPU<->HBM interface, shared by both
            directions (up: ModUp outputs to the xMU; down: IP
            accumulations back) exactly like the analytic model's
            single t_comm budget
    xmu   — IP MACs, extended-domain EWOs, automorphism on bank PEs
    evk   — off-chip evk stream (EVF traffic due this block)

A discrete-event list scheduler places tasks onto explicit per-engine
timelines (FIFO by task id among ready tasks), which yields exact
fill/drain behaviour and cross-block overlap: group g of block i+1
starts on the xPU as soon as group g of block i has drained back
(streaming data dependency), while block i's later groups are still in
the xMU or on the link.  Designs without dual-level overlap
(hw.dual_overlap=False) execute one group per block and a hard barrier
between blocks, which reproduces the serial/naive models exactly.

Stall attribution is measured from gaps in the timelines instead of
algebraic residuals: comm stall is wall-clock time where a link is busy
but neither compute engine is; mem stall is time where only the evk
stream is busy.

A copy of the JAX package's ``sim/schedule.py``.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

from repro_torch.sim.hw import HWConfig, WORD_BYTES


def pipeline_groups(dnum: int, pipelined: bool = True) -> int:
    """Number of pipeline groups a keyswitch block decomposes into.

    The paper streams each block as 2*dnum groups (one per digit for the
    up-phase, one per digit for the down-phase, Sec. V); non-pipelined
    designs execute the block as a single group.  The analytic
    combiner's fill term divides by the same count.
    """
    return max(2 * dnum, 2) if pipelined else 1

XPU = "xpu"
XMU = "xmu"
LINK = "link"
EVK = "evk"
ENGINES = (XPU, XMU, LINK, EVK)


@dataclasses.dataclass
class Task:
    tid: int
    engine: str
    duration: float
    deps: list[int]
    label: str
    block: int
    group: int
    start: float = 0.0
    end: float = 0.0


@dataclasses.dataclass
class Schedule:
    """Result of an event-driven run: placed tasks + per-engine traces."""

    tasks: list[Task]
    makespan: float

    def timeline(self, engine: str) -> list[Task]:
        return sorted((t for t in self.tasks if t.engine == engine),
                      key=lambda t: t.start)

    def timelines(self) -> dict[str, list[tuple[float, float, str]]]:
        return {
            e: [(t.start, t.end, t.label) for t in self.timeline(e)]
            for e in ENGINES
        }

    def busy(self, engine: str) -> float:
        return sum(t.duration for t in self.tasks if t.engine == engine)

    def utilization(self) -> dict[str, float]:
        if not self.makespan:
            return {e: 0.0 for e in ENGINES}
        return {e: self.busy(e) / self.makespan for e in ENGINES}

    # ---- stall attribution from timeline gaps --------------------------
    def _busy_intervals(self, engines: tuple[str, ...]):
        ivs = sorted(
            (t.start, t.end) for t in self.tasks
            if t.engine in engines and t.duration > 0
        )
        merged: list[list[float]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def exposed_time(self, engines: tuple[str, ...],
                     hidden_by: tuple[str, ...]) -> float:
        """Wall-clock time where `engines` are busy but none of
        `hidden_by` is — i.e. stall exposed on the critical path."""
        cover = self._busy_intervals(hidden_by)
        exposed = 0.0
        for s, e in self._busy_intervals(engines):
            for cs, ce in cover:
                if ce <= s:
                    continue
                if cs >= e:
                    break
                lo, hi = max(s, cs), min(e, ce)
                exposed -= max(0.0, hi - lo)
            exposed += e - s
        return max(0.0, exposed)

    @property
    def comm_stall_s(self) -> float:
        return self.exposed_time((LINK,), (XPU, XMU))

    @property
    def mem_stall_s(self) -> float:
        return self.exposed_time((EVK,), (XPU, XMU, LINK))

    # ---- energy integrated over the timelines --------------------------
    def busy_integral(self, engines: tuple[str, ...]) -> float:
        """Seconds covered by the merged busy intervals of ``engines``."""
        return sum(e - s for s, e in self._busy_intervals(engines))

    def energy_breakdown(self, hw: HWConfig) -> dict[str, float]:
        """Per-engine energy from the placed timelines.

        Dynamic power integrates over each engine's merged
        ``_busy_intervals`` (not pre-scheduling busy-time totals), plus
        the 10% static floor over the makespan; link/evk energy charges
        the bytes actually streamed during their busy intervals
        (interval seconds x link bandwidth x pJ/B) — post-cache evk
        traffic, not the raw EVF volume estimate."""
        static = 0.10 * self.makespan
        moved = (self.busy_integral((LINK,)) + self.busy_integral((EVK,)))
        link_bytes = moved * hw.hbm_bw_tbs * 1e12
        return {
            XPU: hw.power_xpu_w * (self.busy_integral((XPU,)) + static),
            XMU: hw.power_xmu_w * (self.busy_integral((XMU,)) + static),
            LINK: link_bytes * hw.link_pj_per_byte * 1e-12,
        }

    def energy_j(self, hw: HWConfig) -> float:
        return sum(self.energy_breakdown(hw).values())


class _TaskGraph:
    def __init__(self) -> None:
        self.tasks: list[Task] = []

    def add(self, engine: str, duration: float, deps: list[Task],
            label: str, block: int, group: int) -> Task:
        t = Task(len(self.tasks), engine, duration,
                 [d.tid for d in deps], label, block, group)
        self.tasks.append(t)
        return t

    def chain(self, stages: list[tuple[str, float]], deps: list[Task],
              label: str, block: int, group: int) -> list[Task]:
        """Create the non-empty stages of a serial chain; the first
        created task inherits `deps`, later ones depend on the previous."""
        out: list[Task] = []
        prev = deps
        for engine, dur in stages:
            if dur <= 0.0:
                continue
            t = self.add(engine, dur, prev, f"{label}/{engine}", block,
                         group)
            prev = [t]
            out.append(t)
        return out


def _xpu_phase_split(v, hw: HWConfig) -> float:
    """Fraction of a block's xPU time spent before the up-link (ModUp
    legs + unattributed work) vs after the down-link (ModDown legs +
    internal sub/scale).  Proportional apportioning keeps the per-engine
    busy totals identical to the analytic model's."""
    up = (v.modup_ntt_words / hw.ntt_tput
          + v.modup_bconv_macs / hw.bconv_tput)
    up += (max(v.ntt_words - v.modup_ntt_words - v.moddown_ntt_words, 0.0)
           / hw.ntt_tput)
    up += (max(v.bconv_macs - v.modup_bconv_macs - v.moddown_bconv_macs,
               0.0) / hw.bconv_tput)
    down = (v.moddown_ntt_words / hw.ntt_tput
            + v.moddown_bconv_macs / hw.bconv_tput
            + v.xpu_ewo_words / hw.ewe_tput)
    total = up + down
    return up / total if total > 0 else 1.0


def _up_slice_weights(v, hw: HWConfig, groups: int) -> list[float]:
    """Per-slice weights for the up-phase xPU work.

    When the block carries per-digit ModUp leg volumes (``v.modup_legs``,
    derived from the keyswitch engine's real (dnum, l_ext, N) plan
    shapes), slice g is weighted by digit g % len(legs)'s actual leg
    seconds — a short last decomposition group gets a proportionally
    shorter xPU slice, which changes fill/drain without changing any
    busy total.  The legs only need to TILE the slice count (groups %
    len(legs) == 0): multi-anchor blocks from the compiled runtime
    (``runtime.lower.MultiHoistedStep``) merge several same-level ModUps
    into dnum summed legs while still streaming 2*dnum groups, and keep
    the per-digit weighting here.  Falls back to a uniform split when
    legs are unavailable or do not tile the groups."""
    legs = getattr(v, "modup_legs", ())
    if not legs or groups % len(legs):
        return [1.0 / groups] * groups
    w = [ntt / hw.ntt_tput + bc / hw.bconv_tput for ntt, bc in legs]
    total = sum(w) * (groups // len(legs))
    if total <= 0.0:
        return [1.0 / groups] * groups
    return [w[g % len(legs)] / total for g in range(groups)]


def _down_slice_weights(v, hw: HWConfig, groups: int) -> list[float]:
    """Per-slice weights for the down-phase xPU work.

    Mirror of :func:`_up_slice_weights` for the ModDown side: the IP
    accumulation streams back digit-by-digit in the same group order the
    ModUp went up, so slice g's post-link xPU work (NTT back + BConv +
    subtract/scale of digit g's base limbs) is weighted by
    ``v.moddown_legs`` — a short last decomposition group drains
    proportionally faster.  Identical to the uniform split when digits
    are uniform; falls back to it when legs are unavailable or do not
    tile the groups."""
    legs = getattr(v, "moddown_legs", ())
    if not legs or groups % len(legs):
        return [1.0 / groups] * groups
    w = [ntt / hw.ntt_tput + bc / hw.bconv_tput + ewo / hw.ewe_tput
         for ntt, bc, ewo in legs]
    total = sum(w) * (groups // len(legs))
    if total <= 0.0:
        return [1.0 / groups] * groups
    return [w[g % len(legs)] / total for g in range(groups)]


def build_block_tasks(graph: _TaskGraph, block_idx: int, times: dict,
                      v, hw: HWConfig,
                      prev_outputs: list[Task],
                      prev_all: list[Task]) -> list[Task]:
    """Expand one mapped block into group tasks; returns the per-group
    output tasks the next block's groups may stream after.

    `times` is the analytic per-engine time dict (engine.py) so that the
    scheduled model's busy totals agree with the analytic ones exactly.
    """
    t_xpu, t_xmu, t_evk = times["xpu"], times["xmu"], times["evk"]
    link_s_per_word = WORD_BYTES / (hw.hbm_bw_tbs * 1e12)
    t_up = v.comm_up_words * link_s_per_word
    t_down = v.comm_down_words * link_s_per_word
    pipelined = hw.dual_overlap and hw.xmu_tput > 0
    groups = pipeline_groups(times["dnum"], pipelined)
    f_up = _xpu_phase_split(v, hw)
    up_w = _up_slice_weights(v, hw, groups)
    down_w = _down_slice_weights(v, hw, groups)

    outputs: list[Task] = []
    for g in range(groups):
        if pipelined:
            # stream after the same group of the previous block
            deps = ([prev_outputs[min(g, len(prev_outputs) - 1)]]
                    if prev_outputs else [])
        else:
            deps = prev_all  # hard barrier: no inter-block overlap
        if hw.xmu_tput == 0:
            # monolithic: all compute on the xPU; evk stream overlaps
            chain = graph.chain([(XPU, (t_xpu + t_xmu) / groups)], deps,
                                f"b{block_idx}.g{g}", block_idx, g)
            ev = graph.chain([(EVK, t_evk / groups)], deps,
                             f"b{block_idx}.g{g}.evk", block_idx, g)
            outputs.append((chain or ev or prev_outputs[-1:] or [None])[-1])
            continue
        up_chain = graph.chain(
            [(XPU, f_up * t_xpu * up_w[g]), (LINK, t_up / groups)],
            deps, f"b{block_idx}.g{g}.up", block_idx, g)
        if pipelined:
            # evk digits stream ahead on their own engine
            ev = graph.chain([(EVK, t_evk / groups)], deps,
                             f"b{block_idx}.g{g}.evk", block_idx, g)
            xmu_deps = (up_chain[-1:] if up_chain else deps) + ev
        else:
            # naive design fetches the key on the critical path
            ev = graph.chain([(EVK, t_evk / groups)],
                             up_chain[-1:] if up_chain else deps,
                             f"b{block_idx}.g{g}.evk", block_idx, g)
            xmu_deps = ev or (up_chain[-1:] if up_chain else deps)
        down_chain = graph.chain(
            [(XMU, t_xmu / groups), (LINK, t_down / groups),
             (XPU, (1.0 - f_up) * t_xpu * down_w[g])],
            xmu_deps, f"b{block_idx}.g{g}.down", block_idx, g)
        last = (down_chain or up_chain or ev)
        outputs.append(last[-1] if last else
                       (prev_outputs[-1] if prev_outputs else None))
    return [t for t in outputs if t is not None]


def run_schedule(tasks: list[Task]) -> Schedule:
    """Deterministic list scheduling: among ready tasks each engine runs
    the lowest task id first (in-order issue per engine, out-of-order
    across engines)."""
    indeg = {t.tid: len(t.deps) for t in tasks}
    dependents: dict[int, list[int]] = defaultdict(list)
    by_id = {t.tid: t for t in tasks}
    for t in tasks:
        for d in t.deps:
            dependents[d].append(t.tid)
    ready: dict[str, list[int]] = defaultdict(list)
    for t in tasks:
        if indeg[t.tid] == 0:
            heapq.heappush(ready[t.engine], t.tid)
    engine_free: dict[str, float] = defaultdict(float)
    running: dict[str, bool] = defaultdict(bool)
    events: list[tuple[float, int]] = []
    now = 0.0

    def dispatch(now: float) -> None:
        for e in list(ready):
            if running[e] or not ready[e]:
                continue
            tid = heapq.heappop(ready[e])
            t = by_id[tid]
            t.start = max(now, engine_free[e])
            t.end = t.start + t.duration
            engine_free[e] = t.end
            running[e] = True
            heapq.heappush(events, (t.end, tid))

    dispatch(now)
    done = 0
    while events:
        now, tid = heapq.heappop(events)
        done += 1
        t = by_id[tid]
        running[t.engine] = False
        for d in dependents[tid]:
            indeg[d] -= 1
            if indeg[d] == 0:
                heapq.heappush(ready[by_id[d].engine], by_id[d].tid)
        dispatch(now)
    if done != len(tasks):
        raise RuntimeError(
            f"schedule deadlock: {len(tasks) - done} tasks never ran")
    return Schedule(tasks, max((t.end for t in tasks), default=0.0))


def schedule_blocks(block_times: list[tuple[dict, object]],
                    hw: HWConfig) -> Schedule:
    """Schedule a program: `block_times` pairs the analytic engine-time
    dict of each block with its OpVolumes, in program order."""
    graph = _TaskGraph()
    prev_outputs: list[Task] = []
    prev_all: list[Task] = []
    for i, (times, v) in enumerate(block_times):
        n0 = len(graph.tasks)
        prev_outputs = build_block_tasks(graph, i, times, v, hw,
                                         prev_outputs, prev_all)
        prev_all = graph.tasks[n0:]
    return run_schedule(graph.tasks)


def scheduled_block_time(times: dict, v, hw: HWConfig) -> float:
    """Group-pipeline makespan of a single block — the cost the fusion
    DP and the hybrid dataflow choice optimize under mode='pipelined'."""
    return schedule_blocks([(times, v)], hw).makespan
