"""Automatic bootstrap insertion: a level-tracking pass over traced DFGs.

A workload is a sequence of *stages* (one per Dense layer).  Each stage
consumes a data-dependent number of levels (matvec: 1, a degree-d
Chebyshev activation: ~log2(d)+2 — the exact figure depends on the
incoming scale's alignment path), so instead of a static cost table the
planner TRACES each candidate span through a throwaway
``runtime.TraceContext`` at the actual (level, scale) it would run at
and reads consumption off the recorded DFG.  When a stage no longer
fits, a ``Bootstrapper.compile`` program must be spliced in; the cut
point is chosen by scoring every feasible boundary with the total
limb-count of the resulting pre/post DFGs (limbs x N ~ modular-word
traffic, the same currency ``dfg.hoist`` counts) and taking the argmin
— cutting as late as possible wins naturally because post-bootstrap
stages rerun at the (lower) bootstrap output level.

The pass is purely symbolic: nothing is executed, no keys are touched,
and the traces it commits are exactly the ones
``pipeline.compile_workload`` lowers — so the plan can never drift from
the program that runs.

A copy of the JAX package's ``workloads/insert.py`` on the port's
``TraceContext``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.dfg.graph import OpKind
from repro_torch.errors import LevelExhaustedError
from repro_torch.runtime.compile import TraceContext

_IO = (OpKind.INPUT, OpKind.OUTPUT)


def trace_span(params, stages, level: int, scale: float,
               close_at_zero: bool = False):
    """Trace ``stages`` from a (level, scale) input; returns (tc, out).

    ``close_at_zero`` appends the level_down that parks the result at
    level 0 for a following bootstrap segment (mod_raise requires it).
    Input tag is ``"x"``, output tag ``"y"``.
    """
    tc = TraceContext(params)
    h = tc.input("x", level=level, scale=scale)
    for stage in stages:
        h = stage.apply(tc, h)
    if close_at_zero and h.level > 0:
        h = tc.level_down(h, 0)
    tc.output(h, "y")
    return tc, h


def graph_words(tc: TraceContext) -> int:
    """Limb-word proxy for a traced graph's work: sum of active limbs
    over all non-I/O nodes, times N."""
    total = sum(n.limbs for n in tc.g.nodes.values() if n.op not in _IO)
    return total * tc.params.N


@dataclasses.dataclass(frozen=True)
class SpanProbe:
    """Feasibility + cost of one traced span."""

    words: int
    out_level: int
    out_scale: float


def probe_span(params, stages, level: int, scale: float) -> SpanProbe | None:
    """Trace a span at (level, scale); ``None`` if the level budget
    underflows.  Underflow surfaces as assorted exceptions from deep in
    the op implementations (negative chain indices, level_down
    assertions), so feasibility is "traces cleanly AND every node keeps
    >= 1 limb"."""
    if level < 0:
        return None
    try:
        tc, h = trace_span(params, stages, level, scale)
    except Exception:
        return None
    if h.level < 0:
        return None
    if any(n.limbs < 1 for n in tc.g.nodes.values() if n.op not in _IO):
        return None
    return SpanProbe(graph_words(tc), h.level, float(h.scale))


def probe_bootstrap(params, btp, scale: float) -> SpanProbe:
    """Trace one bootstrap at a level-0 input of the given scale and
    report its output (level, scale) — the budget a post-cut segment
    restarts with."""
    tc = TraceContext(params)
    h = tc.input("ct", level=0, scale=scale)
    out = btp.bootstrap(h, ctx=tc)
    tc.output(out, "out")
    return SpanProbe(graph_words(tc), out.level, float(out.scale))


@dataclasses.dataclass(frozen=True)
class PlannedCut:
    """One committed bootstrap insertion point."""

    after_stage: int          # bootstrap splices after stages[:after_stage]
    cut_scale: float          # exact traced scale entering the bootstrap
    scores: dict              # candidate boundary -> limb-word score


@dataclasses.dataclass
class WorkloadPlan:
    """Output of the level-tracking pass: compute spans, cuts, and the
    per-stage level table (for summaries/docs)."""

    spans: list[tuple[int, int]]      # stage-index ranges, cuts between
    cuts: list[PlannedCut]
    table: list[dict]                 # per stage: name/in_level/out_level
    input_level: int
    input_scale: float
    output_level: int
    output_scale: float

    @property
    def n_bootstraps(self) -> int:
        return len(self.cuts)


def _pick_cut(params, stages, seg_start: int, blocked: int, level: int,
              scale: float, btp) -> tuple[int, float, SpanProbe, dict]:
    """Score every boundary j in (seg_start, blocked] as a cut point:
    cost = words(pre-span at the segment level) + words(post-span
    replayed at the bootstrap output level).  The bootstrap's own cost
    is (near-)constant across candidates, so it cancels."""
    best = None
    scores: dict[int, int | None] = {}
    for j in range(seg_start + 1, blocked + 1):
        pre = probe_span(params, stages[seg_start:j], level, scale)
        if pre is None:               # prefix itself no longer fits
            scores[j] = None
            continue
        boot = probe_bootstrap(params, btp, pre.out_scale)
        post = probe_span(params, stages[j:blocked + 1],
                          boot.out_level, boot.out_scale)
        if post is None:              # blocked stage still doesn't fit
            scores[j] = None
            continue
        cost = pre.words + post.words
        scores[j] = cost
        # ties break toward the LATER cut (smaller wasted level gap)
        if best is None or cost <= best[0]:
            best = (cost, j, pre.out_scale, boot)
    if best is None:
        raise LevelExhaustedError(
            f"stage '{stages[blocked].name}' does not fit the "
            f"post-bootstrap budget of this parameter set "
            f"(L={params.L}); use deeper params or a cheaper stage")
    _, j, cut_scale, boot = best
    return j, cut_scale, boot, scores


def plan_cuts(model, params, btp=None, input_level: int | None = None,
              input_scale: float | None = None) -> WorkloadPlan:
    """The level-tracking pass: walk the stages, tracing each growing
    span at its actual (level, scale); when a stage underflows, choose
    the cheapest feasible cut boundary and splice a bootstrap there.

    Raises :class:`repro_torch.errors.LevelExhaustedError` if a cut is needed
    but no ``btp`` was provided, or if no feasible cut exists.
    """
    stages = list(model.layers)
    level = params.L if input_level is None else int(input_level)
    scale = float(params.scale if input_scale is None else input_scale)

    spans: list[tuple[int, int]] = []
    cuts: list[PlannedCut] = []
    seg_start, seg_level, seg_scale = 0, level, scale
    i = 0
    while i < len(stages):
        probe = probe_span(params, stages[seg_start:i + 1],
                           seg_level, seg_scale)
        if probe is not None:
            i += 1
            continue
        if i == seg_start:
            if not cuts:
                raise LevelExhaustedError(
                    f"stage '{stages[i].name}' does not fit at input "
                    f"level {seg_level}; raise input_level (<= L="
                    f"{params.L}) or shrink the stage")
            raise LevelExhaustedError(
                f"stage '{stages[i].name}' does not fit the "
                f"post-bootstrap budget (level {seg_level}); use deeper "
                f"params or a cheaper stage")
        if btp is None:
            raise LevelExhaustedError(
                f"workload '{model.name}' exhausts the level budget at "
                f"stage '{stages[i].name}' (input level {level}); pass "
                f"a Bootstrapper to enable automatic insertion")
        j, cut_scale, boot, scores = _pick_cut(
            params, stages, seg_start, i, seg_level, seg_scale, btp)
        spans.append((seg_start, j))
        cuts.append(PlannedCut(j, cut_scale, scores))
        seg_start, seg_level, seg_scale = j, boot.out_level, boot.out_scale
        # NOTE: i is not advanced — the blocked stage re-probes from the
        # fresh post-bootstrap segment.
    spans.append((seg_start, len(stages)))

    # Per-stage level table from the committed spans (incremental
    # re-trace; spans are short so this is cheap).
    table: list[dict] = []
    seg_iter = iter(zip(spans, [None] + list(cuts)))
    lvl, sc = level, scale
    for (a, b), cut in seg_iter:
        if cut is not None:
            boot = probe_bootstrap(params, btp, cut.cut_scale)
            table.append({"stage": "<bootstrap>", "in_level": 0,
                          "out_level": boot.out_level})
            lvl, sc = boot.out_level, boot.out_scale
        for s in range(a, b):
            p = probe_span(params, stages[a:s + 1], lvl, sc)
            prev = (probe_span(params, stages[a:s], lvl, sc)
                    if s > a else SpanProbe(0, lvl, sc))
            table.append({"stage": stages[s].name,
                          "in_level": prev.out_level,
                          "out_level": p.out_level})
        p = probe_span(params, stages[a:b], lvl, sc)
        out_level, out_scale = p.out_level, p.out_scale

    return WorkloadPlan(spans=spans, cuts=cuts, table=table,
                        input_level=level, input_scale=scale,
                        output_level=out_level, output_scale=out_scale)
