"""Compile and execute whole workloads through the compiled runtime.

A compiled workload is a chain of *segments*: compute segments (the
planner's stage spans traced with ``TraceContext`` and lowered via
``compile_program`` — PKB fusion applies per segment) alternating with
bootstrap segments (``Bootstrapper.compile`` programs spliced at the
planner's cut points, compiled at the exact traced scale entering the
cut).  Execution chains ``ProgramExecutor.run`` / ``run_batched`` over
the segments, so every segment rides the engine's cached plans and the
batched path (one kernel launch covers every ciphertext of a batch);
reports reconcile per segment and aggregate.

Bit-exactness story: compute segments traced with ``fusion=False`` are
bit-exact with the eager replay (``WorkloadProgram.run_eager``) because
the traced scale floats are replayed verbatim by the executor, the
segment output ciphertext therefore carries the exact scale the next
segment's INPUT node was traced at, and the bootstrap segment was
compiled with ``input_scale`` pinned to that same float.

A copy of the JAX package's ``workloads/pipeline.py`` on the port's
runtime; ``scheduled_result`` feeds ``repro_torch.sim``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.runtime.compile import CompiledProgram, compile_program
from repro_torch.runtime.exec import ProgramExecutor
from repro_torch.runtime.report import program_blocks
from repro_torch.workloads.insert import WorkloadPlan, plan_cuts, trace_span
from repro_torch.workloads.models import Workload


@dataclasses.dataclass
class Segment:
    """One link of the chain: a compiled program plus its wiring."""

    kind: str                          # "compute" | "bootstrap"
    compiled: CompiledProgram
    span: tuple[int, int] | None       # stage-index range (compute only)
    in_tag: str
    out_tag: str
    closed: bool = False               # compute span ends level_down(0)


def _out_node(compiled: CompiledProgram, tag: str):
    return compiled.dfg.nodes[compiled.outputs[tag]]


@dataclasses.dataclass
class WorkloadProgram:
    """A planned, compiled workload: segments + the plan that produced
    them."""

    model: Workload
    params: object
    plan: WorkloadPlan
    segments: list[Segment]
    fused: bool
    exact: bool

    @property
    def n_bootstraps(self) -> int:
        return sum(1 for s in self.segments if s.kind == "bootstrap")

    @property
    def input_level(self) -> int:
        return self.plan.input_level

    @property
    def input_scale(self) -> float:
        return self.plan.input_scale

    @property
    def output_level(self) -> int:
        return self.plan.output_level

    @property
    def output_scale(self) -> float:
        return self.plan.output_scale

    def predicted_modups(self) -> int:
        return sum(s.compiled.summary()["predicted_modups"]
                   for s in self.segments)

    def summary(self) -> dict:
        return {
            "workload": self.model.name,
            "fused": self.fused,
            "exact": self.exact,
            "n_segments": len(self.segments),
            "n_bootstraps": self.n_bootstraps,
            "input_level": self.input_level,
            "output_level": self.output_level,
            "predicted_modups": self.predicted_modups(),
            "levels": self.plan.table,
            "segments": [
                {"kind": s.kind, "span": s.span,
                 **s.compiled.summary()} for s in self.segments
            ],
        }

    def run_eager(self, ctx, ct, btp=None):
        """Replay the committed plan op-by-op on an eager context —
        the baseline the compiled path must be bit-exact with
        (``fusion=False``) and strictly beat on ModUps."""
        stages = self.model.layers
        for seg in self.segments:
            if seg.kind == "compute":
                a, b = seg.span
                for stage in stages[a:b]:
                    ct = stage.apply(ctx, ct)
                if seg.closed and ct.level > 0:
                    ct = ctx.level_down(ct, 0)
            else:
                if btp is None:
                    raise ValueError(
                        "run_eager on a workload with bootstrap "
                        "segments needs the Bootstrapper")
                ct = btp.bootstrap(ct)
        return ct


def compile_workload(model: Workload, params, btp=None,
                     input_level: int | None = None,
                     input_scale: float | None = None,
                     fusion: bool = False,
                     exact: bool = True) -> WorkloadProgram:
    """Plan (with automatic bootstrap insertion), trace, and lower a
    workload.  ``fusion``/``exact`` are forwarded to every segment's
    ``compile_program`` / ``Bootstrapper.compile``."""
    plan = plan_cuts(model, params, btp=btp, input_level=input_level,
                     input_scale=input_scale)
    stages = list(model.layers)
    segments: list[Segment] = []
    level, scale = plan.input_level, plan.input_scale
    for k, (a, b) in enumerate(plan.spans):
        close = k < len(plan.spans) - 1
        tc, _ = trace_span(params, stages[a:b], level, scale,
                           close_at_zero=close)
        compiled = compile_program(tc, fusion=fusion, exact=exact)
        segments.append(Segment("compute", compiled, (a, b), "x", "y",
                                closed=close))
        node = _out_node(compiled, "y")
        level, scale = node.limbs - 1, float(node.attrs["scale"])
        if close:
            boot = btp.compile(input_scale=scale, fusion=fusion,
                               exact=exact)
            segments.append(Segment("bootstrap", boot, None, "ct", "out"))
            bnode = _out_node(boot, "out")
            level, scale = bnode.limbs - 1, float(bnode.attrs["scale"])
    return WorkloadProgram(model=model, params=params, plan=plan,
                           segments=segments, fused=fusion, exact=exact)


@dataclasses.dataclass
class WorkloadResult:
    """Chained execution output + per-segment reports."""

    output: object                    # Ciphertext, or list when batched
    reports: list | None = None

    def reconcile(self) -> dict:
        """Aggregate exact reconciliation: every segment's executed
        counters must equal its dfg.hoist prediction."""
        if not self.reports:
            raise ValueError("run with with_report=True to reconcile")
        per = [r.reconcile() for r in self.reports]
        return {
            "counts_match": all(p["counts_match"] for p in per),
            "segments": per,
        }


class WorkloadExecutor:
    """Chains ``ProgramExecutor`` over a workload's segments."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.ex = ProgramExecutor(ctx)

    def run(self, wp: WorkloadProgram, ct, with_report: bool = False,
            validate: bool = False) -> WorkloadResult:
        reports = [] if with_report else None
        for seg in wp.segments:
            res = self.ex.run(seg.compiled, {seg.in_tag: ct},
                              with_report=with_report, validate=validate)
            ct = res[seg.out_tag]
            if with_report:
                reports.append(res.report)
        return WorkloadResult(ct, reports)

    def run_batched(self, wp: WorkloadProgram, cts: list,
                    with_report: bool = False,
                    validate: bool = False) -> WorkloadResult:
        reports = [] if with_report else None
        for seg in wp.segments:
            res = self.ex.run_batched(seg.compiled, {seg.in_tag: cts},
                                      with_report=with_report,
                                      validate=validate)
            cts = res[seg.out_tag]
            if with_report:
                reports.append(res.report)
        return WorkloadResult(cts, reports)


def workload_blocks(wp: WorkloadProgram, batch: int = 1) -> list:
    """Concatenated per-segment keyswitch-block volumes — the feed for
    the Sec. V group-level pipeline scheduler."""
    blocks = []
    for seg in wp.segments:
        blocks.extend(program_blocks(seg.compiled, batch))
    return blocks


def scheduled_result(wp: WorkloadProgram, hw, batch: int = 1,
                     mode: str = "pipelined"):
    """What would the HE^2 hardware do with this workload: schedule the
    lowered blocks on the xPU/xMU/link/evk timelines."""
    from repro_torch.sim.engine import simulate_blocks

    return simulate_blocks(workload_blocks(wp, batch), hw,
                           name=f"workload:{wp.model.name}", mode=mode)
