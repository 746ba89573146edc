"""Encrypted inference workloads through the port's compiled runtime.

Real applications — packed logistic regression, small MLPs — traced
through ``repro_torch.runtime`` with automatic bootstrap insertion when
the level budget runs out:

* :mod:`repro_torch.workloads.models` — diagonally-packed Dense layers
  (held as their diagonals) with Chebyshev polynomial activations; the
  same source runs eagerly or traces.
* :mod:`repro_torch.workloads.insert` — the level-tracking planner that
  probes stage spans symbolically and splices ``Bootstrapper.compile``
  programs at the cheapest cut points.
* :mod:`repro_torch.workloads.pipeline` — multi-segment compilation
  (``compile_workload``), chained batched execution
  (``WorkloadExecutor``), eager replay, and the sim-timeline feed.

The public names are the JAX package's ``repro.workloads``'.
"""
from repro_torch.workloads.insert import (
    PlannedCut, SpanProbe, WorkloadPlan, plan_cuts, probe_bootstrap,
    probe_span,
)
from repro_torch.workloads.models import (
    Activation, Dense, Workload, logreg, mlp, mlp_bootstrap,
    scaled_tanh, sigmoid4,
)
from repro_torch.workloads.pipeline import (
    Segment, WorkloadExecutor, WorkloadProgram, WorkloadResult,
    compile_workload, scheduled_result, workload_blocks,
)

__all__ = [
    "Activation", "Dense", "Workload", "logreg", "mlp", "mlp_bootstrap",
    "scaled_tanh", "sigmoid4",
    "PlannedCut", "SpanProbe", "WorkloadPlan", "plan_cuts",
    "probe_bootstrap", "probe_span",
    "Segment", "WorkloadExecutor", "WorkloadProgram", "WorkloadResult",
    "compile_workload", "scheduled_result", "workload_blocks",
]
