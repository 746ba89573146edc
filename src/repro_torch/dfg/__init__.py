"""HERO: hoisting-enhanced DFG optimization framework (paper Sec. IV).

Pipeline:  trace/generate DFG  ->  PKB identify (layering)
        ->  degree-minimized expansion  ->  PKB fusion (DP evaluator)
        ->  hoisting rewrite  ->  IRF/EVF/hybrid dataflow mapping
        ->  repro_torch.sim (performance model) or repro_torch.runtime
            (compiled functional execution on the keyswitch engine).

A copy of the JAX package's ``dfg/`` (numpy only): ``graph``, ``trace``,
``pkb``, ``hoist``, ``fusion``, ``mapping`` and the paper's program
generators ``programs``.

``repro_torch.runtime.compile.TraceContext`` builds this IR from unmodified
program code and ``repro_torch.runtime.lower`` turns identified/fused PKBs
into real hoisted-rotation-sum invocations; ``repro_torch.runtime.report``
cross-checks the executed op counts against ``hoist.OpVolumes``.
"""
from repro_torch.dfg.graph import DFG, Node, OpKind  # noqa: F401
from repro_torch.dfg.pkb import PKB, identify_pkbs  # noqa: F401
