"""repro_torch.runtime — DFG-compiled program executor for the CKKS scheme.

The port of the JAX package's ``runtime/``: the same IR, the same
lowering, the same steps, executed on the port's ``CKKSContext`` and
``KeyswitchEngine`` (on the card, or on the CPU when the context asks
for it):

  trace   (compile.TraceContext)  — run unmodified program code
          (``core.linear`` matvec/BSGS, ``core.polyeval`` Chebyshev)
          against a symbolic context that mirrors ``CKKSContext`` and
          records a ``dfg.trace.ProgramBuilder`` graph;
  compile (compile.compile_program) — identify PKBs, optionally run the
          ``dfg.fusion.optimal_fusion`` DP, and lower (lower.py) fused
          plans to keyswitch-family steps: hoisted-rotation-sum blocks,
          one ``RelinStep`` per CMULT, + eager engine EWOs;
          ``exact=False`` additionally lowers multi-anchor giant-step
          PKBs and sum-of-CMult closures to single-ModDown accumulation
          blocks (``MultiHoistedStep``/``MultiRelinStep``);
  execute (exec.ProgramExecutor)  — run the lowered plan on a real
          ``CKKSContext``/``KeyswitchEngine``, sharing one ModUp across
          every block anchored on the same ciphertext, and batching
          independent ciphertexts along a leading axis of every tensor;
  report  (report.ExecutionReport) — actual ModUp/ModDown/IP/NTT counts
          plus the engine's real (dnum, l_ext, N) plan shapes, cross-
          checked against ``dfg.hoist``'s predicted OpVolumes.  Feeding
          the volumes to the group scheduler waits for the port of the
          simulator.

A ``CompiledProgram`` is a key-free object: the engine resolves evk and
plaintext tensors per dispatch, so one compiled program serves any
ciphertext owner.
"""
from repro_torch.runtime.compile import (  # noqa: F401
    CompiledProgram, TraceContext, compile_program,
)
from repro_torch.runtime.exec import ProgramExecutor  # noqa: F401
from repro_torch.runtime.report import ExecutionReport  # noqa: F401
