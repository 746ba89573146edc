"""Execution reports: close the predict -> execute -> validate loop.

``build_report`` pairs the op counters actually incremented during an
execution (ModUp/ModDown/IP invocations + NTT/BConv work derived from
the engine's real (dnum, l_ext, N) plan shapes) with the OpVolumes that
``repro_torch.dfg.hoist`` predicts for the same lowered plan.  ``reconcile``
asserts the counts agree exactly; ``scheduled_result`` feeds the
per-block volumes into the event-driven group scheduler
(``repro_torch.sim.schedule``) so a functional execution yields the paper's
performance-model latency for the very plan that just ran: a latency of
the modelled accelerator, not of the device that ran the plan.

``program_blocks`` exposes the same lowering->sim-block translation as
a standalone function: the scheduler consumes ANY packed block stream.

A copy of the JAX package's ``runtime/report.py``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.counters import OpCounters
from repro_torch.dfg.graph import OpKind
from repro_torch.dfg.hoist import (
    OpVolumes, evk_words, ip_volumes, moddown_volumes, modup_volumes,
)
from repro_torch.runtime.compile import CompiledProgram
from repro_torch.runtime.lower import (
    HoistedStep, KeyswitchFamilyStep, MultiHoistedStep, MultiRelinStep,
    RelinStep,
)


def _keyswitch_volumes(l: int, k: int, alpha: int, N: int,
                       dataflow: str = "IRF") -> OpVolumes:
    v = (modup_volumes(l, k, alpha, N)
         + moddown_volumes(l, k, alpha, N, 2)
         + ip_volumes(l, k, alpha, N))
    v.keyswitch_count = 1
    v.evk_set_words = evk_words(l, k, alpha, N)
    if dataflow == "IRF":
        dnum = -(-l // alpha)
        v.comm_up_words = dnum * (l + k) * N
        v.comm_down_words = 2 * (l + k) * N
    return v


def step_volumes(compiled: CompiledProgram, step,
                 shared_modup: bool = True) -> OpVolumes | None:
    """dfg.hoist-predicted volumes of one lowered step (None: no work).

    ``shared_modup=False`` models the seed execution path, which has no
    digits-in entry point: every hoisted block performs its own ModUp."""
    p = compiled.params
    k, alpha, N = p.k, p.alpha, p.N
    if isinstance(step, HoistedStep):
        l = step.level + 1
        fresh = step.fresh_modup or not shared_modup
        # step-0 terms are plain base-domain EWOs (no IP, no evk) — see
        # CKKSContext.hoisted_rotation_sum
        nz = [s for s in step.steps if s != 0]
        if not nz:
            v = OpVolumes()
            v.ewo_words = len(step.steps) * 2 * l * N
            return v
        v = OpVolumes()
        if fresh:
            v = v + modup_volumes(l, k, alpha, N)
        v = v + moddown_volumes(l, k, alpha, N, 2)
        for _ in range(len(nz)):
            v = v + ip_volumes(l, k, alpha, N)
        v.keyswitch_count = len(nz)
        v.evk_set_words = len(set(nz)) * evk_words(l, k, alpha, N)
        v.ewo_words = (len(step.steps) - len(nz)) * 2 * l * N
        dnum = -(-l // alpha)
        if fresh:
            v.comm_up_words = dnum * (l + k) * N
        v.comm_down_words = 2 * (l + k) * N
        return v
    if isinstance(step, MultiHoistedStep):
        l = step.level + 1
        v = OpVolumes()
        fresh = (len(step.fresh_anchors) if shared_modup
                 else len({a for a, _ in step.rot_terms}))
        for _ in range(fresh):
            v = v + modup_volumes(l, k, alpha, N)
        v = v + moddown_volumes(l, k, alpha, N, 2)
        for _ in range(step.n_rot):
            v = v + ip_volumes(l, k, alpha, N)
        v.keyswitch_count = step.n_rot
        v.evk_set_words = len(set(step.steps)) * evk_words(l, k, alpha, N)
        dnum = -(-l // alpha)
        v.comm_up_words = fresh * dnum * (l + k) * N
        v.comm_down_words = 2 * (l + k) * N
        # base-domain adds for the passthrough terms
        v.ewo_words = len(step.passthrough) * 2 * l * N
        return v
    if isinstance(step, RelinStep):
        l = step.level + 1
        v = _keyswitch_volumes(l, k, alpha, N)
        v.ewo_words += 4 * l * N      # tensor-product EWOs
        v.relin_count = 1
        return v
    if isinstance(step, MultiRelinStep):
        l = step.level + 1
        n = step.n_relin
        v = OpVolumes()
        for _ in range(n):
            v = v + modup_volumes(l, k, alpha, N)
            v = v + ip_volumes(l, k, alpha, N)
        v = v + moddown_volumes(l, k, alpha, N, 2)
        v.keyswitch_count = n
        v.relin_count = n
        # ONE shared mult key serves every merged term
        v.evk_set_words = evk_words(l, k, alpha, N)
        v.ewo_words = (n * 4 * l * N
                       + len(step.passthrough) * 2 * l * N)
        dnum = -(-l // alpha)
        v.comm_up_words = n * dnum * (l + k) * N
        v.comm_down_words = 2 * (l + k) * N
        return v
    node = compiled.dfg.nodes[step.nid]
    l = node.limbs
    # no eager CMULT branch: lower_program turns every CMULT into a
    # RelinStep (or merges it into a MultiRelinStep), handled above
    if node.op in (OpKind.ROT, OpKind.CONJ):
        return _keyswitch_volumes(l, k, alpha, N)
    if node.op in (OpKind.PMUL, OpKind.CADD, OpKind.CSUB, OpKind.CSCALE,
                   OpKind.PADD):
        v = OpVolumes()
        v.ewo_words = 2 * l * N
        return v
    if node.op == OpKind.RESCALE:
        v = OpVolumes()
        v.ewo_words = 2 * l * N
        v.ntt_words = 2 * N
        return v
    if node.op == OpKind.MOD_RAISE:
        # bootstrap boundary: INTT both components off the base prime,
        # NTT back over the full chain (the centered lift is host-side)
        v = OpVolumes()
        l_in = compiled.dfg.nodes[node.args[0]].limbs
        v.ntt_words = 2 * (l_in + l) * N
        return v
    return None


def program_blocks(compiled: CompiledProgram, batch: int = 1) -> list:
    """Sim blocks of one compiled program executed over ``batch`` cts.

    Keyswitch-family steps stream through 2*dnum pipeline groups with
    per-digit ModUp leg weights; volumes scale linearly with the batch.
    Used by ``ExecutionReport.scheduled_result``."""
    from repro_torch.sim.engine import Block

    alpha = compiled.params.alpha
    blocks = []
    for step in compiled.steps:
        v = step_volumes(compiled, step)
        if v is None:
            continue
        if isinstance(step, KeyswitchFamilyStep):
            # rotation AND relin blocks stream through 2*dnum
            # pipeline groups with per-digit ModUp leg weights
            dnum = -(-(step.level + 1) // alpha)
        elif v.keyswitch_count:
            dnum = -(-compiled.dfg.nodes[step.nid].limbs // alpha)
        else:
            dnum = 1
        blocks.append(Block(v.scaled(batch), max(dnum, 1)))
    return blocks


def predicted_volumes(compiled: CompiledProgram,
                      shared_modup: bool = True) -> OpVolumes:
    total = OpVolumes()
    for step in compiled.steps:
        v = step_volumes(compiled, step, shared_modup)
        if v is not None:
            total = total + v
    return total


@dataclasses.dataclass
class ExecutionReport:
    """Actual vs predicted op counts for one compiled execution."""

    executed: OpCounters            # per batch of ``batch`` ciphertexts
    predicted: OpVolumes            # dfg.hoist model of the lowered plan
    plan_shapes: dict[int, tuple]   # level -> engine (dnum, l_ext, N)
    batch: int
    lowering: dict

    def reconcile(self) -> dict:
        """Exact count agreement + work-volume ratios.

        Counts must match exactly (the lowered plan IS what ran); the
        NTT/BConv word ratios compare the analytic model's uniform-digit
        approximation against the engine plans' true short last groups,
        so they are ~1 but not pinned."""
        e, p, b = self.executed, self.predicted, self.batch
        out = {
            "modup": (e.modup, p.modup_count * b),
            "moddown": (e.moddown, p.moddown_count * b),
            "ip": (e.ip, p.ip_count * b),
            "keyswitch": (e.keyswitch, p.keyswitch_count * b),
            "relin": (e.relin, p.relin_count * b),
        }
        out["counts_match"] = all(a == x for a, x in out.values())
        ks_ntt = p.modup_ntt_words + p.moddown_ntt_words
        out["ntt_ratio"] = (e.ntt_words / (ks_ntt * b)) if ks_ntt else 1.0
        ks_bc = p.modup_bconv_macs + p.moddown_bconv_macs
        out["bconv_ratio"] = (e.bconv_macs / (ks_bc * b)) if ks_bc else 1.0
        out["ip_macs_ratio"] = (e.ip_macs / (p.ip_macs * b)
                                if p.ip_macs else 1.0)
        return out

    def validate_plan_shapes(self, params) -> bool:
        """The hoist model's dnum/ext must equal the engine's plans."""
        for level, (dnum, l_ext, N) in self.plan_shapes.items():
            if dnum != len(params.digit_groups(level)):
                return False
            if l_ext != level + 1 + params.k or N != params.N:
                return False
        return True

    def scheduled_result(self, compiled: CompiledProgram, hw,
                         mode: str = "pipelined"):
        """Feed the executed plan's per-block volumes into the sim's
        event-driven group scheduler -> predicted latency of the
        modelled hardware ``hw``."""
        from repro_torch.sim.engine import simulate_blocks

        return simulate_blocks(program_blocks(compiled, self.batch), hw,
                               name="runtime", mode=mode)


def build_report(compiled: CompiledProgram, ctx, executed: OpCounters,
                 batch: int = 1) -> ExecutionReport:
    plans = getattr(ctx.engine, "_plans", {})
    return ExecutionReport(
        executed=executed,
        # the seed path has no digits-in entry point, so its prediction
        # charges every hoisted block its own ModUp
        predicted=predicted_volumes(compiled,
                                    shared_modup=ctx.use_engine),
        plan_shapes={lvl: (p.dnum, p.l_ext, p.N)
                     for lvl, p in plans.items()},
        batch=batch,
        lowering=compiled.summary(),
    )
