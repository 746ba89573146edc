"""Symbolic tracing + compilation front-end for the CKKS runtime.

``TraceContext`` mirrors the op surface of ``repro_torch.core.ckks.CKKSContext``
(encode / pt_add / pt_mul / add / sub / double / multiply / square /
rotate / conjugate / hoisted_rotation_sum / rescale / level_down /
mod_raise) but records a ``dfg.trace.ProgramBuilder`` graph — the same
IR the simulator consumes — instead of computing.  Plaintexts are
recorded as level/scale-parameterized ``PtSpec``s (the raw slot values
plus the exact encode parameters the eager path would use), and
``mod_raise`` becomes an opaque ``OpKind.MOD_RAISE`` boundary node the
executor replays via ``CKKSContext.mod_raise``.  Unmodified program
code (``core.linear.matvec_diag``/``matvec_bsgs``,
``core.polyeval.eval_chebyshev``) therefore runs EITHER eagerly or under the tracer; every level/scale
decision the eager code makes is replayed symbolically and baked into
node attributes, which is what keeps the compiled execution bit-exact
with the eager path.

``compile_program`` then runs PKB identification and (optionally) the
HERO fusion DP over the traced graph and lowers the plan to executable
steps (see ``repro_torch.runtime.lower``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.core.params import CKKSParams
from repro_torch.dfg.graph import DFG, OpKind
from repro_torch.dfg.trace import ProgramBuilder


@dataclasses.dataclass
class PtSpec:
    """A plaintext recorded at trace time: the raw slot values plus the
    exact (level, scale) the eager path would have encoded them at."""

    values: np.ndarray
    level: int
    scale: float


@dataclasses.dataclass
class TracePlaintext:
    """Symbolic ``Plaintext`` — carries the id into the pt-spec table."""

    pid: int
    level: int
    scale: float


class TraceHandle:
    """Symbolic ``Ciphertext``: a node id plus the (level, scale) the
    eager path would carry.  Assigning ``.scale`` (as ``mul_const``
    does) writes through to the node's recorded attributes so the
    executor replays the exact same float."""

    def __init__(self, tc: "TraceContext", nid: int, level: int,
                 scale: float):
        self._tc = tc
        self.nid = nid
        self.level = level
        self._scale = scale

    @property
    def scale(self) -> float:
        return self._scale

    @scale.setter
    def scale(self, value: float) -> None:
        self._scale = value
        self._tc.g.nodes[self.nid].attrs["scale"] = value

    @property
    def n_limbs(self) -> int:
        return self.level + 1


class TraceContext:
    """Records CKKS programs as DFGs; mirrors ``CKKSContext``'s op API."""

    def __init__(self, params: CKKSParams):
        self.params = params
        self.b = ProgramBuilder(N=params.N, alpha=params.alpha)
        self.g: DFG = self.b.g
        self.pt_specs: list[PtSpec] = []
        self.inputs: dict[str, int] = {}
        self.outputs: dict[str, int] = {}
        self._rot_cse: dict[tuple, int] = {}

    # ------------------------- helpers --------------------------------
    def chain(self, level: int) -> tuple[int, ...]:
        return self.params.q_chain(level)

    def _dnum(self, level: int) -> int:
        return len(self.params.digit_groups(level))

    def _emit(self, op: OpKind, args: tuple[int, ...], level: int,
              scale: float, **attrs) -> TraceHandle:
        nid = self.g.add(op, args, limbs=level + 1, scale=scale, **attrs)
        return TraceHandle(self, nid, level, scale)

    # ------------------------- program I/O -----------------------------
    def input(self, tag: str = "in", level: int | None = None,
              scale: float | None = None) -> TraceHandle:
        level = self.params.L if level is None else level
        scale = self.params.scale if scale is None else scale
        h = self._emit(OpKind.INPUT, (), level, scale, tag=tag)
        self.g.nodes[h.nid].attrs["level"] = level
        self.inputs[tag] = h.nid
        obs.event("trace.input", tag=tag, level=level, nid=h.nid)
        return h

    def output(self, h: TraceHandle, tag: str = "out") -> int:
        nid = self.g.add(OpKind.OUTPUT, (h.nid,), limbs=h.n_limbs, tag=tag)
        self.outputs[tag] = h.nid
        obs.event("trace.output", tag=tag, nid=nid,
                  nodes=len(self.g.nodes))
        return nid

    # ------------------------- encode ----------------------------------
    def encode(self, z, level: int | None = None,
               scale: float | None = None) -> TracePlaintext:
        level = self.params.L if level is None else level
        scale = self.params.scale if scale is None else scale
        self.pt_specs.append(PtSpec(np.asarray(z), level, scale))
        return TracePlaintext(len(self.pt_specs) - 1, level, scale)

    # ------------------------- EWOs ------------------------------------
    def add(self, a: TraceHandle, b: TraceHandle) -> TraceHandle:
        assert a.level == b.level, "level mismatch (use level_down)"
        return self._emit(OpKind.CADD, (a.nid, b.nid), a.level, a.scale)

    def sub(self, a: TraceHandle, b: TraceHandle) -> TraceHandle:
        assert a.level == b.level
        return self._emit(OpKind.CSUB, (a.nid, b.nid), a.level, a.scale)

    def double(self, ct: TraceHandle) -> TraceHandle:
        return self._emit(OpKind.CSCALE, (ct.nid,), ct.level, ct.scale, c=2)

    def pt_add(self, a: TraceHandle, pt: TracePlaintext) -> TraceHandle:
        return self._emit(OpKind.PADD, (a.nid,), a.level, a.scale,
                          pt=pt.pid)

    def pt_mul(self, a: TraceHandle, pt: TracePlaintext,
               rescale: bool = True) -> TraceHandle:
        out = self._emit(OpKind.PMUL, (a.nid,), a.level,
                         a.scale * pt.scale, pt=pt.pid)
        return self.rescale(out) if rescale else out

    # ------------------------- level management ------------------------
    def rescale(self, ct: TraceHandle) -> TraceHandle:
        q_last = self.chain(ct.level)[-1]
        return self._emit(OpKind.RESCALE, (ct.nid,), ct.level - 1,
                          ct.scale / q_last)

    def level_down(self, ct: TraceHandle, target: int) -> TraceHandle:
        assert target <= ct.level
        if target == ct.level:
            return ct
        return self._emit(OpKind.LEVEL_DOWN, (ct.nid,), target, ct.scale,
                          target=target)

    def mod_raise(self, ct: TraceHandle) -> TraceHandle:
        """Bootstrap boundary: an opaque node lifting level 0 -> L.

        The centered-CRT lift has no symbolic form; the executor replays
        it via ``CKKSContext.mod_raise`` (scale is preserved, the level
        jumps to the top of the chain)."""
        assert ct.level == 0, "mod_raise consumes a level-0 ciphertext"
        return self._emit(OpKind.MOD_RAISE, (ct.nid,), self.params.L,
                          ct.scale)

    # ------------------------- mult / rotate ---------------------------
    def multiply(self, a: TraceHandle, b: TraceHandle,
                 rescale: bool = True) -> TraceHandle:
        assert a.level == b.level
        out = self._emit(OpKind.CMULT, (a.nid, b.nid), a.level,
                         a.scale * b.scale, dnum=self._dnum(a.level))
        return self.rescale(out) if rescale else out

    def square(self, a: TraceHandle, rescale: bool = True) -> TraceHandle:
        return self.multiply(a, a, rescale=rescale)

    def rotate(self, ct: TraceHandle, steps: int) -> TraceHandle:
        steps = steps % self.params.num_slots
        if steps == 0:
            return ct
        key = (OpKind.ROT, ct.nid, steps)
        if key in self._rot_cse:          # CSE: same rotation of the same
            nid = self._rot_cse[key]      # value is the same node
            return TraceHandle(self, nid, ct.level, ct.scale)
        h = self._emit(OpKind.ROT, (ct.nid,), ct.level, ct.scale,
                       steps=steps, dnum=self._dnum(ct.level))
        self._rot_cse[key] = h.nid
        return h

    def conjugate(self, ct: TraceHandle) -> TraceHandle:
        key = (OpKind.CONJ, ct.nid, 0)
        if key in self._rot_cse:
            return TraceHandle(self, self._rot_cse[key], ct.level, ct.scale)
        h = self._emit(OpKind.CONJ, (ct.nid,), ct.level, ct.scale,
                       dnum=self._dnum(ct.level))
        self._rot_cse[key] = h.nid
        return h

    # ------------------------- hoisted rotations -----------------------
    def hoisted_rotation_sum(
        self, ct: TraceHandle, steps_list: list[int],
        pts: list[TracePlaintext] | None = None, rescale: bool = True,
    ) -> TraceHandle:
        """Recorded at ELEMENTARY granularity (rot/pmul/cadd) so the
        compiler re-discovers the PKB, re-hoists it, and may fuse it
        with serial neighbours — the eager call's block structure is a
        special case the lowering reproduces bit-exactly."""
        terms: list[TraceHandle] = []
        for i, s in enumerate(steps_list):
            h = self.rotate(ct, s)
            if pts is not None:
                h = self.pt_mul(h, pts[i], rescale=False)
            terms.append(h)
        out = terms[0]
        for t in terms[1:]:
            out = self.add(out, t)
        if pts is not None and rescale:
            out = self.rescale(out)
        return out


# --------------------------- compilation --------------------------------

@dataclasses.dataclass
class CompiledProgram:
    """A lowered program: ordered steps over the traced DFG.

    ``steps`` mixes ``lower.HoistedStep`` (fused PKBs -> one hoisted-
    rotation-sum engine invocation each, ModUp shared per anchor) and
    ``lower.EagerStep`` (everything else, op-by-op on the engine).
    """

    params: CKKSParams
    dfg: DFG
    pt_specs: list[PtSpec]
    inputs: dict[str, int]
    outputs: dict[str, int]
    steps: list
    pkbs: list
    fusion_plan: object | None
    fused: bool
    exact: bool = True

    @property
    def n_hoisted(self) -> int:
        from repro_torch.runtime.lower import HoistedStep

        return sum(1 for s in self.steps if isinstance(s, HoistedStep))

    @property
    def n_multi(self) -> int:
        from repro_torch.runtime.lower import MultiHoistedStep

        return sum(1 for s in self.steps
                   if isinstance(s, MultiHoistedStep))

    @property
    def n_relin(self) -> int:
        from repro_torch.runtime.lower import RelinStep

        return sum(1 for s in self.steps if isinstance(s, RelinStep))

    @property
    def n_multi_relin(self) -> int:
        from repro_torch.runtime.lower import MultiRelinStep

        return sum(1 for s in self.steps
                   if isinstance(s, MultiRelinStep))

    @property
    def n_eager(self) -> int:
        return len(self.steps) - (self.n_hoisted + self.n_multi
                                  + self.n_relin + self.n_multi_relin)

    def summary(self) -> dict:
        from repro_torch.runtime.lower import (
            HoistedStep, MultiHoistedStep, MultiRelinStep, RelinStep,
        )

        hoisted = [s for s in self.steps if isinstance(s, HoistedStep)]
        multi = [s for s in self.steps if isinstance(s, MultiHoistedStep)]
        relin = [s for s in self.steps if isinstance(s, RelinStep)]
        mrelin = [s for s in self.steps if isinstance(s, MultiRelinStep)]
        return {
            "nodes": len(self.dfg.nodes),
            "pkbs": len(self.pkbs),
            "fused": self.fused,
            "exact": self.exact,
            "hoisted_steps": len(hoisted),
            "multi_anchor_steps": len(multi),
            "shared_modups": sum(1 for s in hoisted if not s.fresh_modup),
            "relin_steps": len(relin),
            "multi_relin_steps": len(mrelin),
            "merged_relins": sum(s.n_relin for s in mrelin),
            "eager_steps": self.n_eager,
            "predicted_modups": (
                sum(1 for s in hoisted if s.fresh_modup)
                + sum(len(s.fresh_anchors) for s in multi)
                + len(relin)
                + sum(s.n_relin for s in mrelin)
            ),
            "predicted_relin_moddowns": len(relin) + len(mrelin),
        }


def compile_program(tc: TraceContext, fusion: bool = False,
                    capacity_words: float | None = None,
                    max_group: int = 4,
                    exact: bool = True) -> CompiledProgram:
    """Lower a traced program onto the keyswitch engine.

    fusion=False (default) guarantees bit-exactness with the eager path:
    PKBs are hoisted (ModUp shared per anchor ciphertext) but the Eq. (4)
    inverse-BSGS rewrite is off.  fusion=True runs the
    ``dfg.fusion.optimal_fusion`` DP and lowers fused groups to single
    hoisted blocks with pairwise-summed steps and combined plaintexts —
    numerically equivalent, not bit-identical (different evk
    trajectories), and strictly fewer ModUps/ModDowns.

    Relinearization always compiles through the keyswitch family: every
    CMULT lowers to a ``lower.RelinStep`` on the engine's ``relin``
    entry point (bit-exact with eager ``CKKSContext.multiply``).

    exact=False additionally lowers multi-anchor PKBs (the giant-step
    phase of BSGS, whose rotations consume different ciphertexts) to
    ``lower.MultiHoistedStep`` blocks, and sum-of-CMult closures (the
    giant-step product sums of ``polyeval.eval_chebyshev_bsgs``) to
    ``lower.MultiRelinStep`` blocks: per-term IPs accumulate in the
    extended basis and ONE ModDown closes the whole sum, instead of one
    ModDown per rotation/relin.  Numerically close but not
    bit-identical (the approximate-FBC rounding of the merged ModDowns
    differs); see ``tests/test_runtime_bootstrap.py`` and
    ``tests/test_relin.py`` for the measured error bounds.
    """
    from repro_torch.runtime.lower import lower_program

    with obs.span("compile.program", nodes=len(tc.g.nodes),
                  fusion=fusion, exact=exact) as sp:
        compiled = lower_program(tc, fusion=fusion,
                                 capacity_words=capacity_words,
                                 max_group=max_group, exact=exact)
        if sp:
            sp.set_attrs(**{k: v for k, v in compiled.summary().items()
                            if isinstance(v, (int, float, bool, str))})
    return compiled
