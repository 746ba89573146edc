"""Symbolic tracer: build CKKS DFGs from Python programs.

The handle mirrors repro_torch.core.ckks's API so the same program shape can be
run functionally (small ring) and costed/optimized (production ring).

``repro_torch.runtime.compile.TraceContext`` builds on ``ProgramBuilder``
with the attributes real execution needs (plaintext specs, exact scales,
level management ops) — programs traced there run on the keyswitch
engine via ``repro_torch.runtime``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.dfg.graph import DFG, OpKind


@dataclasses.dataclass
class Handle:
    b: "ProgramBuilder"
    nid: int
    limbs: int

    def rot(self, steps: int) -> "Handle":
        nid = self.b.g.add(OpKind.ROT, (self.nid,), limbs=self.limbs,
                           steps=steps, dnum=self.b.dnum(self.limbs))
        return Handle(self.b, nid, self.limbs)

    def conj(self) -> "Handle":
        nid = self.b.g.add(OpKind.CONJ, (self.nid,), limbs=self.limbs,
                           dnum=self.b.dnum(self.limbs))
        return Handle(self.b, nid, self.limbs)

    def pmul(self, pt_tag: str = "pt") -> "Handle":
        nid = self.b.g.add(OpKind.PMUL, (self.nid,), limbs=self.limbs,
                           pt=pt_tag)
        return Handle(self.b, nid, self.limbs)

    def padd(self, pt_tag: str = "pt") -> "Handle":
        nid = self.b.g.add(OpKind.PADD, (self.nid,), limbs=self.limbs,
                           pt=pt_tag)
        return Handle(self.b, nid, self.limbs)

    def cadd(self, other: "Handle") -> "Handle":
        limbs = min(self.limbs, other.limbs)   # implicit level_down
        nid = self.b.g.add(OpKind.CADD, (self.nid, other.nid), limbs=limbs)
        return Handle(self.b, nid, limbs)

    def cmult(self, other: "Handle") -> "Handle":
        limbs = min(self.limbs, other.limbs)   # implicit level_down
        nid = self.b.g.add(OpKind.CMULT, (self.nid, other.nid),
                           limbs=limbs, dnum=self.b.dnum(limbs))
        return Handle(self.b, nid, limbs)

    def square(self) -> "Handle":
        return self.cmult(self)

    def rescale(self) -> "Handle":
        nid = self.b.g.add(OpKind.RESCALE, (self.nid,), limbs=self.limbs)
        return Handle(self.b, nid, self.limbs - 1)

    def output(self) -> int:
        return self.b.g.add(OpKind.OUTPUT, (self.nid,), limbs=self.limbs)


class ProgramBuilder:
    def __init__(self, N: int = 1 << 16, alpha: int = 12):
        self.g = DFG(N=N)
        self.alpha = alpha

    def dnum(self, limbs: int) -> int:
        return -(-limbs // self.alpha)

    def input(self, limbs: int, tag: str = "in") -> Handle:
        nid = self.g.add(OpKind.INPUT, (), limbs=limbs, tag=tag)
        return Handle(self, nid, limbs)

    def sum_tree(self, hs: list[Handle]) -> Handle:
        assert hs
        while len(hs) > 1:
            nxt = [hs[i].cadd(hs[i + 1]) for i in range(0, len(hs) - 1, 2)]
            if len(hs) % 2:
                nxt.append(hs[-1])
            hs = nxt
        return hs[0]
