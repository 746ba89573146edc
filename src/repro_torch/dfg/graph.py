"""Dataflow-graph IR for CKKS programs.

Nodes are polynomial-level operators (the paper's Table I granularity);
edges are ciphertext/plaintext dependencies.  Each node carries enough
static information (limb count, domain, ring degree) for exact
computation / memory / communication accounting.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict, deque
from typing import Iterable


class OpKind(enum.Enum):
    INPUT = "input"
    OUTPUT = "output"
    # --- ComOps (paper: xPU) ---
    NTT = "ntt"
    INTT = "intt"
    BCONV = "bconv"
    MODUP = "modup"
    MODDOWN = "moddown"
    # --- MemOps (paper: xMU) ---
    IP = "ip"              # inner product with evk digits
    PMUL = "pmul"          # plaintext mult
    CADD = "cadd"          # ct-ct add
    CSUB = "csub"          # ct-ct sub (cost-identical to CADD)
    CSCALE = "cscale"      # ct * small integer constant (scaled_double)
    PADD = "padd"
    RESCALE = "rescale"
    LEVEL_DOWN = "level_down"   # drop limbs without scale change
    MOD_RAISE = "mod_raise"     # bootstrap boundary: level 0 -> full chain
    AUTOM = "autom"        # automorphism (permutation)
    # --- composite ops (pre-lowering) ---
    ROT = "rot"            # rotation keyswitch (expands to autom+ks chain)
    CMULT = "cmult"        # ct-ct mult + relinearize keyswitch
    CONJ = "conj"


# ComOp/MemOp classification (paper Table I).
COM_OPS = {OpKind.NTT, OpKind.INTT, OpKind.BCONV, OpKind.MODUP,
           OpKind.MODDOWN}
MEM_OPS = {OpKind.IP, OpKind.PMUL, OpKind.CADD, OpKind.CSUB,
           OpKind.CSCALE, OpKind.PADD, OpKind.RESCALE, OpKind.AUTOM}
# EWOs commute with ModUp/ModDown (paper Sec. II-B2) — the expansion set.
COMMUTATIVE_OPS = {OpKind.PMUL, OpKind.CADD, OpKind.CSUB, OpKind.CSCALE,
                   OpKind.PADD, OpKind.AUTOM}
KEYSWITCH_OPS = {OpKind.ROT, OpKind.CMULT, OpKind.CONJ}


@dataclasses.dataclass
class Node:
    id: int
    op: OpKind
    args: tuple[int, ...] = ()
    # static cost attributes
    limbs: int = 1            # active Q limbs (level+1)
    ext_limbs: int = 0        # extended-basis limbs if in PQ domain (else 0)
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def domain_limbs(self) -> int:
        return self.ext_limbs if self.ext_limbs else self.limbs

    @property
    def steps(self) -> int:
        return self.attrs.get("steps", 0)


class DFG:
    def __init__(self, N: int = 1 << 16):
        self.N = N
        self.nodes: dict[int, Node] = {}
        self._next = 0
        self._succs: dict[int, set[int]] = defaultdict(set)

    # ------------------------- construction ---------------------------
    def add(self, op: OpKind, args: Iterable[int] = (), limbs: int = 1,
            ext_limbs: int = 0, **attrs) -> int:
        nid = self._next
        self._next += 1
        args = tuple(args)
        self.nodes[nid] = Node(nid, op, args, limbs, ext_limbs, dict(attrs))
        for a in args:
            self._succs[a].add(nid)
        return nid

    def replace_args(self, nid: int, new_args: tuple[int, ...]):
        node = self.nodes[nid]
        for a in node.args:
            self._succs[a].discard(nid)
        node.args = new_args
        for a in new_args:
            self._succs[a].add(nid)

    # --------------------------- queries -------------------------------
    def succs(self, nid: int) -> set[int]:
        return self._succs[nid]

    def preds(self, nid: int) -> tuple[int, ...]:
        return self.nodes[nid].args

    def topo_order(self) -> list[int]:
        # unique preds: duplicate args (e.g. square = cmult(x, x)) must
        # count once, matching the _succs set representation
        indeg = {i: len(set(n.args)) for i, n in self.nodes.items()}
        q = deque([i for i, d in indeg.items() if d == 0])
        out = []
        while q:
            i = q.popleft()
            out.append(i)
            for s in self._succs[i]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    q.append(s)
        assert len(out) == len(self.nodes), "cycle in DFG"
        return out

    def keyswitch_nodes(self) -> list[int]:
        return [i for i, n in self.nodes.items() if n.op in KEYSWITCH_OPS]

    def count(self, op: OpKind) -> int:
        return sum(1 for n in self.nodes.values() if n.op == op)

    # ------------------------ cost accounting --------------------------
    def op_word_volume(self, nid: int) -> int:
        """Words touched by this op (drives MemOp byte counts & AI)."""
        n = self.nodes[nid]
        l = n.domain_limbs
        if n.op in (OpKind.NTT, OpKind.INTT):
            return l * self.N
        if n.op == OpKind.BCONV:
            return (n.attrs.get("src_limbs", l) + l) * self.N
        if n.op == OpKind.IP:
            dnum = n.attrs.get("dnum", 1)
            return dnum * 3 * l * self.N  # digits + 2 evk components
        return len(n.args) * l * self.N + l * self.N

    def summary(self) -> dict[str, int]:
        out: dict[str, int] = defaultdict(int)
        for n in self.nodes.values():
            out[n.op.value] += 1
        return dict(out)
