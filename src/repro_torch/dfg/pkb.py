"""PKB identification and degree-minimized expansion (paper Sec. IV-A).

* identifying: keyswitches are layered by their order along each path
  from the inputs; same-layer rotations connected through commutative
  regions form one PKB.
* expanding: each PKB is greedily expanded with modulus-commutative EWOs
  (PMul/CAdd/PAdd/Autom) so its in-degree (distinct ModUp anchors) and
  out-degree (distinct ModDown sinks) are minimized — these degrees are
  exactly the hoisted ModUp/ModDown counts.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from repro_torch.dfg.graph import COMMUTATIVE_OPS, DFG, KEYSWITCH_OPS, OpKind

# rescale is not modulus-commutative, but for PKB connectivity it is a
# pass-through EWO (it neither needs a ModUp nor blocks fusion adjacency)
TRAVERSE_OPS = COMMUTATIVE_OPS | {OpKind.RESCALE}


@dataclasses.dataclass
class PKB:
    dfg: DFG
    layer: int
    rotations: list[int]
    in_anchors: set[int] = dataclasses.field(default_factory=set)
    out_sinks: set[int] = dataclasses.field(default_factory=set)
    region: set[int] = dataclasses.field(default_factory=set)

    @property
    def n_rot(self) -> int:
        return len(self.rotations)

    @property
    def indeg(self) -> int:
        return max(1, len(self.in_anchors))

    @property
    def outdeg(self) -> int:
        return max(1, len(self.out_sinks))

    @property
    def steps(self) -> list[int]:
        return [self.dfg.nodes[r].attrs.get("steps", 0)
                for r in self.rotations]

    @property
    def limbs(self) -> int:
        return max(self.dfg.nodes[r].limbs for r in self.rotations)

    @property
    def dnum(self) -> int:
        return max(self.dfg.nodes[r].attrs.get("dnum", 1)
                   for r in self.rotations)


def keyswitch_layers(dfg: DFG) -> dict[int, int]:
    """layer[n] = number of keyswitches on the longest path before n."""
    depth: dict[int, int] = {}
    for nid in dfg.topo_order():
        node = dfg.nodes[nid]
        d = 0
        for p in node.args:
            inc = 1 if dfg.nodes[p].op in KEYSWITCH_OPS else 0
            d = max(d, depth[p] + inc)
        depth[nid] = d
    return depth


def _back_anchors(dfg: DFG, start: int, ops=COMMUTATIVE_OPS) -> set[int]:
    """Walk backward through `ops` to the ModUp anchor set.

    Degree computation uses COMMUTATIVE_OPS (rescale is a ModDown-side
    boundary); fusion adjacency uses TRAVERSE_OPS (rescale connects)."""
    anchors: set[int] = set()
    stack = [start]
    seen = set()
    while stack:
        nid = stack.pop()
        if nid in seen:
            continue
        seen.add(nid)
        node = dfg.nodes[nid]
        if node.op in ops:
            stack.extend(node.args)
        else:
            anchors.add(nid)
    return anchors


def deep_anchors(dfg: DFG, rot: int) -> set[int]:
    """Anchor set looking through rescale — used for fusion adjacency."""
    return _back_anchors(dfg, dfg.nodes[rot].args[0], TRAVERSE_OPS)


def _forward_region(dfg: DFG, rot: int,
                    ops=COMMUTATIVE_OPS) -> tuple[set[int], set[int]]:
    """Walk forward through `ops`; return (region, sinks)."""
    region: set[int] = set()
    sinks: set[int] = set()
    stack = [rot]
    seen = set()
    while stack:
        nid = stack.pop()
        if nid in seen:
            continue
        seen.add(nid)
        nexts = dfg.succs(nid)
        comm_next = [s for s in nexts if dfg.nodes[s].op in ops]
        if nid != rot and dfg.nodes[nid].op in ops:
            region.add(nid)
        if len(comm_next) < len(nexts) or not nexts:
            sinks.add(nid)          # some consumer needs base domain here
        stack.extend(comm_next)
    return region, sinks


def identify_pkbs(dfg: DFG, rotations_only: bool = True) -> list[PKB]:
    """Layer keyswitches, group connected same-layer ones into PKBs, and
    expand each for minimal degree."""
    layers = keyswitch_layers(dfg)
    ks_kinds = (
        {OpKind.ROT} if rotations_only else KEYSWITCH_OPS
    )
    by_layer: dict[int, list[int]] = defaultdict(list)
    for nid, node in dfg.nodes.items():
        if node.op in ks_kinds:
            by_layer[layers[nid]].append(nid)

    pkbs: list[PKB] = []
    for layer in sorted(by_layer):
        rots = by_layer[layer]
        anchors = {r: _back_anchors(dfg, dfg.nodes[r].args[0]) for r in rots}
        fwd = {r: _forward_region(dfg, r) for r in rots}
        # union-find: same PKB if anchor sets intersect or sinks intersect
        parent = {r: r for r in rots}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a, b):
            parent[find(a)] = find(b)

        for i, r1 in enumerate(rots):
            for r2 in rots[i + 1 :]:
                if anchors[r1] & anchors[r2] or fwd[r1][1] & fwd[r2][1]:
                    union(r1, r2)
        groups: dict[int, list[int]] = defaultdict(list)
        for r in rots:
            groups[find(r)].append(r)
        for members in groups.values():
            p = PKB(dfg, layer, sorted(members))
            for r in members:
                p.in_anchors |= anchors[r]
                reg, snk = fwd[r]
                p.region |= reg
                p.out_sinks |= snk
            pkbs.append(p)
    return pkbs


def pkb_parallelism_histogram(dfg: DFG) -> list[int]:
    """Per-PKB keyswitch parallelism (Fig. 6 of the paper)."""
    return sorted((p.n_rot for p in identify_pkbs(dfg)), reverse=True)
