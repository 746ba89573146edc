"""PKB fusion (paper Sec. IV-B): inverse-BSGS merging of serial PKBs.

Two serial PKBs (n1 then n2 rotations, EWOs between) fuse into one PKB
whose rotations are the pairwise step sums (Eq. (4)); EWOs are pushed
behind the rotations via Rot(PMul(ct, pt)) = PMul(Rot(ct), Autom(pt)).
Hoisting the fused PKB removes outdeg1 ModDowns + indeg2 ModUps (and
their heterogeneous transfers), at the cost of O(n1*n2) IPs and a larger
evk working set.

A FuseScore-driven interval DP (Eq. (5)) picks the globally optimal
partition of each PKB chain under the evk storage capacity constraint.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.dfg.hoist import OpVolumes, pkb_volumes
from repro_torch.dfg.pkb import PKB


@dataclasses.dataclass
class CostWeights:
    """Seconds per unit — converts OpVolumes to time (defaults: HE2 xPU
    at 768 w/ns NTT, 672-unit BConvU, xMU EWEU 5461 w/ns, 1 TB/s link,
    8-byte words)."""

    ntt: float = 1e-9 / 768
    bconv: float = 1e-9 / 672 / 16
    ip: float = 1e-9 / 5461
    ewo: float = 1e-9 / 5461
    # in-DRAM hierarchical automorphism: near-bank aggregate (~xMU EWEU
    # scale), not the 2048-coeff/cycle single row buffer
    autom: float = 1e-9 / 4000
    comm: float = 8.0 / 1e12          # s per word over the xPU-xMU link
    evk_load: float = 8.0 / 1e12

    def seconds(self, v: OpVolumes) -> float:
        return (v.ntt_words * self.ntt + v.bconv_macs * self.bconv
                + v.ip_macs * self.ip
                + (v.ewo_words + v.ewo_ext_words) * self.ewo
                + v.autom_words * self.autom
                + v.comm_words * self.comm
                + v.evk_load_words * self.evk_load)

    def block_seconds(self, v: OpVolumes) -> float:
        """Latency of one keyswitch block under these weights.

        The default is the linear volume model; hardware-aware weights
        (sim.engine._pipeline_weights) override this with the scheduled
        group-pipeline makespan so the fusion DP optimizes exactly what
        the simulator measures."""
        return self.seconds(v)


class FusedPKB(PKB):
    """PKB-shaped view of a fused group (no graph mutation needed for
    costing; the functional path uses fuse_functional below)."""

    def __init__(self, members: list[PKB], steps: list[int],
                 n_ip: int, region: set[int]):
        first, last = members[0], members[-1]
        rotations = [r for m in members for r in m.rotations]
        super().__init__(first.dfg, first.layer, rotations,
                         set(first.in_anchors), set(last.out_sinks), region)
        self._steps = steps
        self._n_ip = n_ip
        self.members = members

    @property
    def n_rot(self) -> int:          # IPs after fusion
        return self._n_ip

    @property
    def steps(self) -> list[int]:
        return self._steps

    @property
    def limbs(self) -> int:
        return max(m.limbs for m in self.members)


def fuse_pair(p1: PKB, p2: PKB, nh: int) -> FusedPKB:
    """Pairwise-sum the rotation steps (Eq. (4)).

    Paths landing on the SAME fused step merge their plaintext chains
    (PMul/CAdd distribute over rotation), so the IP/evk count is the
    number of DISTINCT sums — the paper's "non-duplicated subset among
    n1*n2 keys".  Arithmetic-progression PKBs (plaintext-matrix x ct,
    ConvBN) overlap heavily, which is where fusion shines.
    """
    s1 = p1.steps
    s2 = p2.steps
    fused_steps = sorted({(a + b) % nh for a in s1 for b in s2})
    n_ip = len(fused_steps)
    region = set(p1.region) | set(p2.region)
    members = (p1.members if isinstance(p1, FusedPKB) else [p1]) + [p2]
    return FusedPKB(members, fused_steps, n_ip, region)


def fuse_group(pkbs: list[PKB], nh: int) -> PKB:
    if len(pkbs) == 1:
        return pkbs[0]
    acc = pkbs[0]
    for p in pkbs[1:]:
        acc = fuse_pair(acc, p, nh)
    return acc


def fusable(p1: PKB, p2: PKB) -> bool:
    """p2 must directly consume p1's outputs (serial adjacency).

    Adjacent layers are fusable; if the anchor/sink sets are resolvable we
    additionally require an actual data dependency.
    """
    if p2.layer != p1.layer + 1:
        return False
    from repro_torch.dfg.pkb import deep_anchors

    reachable = set(p1.out_sinks) | set(p1.rotations) | set(p1.region)
    anchors = set()
    for r in p2.rotations:
        anchors |= deep_anchors(p1.dfg, r)
    return bool(anchors & reachable)


@dataclasses.dataclass
class FusionPlan:
    groups: list[list[int]]          # indices into the pkb list
    score: float                     # seconds saved vs unfused hoisting
    fused: list[PKB]


def fuse_score(group: list[PKB], k: int, alpha: int, nh: int,
               weights: CostWeights, capacity_words: float,
               dataflow: str = "IRF") -> tuple[float, PKB] | None:
    """Savings (s) of fusing `group` vs hoisting each member separately.
    None if the fused evk set exceeds capacity (paper: invalid)."""
    fused = fuse_group(group, nh)
    v_f = pkb_volumes(fused, k, alpha, "hoist", dataflow, nh)
    if v_f.evk_set_words > capacity_words:
        return None
    saved = -weights.block_seconds(v_f)
    for p in group:
        saved += weights.block_seconds(
            pkb_volumes(p, k, alpha, "hoist", dataflow, nh))
    return saved, fused


def optimal_fusion(pkbs: list[PKB], k: int, alpha: int, nh: int,
                   capacity_words: float,
                   weights: CostWeights | None = None,
                   dataflow: str = "IRF",
                   max_group: int = 4) -> FusionPlan:
    """Interval DP (Eq. (5)) over a layer-ordered PKB chain.

    DP[i][j] = best cumulative savings covering PKBs i..j, choosing
    between fusing the whole interval or splitting.  Non-adjacent-layer
    intervals can only split.
    """
    weights = weights or CostWeights()
    pkbs = sorted(pkbs, key=lambda p: p.layer)
    n = len(pkbs)
    if n == 0:
        return FusionPlan([], 0.0, [])

    score = [[0.0] * n for _ in range(n)]
    choice: list[list[list[list[int]]]] = [
        [[[i]] for i in range(n)] for _ in range(n)
    ]
    for i in range(n):
        choice[i][i] = [[i]]

    for length in range(2, n + 1):
        for i in range(0, n - length + 1):
            j = i + length - 1
            best, best_groups = -np.inf, None
            # option 1: fuse whole interval (if chain-adjacent & small)
            if length <= max_group and all(
                pkbs[t + 1].layer == pkbs[t].layer + 1 and
                fusable(pkbs[t], pkbs[t + 1])
                for t in range(i, j)
            ):
                res = fuse_score(pkbs[i : j + 1], k, alpha, nh, weights,
                                 capacity_words, dataflow)
                if res is not None and res[0] > best:
                    best, best_groups = res[0], [list(range(i, j + 1))]
            # option 2: split
            for m in range(i, j):
                s = score[i][m] + score[m + 1][j]
                if s > best:
                    best = s
                    best_groups = choice[i][m] + choice[m + 1][j]
            score[i][j] = best
            choice[i][j] = best_groups
    groups = choice[0][n - 1]
    fused = [fuse_group([pkbs[t] for t in g], nh) for g in groups]
    return FusionPlan(groups, score[0][n - 1], fused)


# ----------------------- functional fusion (Eq. 4) -----------------------

def fuse_functional(steps1, pts1, steps2, pts2, nh: int):
    """Fused (steps, plaintext) list: y = sum_i pt2_i*Rot_{s2_i}(
    sum_j pt1_j*Rot_{s1_j}(x)) == sum_{ij} [pt2_i * roll(pt1_j, -s2_i)]
    * Rot_{s1_j + s2_i}(x).  Verified homomorphically in tests."""
    out_steps, out_pts = [], []
    for s2, p2 in zip(steps2, pts2):
        for s1, p1 in zip(steps1, pts1):
            out_steps.append((s1 + s2) % nh)
            out_pts.append(np.asarray(p2) * np.roll(np.asarray(p1), -s2))
    return out_steps, out_pts
