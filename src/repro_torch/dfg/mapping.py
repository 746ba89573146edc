"""Dataflow mapping (paper Sec. IV-D): IRF / EVF / hybrid per PKB.

IRF ships keyswitch intermediates to the xMU (no evk on xPU); EVF
preloads one evk on the xPU.  The hybrid scheme picks per PKB: IRF when
IP parallelism > 1 (intermediate reuse amortizes the transfers), EVF for
single-keyswitch PKBs (one evk load is cheaper than two intermediate
transfers).  HE2-SM's 44 MB scratchpad cannot hold an evk, so it is
IRF-only; HE2-LM (84 MB) runs hybrid.

A copy of the JAX package's ``dfg/mapping.py``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.dfg.fusion import CostWeights
from repro_torch.dfg.hoist import OpVolumes, pkb_volumes
from repro_torch.dfg.pkb import PKB


@dataclasses.dataclass
class MappedBlock:
    pkb: PKB
    strategy: str       # 'minks' | 'plain' | 'hoist'
    dataflow: str       # 'IRF' | 'EVF'
    volumes: OpVolumes  # carries the ModUp/ModDown phase split the
    #                     group scheduler stripes across pipeline_groups


def map_program(pkbs: list[PKB], k: int, alpha: int, nh: int,
                mode: str = "hybrid", strategy: str = "hoist",
                weights: CostWeights | None = None) -> list[MappedBlock]:
    """mode: 'IRF' | 'EVF' | 'hybrid'."""
    weights = weights or CostWeights()
    out = []
    for p in pkbs:
        if mode in ("IRF", "EVF"):
            df = mode
        else:
            if p.n_rot > 1:
                df = "IRF"
            else:
                v_irf = pkb_volumes(p, k, alpha, strategy, "IRF", nh)
                v_evf = pkb_volumes(p, k, alpha, strategy, "EVF", nh)
                df = ("IRF" if weights.block_seconds(v_irf)
                      <= weights.block_seconds(v_evf) else "EVF")
        out.append(
            MappedBlock(p, strategy, df,
                        pkb_volumes(p, k, alpha, strategy, df, nh))
        )
    return out
