"""Block-level pipelined performance model.

Per keyswitch block (a hoisted PKB or a standalone CMULT/CONJ):

  t_xpu   — INTT/BConv/NTT (+ base-domain EWOs; on monolithic designs all
            MemOps run here too, out of the scratchpad)
  t_xmu   — IP MACs + ext-domain EWOs + automorphism on bank PEs
  t_comm  — heterogeneous transfers over the xPU<->HBM interface (IRF)
  t_evk   — off-chip evk fetch (EVF); distinct keys are cached in the
            scratchpad when they fit (Min-KS reuse; HE2-LM's one-evk
            buffer), so traffic is counted once per distinct key

Two latency models share the per-block engine times:

  * mode="pipelined" (default) — the event-driven group scheduler
    (sim.schedule): blocks expand into 2*dnum group task chains placed
    on explicit engine timelines, with cross-block streaming overlap on
    dual-overlap designs and exact fill/drain.  Stalls are measured
    from timeline gaps and per-engine occupancy traces are attached to
    the result.
  * mode="analytic" — the closed-form combiner (Fig. 11): per block
    max(engines) + fill/(2*dnum), blocks summed serially.  Kept for
    regression comparison against the scheduler.

A copy of the JAX package's ``sim/engine.py``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.dfg.fusion import CostWeights, optimal_fusion
from repro_torch.dfg.hoist import OpVolumes, non_pkb_blocks
from repro_torch.dfg.mapping import map_program
from repro_torch.dfg.pkb import PKB, identify_pkbs
from repro_torch.sim.hw import HWConfig, WORD_BYTES
from repro_torch.sim.schedule import (
    ENGINES, pipeline_groups, schedule_blocks, scheduled_block_time,
)


@dataclasses.dataclass
class SimResult:
    name: str
    latency_s: float = 0.0
    xpu_busy_s: float = 0.0
    xmu_busy_s: float = 0.0
    comm_busy_s: float = 0.0
    comm_stall_s: float = 0.0
    mem_stall_s: float = 0.0
    energy_j: float = 0.0
    volumes: OpVolumes = dataclasses.field(default_factory=OpVolumes)
    mode: str = "analytic"
    # mode="pipelined" extras: per-engine occupancy traces
    # {engine: [(start_s, end_s, label), ...]} and busy seconds
    timelines: dict = dataclasses.field(default_factory=dict, repr=False)
    engine_busy_s: dict = dataclasses.field(default_factory=dict)
    # pipelined extra: Schedule.energy_breakdown(hw) — per-engine joules
    # (obs.registry.publish_energy mirrors this into the metrics registry)
    energy_by_engine: dict = dataclasses.field(default_factory=dict)

    @property
    def edp(self) -> float:           # J*ms
        return self.energy_j * self.latency_s * 1e3

    def edap(self, area_mm2: float) -> float:
        return self.edp * area_mm2

    @property
    def comm_stall_frac(self) -> float:
        return self.comm_stall_s / self.latency_s if self.latency_s else 0.0

    @property
    def xpu_util(self) -> float:
        return self.xpu_busy_s / self.latency_s if self.latency_s else 0.0

    @property
    def xmu_util(self) -> float:
        return self.xmu_busy_s / self.latency_s if self.latency_s else 0.0

    def engine_util(self, engine: str) -> float:
        if not self.latency_s:
            return 0.0
        return self.engine_busy_s.get(engine, 0.0) / self.latency_s


def _block_engine_times(v: OpVolumes, hw: HWConfig, dnum: int,
                        evk_words_due: float) -> dict:
    ns = 1e-9
    t_ntt = v.ntt_words / hw.ntt_tput * ns
    t_bconv = v.bconv_macs / hw.bconv_tput * ns
    if hw.intt_resident:
        # BConv->NTT || NTT parallel paths: overlap NTT legs with BConv
        t_xpu_core = max(t_ntt, t_bconv) + 0.15 * min(t_ntt, t_bconv)
    elif hw.dual_overlap:
        t_xpu_core = max(t_ntt, t_bconv) + 0.3 * min(t_ntt, t_bconv)
    else:
        t_xpu_core = t_ntt + t_bconv

    if hw.memop_fusion:
        # fused IP+PMul+Autom xMU pass: permutation folds into addressing
        mem_words = v.ip_macs + v.ewo_ext_words + v.ewo_words
    else:
        mem_words = (v.ip_macs + v.ewo_ext_words + v.autom_words
                     + v.ewo_words)
    if hw.xmu_tput > 0:
        t_xpu = t_xpu_core + v.xpu_ewo_words / hw.ewe_tput * ns
        t_xmu = mem_words / hw.xmu_tput * ns
    else:
        # monolithic: MemOps on the xPU EWEU out of the scratchpad
        t_xpu = t_xpu_core + (v.xpu_ewo_words + mem_words) \
            / hw.ewe_tput * ns
        t_xmu = 0.0

    t_comm = v.comm_words * WORD_BYTES / (hw.hbm_bw_tbs * 1e12)
    t_evk = evk_words_due * WORD_BYTES / (hw.hbm_bw_tbs * 1e12)
    return {"xpu": t_xpu, "xmu": t_xmu, "comm": t_comm, "evk": t_evk,
            "dnum": dnum}


def _combine(times: dict, hw: HWConfig) -> tuple[float, float, float]:
    """-> (latency, comm_stall, mem_stall) for one block (analytic)."""
    t_xpu, t_xmu, t_comm, t_evk = (times["xpu"], times["xmu"],
                                   times["comm"], times["evk"])
    if hw.xmu_tput == 0:
        compute = t_xpu + t_xmu
        lat = max(compute, t_evk)
        return lat, 0.0, lat - compute
    if hw.dual_overlap:
        g = pipeline_groups(times["dnum"])
        parts = [t_xpu, t_xmu, t_comm, t_evk]
        bound = max(parts)
        fill = (sum(parts) - bound) / g
        lat = bound + fill
        no_comm = max(t_xpu, t_xmu, t_evk)
        no_comm += (t_xpu + t_xmu + t_evk - no_comm) / g
        no_evk = max(t_xpu, t_xmu, t_comm)
        no_evk += (t_xpu + t_xmu + t_comm - no_evk) / g
        return lat, max(0.0, lat - no_comm), max(0.0, lat - no_evk)
    # naive heterogeneous: serialized critical path (Fig. 11(b))
    lat = t_xpu + t_comm + t_xmu + t_evk
    return lat, t_comm, t_evk


@dataclasses.dataclass
class Block:
    volumes: OpVolumes
    dnum: int
    evk_keys: tuple = ()        # (key-id, words) pairs this block touches
    streams_evk: bool = False   # EVF: traffic due on first touch


def block_time(v: OpVolumes, dnum: int, hw: HWConfig,
               evk_words_due: float = 0.0,
               mode: str = "analytic") -> float:
    times = _block_engine_times(v, hw, dnum, evk_words_due)
    if mode == "pipelined":
        return scheduled_block_time(times, v, hw)
    return _combine(times, hw)[0]


def _evk_due(b: Block, cached: set, cache_words: float) -> float:
    due = 0.0
    if b.streams_evk:
        for key, words in b.evk_keys:
            if key in cached and words <= cache_words:
                continue
            due += words
            if words <= cache_words:
                cached.add(key)
    return due


def simulate_blocks(blocks: list[Block], hw: HWConfig, name: str,
                    mode: str = "pipelined") -> SimResult:
    if mode not in ("pipelined", "analytic"):
        raise ValueError(f"mode must be 'pipelined' or 'analytic', got "
                         f"{mode!r}")
    res = SimResult(name=name, mode=mode)
    cached: set = set()
    cache_words = hw.onchip_mb * 1e6 / WORD_BYTES
    block_times = []
    for b in blocks:
        due = _evk_due(b, cached, cache_words)
        t = _block_engine_times(b.volumes, hw, b.dnum, due)
        block_times.append((t, b.volumes))
        res.xpu_busy_s += t["xpu"]
        res.xmu_busy_s += t["xmu"]
        res.comm_busy_s += t["comm"]
        res.volumes = res.volumes + b.volumes
        if mode == "analytic":
            lat, cstall, mstall = _combine(t, hw)
            res.latency_s += lat
            res.comm_stall_s += cstall
            res.mem_stall_s += mstall
    if mode == "pipelined":
        sched = schedule_blocks(block_times, hw)
        res.latency_s = sched.makespan
        res.comm_stall_s = sched.comm_stall_s
        res.mem_stall_s = sched.mem_stall_s
        res.timelines = sched.timelines()
        res.engine_busy_s = {e: sched.busy(e) for e in ENGINES}
        # energy integrated over the placed per-engine busy intervals
        res.energy_by_engine = sched.energy_breakdown(hw)
        res.energy_j = sum(res.energy_by_engine.values())
        return res
    link_bytes = (res.volumes.comm_words + res.volumes.evk_load_words) \
        * WORD_BYTES
    # analytic mode: busy-time dynamic power + 10% static floor
    res.energy_j = (
        hw.power_xpu_w * (res.xpu_busy_s + 0.10 * res.latency_s)
        + hw.power_xmu_w * (res.xmu_busy_s + 0.10 * res.latency_s)
        + link_bytes * hw.link_pj_per_byte * 1e-12
    )
    return res


def _evk_keys_for(pkb: PKB, strategy: str, k: int, alpha: int, nh: int):
    """Distinct evk identities a block touches (for the EVF cache)."""
    from repro_torch.dfg.hoist import evk_words

    l = pkb.limbs
    w = evk_words(l, k, alpha, pkb.dfg.N)
    if strategy == "minks":
        bits = set()
        for s in pkb.steps:
            s = s % nh
            bits |= {i for i in range(max(s.bit_length(), 1)) if s >> i & 1}
        return tuple((("rot2", b, l), w) for b in (bits or {0}))
    return tuple((("rot", s, l), w) for s in set(pkb.steps))


def simulate_program(dfg, hw: HWConfig, strategy: str = "hoist",
                     dataflow: str = "hybrid", fusion: bool = False,
                     nh: int = 1 << 15, k: int = 12, alpha: int = 12,
                     name: str | None = None,
                     mode: str = "pipelined") -> SimResult:
    """strategy: 'minks' | 'plain' | 'hoist'; dataflow 'IRF'|'EVF'|'hybrid'.
    fusion=True applies the HERO DP (scored with THIS hw's pipeline model)
    before mapping.  mode: 'pipelined' (event-driven group scheduler) or
    'analytic' (closed-form per-block combiner, serial block sum)."""
    pkbs = identify_pkbs(dfg)
    weights = _pipeline_weights(hw, mode)
    if fusion:
        plan = optimal_fusion(
            pkbs, k, alpha, nh, capacity_words=hw.evk_capacity_words(),
            weights=weights, dataflow="IRF",
        )
        pkbs = plan.fused
    df_mode = dataflow
    if dataflow == "hybrid" and hw.onchip_mb < 60:
        df_mode = "IRF"      # SM cannot buffer an evk on-chip
    mapped = map_program(pkbs, k, alpha, nh, mode=df_mode,
                         strategy=strategy, weights=weights)
    blocks = []
    for m in mapped:
        streams = m.dataflow == "EVF"
        blocks.append(Block(
            m.volumes, m.pkb.dnum,
            _evk_keys_for(m.pkb, strategy, k, alpha, nh) if streams else (),
            streams,
        ))
    extra, residual = non_pkb_blocks(
        dfg, pkbs, k, alpha,
        dataflow=("IRF" if df_mode == "IRF" else "EVF"),
    )
    for v in extra:
        # relin/conj keys are shared program-wide; identity by size
        key = (("relin", v.evk_set_words), v.evk_set_words)
        # relin/conj blocks stream the 2*dnum group pipeline like every
        # other keyswitch; the real dnum is the ModUp leg count (one leg
        # per decomposition digit), so their xPU up-phase slices carry
        # per-digit weights instead of one undifferentiated volume lump
        dnum = len(v.modup_legs) if v.modup_legs else v.ip_count
        blocks.append(Block(v, max(1, dnum), (key,),
                            df_mode != "IRF"))
    blocks.append(Block(residual, 1))
    return simulate_blocks(
        blocks, hw,
        name or f"{hw.name}/{strategy}/{dataflow}"
        + ("/fused" if fusion else ""),
        mode=mode,
    )


def _pipeline_weights(hw: HWConfig, mode: str = "pipelined") -> CostWeights:
    """CostWeights whose block cost delegates to the hw pipeline model —
    so the fusion DP and the hybrid dataflow choice optimize what the
    simulator measures (the scheduled group-pipeline makespan under
    mode='pipelined', the closed-form block time under 'analytic')."""

    class _W(CostWeights):
        def block_seconds(self, v: OpVolumes) -> float:  # noqa: D102
            dnum = max(1, round(v.modup_count or 1))
            return block_time(v, dnum, hw,
                              v.evk_load_words and v.evk_set_words or 0.0,
                              mode=mode)

        def seconds(self, v: OpVolumes) -> float:  # type: ignore[override]
            return self.block_seconds(v)

    return _W()
