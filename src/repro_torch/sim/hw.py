"""Hardware configurations (paper Table II/III).

Throughputs in words/ns (36-bit words, 4.5 B).  Power in W, area in mm^2.

A copy of the JAX package's ``sim/hw.py``.
"""
from __future__ import annotations

import dataclasses

WORD_BYTES = 4.5  # 36-bit datapath


@dataclasses.dataclass(frozen=True)
class HWConfig:
    name: str
    # xPU compute throughputs (words/ns)
    ntt_tput: float
    bconv_tput: float          # MACs/ns
    ewe_tput: float            # xPU element-wise ops
    # xMU (near-memory) — 0 disables the heterogeneous path
    xmu_tput: float = 0.0      # MACs/ns across all bank PEs
    # memory / link
    hbm_bw_tbs: float = 1.0    # off-chip / heterogeneous link, TB/s
    hbm_cap_gb: float = 8.0
    onchip_mb: float = 180.0
    # pipelining capabilities (Sec. V)
    dual_overlap: bool = False     # compute<->comm + inter-op overlap
    intt_resident: bool = False    # parallel BConv->NTT / NTT paths
    memop_fusion: bool = False     # xMU fused IP+PMul+Autom pass (Fig 10d)
    # energy/area (Table III)
    power_xpu_w: float = 100.0
    power_xmu_w: float = 0.0
    area_mm2: float = 200.0
    # pJ per byte moved across the heterogeneous link / off-chip
    link_pj_per_byte: float = 7.0

    @property
    def link_words_per_ns(self) -> float:
        return self.hbm_bw_tbs * 1e12 / WORD_BYTES / 1e9

    def evk_capacity_words(self, reserve_ct_gb: float = 1.0) -> float:
        """HBM words available for the evk working set."""
        return (self.hbm_cap_gb - reserve_ct_gb) * 1e9 / WORD_BYTES


# --- SHARP [25]: monolithic ASIC, EVF + Min-KS, big scratchpad ----------
SHARP = HWConfig(
    name="SHARP",
    ntt_tput=1024, bconv_tput=16384, ewe_tput=2048,
    xmu_tput=0.0, hbm_bw_tbs=1.0, onchip_mb=198.0,
    dual_overlap=False, intt_resident=False,
    power_xpu_w=94.0, power_xmu_w=0.0, area_mm2=179.0,
)

# --- SHARP-xMU: SHARP xPU + bank-level xMU, IRF dataflow ----------------
SHARP_XMU = HWConfig(
    name="SHARP-xMU",
    ntt_tput=1024, bconv_tput=16384, ewe_tput=2048,
    xmu_tput=5461, hbm_bw_tbs=1.0, onchip_mb=198.0,
    dual_overlap=False, intt_resident=False,
    power_xpu_w=94.0, power_xmu_w=11.8, area_mm2=179.0 + 12.2,
)

# --- HE2-SM: small scratchpad (44 MB), IRF only -------------------------
HE2_SM = HWConfig(
    name="HE2-SM",
    ntt_tput=768, bconv_tput=672 * 16, ewe_tput=512,
    xmu_tput=5461, hbm_bw_tbs=1.0, onchip_mb=44.0,
    dual_overlap=True, intt_resident=True, memop_fusion=True,
    power_xpu_w=74.5, power_xmu_w=23.6, area_mm2=71.9,
)

# --- HE2-LM: 84 MB scratchpad, hybrid IRF/EVF ----------------------------
HE2_LM = HWConfig(
    name="HE2-LM",
    ntt_tput=768, bconv_tput=672 * 16, ewe_tput=512,
    xmu_tput=5461, hbm_bw_tbs=1.0, onchip_mb=84.0,
    dual_overlap=True, intt_resident=True, memop_fusion=True,
    power_xpu_w=79.7, power_xmu_w=23.6, area_mm2=80.2,
)

CONFIGS = {c.name: c for c in (SHARP, SHARP_XMU, HE2_SM, HE2_LM)}


def with_bandwidth(cfg: HWConfig, tbs: float) -> HWConfig:
    return dataclasses.replace(cfg, name=f"{cfg.name}@{tbs}TB/s",
                               hbm_bw_tbs=tbs)


def with_capacity(cfg: HWConfig, gb: float) -> HWConfig:
    return dataclasses.replace(cfg, name=f"{cfg.name}@{gb}GB",
                               hbm_cap_gb=gb)
