"""Heterogeneous CKKS accelerator performance model (paper Secs. V-VII).

Event-driven group-level pipeline simulator over HERO-mapped DFGs
(sim.schedule), with the closed-form analytic combiner retained as
mode="analytic" for regression comparison.  Reproduces the paper's
evaluation: Table IV end-to-end latency/EDP/EDAP, Fig. 14 ablation,
Fig. 15 HERO reductions, Fig. 16 utilization, Fig. 17 bandwidth/
capacity sensitivity.

A copy of the JAX package's ``sim/`` (numpy and the standard library
only).  Every latency, stall and utilisation it returns describes the
modelled accelerators (SHARP, SHARP-xMU, HE2-SM, HE2-LM), never the GPU
that runs the port's kernels.
"""
from repro_torch.sim.hw import HWConfig, SHARP, SHARP_XMU, HE2_SM, HE2_LM  # noqa: F401
from repro_torch.sim.engine import simulate_program, SimResult  # noqa: F401
from repro_torch.sim.schedule import ENGINES, Schedule, Task, run_schedule  # noqa: F401
