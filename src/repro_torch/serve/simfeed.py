"""Replay served traffic onto the HE^2 hardware timelines.

The serving loop logs every executed batch as a ``BatchRecord``; this
module feeds the SAME traffic — same programs, same batch widths, same
launch order — into the event-driven group scheduler
(``repro_torch.sim.schedule`` via ``sim.engine.simulate_blocks``), answering
"what would the paper's xPU/xMU hardware do with this arrival trace"
next to what the port's engine actually did.  This closes the
long-standing "interleave multi-ciphertext batches on engine timelines"
follow-on: consecutive batches' keyswitch blocks stream back-to-back
through the 2*dnum pipeline groups, so cross-BATCH overlap is modeled
exactly like cross-block overlap inside one program.

Three numbers come back:

* ``pipelined_s``   — makespan of the full packed traffic on the HE^2
  timelines (cross-batch group streaming, the hardware analogue of
  continuous batching);
* ``serial_s``      — the same requests one at a time (batch width 1,
  a hard barrier between requests): the hardware analogue of the
  serial request loop;
* ``speedup``       — serial_s / pipelined_s, the scheduler-side
  counterpart of the measured throughput gate.

Per-engine utilization of the pipelined run is attached so the bench
can report how busy the modeled xPU/xMU/link/evk stream would be under
this traffic.

A copy of the JAX package's ``serve/simfeed.py`` on the port's
``program_blocks`` and ``sim``: its latencies are the modelled
accelerators', never the card's.
"""
from __future__ import annotations

from repro_torch.runtime.compile import CompiledProgram
from repro_torch.runtime.report import program_blocks
from repro_torch.sim.engine import simulate_blocks
from repro_torch.sim.hw import HWConfig
from repro_torch.sim.schedule import ENGINES


def replay_on_hardware(records, programs: dict[str, CompiledProgram],
                       hw: HWConfig, with_result: bool = False):
    """Simulate a serving run's batch log on the HE^2 hardware model.

    ``records``: the server's ``BatchRecord`` list (launch order);
    ``programs``: program_id -> compiled program (the server's table).
    ``with_result=True`` returns ``(summary, SimResult)`` so callers can
    reach the pipelined run's engine timelines — the stall-budget gate
    and the Perfetto exporter (``repro_torch.obs``) both consume them.
    """
    ordered = sorted(records, key=lambda r: r.start_s)
    packed = []
    n_requests = 0
    wasted = 0          # dispatches that errored (chaos runs): the
    for rec in ordered:  # hardware still burned their blocks' time, but
        # the requests only count toward goodput on their ok dispatch
        # scale by the requests actually served, not the padded jit
        # width: hardware packs per ciphertext and has no retrace-shape
        # constraint, so padding is an engine artifact the model skips
        packed.extend(program_blocks(programs[rec.program_id],
                                     rec.n_real))
        if getattr(rec, "ok", True):
            n_requests += rec.n_real
        else:
            wasted += 1
    pipe = simulate_blocks(packed, hw, name="serving", mode="pipelined")

    # hardware analogue of the serial loop: every real request alone,
    # a hard barrier between requests (no cross-request streaming)
    serial_s = 0.0
    for rec in ordered:
        blocks = program_blocks(programs[rec.program_id], 1)
        one = simulate_blocks(blocks, hw, name="serving-serial",
                              mode="pipelined")
        serial_s += one.latency_s * rec.n_real
    summary = {
        "hw": hw.name,
        "batches": len(ordered),
        "requests": n_requests,
        "wasted_dispatches": wasted,
        "pipelined_s": pipe.latency_s,
        "serial_s": serial_s,
        "speedup": (serial_s / pipe.latency_s) if pipe.latency_s else 0.0,
        "throughput_ops": (n_requests / pipe.latency_s
                           if pipe.latency_s else 0.0),
        "utilization": {e: pipe.engine_util(e) for e in ENGINES},
        "energy_j": pipe.energy_j,
        "comm_stall_s": pipe.comm_stall_s,
        "comm_stall_frac": pipe.comm_stall_frac,
    }
    if with_result:
        return summary, pipe
    return summary
