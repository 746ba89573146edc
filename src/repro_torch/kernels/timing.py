"""Device time of a callable on the card, for ``chip_smoke.py`` and
``tools/ntt_study.py``."""
from __future__ import annotations

import statistics

import torch

# Spin-kernel cycles per call to be enqueued: ~1 ms of the card's clock,
# well above a wrapper's host time (tens of microseconds).
SPIN_CYCLES_PER_REP = 2_000_000


def cuda_ms(fn, reps: int = 10, batches: int = 5, hide_host: bool = True
            ) -> float:
    """Median over ``batches`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events, after a warm-up.  With ``hide_host`` the
    stream first runs a spin kernel long enough for the host to enqueue
    all ``reps`` calls, so that a wrapper's host time does not stand in
    for a shorter kernel's device time."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(SPIN_CYCLES_PER_REP * reps)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)
