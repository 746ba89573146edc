"""Lightweight op counters for the CKKS runtime.

``CKKSContext`` (and its ``KeyswitchEngine``) increment these at dispatch
time, so parity tests can assert *how many* ModUp/ModDown/IP invocations
actually ran, not just that values matched.  Word/MAC volumes are derived
from the engine's real per-level plan shapes (the digit group sizes and
extended-basis width).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class OpCounters:
    """Invocation counts + plan-shape-derived work volumes.

    One ModDown of both accumulator polynomials counts once; one IP
    covers all dnum digits of one rotation/relinearization.
    """

    modup: int = 0
    moddown: int = 0
    ip: int = 0
    keyswitch: int = 0          # logical keyswitches (rotations + relins)
    rotation: int = 0
    relin: int = 0              # relinearization keyswitches (CMults)
    hoisted_blocks: int = 0
    relin_blocks: int = 0       # merged multi-relin accumulation blocks
    ntt_words: float = 0.0      # INTT + NTT butterfly-pass words
    bconv_macs: float = 0.0
    ip_macs: float = 0.0

    # ------------------------- note_* helpers --------------------------
    def note_modup(self, l: int, ext: int, group_sizes: tuple[int, ...],
                   N: int, m: int = 1) -> None:
        """One ModUp of an l-limb poly to the ext-limb basis (m cts)."""
        self.modup += m
        self.ntt_words += m * (l + sum(ext - a for a in group_sizes)) * N
        self.bconv_macs += m * sum(a * (ext - a) for a in group_sizes) * N

    def note_moddown(self, l: int, k: int, N: int, m: int = 1) -> None:
        """One batched 2-poly ModDown from (l+k) limbs back to l."""
        self.moddown += m
        self.ntt_words += m * 2 * (k + l) * N
        self.bconv_macs += m * 2 * k * l * N

    def note_ip(self, dnum: int, ext: int, N: int, n: int = 1,
                m: int = 1) -> None:
        """n inner products over the extended basis (2 components each)."""
        self.ip += m * n
        self.ip_macs += m * n * dnum * ext * N * 2

    # ------------------------- bookkeeping -----------------------------
    def snapshot(self) -> "OpCounters":
        return dataclasses.replace(self)

    def delta(self, since: "OpCounters") -> "OpCounters":
        return OpCounters(*[
            getattr(self, f.name) - getattr(since, f.name)
            for f in dataclasses.fields(self)
        ])

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)
