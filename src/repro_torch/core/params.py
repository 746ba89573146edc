"""CKKS parameter sets (RNS prime chains, decomposition, scale).

The paper (Table II) uses N=2^16, L=35, k=12, alpha=12, dnum=3 with 36-bit
words at 128-bit security.  The functional implementation uses <=30-bit RNS
primes: products of two residues fit int64 exactly, and the CUDA kernels'
Montgomery arithmetic (R = 2^32) stays in 32-bit words.  The CPU tests run
reduced N; the arithmetic is dimension-generic.
"""
from __future__ import annotations

import dataclasses
import math
from functools import cached_property

from repro_torch.core import nt


@dataclasses.dataclass(frozen=True)
class CKKSParams:
    """Static CKKS/RNS parameters.

    Attributes:
      logN: log2 of ring degree (ring is Z[X]/(X^N+1)).
      L: maximum level — the Q chain has L+1 primes q_0..q_L.
      alpha: decomposition group size (number of Q primes per digit).
      k: number of special primes (the P basis); k >= alpha.
      q_bits: bit size of the chain primes (q_1..q_L, and the P primes).
      q0_bits: bit size of the base prime q_0 (bigger for decrypt headroom).
      scale_bits: log2 of the encoding scale Delta.
    """

    logN: int = 16
    L: int = 35
    alpha: int = 12
    k: int = 12
    q_bits: int = 30
    q0_bits: int = 30
    scale_bits: int = 28

    @property
    def N(self) -> int:
        return 1 << self.logN

    @property
    def num_slots(self) -> int:
        return self.N // 2

    @property
    def dnum(self) -> int:
        return math.ceil((self.L + 1) / self.alpha)

    @property
    def scale(self) -> float:
        return float(1 << self.scale_bits)

    @cached_property
    def q_primes(self) -> tuple[int, ...]:
        """q_0 .. q_L (q_0 first)."""
        two_n = 2 * self.N
        q0 = nt.find_primes(1, self.q0_bits, two_n)
        rest = nt.find_primes(self.L, self.q_bits, two_n, avoid=q0)
        return tuple(q0 + rest)

    @cached_property
    def p_primes(self) -> tuple[int, ...]:
        two_n = 2 * self.N
        return tuple(
            nt.find_primes(self.k, self.q_bits, two_n, avoid=self.q_primes)
        )

    def q_chain(self, level: int) -> tuple[int, ...]:
        """Primes active at ``level`` (level L = fresh, level 0 = last)."""
        if not 0 <= level <= self.L:
            raise ValueError(f"level {level} out of range [0, {self.L}]")
        return self.q_primes[: level + 1]

    def digit_groups(self, level: int) -> list[tuple[int, ...]]:
        """Decomposition of the level-``level`` chain into dnum groups of
        alpha primes (last group may be short)."""
        chain = self.q_chain(level)
        return [
            tuple(chain[i : i + self.alpha])
            for i in range(0, len(chain), self.alpha)
        ]

    @property
    def P(self) -> int:
        return math.prod(self.p_primes)

    def Q(self, level: int) -> int:
        return math.prod(self.q_chain(level))

    # --- size bookkeeping used by the DFG optimizer / simulator ---------
    def limb_bytes(self, word_bytes: int = 8) -> int:
        return self.N * word_bytes

    def ct_bytes(self, level: int, word_bytes: int = 8) -> int:
        """Two polynomials, level+1 limbs each."""
        return 2 * (level + 1) * self.limb_bytes(word_bytes)

    def evk_bytes(self, level: int | None = None, word_bytes: int = 8) -> int:
        """One evk: dnum digits x 2 polys over the extended basis Q_L u P.

        evks are stored at the top level (L) as in real libraries.
        """
        n_limbs = (self.L + 1) + self.k
        return self.dnum * 2 * n_limbs * self.limb_bytes(word_bytes)


# Paper configuration (used by the simulator and DFG cost models).
PAPER_PARAMS = CKKSParams(logN=16, L=35, alpha=12, k=12, scale_bits=28)

# Functional-test configuration: small ring, shallow chain — runs the full
# scheme (keygen/encrypt/mult/rotate/rescale/keyswitch) on CPU in seconds.
SMALL_TEST_PARAMS = CKKSParams(
    logN=10, L=5, alpha=2, k=2, q_bits=30, q0_bits=30, scale_bits=28
)

# Mid-size configuration for the bootstrap pipeline tests.
BOOT_TEST_PARAMS = CKKSParams(
    logN=11, L=14, alpha=3, k=3, q_bits=30, q0_bits=30, scale_bits=25
)
