"""RNS precomputed tables: NTT twiddles, basis-conversion constants,
automorphism permutations.

The same tables as the JAX package's ``core/rns.py``, held as numpy int64.
Power tables are built by repeated doubling over all primes at once in
int64: every product is of two residues below 2^30, so it stays below
2^60 and the tables are exact (a per-entry Python ``pow`` costs about
half a second per prime at logN=16).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from repro_torch.core import nt
from repro_torch.core.params import CKKSParams


def pow_table(bases: np.ndarray, moduli: np.ndarray, n: int) -> np.ndarray:
    """(len(bases), n) int64: ``bases[i] ** e mod moduli[i]`` for e < n.

    ``n`` is a power of two; rows double ``[0, k) -> [k, 2k)`` by one
    vectorized multiply with ``base ** k``.
    """
    q = moduli.astype(np.int64)[:, None]
    step = bases.astype(np.int64)[:, None] % q
    out = np.empty((len(bases), n), dtype=np.int64)
    out[:, 0] = 1
    k = 1
    while k < n:
        out[:, k : 2 * k] = out[:, :k] * step % q
        step = step * step % q
        k *= 2
    return out


def bit_reverse(n: int) -> np.ndarray:
    """Bit-reversal permutation of ``range(n)`` (n a power of two)."""
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


class RNSContext:
    """All tables for a CKKSParams instance, stacked per limb."""

    def __init__(self, params: CKKSParams):
        self.params = params
        self.all_primes: tuple[int, ...] = params.q_primes + params.p_primes
        self.prime_index = {p: i for i, p in enumerate(self.all_primes)}
        self.moduli = np.array(self.all_primes, dtype=np.int64)

        logn, n = params.logN, params.N
        psi = np.array([nt.root_of_unity(2 * n, p) for p in self.all_primes],
                       dtype=np.int64)
        psi_inv = np.array([nt.modinv(int(s), p)
                            for s, p in zip(psi, self.all_primes)],
                           dtype=np.int64)
        omega = psi * psi % self.moduli
        omega_inv = psi_inv * psi_inv % self.moduli
        self.psi_pows = pow_table(psi, self.moduli, n)
        self.psi_inv_pows = pow_table(psi_inv, self.moduli, n)
        self.n_inv = np.array([nt.modinv(n, p) for p in self.all_primes],
                              dtype=np.int64)
        self.bitrev = bit_reverse(n)
        # Stage s (s = 0..logn-1) has 2^s twiddles w^(n >> (s+1) * j).
        w_pows = pow_table(omega, self.moduli, n)
        w_inv_pows = pow_table(omega_inv, self.moduli, n)
        self.stage_tw = [
            w_pows[:, (n >> (s + 1)) * np.arange(1 << s)] for s in range(logn)
        ]
        self.stage_tw_inv = [
            w_inv_pows[:, (n >> (s + 1)) * np.arange(1 << s)]
            for s in range(logn)
        ]

    def limb_ids(self, primes: tuple[int, ...]) -> np.ndarray:
        return np.array([self.prime_index[p] for p in primes], dtype=np.int64)

    # ---------------- basis conversion constants ----------------------
    @lru_cache(maxsize=None)
    def bconv_consts(
        self, src: tuple[int, ...], dst: tuple[int, ...]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Fast-basis-conversion constants src -> dst.

        Returns (qhat_inv_mod_src[i], qhat_mod_dst[i, j]) with
        qhat_i = prod(src)/src_i.  FBC: y_j = sum_i [x_i * qhat_inv_i]_{s_i}
        * (qhat_i mod d_j) mod d_j (approximate: off by a small multiple of
        prod(src), absorbed by ModDown rounding / scheme noise).
        """
        prod = 1
        for s in src:
            prod *= s
        qhat_inv = np.array(
            [nt.modinv(prod // s, s) for s in src], dtype=np.int64
        )
        qhat_mod = np.array(
            [[(prod // s) % d for d in dst] for s in src], dtype=np.int64
        ).reshape(len(src), len(dst))
        return qhat_inv, qhat_mod

    @lru_cache(maxsize=None)
    def p_inv_mod_q(self, level: int) -> np.ndarray:
        """P^{-1} mod q_i for ModDown at ``level``."""
        P = self.params.P
        return np.array(
            [nt.modinv(P, q) for q in self.params.q_chain(level)],
            dtype=np.int64,
        )

    @lru_cache(maxsize=None)
    def q_last_inv(self, level: int) -> np.ndarray:
        """q_level^{-1} mod q_i (i < level) for rescale."""
        chain = self.params.q_chain(level)
        q_last = chain[-1]
        return np.array(
            [nt.modinv(q_last, q) for q in chain[:-1]], dtype=np.int64
        )

    # ---------------- automorphism tables ------------------------------
    @lru_cache(maxsize=None)
    def autom_tables(self, galois: int) -> tuple[np.ndarray, np.ndarray]:
        """Gather indices + sign for b(X) = a(X^galois) in coeff domain.

        b[j] = sign[j] * a[src[j]]  (sign encoded as 0 -> +, 1 -> negate).
        """
        n = self.params.N
        two_n = 2 * n
        kinv = nt.modinv(galois, two_n)
        j = np.arange(n, dtype=np.int64)
        i0 = (j * kinv) % two_n
        src = i0 % n
        neg = (i0 >= n).astype(np.int64)
        return src, neg

    @lru_cache(maxsize=None)
    def autom_eval_perm(self, galois: int) -> np.ndarray:
        """Eval-domain automorphism as a pure permutation (no signs).

        The negacyclic NTT evaluates at psi^(2j+1) (natural order), so
        a(X^g) at point j is a's value at the point with odd exponent
        g*(2j+1) mod 2N:  out[j] = in[perm[j]].
        """
        n = self.params.N
        two_n = 2 * n
        j = np.arange(n, dtype=np.int64)
        return ((galois * (2 * j + 1)) % two_n - 1) // 2

    def galois_for_rotation(self, steps: int) -> int:
        """Galois element 5^steps mod 2N rotating slots left by ``steps``."""
        two_n = 2 * self.params.N
        return pow(5, steps % self.params.num_slots, two_n)

    def galois_conjugate(self) -> int:
        return 2 * self.params.N - 1
