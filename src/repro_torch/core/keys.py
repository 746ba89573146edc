"""Key generation: secret key, keyswitching (evk) keys, rotation/conj keys.

Counterpart of the JAX package's ``core/keys.py``.  Randomness comes from
a numpy ``Generator`` on the host, drawn in exactly the reference's order
with the same arguments, so the same seed gives the same keys; only the
draws move to the device, as int64.

evk construction (level-independent gadget): for full-chain digit group
D_j (alpha consecutive primes of the Q chain),

    G_j = Qhat_j * (Qhat_j^{-1} mod Q_j)   (== 1 mod q in D_j, 0 elsewhere)

    evk_j = (-a_j s + e_j + P * G_j * s',  a_j)   mod (Q_L * P)

so that at ANY level l the digits of the level-l chain (prefixes of the
full-chain groups) reconstruct: sum_j X_j * G_j == x (mod Q_l).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import poly
from repro_torch.core.params import CKKSParams

_SIGMA = 3.2


@dataclasses.dataclass
class EvalKey:
    """dnum digits x 2 components over the extended basis Q_L u P (eval)."""

    digits: list  # list of (2, L+1+k, N) int64 tensors


def sample_ternary(rng: np.random.Generator, n: int, h: int | None = None):
    if h is None:
        return rng.integers(-1, 2, n).astype(np.int64)
    s = np.zeros(n, dtype=np.int64)
    idx = rng.choice(n, size=h, replace=False)
    s[idx] = rng.choice([-1, 1], size=h)
    return s


def sample_gaussian(rng: np.random.Generator, n: int) -> np.ndarray:
    return np.round(rng.normal(0.0, _SIGMA, n)).astype(np.int64)


def to_rns(coeffs: np.ndarray, primes: tuple[int, ...]) -> np.ndarray:
    """Signed int coeffs -> (l, N) int64 residues (coeff domain)."""
    out = np.empty((len(primes), coeffs.shape[0]), dtype=np.int64)
    for i, q in enumerate(primes):
        out[i] = np.mod(coeffs, q)
    return out


def uniform_rns(rng: np.random.Generator, primes: tuple[int, ...],
                n: int) -> np.ndarray:
    """(l, n) uniform residues: one ``integers(0, q, n, uint64)`` draw per
    prime, in order, as the reference draws them."""
    return np.stack(
        [rng.integers(0, q, n, dtype=np.uint64) for q in primes]
    ).astype(np.int64)


class KeyChain:
    """Holds sk and generates evks lazily; rotation keys cached by step."""

    def __init__(self, params: CKKSParams, pc: poly.PolyContext,
                 seed: int = 1234, hamming_weight: int | None = None):
        rng = np.random.default_rng(seed)
        # Sparse secrets (small h) bound the ModRaise overflow |I| <= ~h/2
        # (bootstrapping convention; uniform ternary otherwise).
        s_coeffs = sample_ternary(rng, params.N, h=hamming_weight)
        self._setup(params, pc, s_coeffs, rng)

    @classmethod
    def from_secret(cls, params: CKKSParams, pc: poly.PolyContext,
                    s_coeffs: np.ndarray,
                    rng: np.random.Generator) -> "KeyChain":
        """A chain for a given secret; ``rng`` draws its future keys."""
        chain = cls.__new__(cls)
        chain._setup(params, pc, np.asarray(s_coeffs, dtype=np.int64), rng)
        return chain

    def _setup(self, params, pc, s_coeffs, rng) -> None:
        self.params = params
        self.pc = pc
        self.rng = rng
        self.s_coeffs = s_coeffs
        self.ext_primes = params.q_primes + params.p_primes
        # sk in eval domain over the full extended basis.
        s_rns = to_rns(self.s_coeffs, self.ext_primes)
        self.s_eval = poly.ntt(pc.tensor(s_rns), self.ext_primes, pc)
        self._rot_keys: dict[int, EvalKey] = {}
        self._mult_key: EvalKey | None = None
        self._conj_key: EvalKey | None = None
        self._gadgets = self._make_gadgets()

    # ------------------------------------------------------------------
    def _make_gadgets(self) -> list[torch.Tensor]:
        """P*G_j reduced mod every extended-basis prime: dnum x (L+1+k,)."""
        p = self.params
        full_chain = p.q_chain(p.L)
        groups = p.digit_groups(p.L)
        P = p.P
        out = []
        for D in groups:
            Qj = math.prod(D)
            Qhat = math.prod(full_chain) // Qj
            cj = pow(Qhat % Qj, -1, Qj)
            Gj = Qhat * cj  # integer; == 1 mod D primes, 0 mod others
            vec = np.array(
                [(P * Gj) % r for r in self.ext_primes], dtype=np.int64
            )
            out.append(self.pc.tensor(vec))
        return out

    def _gen_evk(self, s_prime_eval: torch.Tensor) -> EvalKey:
        """evk for switching s_prime -> s. s_prime_eval: (L+1+k, N) eval."""
        p, pc = self.params, self.pc
        primes = self.ext_primes
        mods = pc.mods(primes)
        digits = []
        for j in range(p.dnum):
            a_rns = uniform_rns(self.rng, primes, p.N)
            a_eval = poly.ntt(pc.tensor(a_rns), primes, pc)
            e_rns = to_rns(sample_gaussian(self.rng, p.N), primes)
            e_eval = poly.ntt(pc.tensor(e_rns), primes, pc)
            b = poly.sub(
                poly.add(
                    poly.mul_scalar(s_prime_eval, self._gadgets[j], mods),
                    e_eval,
                    mods,
                ),
                poly.mul(a_eval, self.s_eval, mods),
                mods,
            )
            digits.append(torch.stack([b, a_eval]))
        return EvalKey(digits=digits)

    # ------------------------------------------------------------------
    @property
    def mult_key(self) -> EvalKey:
        if self._mult_key is None:
            mods = self.pc.mods(self.ext_primes)
            s2 = poly.mul(self.s_eval, self.s_eval, mods)
            self._mult_key = self._gen_evk(s2)
        return self._mult_key

    def rot_key(self, steps: int) -> EvalKey:
        steps = steps % self.params.num_slots
        if steps not in self._rot_keys:
            g = self.pc.rns.galois_for_rotation(steps)
            s_rot = poly.automorphism(
                self.s_eval, self.ext_primes, g, self.pc
            )
            self._rot_keys[steps] = self._gen_evk(s_rot)
        return self._rot_keys[steps]

    @property
    def conj_key(self) -> EvalKey:
        if self._conj_key is None:
            g = self.pc.rns.galois_conjugate()
            s_c = poly.automorphism(self.s_eval, self.ext_primes, g, self.pc)
            self._conj_key = self._gen_evk(s_c)
        return self._conj_key
