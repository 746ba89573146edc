"""CKKS canonical-embedding encoder/decoder (special FFT, numpy complex128).

Host-side numpy, as in the JAX package; the port copies it so that it
imports nothing of that package.

Follows the HEAAN reference algorithm: slots z in C^{N/2} map to a real
polynomial m(X) via the embedding at odd powers of the 2N-th root of unity,
ordered by the rotation group 5^j mod 2N (so slot rotation == Galois
automorphism X -> X^5).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import nt
from repro_torch.core.params import CKKSParams


class Encoder:
    def __init__(self, params: CKKSParams):
        self.params = params
        N = params.N
        M = 2 * N
        Nh = N // 2
        self.N, self.M, self.Nh = N, M, Nh
        self.rot_group = np.array(
            [pow(5, i, M) for i in range(Nh)], dtype=np.int64
        )
        j = np.arange(M + 1)
        self.ksi = np.exp(2j * np.pi * j / M)
        self.bitrev = np.array(nt.bit_reverse_indices(Nh), dtype=np.int64)

    # ---- special FFT (slot <-> coeff), vectorized per stage -------------
    def fft_special(self, vals: np.ndarray) -> np.ndarray:
        v = vals[self.bitrev].copy()
        Nh, M = self.Nh, self.M
        ln = 2
        while ln <= Nh:
            lenh, lenq = ln >> 1, ln << 2
            idx = (self.rot_group[:lenh] % lenq) * (M // lenq)
            w = self.ksi[idx]
            v = v.reshape(Nh // ln, ln)
            u, t = v[:, :lenh], v[:, lenh:] * w[None, :]
            v = np.concatenate([u + t, u - t], axis=1)
            ln <<= 1
        return v.reshape(Nh)

    def fft_special_inv(self, vals: np.ndarray) -> np.ndarray:
        v = vals.copy()
        Nh, M = self.Nh, self.M
        ln = Nh
        while ln >= 2:
            lenh, lenq = ln >> 1, ln << 2
            idx = (lenq - (self.rot_group[:lenh] % lenq)) * (M // lenq)
            w = self.ksi[idx]
            v = v.reshape(Nh // ln, ln)
            u = v[:, :lenh] + v[:, lenh:]
            t = (v[:, :lenh] - v[:, lenh:]) * w[None, :]
            v = np.concatenate([u, t], axis=1)
            ln >>= 1
        v = v.reshape(Nh)[self.bitrev]
        return v / Nh

    # ---- encode / decode -------------------------------------------------
    def encode(self, z: np.ndarray, scale: float,
               primes: tuple[int, ...]) -> np.ndarray:
        """Complex slots -> (len(primes), N) uint64 residues, coeff domain."""
        z = np.asarray(z, dtype=np.complex128)
        if z.shape != (self.Nh,):
            full = np.zeros(self.Nh, dtype=np.complex128)
            full[: z.shape[0]] = z
            z = full
        vals = self.fft_special_inv(z)
        coeffs = np.concatenate(
            [np.round(vals.real * scale), np.round(vals.imag * scale)]
        )
        # Rounded floats below 2^62 convert to int64 exactly, so the
        # vectorized reduction equals the per-coefficient big-int one.
        if np.abs(coeffs).max(initial=0.0) < 2.0**62:
            ints = coeffs.astype(np.int64)
            return np.stack(
                [np.mod(ints, q).astype(np.uint64) for q in primes]
            )
        big = coeffs.astype(object)
        out = np.empty((len(primes), self.N), dtype=np.uint64)
        for i, q in enumerate(primes):
            out[i] = np.array([int(c) % q for c in big], dtype=np.uint64)
        return out

    def decode(self, residues: np.ndarray, scale: float,
               primes: tuple[int, ...]) -> np.ndarray:
        """(len(primes), N) residues (coeff domain) -> complex slots."""
        coeffs = centered_crt(residues, primes)
        vals = (
            coeffs[: self.Nh].astype(np.float64)
            + 1j * coeffs[self.Nh :].astype(np.float64)
        ) / scale
        return self.fft_special(vals)


def centered_crt(residues: np.ndarray, primes: tuple[int, ...]) -> np.ndarray:
    """Exact CRT lift to centered big ints (object array)."""
    Q = 1
    for q in primes:
        Q *= q
    acc = np.zeros(residues.shape[1], dtype=object)
    for i, q in enumerate(primes):
        qhat = Q // q
        c = (qhat * nt.modinv(qhat, q)) % Q
        acc = (acc + residues[i].astype(object) * c) % Q
    half = Q // 2
    return np.where(acc > half, acc - Q, acc)
