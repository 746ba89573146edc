"""Host-side constants for the kernels' 32-bit Montgomery arithmetic.

The device arithmetic lives in ``csrc/modarith.cuh``: a 64-bit product
and one Montgomery reduction with R = 2^32, valid for odd q < 2^31, that
returns a fully reduced residue.  Data stays in normal form; twiddle and
basis-conversion constants are handed to the kernels in Montgomery form
(``x * 2^32 mod q``), so ``mont_mul(value, const_mont)`` is the plain
product ``value * const mod q``.

``mont_mul_host`` repeats the device formula in numpy uint64 so that the
CPU tests can hold it against Python integers.
"""
from __future__ import annotations

import numpy as np

R_BITS = 32
_MASK = (1 << R_BITS) - 1


def qinv_neg_host(q: int) -> int:
    """-q^{-1} mod 2^32."""
    return (-pow(int(q), -1, 1 << R_BITS)) % (1 << R_BITS)


def to_mont_host(x: np.ndarray, q) -> np.ndarray:
    """``x * 2^32 mod q`` in int64; ``q`` broadcasts against ``x``.

    Exact for residues below 2^31: the shifted value stays below 2^63.
    """
    return (np.asarray(x, dtype=np.int64) << R_BITS) % np.asarray(q, np.int64)


def r_pow_host(q: int, e: int) -> int:
    """2^(32 e) mod q: the factor that undoes ``e`` Montgomery reductions."""
    return pow(2, R_BITS * e, int(q))


def as_u32(values) -> np.ndarray:
    """Pack 32-bit unsigned constants into int32 storage (same bits)."""
    return np.asarray(values, dtype=np.int64).astype(np.uint32).view(np.int32)


def mont_mul_host(a, b, q, qinv_neg):
    """numpy mirror of ``he2::mont_mul`` in ``csrc/modarith.cuh``."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    q = np.uint64(q)
    t = a * b
    m = ((t & np.uint64(_MASK)) * np.uint64(qinv_neg)) & np.uint64(_MASK)
    r = (t + m * q) >> np.uint64(R_BITS)
    return np.where(r >= q, r - q, r)
