"""Host-side constants for the kernels' 32-bit Montgomery arithmetic.

The device arithmetic lives in ``csrc/modarith.cuh``: a 64-bit product
and one Montgomery reduction with R = 2^32, valid for odd q < 2^31, that
returns a fully reduced residue.  Data stays in normal form; twiddle and
basis-conversion constants are handed to the kernels in Montgomery form
(``x * 2^32 mod q``), so ``mont_mul(value, const_mont)`` is the plain
product ``value * const mod q``.

``mont_mul_host`` repeats the device formula in numpy uint64, and
``bconv_lazy_host`` the BConv kernel's lazy accumulate-and-reduce, so
that the CPU tests can hold them against Python integers.
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
    """numpy mirror of ``he2::mont_mul`` in ``csrc/modarith.cuh``; ``q``
    and ``qinv_neg`` broadcast against ``a`` and ``b``."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    q = np.asarray(q, dtype=np.uint64)
    t = a * b
    m = ((t & np.uint64(_MASK)) * np.asarray(qinv_neg, np.uint64)
         ) & np.uint64(_MASK)
    r = (t + m * q) >> np.uint64(R_BITS)
    return np.where(r >= q, r - q, r)


def lazy_terms(src_q) -> int:
    """Products ``t_i * c_ij`` (``t_i < q_i``, ``c_ij < d_j``) that one
    64-bit sum of the BConv kernel takes before a Montgomery reduction:
    ``floor(2^32 / max q_i)`` keeps the sum below ``d_j * 2^32``.  4 for
    primes in (2^29, 2^30)."""
    return (1 << R_BITS) // int(max(src_q))


def bconv_lazy_host(x, qhat_inv_m, src_q, cm, dst_q, g_acc: int):
    """numpy mirror of ``csrc/bconv.cu``'s arithmetic on (ls, N) residues.

    ``qhat_inv_m`` (ls,) and ``cm`` (ls, ld) are the kernel's Montgomery
    constants.  Each source row is scaled once (``mont_mul``); the
    products of ``g_acc`` rows are summed in 64 bits on top of the carried
    value ``r < 2 d`` in the high word, then one Montgomery reduction
    gives a value below ``4 d``, folded below ``2 d``; the output is folded
    below ``d``.  Raises if a sum or a reduction leaves its bound."""
    u = np.uint64
    top = u((1 << 64) - 1)
    x = np.asarray(x, dtype=u)
    sq = np.asarray(src_q, dtype=u)
    d = np.asarray(dst_q, dtype=u)[:, None]
    dn = np.array([qinv_neg_host(int(q)) for q in dst_q], dtype=u)[:, None]
    sqn = np.array([qinv_neg_host(int(q)) for q in src_q], dtype=u)
    t = mont_mul_host(x, np.asarray(qhat_inv_m, u)[:, None], sq[:, None],
                      sqn[:, None])
    cm = np.asarray(cm, dtype=u)
    ls = x.shape[0]
    acc = np.zeros((len(d), x.shape[1]), dtype=u)
    for i in range(ls):
        prod = t[i][None, :] * cm[i][:, None]
        if np.any(acc > top - prod):
            raise OverflowError("bconv: 64-bit sum overflows")
        acc = acc + prod
        if (i + 1) % g_acc == 0 or i + 1 == ls:
            m = ((acc & u(_MASK)) * dn) & u(_MASK)
            if np.any(acc > top - m * d):
                raise OverflowError("bconv: reduction overflows")
            r = (acc + m * d) >> u(R_BITS)
            if np.any(r >= 4 * d):
                raise OverflowError("bconv: reduction above 4 d")
            acc = np.where(r >= 2 * d, r - 2 * d, r) << u(R_BITS)
    r = acc >> u(R_BITS)
    return np.where(r >= d, r - d, r)
