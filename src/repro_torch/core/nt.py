"""Exact number theory helpers (pure Python ints — used at setup time only).

Everything here runs once per parameter set; hot paths live in
``repro_torch.core.poly`` (torch) and ``repro_torch.kernels`` (CUDA).
"""
from __future__ import annotations

from functools import lru_cache

# Deterministic Miller-Rabin witness set, valid for all n < 3.3e24.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def modinv(a: int, m: int) -> int:
    return pow(a % m, m - 2, m) if is_prime(m) else pow(a % m, -1, m)


def find_primes(count: int, bits: int, step_mod: int, avoid=()) -> list[int]:
    """``count`` primes p ≡ 1 (mod step_mod), p < 2**bits, descending from 2**bits.

    ``step_mod`` is 2N for negacyclic NTT support.
    """
    primes: list[int] = []
    avoid = set(avoid)
    # Start at the largest candidate ≡ 1 mod step_mod below 2**bits.
    p = (1 << bits) - ((1 << bits) - 1) % step_mod
    while len(primes) < count:
        if p <= step_mod:
            raise ValueError(f"ran out of {bits}-bit primes ≡ 1 mod {step_mod}")
        if p not in avoid and is_prime(p):
            primes.append(p)
        p -= step_mod
    return primes


@lru_cache(maxsize=None)
def primitive_root(p: int) -> int:
    """Smallest primitive root mod prime p."""
    factors = _factorize(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root found for {p}")


def root_of_unity(order: int, p: int) -> int:
    """An element of exact multiplicative order ``order`` mod prime p."""
    if (p - 1) % order != 0:
        raise ValueError(f"{order} does not divide {p}-1")
    g = primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) != 1
    return w


def _factorize(n: int) -> set[int]:
    out, d = set(), 2
    while d * d <= n:
        while n % d == 0:
            out.add(d)
            n //= d
        d += 1
    if n > 1:
        out.add(n)
    return out


def bit_reverse_indices(n: int) -> list[int]:
    bits = n.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)]
