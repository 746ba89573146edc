"""RNS polynomial arithmetic on int64 torch tensors.

Counterpart of the JAX package's ``core/poly.py``, with the same function
set.  A polynomial under a basis of ``l`` primes is a ``(..., l, N)``
int64 tensor of residues; products of two residues (< 2^30) fit int64,
so plain ``(a * b) % q`` is exact.  Leading dimensions are a batch.

``ntt``/``intt`` go through the NTT kernel (``kernels/ntt``, natural
order at both ends), and ``bconv`` through the BConv kernel, so every
operation built on them (encode, encrypt, decrypt, rescale, keygen) runs
on the card when its tensors do.

Domain convention: ciphertext polynomials live in EVAL (NTT) domain, in
natural order; ModUp/ModDown run INTT -> BConv -> NTT.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.params import CKKSParams
from repro_torch.core.rns import RNSContext
from repro_torch.kernels.bconv.ops import BConvConsts
from repro_torch.kernels.bconv.ops import bconv as bconv_kernel
from repro_torch.kernels.ntt.ops import NTTTables, ntt_fwd, ntt_inv


def resolve_device(device) -> torch.device:
    """The device a context runs on; CUDA must exist if it is asked for.

    Entry points default to the card; a caller that wants the CPU says
    so.  Asking for CUDA where there is none raises instead of quietly
    running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class PolyContext:
    """Device-resident tables derived from RNSContext."""

    def __init__(self, params: CKKSParams, device="cuda"):
        self.params = params
        self.device = resolve_device(device)
        self.rns = RNSContext(params)
        self.tabs = NTTTables(self.rns)
        self.moduli = torch.from_numpy(self.rns.moduli).to(self.device)
        self._mods: dict[tuple, torch.Tensor] = {}
        self._bconv: dict[tuple, BConvConsts] = {}

    def limb_rows(self, primes: tuple[int, ...]) -> np.ndarray:
        return self.rns.limb_ids(tuple(primes))

    def mods(self, primes: tuple[int, ...]) -> torch.Tensor:
        key = tuple(primes)
        if key not in self._mods:
            self._mods[key] = self.moduli[
                torch.from_numpy(self.limb_rows(key)).to(self.device)]
        return self._mods[key]

    def bconv_consts(self, src: tuple[int, ...],
                     dst: tuple[int, ...]) -> BConvConsts:
        key = (tuple(src), tuple(dst))
        if key not in self._bconv:
            self._bconv[key] = BConvConsts(self.rns, *key, self.device)
        return self._bconv[key]

    def tensor(self, arr: np.ndarray) -> torch.Tensor:
        """numpy residues (uint64 or int64) -> int64 tensor on the device."""
        return torch.from_numpy(
            np.ascontiguousarray(arr).astype(np.int64)).to(self.device)


# --------------------------- elementwise ops ----------------------------

def add(a, b, mods):
    return (a + b) % mods[:, None]


def sub(a, b, mods):
    return (a + mods[:, None] - b) % mods[:, None]


def mul(a, b, mods):
    return (a * b) % mods[:, None]


def neg(a, mods):
    return (mods[:, None] - a) % mods[:, None]


def mul_scalar(a, s, mods):
    """s: (l,) per-limb scalars already reduced."""
    return (a * s[:, None]) % mods[:, None]


# ------------------------------- NTT ------------------------------------

def ntt(x, primes: tuple[int, ...], pc: PolyContext):
    """Negacyclic forward NTT over stacked limbs, natural eval order out."""
    return ntt_fwd(x.contiguous(), primes, pc.tabs)


def intt(x, primes: tuple[int, ...], pc: PolyContext):
    """Negacyclic inverse NTT of natural-order eval residues."""
    return ntt_inv(x.contiguous(), primes, pc.tabs)


# --------------------------- basis conversion ---------------------------

def bconv(x, src: tuple[int, ...], dst: tuple[int, ...], pc: PolyContext):
    """Fast basis conversion (coeff domain). x: (..., len(src), N) ->
    (..., len(dst), N).

    Approximate FBC — result may be off by a small multiple of prod(src);
    downstream ModDown/rescale absorbs it (standard RNS-CKKS).
    """
    return bconv_kernel(x.contiguous(), pc.bconv_consts(src, dst))


# --------------------------- ModUp / ModDown ----------------------------

def _modup_perm(digit_primes: tuple[int, ...], new_primes: tuple[int, ...],
                target_primes: tuple[int, ...]) -> list[int]:
    """Row permutation assembling concat([digit, converted]) in target order."""
    pos = {p: i for i, p in enumerate(digit_primes + new_primes)}
    return [pos[p] for p in target_primes]


def modup_digit(x_digit, digit_primes, target_primes, pc: PolyContext,
                eval_domain: bool = True):
    """Lift one decomposition digit to the extended basis.

    x_digit: (..., alpha, N) residues under digit_primes (eval domain if
    eval_domain).  Returns (..., len(target), N) under ``target_primes``
    (superset containing digit_primes), eval domain.
    INTT -> BConv -> NTT for the new limbs; original limbs pass through.
    """
    coeff = intt(x_digit, digit_primes, pc) if eval_domain else x_digit
    new_primes = tuple(p for p in target_primes if p not in digit_primes)
    converted = bconv(coeff, tuple(digit_primes), new_primes, pc)
    if eval_domain:
        converted = ntt(converted, new_primes, pc)
    perm = _modup_perm(tuple(digit_primes), new_primes, tuple(target_primes))
    return torch.cat([x_digit, converted], dim=-2)[..., perm, :]


def moddown(x, level: int, pc: PolyContext, eval_domain: bool = True):
    """Scale down by P: input under (Q_level u P), output under Q_level.

    x rows ordered: q_0..q_level, p_0..p_{k-1}.
    """
    params = pc.params
    q_primes = params.q_chain(level)
    p_primes = params.p_primes
    nq = len(q_primes)
    xq, xp = x[..., :nq, :], x[..., nq:, :]
    xp_coeff = intt(xp, p_primes, pc) if eval_domain else xp
    conv = bconv(xp_coeff, tuple(p_primes), tuple(q_primes), pc)
    if eval_domain:
        conv = ntt(conv, tuple(q_primes), pc)
    q_mods = pc.mods(tuple(q_primes))
    diff = sub(xq, conv, q_mods)
    pinv = pc.tensor(pc.rns.p_inv_mod_q(level))
    return mul_scalar(diff, pinv, q_mods)


def rescale(x, level: int, pc: PolyContext, eval_domain: bool = True):
    """Drop the last prime q_level: out_i = (x_i - x_last) / q_level mod q_i."""
    params = pc.params
    chain = params.q_chain(level)
    keep = chain[:-1]
    last = x[..., -1:, :]
    last_coeff = intt(last, (chain[-1],), pc) if eval_domain else last
    # Re-express x_last's residue under each remaining prime.
    lifted = bconv(last_coeff, (chain[-1],), tuple(keep), pc)
    if eval_domain:
        lifted = ntt(lifted, tuple(keep), pc)
    mods = pc.mods(tuple(keep))
    diff = sub(x[..., :-1, :], lifted, mods)
    qinv = pc.tensor(pc.rns.q_last_inv(level))
    return mul_scalar(diff, qinv, mods)


# --------------------------- automorphism -------------------------------

def automorphism(x, primes: tuple[int, ...], galois: int, pc: PolyContext,
                 eval_domain: bool = True):
    """Apply X -> X^galois.  Functionally applied in coeff domain."""
    if eval_domain:
        x = intt(x, primes, pc)
    src, negmask = pc.rns.autom_tables(galois)
    mods = pc.mods(tuple(primes))[:, None]
    g = x[..., pc.tensor(src)]
    negm = pc.tensor(negmask)[None, :]
    g = torch.where(negm == 1, (mods - g) % mods, g)
    if eval_domain:
        g = ntt(g, primes, pc)
    return g


def automorphism_eval(x, galois: int, pc: PolyContext):
    """Apply X -> X^galois directly in the eval domain: one gather.

    Bit-exact with ``automorphism(..., eval_domain=True)`` — the NTT's
    evaluation points are permuted by the Galois element (see
    ``RNSContext.autom_eval_perm``) — but with no INTT/NTT round trip.
    """
    return x[..., pc.tensor(pc.rns.autom_eval_perm(galois))]
