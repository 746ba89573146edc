"""Negacyclic NTT: tables, the CUDA kernel's wrapper and its plain version.

Counterpart of the JAX package's ``kernels/ntt`` (``NTTKernelTables``,
``ntt_fwd`` / ``ntt_inv``, ``ntt_pallas``) together with the JAX engine's
bit-reversal bridge: forward maps natural coefficients to natural
evaluation order (index k holds the value at psi^(2k+1)); inverse maps
back.  Internally the forward is DIF (natural -> bit-reversed) and the
inverse DIT (bit-reversed -> natural), twiddles in the flat tree layout
``tw[m + j]``; the kernel does the bit-reversal on chip, the plain
version with one gather.

Residues are int64 tensors of shape ``(..., l, N)``.  On a CPU tensor the
wrappers run the plain version; on a CUDA tensor they launch
``csrc/ntt.cu``, one launch per call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rns import RNSContext, bit_reverse
from repro_torch.kernels import native
from repro_torch.kernels.modops import as_u32, qinv_neg_host, to_mont_host

# A block holds 2^MAX_BLOCK_BITS words of a row where the row allows, a
# cluster at most 2^MAX_CLUSTER_BITS blocks (``csrc/ntt_device.cuh``).
MAX_BLOCK_BITS = 13
MAX_CLUSTER_BITS = 3
# The kernels' butterflies keep residues below 4q in 32 bits.
MAX_PRIME = 1 << 30


def cluster_bits(logn: int) -> int:
    """log2 of the blocks a row is spread over: as few as hold the row
    at 2^13 words a block (one block up to logN = 13, eight at
    logN = 16).  At logN = 16, clusters of 8 ran the paper's forward
    (2 x 36 rows), inverse (2 x 12 rows) and ModUp faster than clusters
    of 4 (PERF.md, ``tools/ntt_study.py``)."""
    return min(MAX_CLUSTER_BITS, max(0, logn - MAX_BLOCK_BITS))


_BITREV: dict[tuple, torch.Tensor] = {}


def bitrev_index(n: int, device) -> torch.Tensor:
    """The bit-reversal permutation of ``range(n)`` on ``device``."""
    key = (n, torch.device(device))
    if key not in _BITREV:
        _BITREV[key] = torch.from_numpy(bit_reverse(n)).to(device)
    return _BITREV[key]


def _flat_tree(stages: list[np.ndarray], n: int) -> np.ndarray:
    out = np.ones((stages[0].shape[0], n), dtype=np.int64)
    for s, tws in enumerate(stages):
        out[:, 1 << s : 2 << s] = tws
    return out


class NTTTables:
    """Per-limb NTT tables over every prime of the parameter set.

    Normal-form int64 tables feed the plain version; 32-bit Montgomery
    tables feed the kernel.  Both are moved to a device on first use."""

    def __init__(self, rns: RNSContext):
        self.rns = rns
        self.logn = rns.params.logN
        n = rns.params.N
        q = rns.moduli[:, None]
        self.q = rns.moduli
        self.tw_f = _flat_tree(rns.stage_tw, n)
        self.tw_i = _flat_tree(rns.stage_tw_inv, n)
        self.twist_f = rns.psi_pows
        self.twist_i = rns.psi_inv_pows * rns.n_inv[:, None] % q
        self.qneg = np.array([qinv_neg_host(p) for p in self.q], np.int64)
        self._plain: dict[torch.device, dict] = {}
        self._mont: dict[torch.device, dict] = {}
        self._rows: dict[tuple, dict] = {}

    def rows(self, primes: tuple[int, ...]) -> np.ndarray:
        return self.rns.limb_ids(tuple(primes))

    def plain_tables(self, device) -> dict:
        device = torch.device(device)
        if device not in self._plain:
            self._plain[device] = {
                k: torch.from_numpy(getattr(self, k)).to(device)
                for k in ("tw_f", "tw_i", "twist_f", "twist_i", "q")
            }
        return self._plain[device]

    def mont_tables(self, device) -> dict:
        """32-bit Montgomery tables (int32 storage) for the kernel."""
        device = torch.device(device)
        if int(self.q.max()) >= MAX_PRIME:
            raise ValueError("the NTT kernels take primes below 2^30")
        if device not in self._mont:
            q = self.q[:, None]
            self._mont[device] = {
                k: torch.from_numpy(as_u32(to_mont_host(getattr(self, k), q)))
                .to(device)
                for k in ("tw_f", "tw_i", "twist_f", "twist_i")
            }
            self._mont[device]["q"] = torch.from_numpy(as_u32(self.q)).to(device)
            self._mont[device]["qn"] = torch.from_numpy(
                as_u32(self.qneg)).to(device)
        return self._mont[device]

    def row_map(self, primes: tuple[int, ...], device) -> torch.Tensor:
        """int32 table row of each prime, on ``device`` (cached)."""
        key = (tuple(primes), torch.device(device))
        if key not in self._rows:
            self._rows[key] = torch.from_numpy(
                self.rows(primes).astype(np.int32)).to(device)
        return self._rows[key]

    def plain_rows(self, primes: tuple[int, ...], device,
                   inverse: bool) -> tuple:
        """(twist, tw, q) rows of the plain tables for ``primes``."""
        t = self.plain_tables(device)
        r = torch.from_numpy(self.rows(primes)).to(device)
        d = "i" if inverse else "f"
        return t[f"twist_{d}"][r], t[f"tw_{d}"][r], t["q"][r]


# ------------------------------------------------------------ plain version
def ntt_dif_plain(x, twist, tw, q):
    """DIF forward NTT. x: (..., l, N) int64 natural coefficients;
    twist/tw: (l, N) normal-form tables; q: (l,).  Bit-reversed output."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    lead = x.shape[:-1]
    q1 = q[:, None]
    q3 = q[:, None, None]
    x = x * twist % q1
    for s in range(logn - 1, -1, -1):
        m = 1 << s
        xb = x.reshape(*lead, n // (2 * m), 2 * m)
        u, v = xb[..., :m], xb[..., m:]
        w = tw[:, None, m : 2 * m]
        x = torch.cat(
            [(u + v) % q3, (u + q3 - v) % q3 * w % q3], dim=-1
        ).reshape(*lead, n)
    return x


def ntt_dit_plain(x, twist, tw, q):
    """DIT inverse NTT: bit-reversed eval -> natural coefficients;
    twist = psi^-i * n^-1."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    lead = x.shape[:-1]
    q3 = q[:, None, None]
    for s in range(logn):
        m = 1 << s
        xb = x.reshape(*lead, n // (2 * m), 2 * m)
        u, v = xb[..., :m], xb[..., m:]
        vw = v * tw[:, None, m : 2 * m] % q3
        x = torch.cat([(u + vw) % q3, (u + q3 - vw) % q3], dim=-1
                      ).reshape(*lead, n)
    return x * twist % q[:, None]


def ntt_fwd_plain(x, twist, tw, q):
    """Natural coefficients -> natural eval order: DIF, then the gather."""
    return ntt_dif_plain(x, twist, tw, q)[
        ..., bitrev_index(x.shape[-1], x.device)]


def ntt_inv_plain(x, twist, tw, q):
    """Natural eval order -> natural coefficients: the gather, then DIT."""
    return ntt_dit_plain(x[..., bitrev_index(x.shape[-1], x.device)],
                         twist, tw, q)


# ------------------------------------------------------------ wrappers
def check_rows(kernel: str, x: torch.Tensor, l: int, n: int) -> None:
    if x.dtype != torch.int64:
        raise TypeError(f"{kernel}: residues must be int64, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] != l or x.shape[-1] != n:
        raise ValueError(f"{kernel}: expected (..., {l}, {n}), got "
                         f"{tuple(x.shape)}")


def _ntt(x, primes, tabs: NTTTables, inverse: bool):
    primes = tuple(primes)
    n = 1 << tabs.logn
    check_rows("ntt", x, len(primes), n)
    if x.device.type == "cpu":
        plain = ntt_inv_plain if inverse else ntt_fwd_plain
        return plain(x, *tabs.plain_rows(primes, x.device, inverse))
    native.check_cuda("ntt", x)
    t = tabs.mont_tables(x.device)
    d = "i" if inverse else "f"
    rows = x.numel() // n
    y = torch.empty_like(x)
    fn = "ntt_inverse" if inverse else "ntt_forward"
    native.call(
        "ntt", fn,
        native.ptr(x), native.ptr(y),
        native.ptr(t[f"twist_{d}"]), native.ptr(t[f"tw_{d}"]),
        native.ptr(tabs.row_map(primes, x.device)),
        native.ptr(t["q"]), native.ptr(t["qn"]),
        rows, len(primes), tabs.logn,
        cluster_bits(tabs.logn),
        shape=(fn, tuple(x.shape)),
    )
    return y


def ntt_fwd(x, primes, tabs: NTTTables):
    """(..., l, N) int64 natural coefficients -> natural eval order.
    ``primes`` may repeat (batched multi-poly transforms tile the limbs)."""
    return _ntt(x, primes, tabs, inverse=False)


def ntt_inv(x, primes, tabs: NTTTables):
    """(..., l, N) int64 natural eval order -> natural coefficients."""
    return _ntt(x, primes, tabs, inverse=True)
