"""Negacyclic NTT: tables, the CUDA kernel's wrapper and its plain version.

Counterpart of the JAX package's ``kernels/ntt`` (``NTTKernelTables``,
``ntt_fwd`` / ``ntt_inv``, ``ntt_pallas``).  Forward maps natural
coefficient order to bit-reversed evaluation order (DIF); inverse maps
back (DIT).  Twiddles use the flat tree layout ``tw[m + j]``.

Residues are int64 tensors of shape ``(..., l, N)``.  On a CPU tensor the
wrappers run the plain version; on a CUDA tensor they launch
``csrc/ntt.cu``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rns import RNSContext
from repro_torch.kernels import native
from repro_torch.kernels.modops import as_u32, qinv_neg_host, to_mont_host

# logN above which the kernel splits a transform in two launches and
# needs a 32-bit workspace (``kChunkBits`` in ``csrc/ntt_device.cuh``).
CHUNK_BITS = 11


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
def ntt_fwd_plain(x, twist, tw, q):
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


def ntt_inv_plain(x, twist, tw, q):
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
    y = torch.empty_like(x)
    work = (torch.empty(x.shape, dtype=torch.int32, device=x.device)
            if tabs.logn > CHUNK_BITS else None)
    native.call(
        "ntt", "ntt_inverse" if inverse else "ntt_forward",
        native.ptr(x), native.ptr(y), native.ptr(work),
        native.ptr(t[f"twist_{d}"]), native.ptr(t[f"tw_{d}"]),
        native.ptr(tabs.row_map(primes, x.device)),
        native.ptr(t["q"]), native.ptr(t["qn"]),
        x.numel() // n, len(primes), tabs.logn,
    )
    return y


def ntt_fwd(x, primes, tabs: NTTTables):
    """(..., l, N) int64 natural coefficients -> bit-reversed eval order.
    ``primes`` may repeat (batched multi-poly transforms tile the limbs)."""
    return _ntt(x, primes, tabs, inverse=False)


def ntt_inv(x, primes, tabs: NTTTables):
    """(..., l, N) int64 bit-reversed eval -> natural coefficients."""
    return _ntt(x, primes, tabs, inverse=True)
