"""Keyswitch inner product with the fused plaintext multiply: the CUDA
kernel's wrapper and its plain version.

Counterpart of the JAX package's ``kernels/fused_ip`` (``fused_ip_mont``,
``fused_ip_pallas``).  The JAX engine calls its kernel once per rotation
and sums outside; here the rotation axis is an operand and the kernel
sums inside:

    out[..., c, r] = sum_rot [pt[rot, r] *] sum_j digits[..., rot, j, r] * evk[rot, j, c, r]

On a CPU tensor ``fused_ip`` runs the plain version; on a CUDA tensor it
launches ``csrc/fused_ip.cu``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import native
from repro_torch.kernels.modops import as_u32, qinv_neg_host, r_pow_host

MAX_ROWS = 65535  # batch * l: one CUDA grid row per (batch, limb)


class IPConsts:
    """Moduli of one extended basis on one device."""

    def __init__(self, primes: tuple[int, ...], device):
        self.primes = tuple(primes)
        q = np.array(self.primes, dtype=np.int64)

        def dev(a):
            return torch.from_numpy(a).to(device)

        self.q = dev(q)
        self.q32 = dev(as_u32(q))
        self.qn32 = dev(as_u32([qinv_neg_host(p) for p in q]))
        # 2^64 / 2^96 mod q undo the one / two Montgomery reductions of a
        # sum without / with the plaintext multiply.
        self.fix = {False: dev(as_u32([r_pow_host(p, 2) for p in q])),
                    True: dev(as_u32([r_pow_host(p, 3) for p in q]))}


def fused_ip_plain(digits, evk, pt, q):
    """digits (..., R, dnum, l, N); evk (R | 1, dnum, 2, l, N); pt
    (R, l, N) or None; q (l,).  Returns (..., 2, l, N)."""
    qq = q[:, None]
    acc = None
    for rot in range(digits.shape[-4]):
        k = evk[rot if evk.shape[0] > 1 else 0]
        d = digits[..., rot, :, :, :]
        ip = None
        for j in range(d.shape[-3]):
            term = d[..., j : j + 1, :, :] * k[j] % qq      # (..., 2, l, N)
            ip = term if ip is None else (ip + term) % qq
        if pt is not None:
            ip = ip * pt[rot] % qq
        acc = ip if acc is None else (acc + ip) % qq
    return acc


def fused_ip(digits: torch.Tensor, evk: torch.Tensor, pt: torch.Tensor | None,
             c: IPConsts) -> torch.Tensor:
    """Inner product of ModUp digits with stacked evks, summed over the
    rotation axis; see the module docstring for shapes."""
    l = len(c.primes)
    if digits.dim() < 4 or digits.shape[-2] != l:
        raise ValueError(f"fused_ip: digits {tuple(digits.shape)} do not "
                         f"end in (R, dnum, {l}, N)")
    nrot, dnum, _, n = digits.shape[-4:]
    if evk.shape[0] not in (1, nrot) or tuple(evk.shape[1:]) != (dnum, 2, l, n):
        raise ValueError(f"fused_ip: evk {tuple(evk.shape)} does not match "
                         f"digits {tuple(digits.shape)}")
    if pt is not None and tuple(pt.shape) != (nrot, l, n):
        raise ValueError(f"fused_ip: pt {tuple(pt.shape)} is not "
                         f"{(nrot, l, n)}")
    for t in (digits, evk, pt):
        if t is not None and t.dtype != torch.int64:
            raise TypeError(f"fused_ip: residues must be int64, got {t.dtype}")
    if digits.device.type == "cpu":
        return fused_ip_plain(digits, evk, pt, c.q)
    native.check_cuda("fused_ip", digits, evk, pt)
    batch = digits.numel() // (nrot * dnum * l * n)
    if batch * l > MAX_ROWS:
        raise ValueError(f"fused_ip: {batch} x {l} rows, kernel takes at "
                         f"most {MAX_ROWS}")
    out = torch.empty(digits.shape[:-4] + (2, l, n), dtype=torch.int64,
                      device=digits.device)
    native.call(
        "fused_ip", "fused_ip", native.ptr(digits), native.ptr(evk),
        native.ptr(pt), native.ptr(out), native.ptr(c.q32),
        native.ptr(c.qn32), native.ptr(c.fix[pt is not None]), batch, nrot,
        int(evk.shape[0] == 1), dnum, l, n.bit_length() - 1,
        shape=("fused_ip", tuple(digits.shape)
               + (int(evk.shape[0]), int(pt is not None))),
    )
    return out
