"""ModUp of every digit at once: constants, the CUDA kernel's wrapper and
its plain version.

Counterpart of the JAX package's ``kernels/modup`` (``ModUpDigitConsts``,
``modup_digit``, ``modup_pallas``) and of the JAX engine's ``_modup``
around it: each digit's source limbs go through an INTT with the BConv
scale ``qhat_inv_i`` folded into the post-twist, a tree-reduce into every
other limb of the extended basis, and a forward NTT; the digit's own
limbs pass through.  ``modup`` takes ``(..., l, N)`` and returns
``(..., dnum, l_ext, N)``, natural eval order at both ends.

On a CPU tensor ``modup`` runs the plain version (per digit, in the
reference's bit-reversed order, bridged by two gathers); on a CUDA tensor
it launches ``csrc/modup.cu``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rns import RNSContext
from repro_torch.kernels import native
from repro_torch.kernels.modops import as_u32, to_mont_host
from repro_torch.kernels.ntt.ops import (
    NTTTables, bitrev_index, check_rows, cluster_bits, ntt_dif_plain,
    ntt_dit_plain,
)


class ModUpDigitConsts:
    """Normal-form tables of one (source digit, destination basis) pair,
    for the plain version."""

    def __init__(self, rns: RNSContext, tabs: NTTTables,
                 src: tuple[int, ...], dst: tuple[int, ...], device):
        self.src, self.dst = tuple(src), tuple(dst)
        self.ls, self.ld = len(src), len(dst)
        self.tabs = tabs
        self.device = torch.device(device)
        qhat_inv, self.qhat_mod_np = rns.bconv_consts(self.src, self.dst)
        self.rs = tabs.rows(self.src)
        self.rd = tabs.rows(self.dst)
        q_src = tabs.q[self.rs][:, None]
        self.twist_i_scaled_np = tabs.twist_i[self.rs] * qhat_inv[:, None] % q_src
        self._plain = None

    def plain(self) -> dict:
        if self._plain is None:
            t, dev = self.tabs, self.device
            self._plain = {
                k: torch.from_numpy(v).to(dev) for k, v in {
                    "twist_i": self.twist_i_scaled_np,
                    "tw_i": t.tw_i[self.rs], "q_src": t.q[self.rs],
                    "qhat_mod": self.qhat_mod_np,
                    "twist_f": t.twist_f[self.rd], "tw_f": t.tw_f[self.rd],
                    "q_dst": t.q[self.rd],
                }.items()
            }
        return self._plain


def modup_digit_plain(x, twist_i, tw_i, q_src, qhat_mod, twist_f, tw_f, q_dst):
    """One digit, as the reference's ``modup_digit``: (..., ls, N) int64
    bit-reversed eval -> (..., ld, N) bit-reversed eval; normal-form
    tables, ``twist_i`` with the BConv scale folded in."""
    t = ntt_dit_plain(x, twist_i, tw_i, q_src)
    d = q_dst[:, None]
    acc = torch.zeros(x.shape[:-2] + (len(q_dst), x.shape[-1]),
                      dtype=torch.int64, device=x.device)
    for i in range(t.shape[-2]):
        acc = (acc + t[..., i : i + 1, :] * qhat_mod[i][:, None] % d) % d
    return ntt_dif_plain(acc, twist_f, tw_f, q_dst)


class ModUpConsts:
    """All digits of one level's ModUp on one device.

    ``groups`` split ``base`` (the level's chain) into digits, the last
    one possibly short; ``ext`` is the extended basis (base then P).  The
    per-digit normal-form tables (plain version) and the Montgomery ones
    (kernel) are each built on first use."""

    def __init__(self, rns: RNSContext, tabs: NTTTables,
                 groups: list[tuple[int, ...]], base: tuple[int, ...],
                 ext: tuple[int, ...], device):
        self.rns, self.tabs = rns, tabs
        self.groups = [tuple(D) for D in groups]
        self.base, self.ext = tuple(base), tuple(ext)
        self.l, self.l_ext = len(self.base), len(self.ext)
        self.dnum = len(self.groups)
        self.alpha = max(len(D) for D in self.groups)
        self.logn = tabs.logn
        self.device = torch.device(device)
        starts = np.cumsum([0] + [len(D) for D in self.groups])
        self.rows = list(zip(starts[:-1].tolist(), starts[1:].tolist()))
        # input row passed through to (digit, ext limb), or -1
        pos = {p: i for i, p in enumerate(self.base)}
        self.own_np = np.array(
            [[pos[p] if p in D else -1 for p in self.ext] for D in self.groups],
            dtype=np.int64)
        self.digit_np = np.array([(r0, r1 - r0) for r0, r1 in self.rows],
                                 dtype=np.int64)
        self._digits = None
        self._plain = None
        self._mont = None

    def digits(self) -> list[ModUpDigitConsts]:
        if self._digits is None:
            self._digits = [
                ModUpDigitConsts(self.rns, self.tabs, D, self.ext, self.device)
                for D in self.groups
            ]
        return self._digits

    def plain(self) -> dict:
        if self._plain is None:
            own = torch.from_numpy(self.own_np).to(self.device)
            self._plain = {"own_idx": own.clamp(min=0), "own_mask": own >= 0}
        return self._plain

    def mont(self) -> dict:
        if self._mont is None:
            t, dev = self.tabs, self.device
            digs = self.digits()
            twist = np.concatenate([c.twist_i_scaled_np for c in digs])
            q_src = t.q[t.rows(self.base)][:, None]
            q_ext = t.q[t.rows(self.ext)][None, :]
            cm = np.zeros((self.dnum, self.alpha, self.l_ext), np.int64)
            for d, c in enumerate(digs):
                cm[d, : c.ls] = to_mont_host(c.qhat_mod_np, q_ext)
            self._mont = {
                "twist_i": torch.from_numpy(as_u32(to_mont_host(
                    twist, q_src))).to(dev),
                "cm": torch.from_numpy(as_u32(cm)).to(dev),
                "own": torch.from_numpy(self.own_np.astype(np.int32)).to(dev),
                "digit": torch.from_numpy(
                    self.digit_np.astype(np.int32)).to(dev),
                "src_map": t.row_map(self.base, dev),
                "dst_map": t.row_map(self.ext, dev),
            }
        return self._mont


def modup_plain(x: torch.Tensor, c: ModUpConsts) -> torch.Tensor:
    """(..., l, N) natural eval -> (..., dnum, l_ext, N) natural eval: the
    per-digit reference body, bridged to natural order by one gather at
    each end, own limbs passed through."""
    br = bitrev_index(x.shape[-1], x.device)
    xb = x[..., br]
    conv = torch.stack([
        modup_digit_plain(xb[..., r0:r1, :], **dc.plain())
        for (r0, r1), dc in zip(c.rows, c.digits())
    ], dim=-3)[..., br]
    p = c.plain()
    return torch.where(p["own_mask"][:, :, None], x[..., p["own_idx"], :],
                       conv)


def modup(x: torch.Tensor, c: ModUpConsts) -> torch.Tensor:
    """(..., l, N) int64 natural eval -> (..., dnum, l_ext, N) natural eval
    under the extended basis, every digit in one call."""
    n = 1 << c.logn
    check_rows("modup", x, c.l, n)
    if x.device.type == "cpu":
        return modup_plain(x, c)
    native.check_cuda("modup", x)
    m = c.mont()
    t = c.tabs.mont_tables(x.device)
    batch = x.numel() // (c.l * n)
    y = torch.empty(x.shape[:-2] + (c.dnum, c.l_ext, n), dtype=torch.int64,
                    device=x.device)
    work = torch.empty((batch, c.l, n), dtype=torch.int32, device=x.device)
    native.call(
        "modup", "modup_all", native.ptr(x), native.ptr(y), native.ptr(work),
        native.ptr(m["twist_i"]), native.ptr(t["tw_i"]),
        native.ptr(m["src_map"]), native.ptr(m["cm"]), native.ptr(m["own"]),
        native.ptr(m["digit"]), native.ptr(t["twist_f"]),
        native.ptr(t["tw_f"]), native.ptr(m["dst_map"]), native.ptr(t["q"]),
        native.ptr(t["qn"]), batch, c.l, c.l_ext, c.dnum, c.alpha, c.logn,
        cluster_bits(c.logn),
        shape=("modup_all", tuple(x.shape)),
    )
    return y
