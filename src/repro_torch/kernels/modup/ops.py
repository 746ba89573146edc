"""One digit's fused ModUp: constants, the CUDA kernel's wrapper and its
plain version.

Counterpart of the JAX package's ``kernels/modup`` (``ModUpDigitConsts``,
``modup_digit``, ``modup_pallas``): INTT of the ls source limbs with the
BConv scale ``qhat_inv_i`` folded into the post-twist, tree-reduce into
each of the ld destination limbs, forward NTT.  Input and output are in
bit-reversed eval order.

On a CPU tensor ``modup_digit`` runs the plain version; on a CUDA tensor
it launches ``csrc/modup.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.core.rns import RNSContext
from repro_torch.kernels import native
from repro_torch.kernels.modops import as_u32, to_mont_host
from repro_torch.kernels.ntt.ops import (
    CHUNK_BITS, NTTTables, check_rows, ntt_fwd_plain, ntt_inv_plain,
)


class ModUpDigitConsts:
    """Per-(source digit, destination basis) tables on one device.

    The normal-form tables (plain version) and the Montgomery ones
    (kernel) are each built on first use."""

    def __init__(self, rns: RNSContext, tabs: NTTTables,
                 src: tuple[int, ...], dst: tuple[int, ...], device):
        self.src, self.dst = tuple(src), tuple(dst)
        self.ls, self.ld = len(src), len(dst)
        self.logn = tabs.logn
        self.tabs = tabs
        self.device = torch.device(device)
        qhat_inv, self.qhat_mod_np = rns.bconv_consts(self.src, self.dst)
        self.rs = tabs.rows(self.src)
        self.rd = tabs.rows(self.dst)
        q_src = tabs.q[self.rs][:, None]
        self.twist_i_scaled_np = tabs.twist_i[self.rs] * qhat_inv[:, None] % q_src
        self._plain = None
        self._mont = None

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

    def mont(self) -> dict:
        if self._mont is None:
            t, dev = self.tabs, self.device
            q_src = t.q[self.rs][:, None]
            q_dst = t.q[self.rd][None, :]
            self._mont = {
                "twist_i": torch.from_numpy(as_u32(to_mont_host(
                    self.twist_i_scaled_np, q_src))).to(dev),
                "cm": torch.from_numpy(as_u32(to_mont_host(
                    self.qhat_mod_np, q_dst))).to(dev),
                "src_map": t.row_map(self.src, dev),
                "dst_map": t.row_map(self.dst, dev),
            }
        return self._mont


def modup_digit_plain(x, twist_i, tw_i, q_src, qhat_mod, twist_f, tw_f, q_dst):
    """(..., ls, N) int64 bit-reversed eval -> (..., ld, N) bit-reversed
    eval; normal-form tables, ``twist_i`` with the BConv scale folded in."""
    t = ntt_inv_plain(x, twist_i, tw_i, q_src)
    d = q_dst[:, None]
    acc = torch.zeros(x.shape[:-2] + (len(q_dst), x.shape[-1]),
                      dtype=torch.int64, device=x.device)
    for i in range(t.shape[-2]):
        acc = (acc + t[..., i : i + 1, :] * qhat_mod[i][:, None] % d) % d
    return ntt_fwd_plain(acc, twist_f, tw_f, q_dst)


def modup_digit(x: torch.Tensor, c: ModUpDigitConsts) -> torch.Tensor:
    """(..., ls, N) int64 bit-reversed eval -> (..., ld, N) bit-reversed
    eval under the destination basis."""
    n = 1 << c.logn
    check_rows("modup", x, c.ls, n)
    if x.device.type == "cpu":
        return modup_digit_plain(x, **c.plain())
    native.check_cuda("modup", x)
    m = c.mont()
    t = c.tabs.mont_tables(x.device)
    batch = x.numel() // (c.ls * n)
    y = torch.empty(x.shape[:-2] + (c.ld, n), dtype=torch.int64,
                    device=x.device)
    t_src = torch.empty((batch, c.ls, n), dtype=torch.int32, device=x.device)
    work = (torch.empty((batch, c.ld, n), dtype=torch.int32, device=x.device)
            if c.logn > CHUNK_BITS else None)
    native.call(
        "modup", "modup_digit", native.ptr(x), native.ptr(y),
        native.ptr(t_src), native.ptr(work), native.ptr(m["twist_i"]),
        native.ptr(t["tw_i"]), native.ptr(m["src_map"]), native.ptr(m["cm"]),
        native.ptr(t["twist_f"]), native.ptr(t["tw_f"]),
        native.ptr(m["dst_map"]), native.ptr(t["q"]), native.ptr(t["qn"]),
        batch, c.ls, c.ld, c.logn,
    )
    return y
