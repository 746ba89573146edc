"""Fast basis conversion: constants, the CUDA kernel's wrapper and its
plain version.

Counterpart of the JAX package's ``kernels/bconv`` (``BConvKernelConsts``,
``bconv_kernel``, ``bconv_pallas``):

    t_i = x_i * qhat_inv_i mod q_i;   y_j = sum_i t_i * (qhat_i mod d_j) mod d_j

On a CPU tensor ``bconv`` runs the plain version; on a CUDA tensor it
launches ``csrc/bconv.cu`` once, with the launch geometry that
``geometry`` picks here.  The kernel takes any number of source rows
(``CHUNK`` at a time) and an operand that is 8- but not 16-byte
aligned; it refuses primes from 2^30 up, as the reference's Montgomery
arithmetic does (``src/repro/kernels/modops.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.rns import RNSContext
from repro_torch.kernels import native
from repro_torch.kernels.modops import (
    as_u32, lazy_terms, qinv_neg_host, to_mont_host,
)
from repro_torch.kernels.ntt.ops import MAX_PRIME, check_rows

CHUNK = 32  # ``kChunk`` in csrc/bconv.cu: source rows in shared memory
COLS = 2  # ``kCols``: columns a thread, one 16-byte load or store a row
MAX_THREADS = 512  # ``kMaxThreads``
GROUP_ROWS = (2, 4, 6, 9)  # the instantiations of ``bconv_kernel<G>``


class Geometry(NamedTuple):
    """One launch of ``blocks`` = batch * tiles blocks of ``threads``.
    Block ``k`` converts column tile ``k % tiles`` (``lanes`` pairs of
    columns) of batch row ``k // tiles``; its thread ``h`` owns pair
    ``h % lanes`` of the tile and destination rows ``g * s`` to
    ``g * s + g - 1`` for every group ``s`` = ``h // lanes`` +
    ``threads // lanes`` * m below ``groups``."""
    g: int
    lanes: int
    threads: int
    tiles: int
    groups: int
    blocks: int


def geometry(batch: int, ls: int, ld: int, logn: int, g: int | None = None,
             lanes: int | None = None) -> Geometry:
    """The launch ``bconv`` makes for (batch, ls, N) -> (batch, ld, N):
    groups of 9 destination rows (the smallest instantiation that holds
    ld when ld is smaller), a warp of lanes a tile, and every group of
    the tile side by side in one block, as far as 512 threads hold them;
    ``g`` and ``lanes`` override the choice (``tools/ntt_study.py``).
    Groups of 9 and a warp a tile were the fastest at the ModDown and the
    rescale shapes on the H100 (PERF.md, `tools/ntt_study.py --bconv`)."""
    g = g or next(c for c in GROUP_ROWS if c >= min(9, ld))
    pairs = (1 << logn) // COLS
    lanes = min(lanes or 32, pairs)
    groups = -(-ld // g)
    threads = lanes * min(groups, MAX_THREADS // lanes)
    tiles = pairs // lanes
    return Geometry(g, lanes, threads, tiles, groups, batch * tiles)


class BConvConsts:
    """src -> dst conversion constants on one device."""

    def __init__(self, rns: RNSContext, src: tuple[int, ...],
                 dst: tuple[int, ...], device):
        qhat_inv, qhat_mod = rns.bconv_consts(tuple(src), tuple(dst))
        self.src, self.dst = tuple(src), tuple(dst)
        self.ls, self.ld = len(src), len(dst)
        self.logn = rns.params.logN
        self.max_prime = max(self.src + self.dst)
        # source rows a 64-bit sum takes before one reduction
        self.g_acc = lazy_terms(self.src)

        def dev(a):
            return torch.from_numpy(a).to(device)

        sq = rns.moduli[rns.limb_ids(self.src)]
        dq = rns.moduli[rns.limb_ids(self.dst)]
        # normal form, for the plain version
        self.qhat_inv = dev(qhat_inv)
        self.qhat_mod = dev(qhat_mod)
        self.src_q = dev(sq)
        self.dst_q = dev(dq)
        # Montgomery form (int32 storage of 32-bit words), for the kernel
        self.qhat_inv_m = dev(as_u32(to_mont_host(qhat_inv, sq)))
        self.cm = dev(as_u32(to_mont_host(qhat_mod, dq[None, :])))
        self.src_q32 = dev(as_u32(sq))
        self.src_qn32 = dev(as_u32([qinv_neg_host(q) for q in sq]))
        self.dst_q32 = dev(as_u32(dq))
        self.dst_qn32 = dev(as_u32([qinv_neg_host(q) for q in dq]))


def bconv_plain(x, qhat_inv, src_q, qhat_mod, dst_q):
    """(..., ls, N) int64 -> (..., ld, N); normal-form constants."""
    t = x * qhat_inv[:, None] % src_q[:, None]
    d = dst_q[:, None]
    acc = torch.zeros(x.shape[:-2] + (len(dst_q), x.shape[-1]),
                      dtype=torch.int64, device=x.device)
    for i in range(t.shape[-2]):
        acc = (acc + t[..., i : i + 1, :] * qhat_mod[i][:, None] % d) % d
    return acc


def bconv(x: torch.Tensor, c: BConvConsts) -> torch.Tensor:
    """(..., ls, N) int64 coefficient domain -> (..., ld, N)."""
    n = 1 << c.logn
    check_rows("bconv", x, c.ls, n)
    if x.device.type == "cpu":
        return bconv_plain(x, c.qhat_inv, c.src_q, c.qhat_mod, c.dst_q)
    native.check_cuda("bconv", x)
    if c.max_prime >= MAX_PRIME:
        raise ValueError(f"bconv: prime {c.max_prime} is not below 2^30")
    batch = x.numel() // (c.ls * n)
    geo = geometry(batch, c.ls, c.ld, c.logn)
    y = torch.empty(x.shape[:-2] + (c.ld, n), dtype=torch.int64,
                    device=x.device)
    native.call(
        "bconv", "bconv", native.ptr(x), native.ptr(y),
        native.ptr(c.qhat_inv_m), native.ptr(c.src_q32),
        native.ptr(c.src_qn32), native.ptr(c.cm), native.ptr(c.dst_q32),
        native.ptr(c.dst_qn32), batch, c.ls, c.ld, c.logn, c.g_acc, geo.g,
        geo.lanes, geo.threads, geo.tiles, geo.groups,
        shape=("bconv", tuple(x.shape[:-2]) + (c.ls, c.ld)),
    )
    return y
