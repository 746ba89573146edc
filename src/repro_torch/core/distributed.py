"""Distributed keyswitch: the paper's IRF-vs-EVF dataflow as a choice of
how to shard the keyswitch inner product over the ranks of a
``torch.distributed`` group.

Counterpart of the JAX package's ``core/distributed.py``, which shards
over a TPU mesh axis with ``shard_map``.  Here every rank calls the same
function on its own shard (SPMD), and the one collective is
``all_to_all_single``.

The inner product  acc_c[r] = sum_j digits[j, r, :] * evk[j, c, r, :]
is independent for every extended-basis limb r and coefficient.  Two
layouts over P ranks:

  IRF (intermediate results flow):
      the evk stays LIMB-SHARDED, (dnum, 2, L/P, N) on each rank: it
      never moves.  ModUp leaves the digits COEFFICIENT-SHARDED,
      (dnum, L, N/P); one all-to-all re-shards them by limb,
      (dnum, L/P, N), before the local product.  Output limb-sharded,
      (L/P, N) a component.
  EVF (evk flows):
      the digits stay coefficient-sharded; one all-to-all re-shards the
      evk by coefficient, (dnum, 2, L, N/P).  Output coefficient-sharded,
      (L, N/P) a component.

Each rank sends (P-1)/P of what it re-shards, so IRF moves
dnum * L * N * (P-1) / P^2 words a rank and EVF twice that: the two evk
components.  ``comm_bytes_per_device`` gives those volumes; every
``ShardedIP`` counts the bytes its all-to-alls actually send off the
rank, which ``measure_collectives`` reads.

The local product is the fused inner product at one rotation without a
plaintext (``kernels/fused_ip``): its CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor.  Any exact reduction gives the same
residues, so both equal ``reference_ip`` bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.fused_ip.ops import IPConsts, fused_ip

KINDS = ("IRF", "EVF")
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _primes(mods) -> tuple[int, ...]:
    """The moduli as Python ints, from a sequence, or an (L,) or (L, 1)
    array or tensor (the JAX package passes a column)."""
    if hasattr(mods, "reshape"):
        mods = mods.reshape(-1).tolist()
    return tuple(int(q) for q in mods)


def _local_ip(digits: torch.Tensor, evk: torch.Tensor, consts: IPConsts):
    """digits (dnum, l, n), evk (dnum, 2, l, n), the l moduli in
    ``consts`` -> (acc0, acc1), each (l, n)."""
    out = fused_ip(digits.contiguous()[None], evk.contiguous()[None], None,
                   consts)
    return out[0], out[1]


def reference_ip(digits: torch.Tensor, evk: torch.Tensor, mods):
    """Single-device oracle (same math, no group): digits (dnum, L, N),
    evk (dnum, 2, L, N), the L moduli."""
    return _local_ip(digits, evk, IPConsts(_primes(mods), digits.device))


class ShardedIP:
    """One sharded inner product, IRF or EVF, on the ranks of ``group``.

    Call it on every rank with the rank's shards and all L moduli:

    - IRF: digits (dnum, L, N/P), the rank's coefficients; evk
      (dnum, 2, L/P, N), the rank's limbs.  Returns (acc0, acc1), each
      (L/P, N): the rank's limbs.
    - EVF: the same inputs.  Returns (acc0, acc1), each (L, N/P): the
      rank's coefficients.

    ``bytes_sent`` and ``counts`` add up, per collective kind, the bytes
    this rank's collectives sent to other ranks and the collectives it
    entered."""

    def __init__(self, kind: str, group=None):
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        self.kind = kind
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.bytes_sent = dict.fromkeys(COLLECTIVES, 0)
        self.counts = dict.fromkeys(COLLECTIVES, 0)
        self._consts: dict[tuple, IPConsts] = {}

    def reset(self) -> None:
        for k in COLLECTIVES:
            self.bytes_sent[k] = 0
            self.counts[k] = 0

    def _ip_consts(self, primes: tuple[int, ...], device) -> IPConsts:
        key = (primes, str(device))
        if key not in self._consts:
            self._consts[key] = IPConsts(primes, device)
        return self._consts[key]

    def _all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send`` (P, ...) -> (P, ...): chunk p goes to rank p, and
        chunk q of the result came from rank q."""
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        self.counts["all-to-all"] += 1
        self.bytes_sent["all-to-all"] += (send.numel() * send.element_size()
                                          * (self.world - 1) // self.world)
        return recv

    def __call__(self, digits: torch.Tensor, evk: torch.Tensor, mods):
        P = self.world
        primes = _primes(mods)
        L = len(primes)
        dnum, l_d, n_loc = digits.shape
        if l_d != L or L % P:
            raise ValueError(f"{self.kind}: digits {tuple(digits.shape)} "
                             f"need L = {L} limbs, divisible by {P} ranks")
        n = n_loc * P
        if tuple(evk.shape) != (dnum, 2, L // P, n):
            raise ValueError(f"{self.kind}: evk {tuple(evk.shape)} is not "
                             f"the limb shard {(dnum, 2, L // P, n)}")
        lp = L // P
        if self.kind == "IRF":
            # split the limb axis, gather the coefficient axis
            send = digits.reshape(dnum, P, lp, n_loc).permute(1, 0, 2, 3)
            recv = self._all_to_all(send.contiguous())
            d = recv.permute(1, 2, 0, 3).reshape(dnum, lp, n)
            mine = primes[self.rank * lp:(self.rank + 1) * lp]
            return _local_ip(d, evk, self._ip_consts(mine, digits.device))
        # EVF: split the evk's coefficient axis, gather its limb axis
        send = evk.reshape(dnum, 2, lp, P, n_loc).permute(3, 0, 1, 2, 4)
        recv = self._all_to_all(send.contiguous())
        k = recv.permute(1, 2, 0, 3, 4).reshape(dnum, 2, L, n_loc)
        return _local_ip(digits, k, self._ip_consts(primes, digits.device))


def ip_irf(group=None) -> tuple[ShardedIP, int]:
    """IRF inner product on ``group`` (the default group if None) and the
    group's size.  The evk is limb-sharded and never moves; the digits
    cross the group once."""
    fn = ShardedIP("IRF", group)
    return fn, fn.world


def ip_evf(group=None) -> tuple[ShardedIP, int]:
    """EVF inner product on ``group`` and the group's size: the keys
    flow, re-sharded by coefficient to meet the stationary digits, twice
    IRF's bytes (both evk components move)."""
    fn = ShardedIP("EVF", group)
    return fn, fn.world


def measure_collectives(fn: ShardedIP, *args) -> dict:
    """Run ``fn(*args)`` once and return the bytes its collectives sent
    off this rank, per kind, in the JAX package's ``collective_bytes``
    layout: ``{"bytes": {kind: n}, "counts": {kind: n}, "total_bytes":
    n}``.  The JAX package parses compiled HLO; the port has none, so it
    counts what each ``all_to_all_single`` sends."""
    fn.reset()
    fn(*args)
    return {"bytes": dict(fn.bytes_sent), "counts": dict(fn.counts),
            "total_bytes": sum(fn.bytes_sent.values())}


def comm_bytes_per_device(kind: str, dnum: int, ext: int, n: int,
                          p: int, word_bytes: int = 8) -> float:
    """Exact per-device interconnect bytes of one inner product.

    IRF: the digit tensor crosses the group once (all_to_all),
    EVF: both evk components cross (all_to_all) -- 2x IRF, the paper's
    Fig. 3 single-keyswitch trade-off.  A hoisted PKB with r rotations
    pays IRF ONCE for all r (digits shared) but EVF r times (distinct
    keys), which is why hoisting flips the preferred dataflow."""
    moved = {"IRF": dnum * ext * n, "EVF": dnum * 2 * ext * n}[kind]
    return moved * (p - 1) / p * word_bytes / p
