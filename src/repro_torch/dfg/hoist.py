"""Hoisting cost/lowering model: exact word-level volumes per PKB.

For a PKB at level l-1 (l limbs, ext = l + k extended limbs, dnum digits,
n rotations, in-degree di, out-degree do):

  baseline (per-rotation keyswitch):   n ModUps, n ModDowns, n IPs
  hoisted  (Bossuat double hoisting):  di ModUps, do ModDowns, n IPs,
                                       region EWOs shifted to ext domain

Communication (IRF dataflow, paper Sec. III-B):
  up   (xPU->xMU): ModUp outputs      — dnum*ext*N words per ModUp
  down (xMU->xPU): IP accumulations   — 2*ext*N words per ModDown point

EVF instead loads evks on-chip: dnum*2*ext*N words per distinct evk.
Min-KS serializes rotations into uniform power-of-two hops (popcount of
the step) to reuse a small evk set — fewer keys, more keyswitches.
"""
from __future__ import annotations

import dataclasses

from repro_torch.dfg.graph import DFG, OpKind
from repro_torch.dfg.pkb import PKB


@dataclasses.dataclass
class OpVolumes:
    """Word-level volumes (words = one RNS residue of one coefficient)."""

    ntt_words: float = 0.0      # NTT + INTT butterfly passes
    bconv_macs: float = 0.0     # BConv multiply-accumulates
    # phase attribution of the xPU work (ModUp legs run before the
    # up-link transfer; ModDown legs after the down-link) — the group
    # scheduler needs the split, the analytic model only the totals
    modup_ntt_words: float = 0.0
    modup_bconv_macs: float = 0.0
    moddown_ntt_words: float = 0.0
    moddown_bconv_macs: float = 0.0
    ip_macs: float = 0.0        # IP multiply-accumulates (xMU)
    ewo_words: float = 0.0      # program EWOs (xMU under IRF, else xPU)
    xpu_ewo_words: float = 0.0  # ModDown-internal sub/scale (always xPU)
    ewo_ext_words: float = 0.0  # EWO words shifted to extended domain
    autom_words: float = 0.0
    comm_up_words: float = 0.0      # xPU -> xMU (IRF)
    comm_down_words: float = 0.0    # xMU -> xPU (IRF)
    evk_load_words: float = 0.0     # EVF on-chip evk traffic
    evk_set_words: float = 0.0      # evk working set (storage, xMU HBM)
    modup_count: int = 0
    moddown_count: int = 0
    ip_count: int = 0
    keyswitch_count: int = 0
    relin_count: int = 0        # relinearization keyswitches (CMults)
    # Per-digit ModUp leg volumes — ((ntt_words, bconv_macs), ...) one
    # entry per decomposition digit, derived from the same (dnum, l_ext,
    # N) shapes the keyswitch engine's plans use.  The group scheduler
    # weights its up-phase xPU slices by these instead of a uniform
    # split; blocks of differing dnum drop the legs when summed.
    modup_legs: tuple = ()
    # Per-digit ModDown leg volumes — ((ntt_words, bconv_macs,
    # ewo_words), ...), one entry per decomposition digit.  The IP
    # accumulation streams back digit-by-digit in the same group order
    # the ModUp went up, so the down-phase xPU work (INTT of the
    # returned slice + BConv + subtract/scale) is attributable to the
    # digit whose base limbs it restores.
    moddown_legs: tuple = ()

    _LEG_FIELDS = ("modup_legs", "moddown_legs")

    def __add__(self, o: "OpVolumes") -> "OpVolumes":
        out = OpVolumes(*[
            getattr(self, f.name) + getattr(o, f.name)
            for f in dataclasses.fields(self)
            if f.name not in self._LEG_FIELDS
        ])
        for name in self._LEG_FIELDS:
            setattr(out, name,
                    _merge_legs(getattr(self, name), getattr(o, name)))
        return out

    def scaled(self, c: float) -> "OpVolumes":
        out = OpVolumes(*[
            getattr(self, f.name) * c
            for f in dataclasses.fields(self)
            if f.name not in self._LEG_FIELDS
        ])
        for name in self._LEG_FIELDS:
            setattr(out, name, tuple(
                tuple(x * c for x in leg) for leg in getattr(self, name)
            ))
        return out

    @property
    def compute_words(self) -> float:
        return (self.ntt_words + self.bconv_macs + self.ip_macs
                + self.ewo_words + self.ewo_ext_words + self.autom_words)

    @property
    def comm_words(self) -> float:
        return self.comm_up_words + self.comm_down_words


def _merge_legs(a: tuple, b: tuple) -> tuple:
    """Elementwise sum of per-digit legs (any leg arity); blocks of
    differing dnum (or a legless operand with real volumes) cannot be
    attributed per digit."""
    if not a:
        return b
    if not b:
        return a
    if len(a) != len(b):
        return ()
    return tuple(
        tuple(x + y for x, y in zip(ea, eb)) for ea, eb in zip(a, b)
    )


def _region_ewo_count(pkb: PKB) -> int:
    return sum(
        1 for nid in pkb.region
        if pkb.dfg.nodes[nid].op in (OpKind.PMUL, OpKind.CADD, OpKind.CSUB,
                                     OpKind.CSCALE, OpKind.PADD)
    )


def modup_volumes(l: int, k: int, alpha: int, N: int) -> OpVolumes:
    """One ModUp of an l-limb polynomial to the (l+k)-limb basis."""
    dnum = -(-l // alpha)
    ext = l + k
    v = OpVolumes()
    v.ntt_words = l * N + dnum * max(ext - alpha, 0) * N  # INTT + NTT legs
    v.bconv_macs = sum(
        min(alpha, l - g * alpha) * (ext - min(alpha, l - g * alpha)) * N
        for g in range(dnum)
    )
    v.modup_ntt_words = v.ntt_words
    v.modup_bconv_macs = v.bconv_macs
    v.modup_count = 1
    # per-digit legs: digit g INTTs its own a_g limbs and NTTs the ext-a_g
    # new limbs — exactly the engine plan's (dnum, l_ext, N) shape with a
    # short last group when alpha does not divide l
    v.modup_legs = tuple(
        (
            (min(alpha, l - g * alpha)
             + (ext - min(alpha, l - g * alpha))) * N,
            min(alpha, l - g * alpha) * (ext - min(alpha, l - g * alpha))
            * N,
        )
        for g in range(dnum)
    )
    return v


def moddown_volumes(l: int, k: int, alpha: int, N: int,
                    components: int = 2) -> OpVolumes:
    """ModDown of `components` polynomials from (l+k) limbs back to l."""
    v = OpVolumes()
    v.ntt_words = components * (k * N + l * N)   # INTT(P part) + NTT back
    v.bconv_macs = components * k * l * N
    v.xpu_ewo_words = components * 2 * l * N     # subtract + scale
    v.moddown_ntt_words = v.ntt_words
    v.moddown_bconv_macs = v.bconv_macs
    v.moddown_count = components // 2 if components >= 2 else 1
    # per-digit legs: the IP accumulation streams back in the same digit
    # order it went up, so digit g's returned slice restores its own a_g
    # base limbs — NTT back (a_g rows) plus its share a_g/l of the P-part
    # INTT, BConv into a_g limbs, and the subtract/scale EWO on them.
    # Legs sum exactly to (ntt_words, bconv_macs, xpu_ewo_words).
    dnum = -(-l // alpha)
    v.moddown_legs = tuple(
        (
            components * (min(alpha, l - g * alpha) * N
                          + k * N * min(alpha, l - g * alpha) / l),
            components * k * min(alpha, l - g * alpha) * N,
            components * 2 * min(alpha, l - g * alpha) * N,
        )
        for g in range(dnum)
    )
    return v


def ip_volumes(l: int, k: int, alpha: int, N: int) -> OpVolumes:
    """One rotation's inner product over the extended basis (2 comps)."""
    dnum = -(-l // alpha)
    ext = l + k
    v = OpVolumes()
    v.ip_macs = dnum * ext * N * 2
    v.ip_count = 1
    return v


def evk_words(l: int, k: int, alpha: int, N: int) -> int:
    dnum = -(-l // alpha)
    return dnum * 2 * (l + k) * N


def _minks_hops(steps: list[int], nh: int) -> int:
    """Min-KS keyswitch count.

    Min-KS's primary effect is evk-set reduction (uniform step keys);
    with the BSGS-structured baselines (bs=4, Fig. 7a) the steps are
    already single-hop decomposable with composite keys, so the
    keyswitch count stays ~n.  The parallelism penalty shows up via the
    PKB structure (Fig. 6), not raw counts.
    """
    return len(steps)


def pkb_volumes(pkb: PKB, k: int, alpha: int, strategy: str = "hoist",
                dataflow: str = "IRF", nh: int = 1 << 15) -> OpVolumes:
    """Total volumes for one PKB under a strategy x dataflow choice.

    strategy: 'minks' | 'plain' | 'hoist'
    dataflow: 'IRF' | 'EVF'
    """
    dfg = pkb.dfg
    N = dfg.N
    l = pkb.limbs
    ext = l + k
    n = pkb.n_rot
    di, do = pkb.indeg, pkb.outdeg
    ewo_n = _region_ewo_count(pkb)

    v = OpVolumes()
    if strategy == "hoist":
        for _ in range(di):
            v = v + modup_volumes(l, k, alpha, N)
        v = v + moddown_volumes(l, k, alpha, N, components=2 * do)
        for _ in range(n):
            v = v + ip_volumes(l, k, alpha, N)
        dnum = -(-l // alpha)
        v.autom_words = n * (dnum * ext + l) * N   # ext digits + c0 at base
        v.ewo_ext_words = ewo_n * ext * N * 2
        v.keyswitch_count = n
        distinct = len(set(pkb.steps))
        v.evk_set_words = distinct * evk_words(l, k, alpha, N)
        if dataflow == "IRF":
            dnum = -(-l // alpha)
            v.comm_up_words = di * dnum * ext * N
            v.comm_down_words = do * 2 * ext * N
        else:
            v.evk_load_words = distinct * evk_words(l, k, alpha, N)
    else:
        hops = _minks_hops(pkb.steps, nh) if strategy == "minks" else n
        for _ in range(hops):
            v = v + modup_volumes(l, k, alpha, N)
            v = v + moddown_volumes(l, k, alpha, N, components=2)
            v = v + ip_volumes(l, k, alpha, N)
        v.autom_words = hops * 2 * l * N
        v.ewo_words = ewo_n * l * N * 2
        v.keyswitch_count = hops
        if strategy == "minks":
            # uniform power-of-two hop keys actually used
            bits = set()
            for s in pkb.steps:
                s = s % nh
                bits |= {i for i in range(max(s.bit_length(), 1))
                         if s >> i & 1}
            n_evk = max(len(bits), 1)
        else:
            n_evk = len(set(pkb.steps))
        v.evk_set_words = n_evk * evk_words(l, k, alpha, N)
        if dataflow == "IRF":
            dnum = -(-l // alpha)
            v.comm_up_words = hops * dnum * ext * N
            v.comm_down_words = hops * 2 * ext * N
        else:
            v.evk_load_words = hops * evk_words(l, k, alpha, N)
    return v


def non_pkb_blocks(dfg: DFG, pkbs: list[PKB], k: int, alpha: int,
                   dataflow: str = "IRF") -> tuple[list[OpVolumes], OpVolumes]:
    """Per-keyswitch volumes for CMULT/CONJ outside PKBs + residual EWOs."""
    in_pkb: set[int] = set()
    for p in pkbs:
        in_pkb |= set(p.rotations) | p.region
    N = dfg.N
    blocks: list[OpVolumes] = []
    residual = OpVolumes()
    for nid, node in dfg.nodes.items():
        if nid in in_pkb:
            continue
        l = node.limbs
        if node.op in (OpKind.CMULT, OpKind.CONJ):
            v = (modup_volumes(l, k, alpha, N)
                 + moddown_volumes(l, k, alpha, N, 2)
                 + ip_volumes(l, k, alpha, N))
            if node.op == OpKind.CMULT:
                v.ewo_words += 4 * l * N
                v.relin_count += 1
            v.keyswitch_count += 1
            v.evk_set_words = evk_words(l, k, alpha, N)
            if dataflow == "IRF":
                dnum = -(-l // alpha)
                v.comm_up_words += dnum * (l + k) * N
                v.comm_down_words += 2 * (l + k) * N
            else:
                v.evk_load_words += evk_words(l, k, alpha, N)
            blocks.append(v)
        elif node.op in (OpKind.PMUL, OpKind.CADD, OpKind.CSUB,
                         OpKind.CSCALE, OpKind.PADD, OpKind.RESCALE):
            residual.ewo_words += 2 * l * N
            if node.op == OpKind.RESCALE:
                residual.ntt_words += 2 * N
    return blocks, residual


def program_volumes(dfg: DFG, pkbs: list[PKB], k: int, alpha: int,
                    strategy: str = "hoist", dataflow: str = "IRF",
                    nh: int = 1 << 15) -> OpVolumes:
    """Whole-program volumes: PKBs + non-PKB keyswitches (CMULT relin) +
    standalone EWOs (the latter two via :func:`non_pkb_blocks`, the same
    per-block assembly the simulator schedules)."""
    total = OpVolumes()
    for p in pkbs:
        total = total + pkb_volumes(p, k, alpha, strategy, dataflow, nh)
    blocks, residual = non_pkb_blocks(dfg, pkbs, k, alpha, dataflow)
    for v in blocks:
        total = total + v
    return total + residual
