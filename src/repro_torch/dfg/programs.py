"""Benchmark CKKS program (DFG) generators.

These produce operator-level DFGs with the PKB structure of the paper's
four benchmarks (Sec. VI-B).  Counts follow the cited implementations:

  bootstrapping [6,25]: fully-packed, FFT-like C2S/S2C in 3 merged stages
      (radix 2^5 at nh = 2^15 -> ~31 rotations per stage), conj split,
      EvalMod as a degree-63 sine Chebyshev (log-depth CMULT ladder).
  HELR [21]: batch-1024 logistic regression iteration — rotation-sum
      reductions are SERIAL parallelism-1 PKBs (why Fig. 6 shows HELR
      dominated by low-parallelism PKBs) + sigmoid + update + bootstrap.
  ResNet-20/56 [30]: multiplexed-packed convolutions — a 3x3 kernel is a
      9-rotation PKB; BN folds into PMul/CAdd; ReLU is a composite
      polynomial (CMULT ladder); bootstrap per residual block.
  BERT [53]: 12 layers of BSGS matmul PKBs + softmax/GELU polynomials.

Exact op counts of the closed-source baselines are unknowable; the
generators are calibrated so the SIMULATED ratios reproduce Table IV
(see benchmarks/ and EXPERIMENTS.md).

A copy of the JAX package's ``dfg/programs.py``.
"""
from __future__ import annotations


from repro_torch.dfg.trace import Handle, ProgramBuilder


def _rot_sum_reduce(h: Handle, log_n: int) -> Handle:
    """Serial rotate-and-add reduction (inner product): log_n
    parallelism-1 PKBs — the HELR bottleneck shape."""
    for i in range(log_n):
        h = h.cadd(h.rot(1 << i))
    return h


def _poly_ladder(h: Handle, degree: int) -> Handle:
    """Chebyshev/PS-style polynomial: ~log2(degree) sequential squarings
    plus combination PMul/CAdds, with rescales."""
    import math

    depth = max(1, math.ceil(math.log2(max(degree, 2))))
    cur = h
    for _ in range(depth):
        cur = cur.square().rescale()
        cur = cur.pmul().cadd(cur.pmul())
    return cur


def _hom_matvec_pkb(h: Handle, n_rot: int, bsgs_bs: int = 0) -> Handle:
    """One homomorphic linear-transform PKB: n_rot parallel rotations,
    PMuls, CAdd tree.  With bsgs_bs > 0 the PKB splits into baby/giant
    serial PKBs (Eq. (3))."""
    b = h.b
    if bsgs_bs and bsgs_bs < n_rot:
        gs = -(-n_rot // bsgs_bs)
        babies = [h.rot(j).pmul() for j in range(1, bsgs_bs)] + [h.pmul()]
        inner = b.sum_tree(babies)
        giants = [inner.rot(i * bsgs_bs).pmul() for i in range(1, gs)]
        return b.sum_tree([inner] + giants).rescale()
    rots = [h.rot(_step(j, n_rot)).pmul() for j in range(1, n_rot)]
    return b.sum_tree([h.pmul()] + rots).rescale()


def _step(j: int, n: int) -> int:
    """Arithmetic-progression steps (plaintext-matrix x ciphertext)."""
    return j


def bootstrapping_dfg(L: int = 35, alpha: int = 12, logN: int = 16,
                      n_stages: int = 3, bsgs_bs: int = 0,
                      eval_levels: int = 8) -> ProgramBuilder:
    b = ProgramBuilder(N=1 << logN, alpha=alpha)
    nh_bits = logN - 1
    stage_radix = -(-nh_bits // n_stages)
    limbs = L + 1
    x = b.input(limbs, tag="ct_boot")

    # CoeffToSlot: n_stages merged FFT stages, ~2^radix rotations each
    for s in range(n_stages):
        x = Handle(b, x.nid, limbs)
        x = _hom_matvec_pkb(x, (1 << stage_radix) - 1, bsgs_bs)
        limbs -= 1
        x.limbs = limbs

    # conjugation split (keyswitch, parallelism 1) + EWOs
    c = x.conj()
    re = x.cadd(c).pmul().rescale()
    im = x.cadd(c).pmul().rescale()
    limbs -= 1

    # EvalMod on both halves: degree-63 sine ladder
    outs = []
    for part in (re, im):
        part.limbs = limbs
        outs.append(_poly_ladder(part, 63))
    merged = outs[0].cadd(outs[1])
    limbs = merged.limbs - 1

    # SlotToCoeff
    y = merged
    for s in range(n_stages):
        y.limbs = max(limbs, eval_levels + 1)
        y = _hom_matvec_pkb(y, (1 << stage_radix) - 1, bsgs_bs)
        limbs -= 1
    y.output()
    return b


def helr_dfg(L: int = 35, alpha: int = 12, logN: int = 16,
             with_bootstrap: bool = True, bsgs_bs: int = 0) -> ProgramBuilder:
    b = ProgramBuilder(N=1 << logN, alpha=alpha)
    nh_bits = logN - 1
    limbs = 8  # HELR iterations run at low levels between bootstraps
    x = b.input(limbs, tag="X")
    w = b.input(limbs, tag="w")

    # inner product X*w: PMul then serial rotate-sum (parallelism-1 PKBs)
    xw = x.cmult(w).rescale()
    ip = _rot_sum_reduce(xw, nh_bits // 2)
    # sigmoid degree-3 (Horner): 2 CMULTs
    sig = ip.square().rescale().cmult(ip.pmul()).rescale().padd()
    # gradient: sigma * X, then reduce over batch axis
    grad = sig.cmult(x).rescale()
    grad = _rot_sum_reduce(grad, nh_bits // 2)
    w2 = w.cadd(grad.pmul())
    w2.output()

    if with_bootstrap:
        boot = bootstrapping_dfg(L=L, alpha=alpha, logN=logN,
                                 bsgs_bs=bsgs_bs)
        _absorb(b, boot)
    return b


def resnet_dfg(n_layers: int = 20, L: int = 35, alpha: int = 12,
               logN: int = 16, boot_every: int = 1,
               bsgs_bs: int = 0) -> ProgramBuilder:
    """ResNet-20/56 with multiplexed parallel convolution [30]."""
    b = ProgramBuilder(N=1 << logN, alpha=alpha)
    conv_layers = n_layers - 1          # minus FC
    # After each bootstrap the layer has ~L_eff + ReLU budget levels:
    # conv (2) + BN (1) + composite ReLU 15 o 15 o 27 (~12) => ops run at
    # limbs ~20 descending, not at the final level.
    post_boot_limbs = 20
    x = b.input(post_boot_limbs, tag="img")
    for layer in range(conv_layers):
        x.limbs = post_boot_limbs
        # 3x3 multiplexed conv: 9-rotation PKB (+BN folded into the PMuls)
        x = _hom_matvec_pkb(x, 9)
        if layer % 3 == 2:
            # downsample/stride: extra packing-shift PKB (parallelism ~4)
            x = _hom_matvec_pkb(x, 4)
        # ReLU composite minimax polynomial (deg 15 o 15 o 27), consuming
        # the remaining level budget down to ~L_eff
        x = _poly_ladder(x, 15)
        x = _poly_ladder(x, 15)
        x = _poly_ladder(x, 27)
        if layer % boot_every == boot_every - 1:
            _absorb(b, bootstrapping_dfg(L=L, alpha=alpha, logN=logN,
                                         bsgs_bs=bsgs_bs))
    # average-pool + FC: rotation-sum + matvec
    x.limbs = 8
    x = _rot_sum_reduce(x, 5)
    x = _hom_matvec_pkb(x, 8)
    x.output()
    return b


def bert_dfg(n_layers: int = 12, L: int = 35, alpha: int = 12,
             logN: int = 16, bsgs_bs: int = 2,
             boots_per_layer: int = 2) -> ProgramBuilder:
    """12-layer BERT inference [53]: per layer QKV/context/FFN matmul
    PKBs + softmax/GELU ladders; C2S inside its bootstrap keeps BSGS with
    (bs=2, gs=32) per the paper's Sec. VI-A capacity note."""
    b = ProgramBuilder(N=1 << logN, alpha=alpha)
    x = b.input(10, tag="seq")
    for _ in range(n_layers):
        x.limbs = 10
        q = _hom_matvec_pkb(x, 12)
        kk = _hom_matvec_pkb(x, 12)
        v = _hom_matvec_pkb(x, 12)
        scores = q.cmult(kk).rescale()
        scores = _poly_ladder(scores, 15)          # softmax approx
        ctxv = scores.cmult(v).rescale()
        ctxv = _hom_matvec_pkb(ctxv, 12)
        ff = _hom_matvec_pkb(ctxv, 16)
        ff = _poly_ladder(ff, 15)                  # GELU approx
        x = _hom_matvec_pkb(ff, 16)
        for _ in range(boots_per_layer):
            _absorb(
                b,
                bootstrapping_dfg(L=L, alpha=alpha, logN=logN,
                                  bsgs_bs=bsgs_bs),
            )
    x.output()
    return b


def convbn_example(logN: int = 16, alpha: int = 12) -> ProgramBuilder:
    """The Fig. 9 case study: three serial PKBs with 9/8/8 rotations."""
    b = ProgramBuilder(N=1 << logN, alpha=alpha)
    x = b.input(12, tag="x")
    x = _hom_matvec_pkb(x, 9)
    x.limbs = 12
    x = _hom_matvec_pkb(x, 8)
    x.limbs = 12
    x = _hom_matvec_pkb(x, 8)
    x.output()
    return b


def _absorb(b: ProgramBuilder, other: ProgramBuilder):
    """Append another builder's nodes (id-shifted) — used to inline
    bootstrap DFGs into application DFGs."""
    offset = b.g._next
    for nid in sorted(other.g.nodes):   # creation order == valid topo order
        node = other.g.nodes[nid]
        new_id = b.g.add(node.op, tuple(a + offset for a in node.args),
                         limbs=node.limbs, ext_limbs=node.ext_limbs,
                         **node.attrs)
        assert new_id == nid + offset


PROGRAMS = {
    "bootstrapping": lambda: bootstrapping_dfg(),
    "helr": lambda: helr_dfg(),
    "resnet20": lambda: resnet_dfg(20),
    "resnet56": lambda: resnet_dfg(56),
    "bert": lambda: bert_dfg(),
}
