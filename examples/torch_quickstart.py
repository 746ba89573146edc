"""Quickstart on the PyTorch/CUDA port: the paper's pipeline end to end
on a small ring, the five steps of ``examples/quickstart.py``.

1. encrypt a vector, run a hoisted rotation block (one ModUp, one
   ModDown for three rotations), decrypt
2. compile the SAME program through the DFG runtime: trace -> PKB
   identification -> fusion -> execution with fewer ModUps, batched
   over independent ciphertexts along a leading axis
3. apply HERO: identify the PKBs of a ConvBN program and fuse them
4. simulate SHARP against HE2-LM on the bootstrapping benchmark (the
   modelled accelerators' latencies, not times of this machine)
5. compile the real bootstrap pipeline (ModRaise -> C2S -> EvalMod ->
   S2C) through the runtime on a tiny ring: bit-exact, fewer ModUps

Every ciphertext operation runs on ``--device`` (the card by default,
where the NTT, ModUp, BConv and inner-product kernels of
``src/repro_torch/csrc`` do the keyswitching); asking for the card
without one raises.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import linear
from repro_torch.core.bootstrap import Bootstrapper
from repro_torch.core.ckks import CKKSContext
from repro_torch.core.params import CKKSParams
from repro_torch.core.poly import resolve_device
from repro_torch.dfg.fusion import optimal_fusion
from repro_torch.dfg.pkb import identify_pkbs
from repro_torch.dfg.programs import bootstrapping_dfg, convbn_example
from repro_torch.runtime import ProgramExecutor, TraceContext, compile_program
from repro_torch.sim import HE2_LM, SHARP
from repro_torch.sim.engine import simulate_program

PARAMS = dict(logN=9, L=5, alpha=2, k=3, q_bits=29, scale_bits=29)
BOOT_PARAMS = dict(logN=6, L=19, alpha=4, k=4, q_bits=29, scale_bits=29,
                   q0_bits=30)


def same(a, b) -> bool:
    return bool(torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the ciphertexts live (cpu: no card)")
    ap.add_argument("--skip-bootstrap", action="store_true",
                    help="stop after step 4")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()

    # --- 1. functional CKKS with hoisting --------------------------------
    params = CKKSParams(**PARAMS)
    ctx = CKKSContext(params, seed=1, device=device)
    nh = params.num_slots
    rng = np.random.default_rng(0)
    z = rng.normal(size=nh)
    ct = ctx.encrypt(z)
    steps = [1, 2, 4]
    ptvals = [rng.normal(size=nh) for _ in steps]
    pts = [ctx.encode(v) for v in ptvals]
    s0 = ctx.counters.snapshot()
    out = ctx.hoisted_rotation_sum(ct, steps, pts)   # ONE ModUp, ONE ModDown
    d = ctx.counters.delta(s0)
    expect = sum(np.roll(z, -s) * v for s, v in zip(steps, ptvals))
    err = np.abs(ctx.decrypt(out) - expect).max()
    print(f"[1] hoisted rotation-sum: max err {err:.6e} "
          f"({d.modup} ModUp + {d.moddown} ModDown for {len(steps)} "
          f"rotations) on {device.type}")

    # --- 2. the compiled runtime on a BSGS matvec -------------------------
    diags = {k: rng.normal(size=nh) for k in range(8)}
    tc = TraceContext(params)
    h = tc.input("x", level=params.L, scale=params.scale)
    tc.output(linear.matvec_bsgs(tc, h, diags, bs=4), "y")  # same source
    ex = ProgramExecutor(ctx)

    def modups(fn):
        s = ctx.counters.snapshot()
        r = fn()
        return r, ctx.counters.delta(s).modup

    eager, m_eager = modups(lambda: linear.matvec_bsgs(ctx, ct, diags, bs=4))
    compiled = compile_program(tc)                   # bit-exact with eager
    run, m_comp = modups(lambda: ex.run(compiled, {"x": ct}, True))
    fused = compile_program(tc, fusion=True)         # HERO Eq. (4) rewrite
    _, m_fused = modups(lambda: ex.run(fused, {"x": ct}))
    print(f"[2] compiled BSGS matvec: bit-exact={same(run['y'], eager)}; "
          f"ModUps eager={m_eager} compiled={m_comp} fused={m_fused}; "
          f"reconciled={run.report.reconcile()['counts_match']}")
    batch = [ctx.encrypt(rng.normal(size=nh)) for _ in range(4)]
    outs = ex.run_batched(compiled, {"x": batch})["y"]
    singles = [ex.run(compiled, {"x": b})["y"] for b in batch]
    print(f"    batched {len(outs)} cts along one leading axis; equal to "
          f"single runs={all(same(a, b) for a, b in zip(outs, singles))}")

    # --- 3. HERO on the Fig. 9 ConvBN case study --------------------------
    g = convbn_example().g
    pkbs = identify_pkbs(g)
    print(f"[3] ConvBN PKBs: {[p.n_rot for p in pkbs]} rotations "
          f"(in/out degree {[(p.indeg, p.outdeg) for p in pkbs]})")
    plan = optimal_fusion(pkbs, k=12, alpha=12, nh=1 << 15,
                          capacity_words=8e9 / 8)
    print(f"    HERO fuses groups {plan.groups}, saving "
          f"{plan.score*1e6:.0f} us/block; fused evk set: "
          f"{len(set(plan.fused[0].steps))} keys")

    # --- 4. simulator: SHARP vs HE2 on bootstrapping ----------------------
    sharp = simulate_program(bootstrapping_dfg(bsgs_bs=4).g, SHARP,
                             "minks", "EVF")
    he2 = simulate_program(bootstrapping_dfg(bsgs_bs=0).g, HE2_LM,
                           "hoist", "hybrid", fusion=True)
    print(f"[4] bootstrapping (modelled): SHARP "
          f"{sharp.latency_s*1e3:.6f} ms vs HE2-LM "
          f"{he2.latency_s*1e3:.6f} ms -> "
          f"{sharp.latency_s/he2.latency_s:.2f}x speedup "
          f"(paper: 1.66x); comm stalls {he2.comm_stall_frac*100:.1f}%")
    if args.skip_bootstrap:
        print(f"done in {time.perf_counter() - t0:.1f} s")
        return

    # --- 5. the COMPILED bootstrap on a tiny ring --------------------------
    bp = CKKSParams(**BOOT_PARAMS)
    bctx = CKKSContext(bp, seed=7, hamming_weight=8, device=device)
    btp = Bootstrapper(bctx, n_groups=2, mod_K=3, cheb_degree=27)
    zb = (np.random.default_rng(1).normal(size=bp.num_slots)
          + 1j * np.random.default_rng(2).normal(size=bp.num_slots)) * 0.01
    ct0 = bctx.encrypt(zb, level=0)
    bex = ProgramExecutor(bctx)

    def boot_modups(fn):
        s = bctx.counters.snapshot()
        r = fn()
        return r, bctx.counters.delta(s).modup

    out_e, m_eager = boot_modups(lambda: btp.bootstrap(ct0))
    compiled_b = btp.compile(input_scale=ct0.scale)   # same source, traced
    out_c, m_comp = boot_modups(
        lambda: bex.run(compiled_b, {"ct": ct0})["out"])
    err = np.abs(bctx.decrypt(out_c) - zb).max()
    print(f"[5] compiled bootstrap (logN=6): bit-exact={same(out_c, out_e)}; "
          f"ModUps eager={m_eager} compiled={m_comp}; "
          f"levels 0 -> {out_c.level}; max err {err:.6e}")
    print(f"done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
