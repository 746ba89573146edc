"""Drive the PyTorch/CUDA port's CKKS keyswitch path once on an H100.

    python3 chip_smoke.py

Phases, each printing one JSON line (any mismatch raises, so the script
exits non-zero):

  1. build   compile the four CUDA kernels from ``src/repro_torch/csrc``
             (one nvcc per source, in parallel); print the card's name
             and power limit;
  2. kernels each kernel at the paper shapes (logN=16, level 35: l=36,
             k=12, l_ext=48, dnum=3, alpha=12) against its plain PyTorch
             version on the same inputs, exact integer equality; median
             kernel and plain times from CUDA events; the CUDA launches
             one wrapper call makes, as torch.profiler sees them on the
             device (they must equal the library's own launch log), and
             the cluster dimension of each, from that log; the NTT in
             both directions, BConv at the ModDown (``bconv``) and the
             rescale (``bconv_rescale``) shapes, also on all-(q-1)
             residues, ModUp over all digits (``modup_all``); each
             kernel's bound from its bytes and its multiply results
             (the integer multiply rate at the card's maximum clock);
  3. main    ``CKKSContext(PAPER_PARAMS, device="cuda")``: encrypt two
             slot vectors, multiply (relin + rescale), rotate by 1 and 5,
             a hoisted rotation sum over 4 steps with plaintexts,
             conjugate, decrypt; every result against numpy within
             MAX_ERR, and residue for residue against the same seeded
             program on the CPU (the plain versions); every kernel's
             launch count must rise, ModUp's by one per keyswitch that
             needs one (MODUPS), BConv's by MODDOWNS ModDown-shaped and
             RESCALES rescale-shaped calls, and each library's CUDA
             launches must be what its wrapper calls make: one a call,
             two for ModUp;
  4. runtime the compiled runtime at PAPER_PARAMS: x -> BSGS matvec
             (8 diagonals, 4 baby steps) -> rescale -> Chebyshev of
             degree 7, traced once and compiled with fusion off and on;
             ``ProgramExecutor.run`` of both, ``run_batched`` (B=2) of
             the fused one.  The unfused output must equal the eager
             replay of the same code bit for bit (level and scale too),
             every run's ``reconcile()`` must have ``counts_match``, the
             fused run must do fewer ModUps than the eager one, the
             batch's slots must equal the single runs, each batched
             rescale must be one BConv launch, and every kernel must be
             launched in every run.  Then the fused program at logN=16,
             L=7 on the card and on the CPU, identical residues.  Prints
             seconds per run and per step (the port's ``obs`` spans),
             launches and calls per run, ModUp/ModDown counts and the
             device's busy share;
  5. parity  the main path's program at N = 2^16 on a short chain (L=7,
             alpha=3, k=3) on the card and on the CPU, identical residues
             after every op.

Then the kernels' summary line, and last the device line.  Without a
CUDA device, or without the repository beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# Decrypted slots vs numpy.  PAPER_PARAMS has k = alpha = 12 and 30-bit
# primes at scale 2^28, so its keyswitch noise is large: after a multiply
# and two more keyswitches (scale 2^24) the slots are off by tens.  The
# bound catches a wrong result, which decrypts to ~Q/scale; exactness is
# the CPU replica's residue-for-residue check.
MAX_ERR = 64.0
SEED = 2026
PEAK_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s
# Operations bound: the modular arithmetic runs on the integer multiply
# pipe, 64 32-bit multiply results per clock per SM on sm_90 (half the
# FP32 rate); the peak is that times the SMs times the maximum SM clock
# (nvidia-smi clocks.max.sm), set in phase_build.  Counted in multiply
# results: a 32x32->64 product is 2 (low and high halves), a Montgomery
# reduction 2 more (m = lo * q' and the high half of m * q), so a full
# Montgomery product is 4.
INT_MUL_PER_CLOCK_SM = 64
PRODUCT_OPS = 2
REDUCE_OPS = 2
MONT_OPS = PRODUCT_OPS + REDUCE_OPS
PEAK_OPS = None         # multiply results/s, from the card in phase_build
SPIN_CYCLES = 2_000_000  # ~1 ms of the card's clock
# ModUps of ``program``: the multiply's relinearization, two rotations,
# the hoisted sum (one for all its rotations) and the conjugation
MODUPS = 5
# BConv calls of ``program``: one ModDown (P -> Q of both accumulators)
# per keyswitch, and two rescales (after the multiply and after the
# hoisted sum) of two polynomials each, one source row -> the rest
MODDOWNS = 5
RESCALES = 4
# CUDA launches per wrapper call, by library
CUDA_PER_CALL = {"ntt": 1, "bconv": 1, "fused_ip": 1, "modup": 2}
# The runtime phase's program: a BSGS matvec over RT_DIAGS diagonals
# with RT_BS baby steps, then a Chebyshev polynomial of RT_DEGREE
RT_DIAGS = 8
RT_BS = 4
RT_DEGREE = 7
# the short chain at full ring width of the parity checks
SHORT_KW = dict(logN=16, L=7, alpha=3, k=3)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_kernels(fn) -> int:
    """Kernels that torch.profiler sees run on the device during one
    ``fn()``; copies, fills and the spin kernels around it are not
    counted.  A spin kernel of ~1 ms on each side keeps ``fn``'s kernels
    away from the edges of the profiler's window."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        fn()
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.key
               and not e.key.startswith(("Memcpy", "Memset")))


def bconv_ops(batch: int, ls: int, ld: int, n: int, g_acc: int) -> int:
    """Multiply results of the lazy BConv per column of each batch row:
    ls scalings (a Montgomery product each), ls * ld products and
    ld * ceil(ls / g_acc) reductions."""
    return batch * n * (MONT_OPS * ls + PRODUCT_OPS * ls * ld
                        + REDUCE_OPS * ld * -(-ls // g_acc))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def residues(rng, primes, shape, dev):
    """Uniform residues of ``shape`` (..., len(primes), N) on ``dev``."""
    q = torch.tensor(primes, dtype=torch.int64, device=dev)[:, None]
    x = torch.from_numpy(rng.integers(0, 1 << 62, size=shape, dtype=np.int64))
    return x.to(dev) % q


# ------------------------------------------------------------------ phase 1
def smi_query(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def registers(ptxas: str) -> dict:
    """{kernel: [registers, spill store bytes]} from ``ptxas -v``, for
    every kernel function of one library."""
    out = {}
    for part in ptxas.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        if regs and spill:
            out[part.split("'")[0]] = [int(regs.group(1)),
                                       int(spill.group(1))]
    return out


def phase_build(native) -> str:
    global PEAK_OPS
    smi = smi_query("name,power.limit")
    print(smi, flush=True)
    clock_mhz = float(smi_query("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    PEAK_OPS = INT_MUL_PER_CLOCK_SM * sms * clock_mhz * 1e6
    t0 = time.perf_counter()
    report = native.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: v["seconds"] for k, v in report.items()},
          "ptxas": {k: v["ptxas"][-600:] for k, v in report.items()},
          "registers_spills": {k: registers(v["ptxas"])
                               for k, v in report.items()},
          "sms": sms, "max_sm_clock_mhz": clock_mhz, "peak_ops": PEAK_OPS})
    return smi


# ------------------------------------------------------------------ phase 2
def phase_kernels(P, native) -> dict:
    from repro_torch.core.poly import PolyContext
    from repro_torch.kernels.bconv.ops import BConvConsts, bconv, bconv_plain
    from repro_torch.kernels.fused_ip.ops import IPConsts, fused_ip, fused_ip_plain
    from repro_torch.kernels.modup.ops import ModUpConsts, modup, modup_plain
    from repro_torch.kernels.ntt.ops import (
        ntt_fwd, ntt_fwd_plain, ntt_inv, ntt_inv_plain,
    )
    from repro_torch.kernels.timing import cuda_ms

    dev = torch.device("cuda")
    pc = PolyContext(P, device=dev)
    rng = np.random.default_rng(SEED)
    N, logn = P.N, P.logN
    level = P.L
    base = P.q_chain(level)
    ext = base + P.p_primes
    l, k, l_ext = len(base), P.k, len(ext)
    groups = P.digit_groups(level)
    dnum = len(groups)
    out = {}

    def exact(name, got, exp, shape) -> int:
        torch.cuda.synchronize()
        err = int((got - exp).abs().max())
        if not torch.equal(got, exp):
            raise AssertionError(f"{name}: kernel != plain at {shape}, "
                                 f"max abs err {err}")
        return err

    def record(name, lib, kern, plain, nbytes, ops, shape):
        err = exact(name, kern(), plain(), shape)
        # one more call, watched by the profiler and by the library's log;
        # a session that sees no kernel at all (the profiler has lost
        # its records on the H100) is repeated, at most 3 times
        for sessions in range(1, 4):
            native.launch_log(lib)
            cuda_launches = device_kernels(kern)
            logged, cluster = native.launch_log(lib)
            if cuda_launches:
                break
        if cuda_launches != logged:
            raise AssertionError(f"{name}: the profiler saw {cuda_launches} "
                                 f"kernels, the library logged {logged}")
        b, by = bound(nbytes, ops)
        out[name] = {"max_abs_err": err, "ms": cuda_ms(kern),
                     "plain_ms": cuda_ms(plain, reps=2, batches=3,
                                         hide_host=False),
                     "bound_ms": b, "bound_by": by, "library_ms": None,
                     "shape": shape, "cuda_launches": cuda_launches,
                     "cluster": cluster, "profiler_sessions": sessions}

    # NTT: the ModDown forward transform of both accumulators, 2 x l rows
    x = residues(rng, base, (2, l, N), dev)
    tabs = pc.tabs
    fwd_tables = tabs.plain_rows(base, dev, inverse=False)
    record("ntt", "ntt", lambda: ntt_fwd(x, base, tabs),
           lambda: ntt_fwd_plain(x, *fwd_tables),
           2 * 2 * l * N * 8 + 2 * l * N * 4,
           MONT_OPS * 2 * l * N * (1 + logn / 2), [2, l, N])
    # and the ModDown inverse transform of the P limbs, 2 x k rows
    xp = residues(rng, P.p_primes, (2, k, N), dev)
    inv_tables = tabs.plain_rows(P.p_primes, dev, inverse=True)
    record("ntt_inverse", "ntt", lambda: ntt_inv(xp, P.p_primes, tabs),
           lambda: ntt_inv_plain(xp, *inv_tables),
           2 * 2 * k * N * 8 + 2 * k * N * 4,
           MONT_OPS * 2 * k * N * (1 + logn / 2), [2, k, N])

    # BConv: ModDown P -> Q of both accumulators, and the rescale's last
    # prime -> the rest; exact on random and on all-(q-1) residues
    c = BConvConsts(pc.rns, P.p_primes, base, dev)
    cr = BConvConsts(pc.rns, base[-1:], base[:-1], dev)
    x1 = residues(rng, base[-1:], (1, N), dev)
    for name, cc, xx, shape in (("bconv", c, xp, [2, k, l, N]),
                                ("bconv_rescale", cr, x1, [1, l - 1, N])):
        top = (cc.src_q[:, None] - 1).expand(xx.shape).contiguous()
        exact(name, bconv(top, cc), bconv_plain(
            top, cc.qhat_inv, cc.src_q, cc.qhat_mod, cc.dst_q), shape)
        batch = xx.numel() // (cc.ls * N)
        record(name, "bconv", lambda cc=cc, xx=xx: bconv(xx, cc),
               lambda cc=cc, xx=xx: bconv_plain(
                   xx, cc.qhat_inv, cc.src_q, cc.qhat_mod, cc.dst_q),
               batch * (cc.ls + cc.ld) * N * 8,
               bconv_ops(batch, cc.ls, cc.ld, N, cc.g_acc), shape)

    # fused IP: a hoisted block of 4 rotations with plaintexts
    R = 4
    ipc = IPConsts(ext, dev)
    dig = residues(rng, ext, (R, dnum, l_ext, N), dev)
    evk = residues(rng, ext, (R, dnum, 2, l_ext, N), dev)
    pt = residues(rng, ext, (R, l_ext, N), dev)
    record("fused_ip", "fused_ip", lambda: fused_ip(dig, evk, pt, ipc),
           lambda: fused_ip_plain(dig, evk, pt, ipc.q),
           (R * dnum + 2 * R * dnum + R + 2) * l_ext * N * 8,
           MONT_OPS * l_ext * N * (2 * R * dnum + 2 * R + 2),
           [R, dnum, l_ext, N])

    # ModUp of every digit of one level-35 polynomial (B = 1): int64 in
    # and out, the inverse tables of the l source limbs and the forward
    # tables of the l_ext destination limbs, each read once
    mc = ModUpConsts(pc.rns, tabs, groups, base, ext, dev)
    xm = residues(rng, base, (l, N), dev)
    sizes = [len(D) for D in groups]
    record("modup_all", "modup", lambda: modup(xm, mc),
           lambda: modup_plain(xm, mc),
           l * N * 8 + dnum * l_ext * N * 8 + 2 * l * N * 4
           + 2 * l_ext * N * 4,
           MONT_OPS * N * (l * (1 + logn / 2) + sum(
               (l_ext - ls) * (ls + 1 + logn / 2) for ls in sizes)),
           [l, dnum, l_ext, N])
    emit({"phase": "kernels", "results": out})
    return out


# ------------------------------------------------------------- phases 3, 5
STEPS = [1, 2, 3, 4]


def prepare(ctx, P, seed: int) -> dict:
    """Set-up of the program: slot vectors, every key it uses, and the
    hoisted block's plaintexts (encoded at the level after one rescale)."""
    rng = np.random.default_rng(seed)
    nh = P.num_slots
    z1, z2 = (rng.uniform(-1, 1, nh) + 1j * rng.uniform(-1, 1, nh)
              for _ in range(2))
    ws = [rng.uniform(-1, 1, nh) for _ in STEPS]
    ctx.keys.mult_key
    ctx.keys.conj_key
    for s in sorted(set(STEPS) | {5}):
        ctx.keys.rot_key(s)
    pts = [ctx.encode(w, level=P.L - 1) for w in ws]
    return {"z1": z1, "z2": z2, "ws": ws, "pts": pts}


def program(ctx, prep: dict, times: dict | None = None) -> dict:
    """encrypt x2 -> multiply (relin + rescale) -> rotate by 1 and 5 ->
    hoisted rotation sum over STEPS with plaintexts (+ rescale) ->
    conjugate.  After the rescale the chain has L primes, so with
    L % alpha != 0 every keyswitch here has a short last digit.

    ``times`` (card only) receives each op's host seconds, synchronized."""
    def op(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if times is not None:
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
        return out

    a = op("encrypt", ctx.encrypt, prep["z1"])
    b = ctx.encrypt(prep["z2"])
    m = op("multiply", ctx.multiply, a, b)
    r1 = op("rotate_1", ctx.rotate, m, 1)
    r5 = op("rotate_5", ctx.rotate, m, 5)
    h = op("hoisted", ctx.hoisted_rotation_sum, m, STEPS, prep["pts"])
    cj = op("conjugate", ctx.conjugate, h)
    return {"encrypt": a, "multiply": m, "rotate_1": r1, "rotate_5": r5,
            "hoisted": h, "conjugate": cj}


def device_profile(fn) -> dict:
    """Device time of the kernels ``fn`` launches, by name, from
    torch.profiler; ``None`` fields where the profiler saw no device."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per = {}
    for e in prof.key_averages():
        # device-side events only: a CPU op's entry repeats the device
        # time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            per[e.key[:60]] = us / 1e3
    total_ms = sum(per.values())
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:10])
    return {"profiled_wall_s": wall,
            "device_ms": total_ms if per else None,
            "top_ms": top if per else None}


def expected(prep: dict) -> dict:
    zm = prep["z1"] * prep["z2"]
    hz = sum(w * np.roll(zm, -s) for w, s in zip(prep["ws"], STEPS))
    return {"encrypt": prep["z1"], "multiply": zm,
            "rotate_1": np.roll(zm, -1), "rotate_5": np.roll(zm, -5),
            "hoisted": hz, "conjugate": np.conj(hz)}


def cpu_replica(P, seed: int, outs: dict) -> dict:
    """The same seeded program through the plain versions on the CPU;
    every ciphertext must equal the card's residue for residue."""
    from repro_torch.core.ckks import CKKSContext

    t0 = time.perf_counter()
    ctx = CKKSContext(P, seed=seed, device="cpu")
    ref = program(ctx, prepare(ctx, P, seed))
    res = {}
    for name, ct in outs.items():
        r = ref[name]
        same = (ct.level == r.level and torch.equal(ct.c0.cpu(), r.c0)
                and torch.equal(ct.c1.cpu(), r.c1))
        res[name] = {"level": ct.level, "identical": bool(same)}
        if not same:
            raise AssertionError(f"{name}: CUDA and CPU residues differ")
    return {"ops": res, "cpu_s": time.perf_counter() - t0}


def phase_main(P, native) -> dict:
    from repro_torch.core.ckks import CKKSContext

    t0 = time.perf_counter()
    ctx = CKKSContext(P, seed=SEED, device="cuda")
    prep = prepare(ctx, P, SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    native.reset_counts()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    op_s = {}
    outs = program(ctx, prep, op_s)
    ev1.record()
    torch.cuda.synchronize()
    ops_s = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    cuda_launches = {k: native.launch_log(k)[0] for k in launches}
    calls = {f"{fn} {list(shape)}": v
             for (fn, shape), v in sorted(native.CALLS.items())}
    prof = device_profile(lambda: program(ctx, prep))
    if prof["device_ms"] is not None:
        prof["device_busy_share"] = prof["device_ms"] / 1e3 / ops_s

    t1 = time.perf_counter()
    errs = {}
    for name, want in expected(prep).items():
        got = ctx.decrypt(outs[name])
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"{name}: bad decryption {got.shape}")
        errs[name] = float(np.abs(got - want).max())
    decrypt_s = time.perf_counter() - t1
    res = {"phase": "main", "params": "PAPER_PARAMS", "level_in": P.L,
           "level_out": outs["conjugate"].level, "max_err": errs,
           "bound": MAX_ERR, "setup_s": setup_s, "ops_s": ops_s,
           "op_s": op_s, "ops_event_s": ev0.elapsed_time(ev1) / 1e3,
           "profile": prof,
           "decrypt_s": decrypt_s, "launches": launches,
           "cuda_launches": cuda_launches, "calls": calls,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res.update(cpu_replica(P, SEED, outs))
    emit(res)
    bad = {k: v for k, v in errs.items() if v > MAX_ERR}
    if bad:
        raise AssertionError(f"decryption error above {MAX_ERR}: {bad}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    if not any(c.startswith("ntt_inverse ") for c in calls) or not any(
            c.startswith("ntt_forward ") for c in calls):
        raise AssertionError("an NTT direction was not launched on the "
                             "main path")
    if launches["modup"] != MODUPS:
        raise AssertionError(f"{launches['modup']} ModUp calls, expected "
                             f"{MODUPS}: one per keyswitch that needs one")
    for k, n in cuda_launches.items():
        if n != CUDA_PER_CALL[k] * launches[k]:
            raise AssertionError(f"{k}: {n} CUDA launches for {launches[k]} "
                                 f"wrapper calls")
    by_kind = bconv_calls(calls, P.k)
    if by_kind != {"moddown": MODDOWNS, "rescale": RESCALES, "other": 0} \
            or launches["bconv"] != MODDOWNS + RESCALES:
        raise AssertionError(f"bconv calls {by_kind}, expected {MODDOWNS} "
                             f"ModDown-shaped and {RESCALES} rescale-shaped")
    return res


def bconv_calls(calls: dict, k: int) -> dict:
    """The main path's BConv calls by kind, from ``calls``' shapes
    ``bconv [..., ls, ld]``: ModDown converts the k P limbs of both
    accumulators, a rescale one source row."""
    out = {"moddown": 0, "rescale": 0, "other": 0}
    for key, v in calls.items():
        fn, _, dims = key.partition(" ")
        if fn != "bconv":
            continue
        dims = json.loads(dims)
        kind = ("moddown" if dims[-3:-1] == [2, k] else
                "rescale" if dims[-2] == 1 else "other")
        out[kind] += v
    return out


# ------------------------------------------------------------------ phase 4
def runtime_data(P, seed: int) -> dict:
    """Diagonals (each slot of the product stays in [-1, 1]), the
    Chebyshev coefficients of tanh, and two input slot vectors."""
    from repro_torch.core.polyeval import chebyshev_coeffs

    rng = np.random.default_rng(seed)
    nh = P.num_slots
    return {"diags": {d: rng.uniform(-1, 1, nh) / RT_DIAGS
                      for d in range(RT_DIAGS)},
            "coeffs": chebyshev_coeffs(np.tanh, RT_DEGREE),
            "xs": [rng.uniform(-1, 1, nh) for _ in range(2)]}


def runtime_program(cx, h, data):
    """BSGS matvec (with its rescale) then the Chebyshev polynomial: the
    same code runs eagerly on a ``CKKSContext`` and traced on a
    ``TraceContext``."""
    from repro_torch.core import linear, polyeval

    y = linear.matvec_bsgs(cx, h, data["diags"], bs=RT_BS)
    return polyeval.eval_chebyshev(cx, y, data["coeffs"])


def runtime_expected(data, x):
    y = sum(v * np.roll(x, -d) for d, v in data["diags"].items())
    return np.polynomial.chebyshev.chebval(y, data["coeffs"])


def compile_runtime(P, data, fusion: bool):
    from repro_torch.runtime import TraceContext, compile_program

    tc = TraceContext(P)
    h = tc.input("x", level=P.L, scale=P.scale)
    tc.output(runtime_program(tc, h, data), "y")
    return compile_program(tc, fusion=fusion)


def same_ct(a, b) -> bool:
    return (a.level == b.level and a.scale == b.scale
            and torch.equal(a.c0.cpu(), b.c0.cpu())
            and torch.equal(a.c1.cpu(), b.c1.cpu()))


def counted_run(native, fn) -> tuple:
    """``fn()`` with the launch counts set to 0 just before it and read
    just after: (result, wall seconds, launches, CUDA launches, calls)."""
    native.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    cuda_launches = {k: native.launch_log(k)[0] for k in launches}
    calls = {f"{f} {list(shape)}": v
             for (f, shape), v in sorted(native.CALLS.items())}
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the runtime path: "
                             f"{idle}")
    for k, n in cuda_launches.items():
        if n != CUDA_PER_CALL[k] * launches[k]:
            raise AssertionError(f"runtime {k}: {n} CUDA launches for "
                                 f"{launches[k]} wrapper calls")
    return out, wall, launches, cuda_launches, calls


def step_seconds(ex, comp, inputs) -> dict:
    """One run with the port's tracer on: seconds per ``exec.step.*``
    span (each ends with a device synchronize), by step label."""
    from repro_torch import obs

    was = obs.TRACER.enabled
    obs.TRACER.reset()
    obs.enable()
    try:
        ex.run(comp, inputs)
    finally:
        spans = obs.TRACER.spans("exec.step.*")
        obs.TRACER.reset()
        obs.TRACER.enabled = was
    out = {}
    for s in spans:
        label = s.name[len("exec.step."):]
        n, total, top = out.get(label, (0, 0.0, 0.0))
        dt = (s.end_ns - s.start_ns) / 1e9
        out[label] = (n + 1, total + dt, max(top, dt))
    return {k: {"steps": n, "s": total, "max_s": top}
            for k, (n, total, top) in sorted(out.items())}


def phase_runtime(P, native) -> dict:
    """The compiled runtime at PAPER_PARAMS (see the module docstring)."""
    from repro_torch.core.ckks import CKKSContext
    from repro_torch.core.params import CKKSParams
    from repro_torch.dfg.graph import OpKind
    from repro_torch.runtime import ProgramExecutor
    from repro_torch.runtime.lower import EagerStep

    t_phase = time.perf_counter()
    data = runtime_data(P, SEED + 4)
    t0 = time.perf_counter()
    comps = {f: compile_runtime(P, data, f) for f in (False, True)}
    compile_s = time.perf_counter() - t0
    ctx = CKKSContext(P, seed=SEED + 4, device="cuda")
    cts = [ctx.encrypt(x) for x in data["xs"]]
    ex = ProgramExecutor(ctx)
    runs = {}
    results = {}
    for name, comp, fn in (
            ("unfused", comps[False],
             lambda: ex.run(comps[False], {"x": cts[0]}, with_report=True)),
            ("fused", comps[True],
             lambda: ex.run(comps[True], {"x": cts[0]}, with_report=True)),
            ("fused_batched", comps[True],
             lambda: ex.run_batched(comps[True], {"x": cts},
                                    with_report=True))):
        res, wall, launches, cuda_launches, calls = counted_run(native, fn)
        rec = res.report.reconcile()
        if not rec["counts_match"]:
            raise AssertionError(f"runtime {name}: counts do not reconcile "
                                 f"{rec}")
        results[name] = res
        runs[name] = {"s": wall, "modup": res.report.executed.modup,
                      "moddown": res.report.executed.moddown,
                      "steps": len(comp.steps), "summary": comp.summary(),
                      "reconcile": rec, "launches": launches,
                      "cuda_launches": cuda_launches, "calls": calls}

    # the eager replay of the same code: the unfused run's bitstream
    before = ctx.counters.snapshot()
    t0 = time.perf_counter()
    eager = runtime_program(ctx, cts[0], data)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager_ops = ctx.counters.delta(before)
    if not same_ct(results["unfused"]["y"], eager):
        raise AssertionError("runtime: the fusion=False output differs "
                             "from the eager replay")
    if not runs["fused"]["modup"] < eager_ops.modup:
        raise AssertionError(f"runtime: fused run did {runs['fused']['modup']}"
                             f" ModUps, the eager one {eager_ops.modup}")
    for b, ct in enumerate(results["fused_batched"]["y"]):
        want = (results["fused"]["y"] if b == 0 else
                ex.run(comps[True], {"x": cts[b]})["y"])
        if not same_ct(ct, want):
            raise AssertionError(f"runtime: batch slot {b} differs from "
                                 f"its single run")
    # each batched rescale is one poly.rescale over both components of
    # both ciphertexts: one rescale-shaped BConv launch
    n_rescale = sum(1 for s in comps[True].steps if isinstance(s, EagerStep)
                    and comps[True].dfg.nodes[s.nid].op == OpKind.RESCALE)
    rescale_calls = {c: v for c, v in runs["fused_batched"]["calls"].items()
                     if c.startswith("bconv ")
                     and json.loads(c.partition(" ")[2])[-2] == 1}
    if sum(rescale_calls.values()) != n_rescale or any(
            json.loads(c.partition(" ")[2])[:3] != [2, 2, 1]
            for c in rescale_calls):
        raise AssertionError(f"runtime: batched rescales {rescale_calls}, "
                             f"expected {n_rescale} of shape [2, 2, 1, ld]")

    errs = {}
    for name in ("unfused", "fused"):
        got = ctx.decrypt(results[name]["y"])
        want = runtime_expected(data, data["xs"][0])
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"runtime {name}: bad decryption")
        errs[name] = float(np.abs(got - want).max())
    bad = {k: v for k, v in errs.items() if v > MAX_ERR}
    if bad:
        raise AssertionError(f"runtime: decryption error above {MAX_ERR}: "
                             f"{bad}")

    # warm: the plaintexts are encoded and lifted now
    t0 = time.perf_counter()
    ex.run(comps[False], {"x": cts[0]})
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    per_step = step_seconds(ex, comps[False], {"x": cts[0]})
    prof = device_profile(lambda: ex.run(comps[False], {"x": cts[0]}))
    if prof["device_ms"] is not None:
        prof["device_busy_share"] = (prof["device_ms"] / 1e3
                                     / prof["profiled_wall_s"])

    # the fused program on the short chain, card against CPU
    P7 = CKKSParams(**SHORT_KW)
    t0 = time.perf_counter()
    data7 = runtime_data(P7, SEED + 6)
    comp7 = compile_runtime(P7, data7, True)
    outs7 = []
    for dev in ("cuda", "cpu"):
        c7 = CKKSContext(P7, seed=SEED + 6, device=dev)
        outs7.append(ProgramExecutor(c7).run(
            comp7, {"x": c7.encrypt(data7["xs"][0])})["y"])
    if not same_ct(*outs7):
        raise AssertionError("runtime: logN=16 L=7 card and CPU residues "
                             "differ")
    short_s = time.perf_counter() - t0

    res = {"phase": "runtime", "params": "PAPER_PARAMS",
           "program": f"matvec_bsgs({RT_DIAGS} diagonals, bs={RT_BS}) -> "
                      f"rescale -> chebyshev(degree {RT_DEGREE})",
           "compile_s": compile_s, "runs": runs,
           "eager": {"s": eager_s, "modup": eager_ops.modup,
                     "moddown": eager_ops.moddown},
           "unfused_equals_eager": True, "max_err": errs,
           "bound": MAX_ERR, "warm_unfused_s": warm_s,
           "step_s": per_step, "profile": prof,
           "batched_rescales": rescale_calls,
           "short_chain": {"params": "logN=16 L=7 alpha=3 k=3",
                           "fused_identical_cpu": True, "s": short_s},
           "level_out": results["unfused"]["y"].level,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


def runtime_launches(rt: dict, name: str, k: int) -> int:
    """Wrapper calls of kernel row ``name`` in the runtime phase's three
    counted runs."""
    total = 0
    for run in rt["runs"].values():
        calls = run["calls"]
        if name in ("ntt", "ntt_inverse"):
            prefix = "ntt_forward " if name == "ntt" else "ntt_inverse "
            total += sum(v for c, v in calls.items() if c.startswith(prefix))
        elif name in ("bconv", "bconv_rescale"):
            kinds = bconv_calls(calls, k)
            total += kinds["moddown" if name == "bconv" else "rescale"]
        else:
            total += run["launches"]["fused_ip" if name == "fused_ip"
                                     else "modup"]
    return total


def phase_parity() -> None:
    """The program at N = 2^16 on a short chain, card against CPU."""
    from repro_torch.core.ckks import CKKSContext
    from repro_torch.core.params import CKKSParams

    P = CKKSParams(**SHORT_KW)
    t0 = time.perf_counter()
    ctx = CKKSContext(P, seed=SEED + 2, device="cuda")
    outs = program(ctx, prepare(ctx, P, SEED + 2))
    emit({"phase": "parity", "params": "logN=16 L=7 alpha=3 k=3",
          **cpu_replica(P, SEED + 2, outs),
          "seconds": time.perf_counter() - t0})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.params import PAPER_PARAMS
    from repro_torch.kernels import native

    t_start = time.perf_counter()
    smi = phase_build(native)
    kern = phase_kernels(PAPER_PARAMS, native)
    main_res = phase_main(PAPER_PARAMS, native)
    rt = phase_runtime(PAPER_PARAMS, native)
    phase_parity()
    ntt_src = ("src/repro_torch/csrc/ntt.cu", "src/repro/kernels/ntt/ntt.py:70")
    calls = main_res["calls"]
    bconv_main = bconv_calls(calls, PAPER_PARAMS.k)
    sources = {
        "ntt": (*ntt_src, sum(v for c, v in calls.items()
                              if c.startswith("ntt_forward "))),
        "ntt_inverse": (*ntt_src, sum(v for c, v in calls.items()
                                      if c.startswith("ntt_inverse "))),
        "bconv": ("src/repro_torch/csrc/bconv.cu",
                  "src/repro/kernels/bconv/bconv.py:40", bconv_main["moddown"]),
        "bconv_rescale": ("src/repro_torch/csrc/bconv.cu",
                          "src/repro/kernels/bconv/bconv.py:40",
                          bconv_main["rescale"]),
        "fused_ip": ("src/repro_torch/csrc/fused_ip.cu",
                     "src/repro/kernels/fused_ip/fused_ip.py:41",
                     main_res["launches"]["fused_ip"]),
        "modup_all": ("src/repro_torch/csrc/modup.cu",
                      "src/repro/kernels/modup/modup.py:71",
                      main_res["launches"]["modup"]),
    }
    rows = []
    for name, (src, rep, launches) in sources.items():
        r = kern[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches,
                     "runtime_launches": runtime_launches(rt, name,
                                                          PAPER_PARAMS.k),
                     **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "cuda_launches",
                                          "cluster")}})
    emit({"kernels": rows})
    print(f"card: {smi}; total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
