"""Drive the PyTorch/CUDA port's CKKS keyswitch path, its distributed
keyswitch and its LM serving paths once on an H100.

    python3 chip_smoke.py

Phases, each printing one JSON line (any mismatch raises, so the script
exits non-zero); phases 9, 10 and 8 run right after the build, in a
fresh process, the others in the order below:

  1. build   compile the four CUDA kernels from ``src/repro_torch/csrc``
             (one nvcc per source, in parallel); print the card's name
             and power limit;
  2. kernels each kernel at the paper shapes (logN=16, level 35: l=36,
             k=12, l_ext=48, dnum=3, alpha=12) against its plain PyTorch
             version on the same inputs, exact integer equality; median
             kernel and plain times from CUDA events; the CUDA kernels
             one wrapper call enqueues, as the kernel nodes of a CUDA
             graph captured from that call (they must equal the
             library's own launch log, and the graph's replay must again
             equal the plain version), and the cluster dimension of
             each, from that log; the NTT in
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
             after every op;
  6. bootstrap
             bootstrapping at logN=10, L=23 (the JAX package's
             tests/test_bootstrap.py: context seed 7, Hamming weight 8,
             3 stage groups, K=5, Chebyshev degree 59) from level 0.  The
             compiled program (exact, unfused) must equal the eager
             ``bootstrap`` bit for bit at fewer ModUps, reconcile, decrypt
             within BOOT_MAX_ERR at level >= 1, and feed the simulator;
             ``exact=False`` must merge ModDowns within 1.5x the error;
             ``run_batched`` (B=2) slots must equal single runs; the
             exact, inexact and fused programs must give the CPU's
             residues; every kernel must be launched, the NTT without a
             cluster.  Prints seconds (build, compile, first and warm
             run, eager, CPU replica), ModUp/ModDown counts, launches
             and calls per shape, and the busy share of a warm run.

Then the kernels at the bootstrap phase's most frequent logN=10 shape of
each (``bootstrap_kernels``), and

  7. serve   the multi-tenant ``FHEServer`` at SERVE_KW (logN=16, L=14,
             nh = 2^15, dnum = 8, k = 3; tenant secrets of Hamming
             weight SERVE_HW): ``workload_request_programs``
             of ``logreg(degree=15)`` and ``mlp``; three tenants enrolled
             as benchmarks/bench_serving.py warms them (the host's exact
             plaintext lifts timed apart); a Poisson trace of 24 requests
             served continuously (batches of up to 4, 0.15 s wait, its
             launches counted) and serially.  Gates: every request
             completed in both loops, no new dispatch shape after the
             warm-up, a plan-cache hit for every batch, every output
             within its workload's tolerance of the banded reference
             under its own tenant's key, the slots of a batch equal to
             single runs, the first request of each program equal to its
             CPU replica, the full chain's ModUp, fused IP and ModDown
             shapes called, every kernel launched.  Then a chaos run
             (logreg, 12 requests from two tenants at t = 0, transient
             faults, evictions, corrupted slots and latency spikes all
             firing): one outcome per request, a corrupted slot fails
             alone, the injected counts equal the retries, failures and
             re-keyed tenants, and every output decrypts.  Then
             ``mlp_bootstrap`` served hop by hop at logN=8, L=19 (compute
             -> bootstrap -> compute) equal to ``run_eager`` bit for bit
             and within its tolerance.  Prints each loop's report, the
             seconds per batch by width, launches per request, the busy
             share and the HE2-SM simulator's replay of the batch log
             (the model's latency, not the card's);

  8. distributed
             the distributed keyswitch (``core/distributed``) on an NCCL
             group of one rank (rendezvous through a file in a temporary
             directory): IRF and EVF at the paper's shape (dnum = 3,
             l_ext = 48, N = 2^16), their local inner product through the
             fused-IP kernel at R = 1 without a plaintext, counted (one
             launch each, no other kernel) and equal to the plain version
             residue for residue; the kernel's row at that shape; the
             bytes each all-to-all sent off the rank (none at P = 1) and
             the analytic IRF / EVF bytes for P = 2, 4, 8.  One card, so
             no time across cards;
  9. lm_serve
             phi3-medium-14b at full width (40 layers, d = 5120, bf16,
             random weights from a seeded generator on the card) served
             by ``launch/serve.generate`` (batch 4, prompt 16, 32 greedy
             tokens; a warm-up run first).  Gates: finite logits;
             teacher-forced decode of the prompts equal to the full
             forward within the JAX package's own bound (0.15) in bf16
             at that bound's depth (2 layers) and in a float32 copy at
             full depth (the bf16 full-depth difference is printed); the
             float32 copy cut to two layers equal on the card and on the
             CPU within 1e-3.  Prints weight GB, peak memory, prefill
             seconds, ms per decode step, tokens/s and the per-step
             bytes bound (every weight and the cache read once);
 10. lm_zoo  the other families at full width in bf16, each served as
             ``lm_serve`` serves phi3 and freed before the next (LM_ZOO):
             minicpm3-4b (MLA), moonshot-v1-16b-a3b (MoE), arctic-480b
             (MoE + dense residual, 2 of 35 layers), jamba-1.5-large
             (Mamba + MoE, Mamba + dense: 2 of 72 layers), xlstm-1.3b,
             qwen2-vl-2b (M-RoPE) and whisper-base (encoder-decoder).
             Gates: the output's shape, prompt and vocabulary, finite
             logits, one decode step captured in a CUDA graph, MLA's
             decode within 0.2 of its full forward (bf16 at 2 layers,
             float32 at 62), and a float32 copy (full width cut to 2
             layers, whisper uncut, arctic and jamba at their reduced
             configs) equal on the card and the CPU within 1e-3 in
             prefill, four decode steps and the caches, with stub
             embeddings and three position streams where the family
             takes them.  Prints per arch what ``lm_serve`` prints, the
             step's kernels and graph replay time, and the other
             families' decode-vs-prefill figures, ungated;

then the kernels' summary line (launches on the main path and on the
runtime, bootstrap, serve and distributed paths, a row per kernel at its
logN=10 shape, and the fused IP at the distributed path's shape), and
last the device line.  Latencies
that the simulator (``repro_torch.sim``) returns model the paper's
accelerators, not this card, and are named so.  Without a CUDA device,
or without the repository beside it, it exits non-zero before printing
any result.
"""
from __future__ import annotations

import ctypes
import gc
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
# CUgraphNodeType of a kernel node (cuda.h)
CU_GRAPH_NODE_TYPE_KERNEL = 0
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
# The bootstrap phase: tests/test_bootstrap.py's parameters, context and
# Bootstrapper, and its decryption bound
BOOT_KW = dict(logN=10, L=23, alpha=3, k=4, q_bits=29, scale_bits=29,
               q0_bits=30)
BOOT_CTX = dict(seed=7, hamming_weight=8)
BOOT_BTP = dict(n_groups=3, mod_K=5, cheb_degree=59)
BOOT_MAX_ERR = 5e-3
# The serve phase: the JAX package's workload parameters
# (tests/test_workloads.py's wctx, benchmarks/bench_workloads.py) at the
# paper's ring degree, nh = 2^15 slots; scale 2^29 on 29-bit primes, so
# no rescale drifts the scale (PAPER_PARAMS pairs 2^28 with 30-bit
# primes, and 9 rescales divide its scale by about 4^9)
SERVE_KW = dict(logN=16, L=14, alpha=2, k=3, q_bits=29, scale_bits=29)
SERVE_SEED = 3
# Tenant secrets: sparse ternary of this Hamming weight.  Rescale and
# ModDown floor the dropped limb (as the JAX package does), which leaves
# a biased term whose largest slot grows about as N * sqrt(h): with dense
# secrets at N = 2^16 logreg decrypts 0.16 off, over its 5e-3 tolerance
SERVE_HW = 64
SERVE_TENANTS = ["alice", "bob", "carol"]
SERVE_RATE = 200.0
SERVE_REQUESTS = 24
SERVE_BATCH = 4
SERVE_WAIT = 0.15
# the programs whose first request is replayed on the CPU
SERVE_REPLICA = ("logreg", "mlp")
# the chaos run: logreg, two tenants, every arrival at t = 0, a fault
# schedule under which every kind fires in the first four dispatches
CHAOS_TENANTS = ["alice", "bob"]
CHAOS_REQUESTS = 12
CHAOS_PLAN = dict(seed=10, p_transient=0.25, p_evict=0.25, p_corrupt=0.25,
                  p_spike=0.25, spike_s=0.05)
# the bootstrap-inserted workload at the JAX package's shape for it
# (tests/test_workloads.py's boot_ctx, input level 7)
SERVE_BOOT_KW = dict(logN=8, L=19, alpha=4, k=4, q_bits=29, scale_bits=29,
                     q0_bits=30)
SERVE_BOOT_CTX = dict(seed=7, hamming_weight=8)
SERVE_BOOT_BTP = dict(n_groups=2, mod_K=3, cheb_degree=27)
SERVE_BOOT_LEVEL = 7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def graph_kernels(fn):
    """(kernels, output) of one ``fn()`` captured into a CUDA graph and
    replayed: the kernel nodes of the graph are the device kernels the
    call enqueues (copies and fills are nodes of other types), read from
    the graph through the driver API, and the output is the replay's.
    Capture also fails if the call launches on a stream other than the
    current one or syncs with the host."""
    drv = ctypes.CDLL("libcuda.so.1")

    def check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what}: CUresult {rc}")

    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        out = fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(drv.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(drv.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        kinds.append(kind.value)
    g.replay()
    torch.cuda.synchronize()
    out = out.clone()
    g.reset()
    return kinds.count(CU_GRAPH_NODE_TYPE_KERNEL), out


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
def ntt_cost(shape, logn: int) -> tuple[int, float]:
    """(bytes, multiply results) of one NTT over ``shape`` (..., l, N):
    the rows in and out, and the l rows of both tables."""
    l, n = shape[-2], shape[-1]
    rows = int(np.prod(shape[:-1]))
    return (2 * rows * n * 8 + 2 * l * n * 4,
            MONT_OPS * rows * n * (1 + logn / 2))


def bconv_cost(batch: int, ls: int, ld: int, n: int,
               g_acc: int) -> tuple[int, int]:
    return batch * (ls + ld) * n * 8, bconv_ops(batch, ls, ld, n, g_acc)


def fused_ip_cost(shape, n_evk: int, with_pt: bool) -> tuple[int, int]:
    """Digits (..., R, dnum, l, N), ``n_evk`` evk stacks (1 or R), the R
    plaintexts, and the (..., 2, l, N) output."""
    nrot, dnum, l, n = shape[-4:]
    batch = int(np.prod(shape[:-4]))
    words = (batch * nrot * dnum + n_evk * dnum * 2
             + (nrot if with_pt else 0) + batch * 2) * l * n
    return words * 8, MONT_OPS * batch * l * n * (
        2 * nrot * dnum + (2 * nrot if with_pt else 0) + 2)


def modup_cost(batch: int, l: int, l_ext: int, sizes, n: int,
               logn: int) -> tuple[int, float]:
    """int64 in and out, the inverse tables of the l source limbs and the
    forward tables of the l_ext destination limbs, each read once."""
    dnum = len(sizes)
    return (batch * (l + dnum * l_ext) * n * 8 + 2 * (l + l_ext) * n * 4,
            MONT_OPS * batch * n * (l * (1 + logn / 2) + sum(
                (l_ext - ls) * (ls + 1 + logn / 2) for ls in sizes)))


def exact(name, got, exp, shape) -> int:
    torch.cuda.synchronize()
    err = int((got - exp).abs().max())
    if not torch.equal(got, exp):
        raise AssertionError(f"{name}: kernel != plain at {shape}, "
                             f"max abs err {err}")
    return err


def kernel_row(native, name, lib, kern, plain, cost, shape) -> dict:
    """``kern()`` against ``plain()`` (exact), its CUDA launches a call
    (the kernel nodes of a graph captured from one call, checked against
    the library's launch log, and the replay exact too), the median
    kernel and plain times, and its bound from ``cost`` = (bytes,
    multiply results)."""
    from repro_torch.kernels.timing import cuda_ms

    want = plain()
    err = exact(name, kern(), want, shape)
    # one more call, captured into a graph and logged by the library
    native.launch_log(lib)
    cuda_launches, replay = graph_kernels(kern)
    logged, cluster = native.launch_log(lib)
    if cuda_launches != logged:
        raise AssertionError(f"{name}: the captured graph holds "
                             f"{cuda_launches} kernels, the library logged "
                             f"{logged}")
    exact(f"{name} (graph replay)", replay, want, shape)
    b, by = bound(*cost)
    return {"max_abs_err": err, "ms": cuda_ms(kern),
            "plain_ms": cuda_ms(plain, reps=2, batches=3, hide_host=False),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": list(shape), "cuda_launches": cuda_launches,
            "cluster": cluster}


def kernel_at(native, P, pc, rng, name: str, dims, primes=None) -> dict:
    """``kernel_row`` of kernel ``name`` at call shape ``dims``, as
    ``native.CALLS`` keys it, on random residues of ``P``'s primes:

    - ``ntt`` / ``ntt_inverse``: the input (..., l, N), of the first l
      primes of the chain unless ``primes`` is given;
    - ``bconv``: (..., k, l) from the special primes to the first l (a
      ModDown); ``bconv_rescale``: (..., 1, l) from prime l to the l
      below it; both also exact on all-(q-1) residues;
    - ``fused_ip``: digits (..., R, dnum, l_ext, N), then the number of
      evk stacks and whether plaintexts come with them;
    - ``modup_all``: the input (..., l, N), every digit of level l-1."""
    from repro_torch.kernels.bconv.ops import BConvConsts, bconv, bconv_plain
    from repro_torch.kernels.fused_ip.ops import IPConsts, fused_ip, fused_ip_plain
    from repro_torch.kernels.modup.ops import ModUpConsts, modup, modup_plain
    from repro_torch.kernels.ntt.ops import (
        ntt_fwd, ntt_fwd_plain, ntt_inv, ntt_inv_plain,
    )

    dev = torch.device("cuda")
    N, logn, k, tabs = P.N, P.logN, P.k, pc.tabs
    dims = list(dims)
    if name in ("ntt", "ntt_inverse"):
        inverse = name == "ntt_inverse"
        pr = list(primes or (P.q_primes + P.p_primes)[:dims[-2]])
        x = residues(rng, pr, tuple(dims), dev)
        kern = ntt_inv if inverse else ntt_fwd
        plain = ntt_inv_plain if inverse else ntt_fwd_plain
        tables = tabs.plain_rows(pr, dev, inverse=inverse)
        return kernel_row(native, name, "ntt", lambda: kern(x, pr, tabs),
                          lambda: plain(x, *tables), ntt_cost(dims, logn),
                          dims)
    if name in ("bconv", "bconv_rescale"):
        ls, ld = dims[-2:]
        src = (P.p_primes if name == "bconv"
               else P.q_primes[ld:ld + ls])
        cc = BConvConsts(pc.rns, src, P.q_chain(ld - 1), dev)
        x = residues(rng, src, tuple(dims[:-2]) + (ls, N), dev)
        top = (cc.src_q[:, None] - 1).expand(x.shape).contiguous()
        exact(name, bconv(top, cc), bconv_plain(
            top, cc.qhat_inv, cc.src_q, cc.qhat_mod, cc.dst_q), dims)
        return kernel_row(
            native, name, "bconv", lambda: bconv(x, cc),
            lambda: bconv_plain(x, cc.qhat_inv, cc.src_q, cc.qhat_mod,
                                cc.dst_q),
            bconv_cost(x.numel() // (ls * N), ls, ld, N, cc.g_acc), dims)
    if name == "fused_ip":
        shape, n_evk, with_pt = dims[:-2], dims[-2], bool(dims[-1])
        nrot, dnum, l_ext = shape[-4:-1]
        ext = P.q_chain(l_ext - k - 1) + P.p_primes
        ipc = IPConsts(ext, dev)
        dig = residues(rng, ext, tuple(shape), dev)
        evk = residues(rng, ext, (n_evk, dnum, 2, l_ext, N), dev)
        pt = residues(rng, ext, (nrot, l_ext, N), dev) if with_pt else None
        return kernel_row(native, name, "fused_ip",
                          lambda: fused_ip(dig, evk, pt, ipc),
                          lambda: fused_ip_plain(dig, evk, pt, ipc.q),
                          fused_ip_cost(shape, n_evk, with_pt), dims)
    assert name == "modup_all", name
    l = dims[-2]
    base = P.q_chain(l - 1)
    groups = P.digit_groups(l - 1)
    mc = ModUpConsts(pc.rns, tabs, groups, base, base + P.p_primes, dev)
    xm = residues(rng, base, tuple(dims), dev)
    return kernel_row(native, name, "modup", lambda: modup(xm, mc),
                      lambda: modup_plain(xm, mc),
                      modup_cost(xm.numel() // (l * N), l, l + k,
                                 [len(D) for D in groups], N, logn), dims)


def phase_kernels(P, native) -> dict:
    from repro_torch.core.poly import PolyContext

    pc = PolyContext(P, device=torch.device("cuda"))
    rng = np.random.default_rng(SEED)
    N, k, l, R = P.N, P.k, P.L + 1, 4
    dnum, l_ext = len(P.digit_groups(P.L)), l + k
    shapes = {
        # the ModDown forward transform of both accumulators, 2 x l rows,
        # and its inverse transform of the P limbs, 2 x k rows
        "ntt": ([2, l, N], None),
        "ntt_inverse": ([2, k, N], P.p_primes),
        # ModDown P -> Q of both accumulators; the rescale's last prime
        # -> the rest
        "bconv": ([2, k, l], None),
        "bconv_rescale": ([1, l - 1], None),
        # a hoisted block of 4 rotations with plaintexts
        "fused_ip": ([R, dnum, l_ext, N, R, 1], None),
        # ModUp of every digit of one level-35 polynomial (B = 1)
        "modup_all": ([l, N], None),
    }
    out = {name: kernel_at(native, P, pc, rng, name, dims, primes)
           for name, (dims, primes) in shapes.items()}
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


def busy_profile(fn) -> dict:
    """``device_profile`` of ``fn`` with the device's busy share of the
    profiled wall time."""
    prof = device_profile(fn)
    if prof["device_ms"] is not None:
        prof["device_busy_share"] = (prof["device_ms"] / 1e3
                                     / prof["profiled_wall_s"])
    return prof


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


def counted_run(native, fn, path: str = "runtime") -> tuple:
    """``fn()`` with the launch counts set to 0 just before it and read
    just after: (result, wall seconds, launches, CUDA launches, calls,
    clusters), where ``clusters`` holds each library's cluster dimension
    of its first eight launches."""
    native.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    logs = {k: native.launch_log(k) for k in launches}
    cuda_launches = {k: v[0] for k, v in logs.items()}
    clusters = {k: v[1] for k, v in logs.items()}
    calls = {f"{f} {list(shape)}": v
             for (f, shape), v in sorted(native.CALLS.items())}
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{idle}")
    for k, n in cuda_launches.items():
        if n != CUDA_PER_CALL[k] * launches[k]:
            raise AssertionError(f"{path} {k}: {n} CUDA launches for "
                                 f"{launches[k]} wrapper calls")
    return out, wall, launches, cuda_launches, calls, clusters


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
        res, wall, launches, cuda_launches, calls, _ = counted_run(native,
                                                                  fn)
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
    prof = busy_profile(lambda: ex.run(comps[False], {"x": cts[0]}))

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


def path_launches(runs, name: str) -> int:
    """Wrapper calls of kernel row ``name`` in counted runs ``runs``, each
    a dict with the run's ``calls``, ``launches`` and the params' ``k``."""
    total = 0
    for run in runs:
        calls = run["calls"]
        if name in ("ntt", "ntt_inverse"):
            prefix = "ntt_forward " if name == "ntt" else "ntt_inverse "
            total += sum(v for c, v in calls.items() if c.startswith(prefix))
        elif name in ("bconv", "bconv_rescale"):
            kinds = bconv_calls(calls, run["k"])
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


# ------------------------------------------------------------------ phase 6
def kw_str(kw: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in kw.items())


def counted(native, fn, path: str, P) -> tuple:
    """``counted_run`` of ``fn`` at params ``P``: its result and the
    run's record."""
    res, wall, launches, cuda_launches, calls, clusters = counted_run(
        native, fn, path)
    return res, {"s": wall, "k": P.k, "logn": P.logN, "launches": launches,
                 "cuda_launches": cuda_launches, "calls": calls,
                 "clusters": clusters}


def max_err(ctx, ct, want) -> float:
    """Largest slot error of ``ct``'s decryption against ``want`` (its
    real part against a real ``want``)."""
    got = ctx.decrypt(ct)
    if np.isrealobj(want):
        got = got.real
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"bad decryption {got.shape}")
    return float(np.abs(got - want).max())


def phase_bootstrap(native) -> dict:
    """Bootstrapping at logN=10, L=23 (tests/test_bootstrap.py's shape),
    eager and compiled, on the card; see the module docstring."""
    from repro_torch.core.bootstrap import Bootstrapper
    from repro_torch.core.ckks import CKKSContext
    from repro_torch.core.params import CKKSParams
    from repro_torch.runtime import ProgramExecutor
    from repro_torch.sim import HE2_SM

    t_phase = time.perf_counter()
    P = CKKSParams(**BOOT_KW)
    rng = np.random.default_rng(SEED + 8)
    nh = P.num_slots
    zs = [(rng.normal(size=nh) + 1j * rng.normal(size=nh)) * 0.01
          for _ in range(2)]
    secs = {}
    t0 = time.perf_counter()
    ctx = CKKSContext(P, device="cuda", **BOOT_CTX)
    btp = Bootstrapper(ctx, **BOOT_BTP)
    secs["build"] = time.perf_counter() - t0
    cts = [ctx.encrypt(z, level=0) for z in zs]
    t0 = time.perf_counter()
    comps = {"exact": btp.compile(input_scale=cts[0].scale),
             "inexact": btp.compile(input_scale=cts[0].scale, exact=False),
             "fused": btp.compile(input_scale=cts[0].scale, fusion=True)}
    secs["compile"] = time.perf_counter() - t0
    ex = ProgramExecutor(ctx)

    def run(name, i=0, report=True):
        before = ctx.counters.snapshot()
        res = ex.run(comps[name], {"ct": cts[i]}, with_report=report)
        return res, ctx.counters.delta(before)

    # the compiled program, exact and unfused: its first run is counted
    (res, ops), rec = counted(native, lambda: run("exact"), "bootstrap",
                              P)
    secs["first_run"] = rec["s"]
    out = res["out"]
    check = res.report.reconcile()
    if not check["counts_match"] or not res.report.validate_plan_shapes(P):
        raise AssertionError(f"bootstrap: counts do not reconcile {check}")
    if any(c != 1 for c in rec["clusters"]["ntt"]):
        raise AssertionError(f"bootstrap: NTT clusters {rec['clusters']} "
                             f"at logN={P.logN}, expected 1")
    t0 = time.perf_counter()
    run("exact", report=False)
    torch.cuda.synchronize()
    secs["warm_run"] = time.perf_counter() - t0
    # ModRaise lifts through centered_crt on the host, as the reference's
    t0 = time.perf_counter()
    ctx.mod_raise(cts[0])
    torch.cuda.synchronize()
    secs["mod_raise"] = time.perf_counter() - t0

    # the eager pipeline: the same residues at more ModUps
    before = ctx.counters.snapshot()
    t0 = time.perf_counter()
    eager = btp.bootstrap(cts[0])
    torch.cuda.synchronize()
    secs["eager"] = time.perf_counter() - t0
    eager_ops = ctx.counters.delta(before)
    if not same_ct(out, eager):
        raise AssertionError("bootstrap: compiled output differs from the "
                             "eager bootstrap")
    if not ops.modup < eager_ops.modup:
        raise AssertionError(f"bootstrap: {ops.modup} compiled ModUps, "
                             f"eager {eager_ops.modup}")
    err = max_err(ctx, eager, zs[0])
    if eager.level < 1 or err >= BOOT_MAX_ERR:
        raise AssertionError(f"bootstrap: level {eager.level}, error {err}")
    sim_s = res.report.scheduled_result(comps["exact"], HE2_SM).latency_s
    if not sim_s > 0:
        raise AssertionError("bootstrap: no scheduled latency")

    # exact=False: merged giant-step ModDowns, within the error bound
    res_in, ops_in = run("inexact")
    err_in = max_err(ctx, res_in["out"], zs[0])
    if not (comps["inexact"].n_multi > 0 and ops_in.moddown < ops.moddown
            and res_in.report.reconcile()["counts_match"]
            and err_in <= 1.5 * err + 1e-3):
        raise AssertionError(f"bootstrap exact=False: {ops_in.moddown} "
                             f"ModDowns (exact {ops.moddown}), error "
                             f"{err_in} (exact {err})")
    res_f, ops_f = run("fused")
    if not res_f.report.reconcile()["counts_match"]:
        raise AssertionError("bootstrap fusion=True: counts do not "
                             "reconcile")

    # B=2: each slot equals its single run
    res_b, rec_b = counted(
        native, lambda: ex.run_batched(comps["exact"], {"ct": cts},
                                       with_report=True),
        "bootstrap", P)
    if not (same_ct(res_b["out"][0], out) and same_ct(
            res_b["out"][1], run("exact", 1, report=False)[0]["out"])):
        raise AssertionError("bootstrap: a batch slot differs from its "
                             "single run")
    prof = busy_profile(lambda: run("exact", report=False))

    # the same programs on the CPU, in the same order (the same keys)
    t0 = time.perf_counter()
    cpu = CKKSContext(P, device="cpu", **BOOT_CTX)
    cpu_cts = [cpu.encrypt(z, level=0) for z in zs]
    cpu_ex = ProgramExecutor(cpu)
    for name, got in (("exact", out), ("inexact", res_in["out"]),
                      ("fused", res_f["out"])):
        if not same_ct(got, cpu_ex.run(comps[name],
                                       {"ct": cpu_cts[0]})["out"]):
            raise AssertionError(f"bootstrap {name}: card and CPU residues "
                                 f"differ")
    secs["cpu_replica"] = time.perf_counter() - t0
    res = {"phase": "bootstrap",
           "params": kw_str(BOOT_KW), "bootstrapper": BOOT_BTP,
           "level_out": out.level,
           "max_err": err, "bound": BOOT_MAX_ERR, "inexact_err": err_in,
           "compiled_equals_eager": True, "batch_slots_equal": True,
           "cpu_identical": ["exact", "inexact", "fused"],
           "modup_moddown": {"compiled": [ops.modup, ops.moddown],
                             "eager": [eager_ops.modup, eager_ops.moddown],
                             "inexact": [ops_in.modup, ops_in.moddown],
                             "fused": [ops_f.modup, ops_f.moddown]},
           "steps": {k: len(c.steps) for k, c in comps.items()},
           "n_multi": comps["inexact"].n_multi,
           "runs": {"compiled": rec, "batched": rec_b},
           "seconds_by_stage": secs, "profile": prof,
           "simulator_he2_sm_latency_s": sim_s,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


def slice_rows(native, boot: dict) -> dict:
    """Each kernel at the bootstrap phase's most frequent logN=10 shape
    (from its counted compiled run's ``native.CALLS``) against its plain
    version, with its bound: {name: (row, calls at the shape, key)}."""
    from repro_torch.core.params import CKKSParams
    from repro_torch.core.poly import PolyContext

    P = CKKSParams(**BOOT_KW)
    pc = PolyContext(P, device=torch.device("cuda"))
    rng = np.random.default_rng(SEED + 14)
    calls = boot["runs"]["compiled"]["calls"]

    def top(fn, keep=lambda dims: True):
        """(shape, calls) of entry point ``fn``'s most frequent shape."""
        cands = [(v, json.loads(c.partition(" ")[2])) for c, v in
                 calls.items() if c.partition(" ")[0] == fn
                 and keep(json.loads(c.partition(" ")[2]))]
        v, dims = max(cands, key=lambda t: t[0])
        return dims, v

    entry = {
        "ntt": ("ntt_forward", lambda d: True),
        "ntt_inverse": ("ntt_inverse", lambda d: True),
        "bconv": ("bconv", lambda d: d[-2] == P.k and len(d) >= 3
                  and d[-3] == 2),
        "bconv_rescale": ("bconv", lambda d: d[-2] == 1),
        "fused_ip": ("fused_ip", lambda d: True),
        "modup_all": ("modup_all", lambda d: True),
    }
    rows = {}
    for name, (fn, keep) in entry.items():
        dims, v = top(fn, keep)
        rows[name] = (kernel_at(native, P, pc, rng, name, dims), v,
                      f"{fn} {dims}")
    emit({"phase": "bootstrap_kernels", "params": kw_str(BOOT_KW),
          "results": {n: {**r, "calls_at_shape": v, "key": key}
                      for n, (r, v, key) in rows.items()}})
    return rows


# ------------------------------------------------------------------ phase 7
def _timed_lifts(ctx) -> dict:
    """Wrap ``ctx._pmodup`` (the host's exact lift of a plaintext, on a
    cache miss) to add up its seconds and count its misses."""
    acc = {"s": 0.0, "lifts": 0}
    lift = ctx._pmodup

    def timed(pt, level):
        if level in pt.pmodup_cache:
            return pt.pmodup_cache[level]
        t0 = time.perf_counter()
        out = lift(pt, level)
        acc["s"] += time.perf_counter() - t0
        acc["lifts"] += 1
        return out

    ctx._pmodup = timed
    return acc


class _Rekeys:
    """Host seconds spent making tenant keys (a ``KeyChain`` and its
    evks) while active: what re-keying an evicted tenant costs."""

    def __enter__(self):
        from repro_torch.core.keys import KeyChain

        self.cls, self.s, self.chains = KeyChain, 0.0, 0
        self.orig = (KeyChain.__init__, KeyChain._gen_evk)
        init, gen = self.orig

        def timed_init(chain, *a, **k):
            t0 = time.perf_counter()
            init(chain, *a, **k)
            self.s += time.perf_counter() - t0
            self.chains += 1

        def timed_gen(chain, *a, **k):
            t0 = time.perf_counter()
            out = gen(chain, *a, **k)
            torch.cuda.synchronize()
            self.s += time.perf_counter() - t0
            return out

        KeyChain.__init__, KeyChain._gen_evk = timed_init, timed_gen
        return self

    def __exit__(self, *exc):
        self.cls.__init__, self.cls._gen_evk = self.orig
        return False


def _serve_loop(report, records) -> dict:
    """The ``ServingReport`` numbers of one loop."""
    widths = {}
    for r in records:
        if r.ok:
            n, s = widths.get(f"{r.program_id}@{r.batch}", (0, 0.0))
            widths[f"{r.program_id}@{r.batch}"] = (n + 1, s + r.duration_s)
    return {"completed": report.completed, "failed": report.failed,
            "shed": report.shed, "rejected": report.rejected,
            "batches": report.batches,
            "batch_occupancy": report.batch_occupancy,
            "p50_latency_s": report.p50_latency_s,
            "p99_latency_s": report.p99_latency_s,
            "throughput_rps": report.throughput_ops, "span_s": report.span_s,
            "plan_cache": report.plan_cache,
            "s_per_batch": {k: {"batches": n, "mean_s": s / n}
                            for k, (n, s) in sorted(widths.items())}}


def _decrypt_errors(ctx, registry, outputs, sent, models) -> dict:
    """Largest slot error of each program's outputs, each decrypted under
    its own tenant's key, against the banded reference."""
    errs = {}
    for rid, (a, x, _) in enumerate(sent):
        with registry.lease(a.tenant):
            err = max_err(ctx, outputs[rid]["y"],
                          models[a.program_id].reference(x))
        errs[a.program_id] = max(errs.get(a.program_id, 0.0), err)
    return errs


def _gate_loop(name, rep, n, warm_hits, errs, models) -> None:
    """Every request completed, a plan-cache hit for every batch (the
    hits after ``warm_hits``, those of the warm-up), every output within
    its workload's tolerance."""
    if (rep.completed, rep.failed, rep.shed, rep.rejected) != (n, 0, 0, 0):
        raise AssertionError(f"serve {name}: {rep.completed} of {n} "
                             f"completed, {rep.failed} failed, {rep.shed} "
                             f"shed, {rep.rejected} rejected")
    if rep.plan_cache["hits"] - warm_hits != rep.batches:
        raise AssertionError(f"serve {name}: {rep.plan_cache['hits']} plan "
                             f"hits ({warm_hits} in the warm-up) for "
                             f"{rep.batches} batches")
    bad = {p: e for p, e in errs.items() if not e < models[p].tolerance}
    if bad:
        raise AssertionError(f"serve {name}: decryption errors {bad} above "
                             f"the workloads' tolerances")


def _inputs(ctx, models, seed: int, sent: list):
    """``inputs_for`` of a served trace: a sample of the program's model,
    encrypted under the lease the server holds; ``sent`` gets (arrival,
    sample, ciphertext) in admission order (rid order)."""
    rng = np.random.default_rng(seed)

    def inputs_for(a):
        x = models[a.program_id].sample(rng)
        ct = ctx.encrypt(x)
        sent.append((a, x, ct))
        return {"x": ct}

    return inputs_for


def serve_cpu_replica(P, registry, programs, sent, outputs, pids) -> dict:
    """The first request of each program in ``pids`` through the plain
    versions on the CPU, under a copy of its tenant's keys: the output
    must equal the card's residue for residue."""
    from repro_torch import convert
    from repro_torch.core.ckks import CKKSContext
    from repro_torch.runtime import ProgramExecutor

    out = {}
    cpu = CKKSContext(P, seed=SERVE_SEED, hamming_weight=SERVE_HW,
                      device="cpu")
    ex = ProgramExecutor(cpu)
    for pid in pids:
        t0 = time.perf_counter()
        rid = next(i for i, (a, _, _) in enumerate(sent)
                   if a.program_id == pid)
        a, _, ct = sent[rid]
        keys = convert.keychain_to_numpy(registry.keychain(a.tenant))
        cpu.keys = convert.keychain_from_numpy(cpu.pc, **keys)
        got = ex.run(programs[pid], {"x": convert.ciphertext_from_numpy(
            cpu.pc, **convert.ciphertext_to_numpy(ct))})["y"]
        if not same_ct(outputs[rid]["y"], got):
            raise AssertionError(f"serve: rid {rid} ({pid}) card and CPU "
                                 f"residues differ")
        out[pid] = {"rid": rid, "identical": True,
                    "s": time.perf_counter() - t0}
    return out


def serve_chaos(ctx, registry, executor, programs, models) -> dict:
    """logreg only, two tenants, every arrival at t = 0, under a seeded
    fault schedule that fires every kind of fault (see the module
    docstring)."""
    from repro_torch.serve import Arrival, FaultInjector, FaultPlan, FHEServer

    pid = "logreg"
    injector = FaultInjector(FaultPlan(**CHAOS_PLAN))
    server = FHEServer(ctx, max_batch=SERVE_BATCH, max_wait_s=0.0,
                       registry=registry, faults=injector, max_retries=4)
    server.executor = executor
    server.register_program(pid, programs[pid])
    with registry.lease(CHAOS_TENANTS[0]):
        ct0 = ctx.encrypt(np.zeros(ctx.params.num_slots))
    for w in (1, 2, 4):
        server.warmup(CHAOS_TENANTS[0], pid, {"x": ct0}, width=w)
    trace = [Arrival(0.0, CHAOS_TENANTS[i % 2], pid)
             for i in range(CHAOS_REQUESTS)]
    sent = []
    evictions = registry.evictions
    t0 = time.perf_counter()
    with _Rekeys() as rekeys:
        rep = server.run_trace(trace, _inputs(ctx, models, SEED + 22, sent))
    wall = time.perf_counter() - t0
    inj = dict(injector.injected)
    evicted = registry.evictions - evictions
    failed = sorted(r for r, o in server.outcomes.items() if o != "completed")
    if not all(v >= 1 for v in inj.values()):
        raise AssertionError(f"serve chaos: a fault kind never fired {inj}")
    if (rep.accounted != rep.submitted or rep.submitted != CHAOS_REQUESTS
            or len(server.outcomes) != CHAOS_REQUESTS):
        raise AssertionError(f"serve chaos: {rep.accounted} of "
                             f"{rep.submitted} requests accounted")
    if (rep.failed != inj["corrupt"] or len(failed) != inj["corrupt"]
            or rep.errors != ({"CorruptCiphertextError": inj["corrupt"]}
                              if inj["corrupt"] else {})
            or any(r in server.outputs for r in failed)):
        raise AssertionError(f"serve chaos: {failed} failed, {rep.errors}, "
                             f"for {inj['corrupt']} corrupted slots")
    if rep.retries != inj["transient"] + inj["evict"]:
        raise AssertionError(f"serve chaos: {rep.retries} retries for "
                             f"{inj['transient']} transient faults and "
                             f"{inj['evict']} evictions")
    if not 1 <= evicted <= inj["evict"] or rekeys.chains != evicted:
        raise AssertionError(f"serve chaos: {evicted} tenants evicted, "
                             f"{rekeys.chains} re-keyed, for "
                             f"{inj['evict']} injected evictions")
    errs = 0.0
    for rid, outs in server.outputs.items():
        a, x, _ = sent[rid]
        with registry.lease(a.tenant):
            errs = max(errs, max_err(ctx, outs["y"], models[pid].reference(x)))
    if not errs < models[pid].tolerance:
        raise AssertionError(f"serve chaos: decryption error {errs}")
    return {"plan": CHAOS_PLAN, "requests": CHAOS_REQUESTS,
            "injected": inj, "completed": rep.completed,
            "failed_rids": failed, "retries": rep.retries,
            "quarantine_splits": rep.quarantine_splits,
            "evicted": evicted, "rekeyed": rekeys.chains,
            "rekey_host_s": rekeys.s, "max_err": errs, "s": wall,
            "outcomes_accounted": True}


def serve_bootstrap_chain(dev) -> dict:
    """``mlp_bootstrap`` at the JAX package's shape for it, served hop by
    hop (compute -> bootstrap -> compute) through ``FHEServer`` to one
    tenant with a sparse secret."""
    from repro_torch.core.bootstrap import Bootstrapper
    from repro_torch.core.ckks import CKKSContext
    from repro_torch.core.params import CKKSParams
    from repro_torch.serve import (
        Arrival, FHEServer, TenantRegistry, workload_request_programs,
    )
    from repro_torch.workloads import compile_workload, mlp_bootstrap

    t0 = time.perf_counter()
    P = CKKSParams(**SERVE_BOOT_KW)
    ctx = CKKSContext(P, device=dev, **SERVE_BOOT_CTX)
    btp = Bootstrapper(ctx, **SERVE_BOOT_BTP)
    m = mlp_bootstrap(P.num_slots, bs=4)
    wp = compile_workload(m, P, btp=btp, input_level=SERVE_BOOT_LEVEL)
    programs, chains = workload_request_programs(
        [m], P, btp=btp, input_level=SERVE_BOOT_LEVEL)
    hops = chains[m.name]
    kinds = [s.kind for s in wp.segments]
    if kinds != ["compute", "bootstrap", "compute"] or len(hops) != 3:
        raise AssertionError(f"serve bootstrap chain: segments {kinds}, "
                             f"hops {hops}")
    registry = TenantRegistry(ctx, hamming_weight=SERVE_BOOT_CTX[
        "hamming_weight"])
    server = FHEServer(ctx, max_batch=2, max_wait_s=0.0, registry=registry)
    for pid, comp in programs.items():
        server.register_program(pid, comp)
    rng = np.random.default_rng(SEED + 24)
    xs = [m.sample(rng) for _ in range(2)]
    tenant = "dave"
    with registry.lease(tenant):
        cur = [ctx.encrypt(x, level=SERVE_BOOT_LEVEL) for x in xs]
    first = list(cur)
    for pid, in_tag, out_tag in hops:
        base = server.submitted
        it = iter(cur)
        rep = server.run_trace([Arrival(0.0, tenant, pid)] * len(xs),
                               lambda a: {in_tag: next(it)})
        cur = [server.outputs[base + i][out_tag] for i in range(len(xs))]
    if rep.completed != 3 * len(xs) or rep.failed or rep.shed:
        raise AssertionError(f"serve bootstrap chain: {rep.completed} hops "
                             f"completed")
    errs = []
    with registry.lease(tenant):
        for x, ct, got in zip(xs, first, cur, strict=True):
            if not same_ct(got, wp.run_eager(ctx, ct, btp=btp)):
                raise AssertionError("serve bootstrap chain: served output "
                                     "differs from run_eager")
            errs.append(max_err(ctx, got, m.reference(x)))
    if not max(errs) < m.tolerance:
        raise AssertionError(f"serve bootstrap chain: decryption errors "
                             f"{errs}, tolerance {m.tolerance}")
    return {"params": kw_str(SERVE_BOOT_KW), "bootstrapper": SERVE_BOOT_BTP,
            "input_level": SERVE_BOOT_LEVEL, "hops": [h[0] for h in hops],
            "segments": kinds, "n_bootstraps": wp.n_bootstraps,
            "served_equals_eager": True, "max_err": max(errs),
            "tolerance": m.tolerance, "level_out": cur[0].level,
            "batches": rep.batches, "s": time.perf_counter() - t0}


def serve_shapes(calls: dict, P) -> dict:
    """The served traffic's calls at the shapes of ``P``'s full chain:
    ModUp of all dnum digits of level L, the fused IP over dnum digits of
    L+1+k limbs, ModDown's BConv from the k special primes."""
    l, l_ext, dnum = P.L + 1, P.L + 1 + P.k, len(P.digit_groups(P.L))
    out = {"modup_all": 0, "fused_ip": 0, "bconv": 0}
    for key, v in calls.items():
        fn, _, dims = key.partition(" ")
        dims = json.loads(dims)
        if fn == "modup_all" and dims[-2:] == [l, P.N]:
            out[fn] += v
        elif fn == "fused_ip" and dims[-5:-2] == [dnum, l_ext, P.N]:
            out[fn] += v
        elif fn == "bconv" and dims[-2:] == [P.k, l]:
            out[fn] += v
    return {"dnum": dnum, "l_ext": l_ext, "k": P.k, "calls": out}


def phase_serve(native, dev="cuda") -> dict:
    """The multi-tenant FHE server at SERVE_KW (see the module
    docstring)."""
    from repro_torch.core.ckks import CKKSContext
    from repro_torch.core.params import CKKSParams
    from repro_torch.serve import (
        FHEServer, TenantRegistry, poisson_trace, replay_on_hardware,
        workload_request_programs,
    )
    from repro_torch.sim import HE2_SM
    from repro_torch.workloads import logreg, mlp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    P = CKKSParams(**SERVE_KW)
    nh = P.num_slots
    secs = {}
    t0 = time.perf_counter()
    models = {m.name: m for m in (logreg(nh, degree=15), mlp(nh))}
    secs["models"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    programs, _ = workload_request_programs(list(models.values()), P)
    secs["compile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = CKKSContext(P, seed=SERVE_SEED, hamming_weight=SERVE_HW,
                      device=dev)
    lifts = _timed_lifts(ctx)
    registry = TenantRegistry(ctx, hamming_weight=SERVE_HW)
    server = FHEServer(ctx, max_batch=SERVE_BATCH, max_wait_s=SERVE_WAIT,
                       registry=registry)
    for pid, comp in programs.items():
        server.register_program(pid, comp)
    # tenant enrollment, as benchmarks/bench_serving.py warms: the first
    # tenant every width, the others the widest
    zeros = {}
    for ti, tenant in enumerate(SERVE_TENANTS):
        with registry.lease(tenant):
            zeros[tenant] = {"x": ctx.encrypt(np.zeros(nh))}
        for pid in programs:
            for w in ((1, 2, SERVE_BATCH) if ti == 0 else (SERVE_BATCH,)):
                server.warmup(tenant, pid, zeros[tenant], width=w)
    torch.cuda.synchronize()
    secs["warmup"] = time.perf_counter() - t0
    secs["lift"] = lifts["s"]
    traces = dict(ctx.engine.trace_counts)
    warm_hits = server.plan_cache.hits
    trace = poisson_trace(SERVE_RATE, SERVE_REQUESTS, SERVE_TENANTS,
                          list(programs), seed=SERVE_SEED)

    sent = []
    rep, run = counted(native, lambda: server.run_trace(
        trace, _inputs(ctx, models, SEED + 20, sent)), "serve", P)
    serial = FHEServer(ctx, max_batch=SERVE_BATCH, max_wait_s=SERVE_WAIT,
                       registry=registry)
    # the executor holds the programs' plaintexts, encoded and lifted in
    # the warm-up: a second server on the same context reuses them
    serial.executor = server.executor
    for pid, comp in programs.items():
        serial.register_program(pid, comp)
        serial.warmup(SERVE_TENANTS[0], pid, zeros[SERVE_TENANTS[0]],
                      width=1)
    sent_serial = []
    t0 = time.perf_counter()
    rep_serial = serial.run_serial(trace, _inputs(ctx, models, SEED + 20,
                                                  sent_serial))
    serial_wall = time.perf_counter() - t0
    retraces = sum(ctx.engine.trace_counts.values()) - sum(traces.values())
    if retraces:
        raise AssertionError(f"serve: {retraces} new dispatch shapes after "
                             f"warm-up")
    errs = {"continuous": _decrypt_errors(ctx, registry, server.outputs,
                                          sent, models),
            "serial": _decrypt_errors(ctx, registry, serial.outputs,
                                      sent_serial, models)}
    _gate_loop("continuous", rep, SERVE_REQUESTS, warm_hits,
               errs["continuous"], models)
    _gate_loop("serial", rep_serial, SERVE_REQUESTS, 0, errs["serial"],
               models)
    shapes = serve_shapes(run["calls"], P)
    if not all(shapes["calls"].values()):
        raise AssertionError(f"serve: a kernel was not called at the full "
                             f"chain's shapes {shapes}")

    # slot j of a batched dispatch equals the same request run alone
    slots = 0
    for pid in programs:
        rec = next(r for r in server.records
                   if r.program_id == pid and r.ok and r.n_real > 1)
        with registry.lease(rec.tenant):
            for rid in rec.rids:
                alone = server.executor.run(programs[pid],
                                            {"x": sent[rid][2]})["y"]
                if not same_ct(alone, server.outputs[rid]["y"]):
                    raise AssertionError(f"serve: rid {rid} of a batch of "
                                         f"{rec.batch} differs from its "
                                         f"single run")
                slots += 1
    # the busy share of one full batch of each program
    prof = {}
    for pid in programs:
        rec = next(r for r in server.records if r.program_id == pid)
        cts = [sent[r][2] for r in rec.rids]
        cts += [cts[-1]] * (SERVE_BATCH - len(cts))
        with registry.lease(rec.tenant):
            prof[pid] = busy_profile(lambda: server.executor.run_batched(
                programs[pid], {"x": cts}))
    sim = replay_on_hardware(server.records, programs, HE2_SM)

    t0 = time.perf_counter()
    replica = serve_cpu_replica(P, registry, programs, sent, server.outputs,
                                SERVE_REPLICA)
    secs["cpu_replica"] = time.perf_counter() - t0
    chaos = serve_chaos(ctx, registry, server.executor, programs, models)
    boot = serve_bootstrap_chain(dev)
    loops = {"continuous": _serve_loop(rep, server.records),
             "serial": _serve_loop(rep_serial, serial.records)}
    loops["serial"]["wall_s"] = serial_wall
    loops["continuous"]["wall_s"] = run["s"]
    res = {"phase": "serve", "params": kw_str(SERVE_KW),
           "slots": nh, "dnum": shapes["dnum"],
           "workloads": {p: {"tolerance": m.tolerance,
                             "summary": programs[p].summary(),
                             "steps": len(programs[p].steps)}
                         for p, m in models.items()},
           "trace": {"rate_rps": SERVE_RATE, "requests": SERVE_REQUESTS,
                     "tenants": SERVE_TENANTS, "seed": SERVE_SEED,
                     "max_batch": SERVE_BATCH, "max_wait_s": SERVE_WAIT},
           "setup_s": secs, "lifts": lifts["lifts"],
           "loops": loops,
           "throughput_ratio": (loops["continuous"]["throughput_rps"]
                                / loops["serial"]["throughput_rps"]),
           "max_err": errs, "retraces_after_warmup": retraces,
           "batched_slots_equal_single": slots, "cpu_replica": replica,
           "shapes": shapes, "run": run,
           "launches_per_request": {k: v / SERVE_REQUESTS
                                    for k, v in run["launches"].items()},
           "profile": prof,
           "simulator_he2_sm": {k: sim[k] for k in (
               "pipelined_s", "serial_s", "speedup", "throughput_ops",
               "comm_stall_frac")},
           "chaos": chaos, "bootstrap_chain": boot,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


# ------------------------------------------------------------------ phase 8
# The distributed keyswitch at the paper's shape: dnum = 3 digits of
# l_ext = 48 limbs (level 35 and the 12 special primes) at N = 2^16
DIST_LEVEL = 35
DIST_P = (2, 4, 8)


def phase_distributed(native) -> dict:
    """IRF and EVF on an NCCL group of one rank (one card), their local
    inner product through the fused-IP kernel at R = 1 without a
    plaintext; both held residue for residue against the plain version
    on the card.  Prints the kernel's row at that shape, the bytes each
    all-to-all sent off the rank (none at P = 1) and the analytic IRF /
    EVF bytes for P = 2, 4, 8.  No time across cards is claimed: there is
    one card."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.core.params import PAPER_PARAMS as P
    from repro_torch.core.poly import PolyContext
    from repro_torch.kernels.fused_ip.ops import fused_ip_plain
    from repro_torch.kernels.timing import cuda_ms

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    ext = P.q_chain(DIST_LEVEL) + P.p_primes
    dnum, l_ext, N = len(P.digit_groups(DIST_LEVEL)), len(ext), P.N
    rng = np.random.default_rng(SEED + 8)
    digits = residues(rng, ext, (dnum, l_ext, N), dev)
    evk = residues(rng, ext, (dnum, 2, l_ext, N), dev)
    q = torch.tensor(ext, dtype=torch.int64, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            fns = {"IRF": distributed.ip_irf()[0],
                   "EVF": distributed.ip_evf()[0]}
            # the counted run: every launch of the path's IRF and EVF
            native.reset_counts()
            outs = {kind: fn(digits, evk, ext) for kind, fn in fns.items()}
            torch.cuda.synchronize()
            launches = dict(native.LAUNCHES)
            cuda_launches = native.launch_log("fused_ip")[0]
            calls = {f"{f} {list(shape)}": v
                     for (f, shape), v in sorted(native.CALLS.items())}
            if launches["fused_ip"] != len(fns) or cuda_launches != len(fns):
                raise AssertionError(f"distributed: {launches}, "
                                     f"{cuda_launches} CUDA launches")
            if any(v for k, v in launches.items() if k != "fused_ip"):
                raise AssertionError(f"distributed: {launches}")
            want = fused_ip_plain(digits[None], evk[None], None, q)
            errs = {kind: exact(f"distributed {kind}", torch.stack(out),
                                want, [dnum, l_ext, N])
                    for kind, out in outs.items()}
            counted = {kind: distributed.measure_collectives(
                fn, digits, evk, ext) for kind, fn in fns.items()}
            ms = {kind: cuda_ms(lambda fn=fn: fn(digits, evk, ext))
                  for kind, fn in fns.items()}
        finally:
            dist.destroy_process_group()
    pc = PolyContext(P, device=dev)
    row = kernel_at(native, P, pc, rng, "fused_ip",
                    [1, dnum, l_ext, N, 1, 0])
    analytic = {kind: {p: distributed.comm_bytes_per_device(
                    kind, dnum, l_ext, N, p) for p in DIST_P}
                for kind in distributed.KINDS}
    res = {"phase": "distributed", "world_size": 1, "backend": "nccl",
           "shape": {"dnum": dnum, "l_ext": l_ext, "N": N},
           "launches": launches, "cuda_launches": cuda_launches,
           "calls": calls, "max_abs_err": errs,
           "ms_at_p1": ms, "counted_bytes_p1": counted,
           "analytic_bytes": analytic, "kernel": row,
           "seconds": time.perf_counter() - t_phase}
    for p in DIST_P:
        if not analytic["IRF"][p] < analytic["EVF"][p]:
            raise AssertionError(f"IRF moves no fewer bytes at P = {p}")
    emit(res)
    return res


# ------------------------------------------------------------------ phase 9
# phi3-medium-14b at full width, served with launch/serve.py's defaults
LM_ARCH = "phi3_medium_14b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 16, 32
# The JAX package's own decode-vs-prefill bound, rtol = atol = 0.15, set
# on its 2-layer smoke model (tests/test_models_smoke.py:77-95).  It is
# held in bf16 at that depth (LM_REF_LAYERS, full width) and in float32
# at full depth.  In bf16 the difference is rounding noise that grows
# with depth (max 0.0625 at 2 layers, 0.189 at 40 on logits of std 1.43,
# against 3e-5 in float32 at every depth, on an H100 80GB HBM3 at 700 W),
# so the full-depth bf16 figures are printed, not gated.
LM_DECODE_TOL = 0.15
LM_REF_LAYERS = 2
# float32 card against CPU over two full-width layers: summation order
# only (TF32 is off), about 1e-5 of logits of magnitude ~1
LM_F32_TOL = 1e-3
LM_F32_LAYERS = 2


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _tree_sum(fn, tree) -> int:
    total = []
    _tree_map(lambda t: total.append(fn(t)), tree)
    return sum(total)


def _tree_bytes(tree) -> int:
    return _tree_sum(lambda t: t.numel() * t.element_size(), tree)


def _first_layers(params, n: int) -> dict:
    """The model cut to its first ``n`` layers (views of the stacked
    blocks; the embeddings and final norm shared)."""
    return dict(params, blocks=_tree_map(lambda t: t[:n], params["blocks"]))


def _decode_vs_prefill(params, cfg, toks, tol=LM_DECODE_TOL) -> dict:
    """Teacher-forced decode of ``toks`` against the full forward: the
    largest difference, the largest excess over a bound of rtol = atol =
    ``tol`` (|d| - rtol |full|, to compare with its atol), the mean
    difference, the logits' scale and the share of positions with the
    same argmax; raises on a non-finite logit."""
    from repro_torch.models.model import forward, init_cache

    B, S = toks.shape
    with torch.no_grad():
        full, _ = forward(params, toks, cfg)
        cache = init_cache(cfg, B, S, device=toks.device)
        steps = []
        for t in range(S):
            lg, cache = forward(params, toks[:, t:t + 1], cfg, cache=cache)
            steps.append(lg[:, 0])
        dec = torch.stack(steps, 1)
    if not (torch.isfinite(full).all() and torch.isfinite(dec).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits ({cfg.dtype}, "
                             f"{cfg.n_layers} layers)")
    d = (dec - full).abs()
    return {"max_abs": float(d.max()),
            "excess": float((d - tol * full.abs()).max()),
            "mean_abs": float(d.mean()), "logit_std": float(full.std()),
            "logit_max_abs": float(full.abs().max()),
            "argmax_agree": float((dec.argmax(-1) == full.argmax(-1))
                                  .float().mean())}


def _gate_decode(name: str, r: dict, tol=LM_DECODE_TOL) -> None:
    if r["excess"] > tol:
        raise AssertionError(f"{name} decode != prefill: max abs diff "
                             f"{r['max_abs']} over rtol = atol = {tol}")


def phase_lm_serve(smi: str) -> dict:
    """phi3-medium-14b at full width (bf16, random weights from a seeded
    generator on the card) served through ``launch/serve.generate``:
    batch 4, prompt 16, 32 greedy tokens, twice (the first warms up).
    Then, on the prompts, teacher-forced decode against the full forward:
    every logit finite; within the JAX package's bound (LM_DECODE_TOL) in
    bf16 at its depth (LM_REF_LAYERS) and in a float32 copy at full
    depth; the bf16 full-depth figures printed.  Last, the float32 copy
    cut to LM_F32_LAYERS layers gives the card's logits on the CPU within
    LM_F32_TOL.  Prints weight GB, peak memory, prefill seconds, ms per
    decode step, tokens/s, the per-step bytes bound, and one decode step
    captured into a CUDA graph: its kernels and its replay's device
    time, the step without host dispatch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.timing import cuda_ms
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import forward, init_cache, init_params

    t_phase = time.perf_counter()
    gc.collect()
    heap_objects = len(gc.get_objects())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = _tree_bytes(params)
    n_params = _tree_sum(lambda t: t.numel(), params)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    runs = []
    for _ in range(2):
        times = {}
        t0 = time.perf_counter()
        out = generate(cfg, params, prompts, LM_GEN, times)
        runs.append(dict(times, total_s=time.perf_counter() - t0))
    if out.shape != (LM_BATCH, LM_PROMPT + LM_GEN) or not np.array_equal(
            out[:, :LM_PROMPT], prompts):
        raise AssertionError(f"lm_serve: bad output {out.shape}")
    if not ((out >= 0) & (out < cfg.vocab)).all():
        raise AssertionError("lm_serve: token out of the vocabulary")
    warm = runs[-1]
    step_ms = warm["decode_s"] / LM_GEN * 1e3
    # a decode step reads every weight once, and the cache
    cache_bytes = _tree_bytes(init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN,
                                         device=dev)["slots"])
    bound_ms = (weight_bytes + cache_bytes) / PEAK_BYTES * 1e3

    # one decode step captured into a CUDA graph: its kernels, and its
    # device time from replays (no host dispatch), against the eager step
    cache = init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
    cache["idx"] = LM_PROMPT
    cur = torch.as_tensor(out[:, LM_PROMPT:LM_PROMPT + 1], dtype=torch.int64,
                          device=dev)

    def step():
        with torch.no_grad():
            return forward(params, cur, cfg, cache=cache)[0]

    step_kernels, _ = graph_kernels(step)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step()
    graph_ms = cuda_ms(g.replay, reps=5, batches=3, hide_host=False)
    del g, cache

    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    checks = {"bf16_full_depth": _decode_vs_prefill(params, cfg, toks),
              f"bf16_{LM_REF_LAYERS}_layers": _decode_vs_prefill(
                  _first_layers(params, LM_REF_LAYERS),
                  dataclasses.replace(cfg, n_layers=LM_REF_LAYERS), toks)}
    _gate_decode("lm_serve: bf16", checks[f"bf16_{LM_REF_LAYERS}_layers"])
    del params
    torch.cuda.empty_cache()

    # the float32 copy at full depth (56.6 GB: the bf16 model is freed)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED),
                      dev)
    checks["f32_full_depth"] = _decode_vs_prefill(p32, cfg32, toks)
    _gate_decode("lm_serve: float32", checks["f32_full_depth"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the float32 copy cut to LM_F32_LAYERS layers, on the card and the CPU
    cut = dataclasses.replace(cfg32, n_layers=LM_F32_LAYERS)
    p_card = _first_layers(p32, LM_F32_LAYERS)
    p_cpu = _tree_map(lambda t: t.cpu(), p_card)
    toks32 = toks[:2, :8]
    with torch.no_grad():
        card, _ = forward(p_card, toks32, cut)
        t0 = time.perf_counter()
        cpu, _ = forward(p_cpu, toks32.cpu(), cut)
        cpu_s = time.perf_counter() - t0
    f32_err = float((card.cpu() - cpu).abs().max())
    if not (f32_err <= LM_F32_TOL and torch.isfinite(cpu).all()):
        raise AssertionError(f"lm_serve: float32 card != CPU, {f32_err}")
    del p32, p_card, p_cpu
    torch.cuda.empty_cache()

    res = {"phase": "lm_serve", "arch": LM_ARCH, "card": smi,
           "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                      "dtype": cfg.dtype},
           "n_params": n_params, "weight_gb": weight_bytes / 1e9,
           "init_s": init_s, "peak_mem_gb": peak_gb,
           "heap_objects": heap_objects,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
           "runs": runs, "prefill_s": warm["prefill_s"],
           "decode_ms_per_step": step_ms,
           "prefill_ms_per_step": warm["prefill_s"] / LM_PROMPT * 1e3,
           "decode_tokens_per_s": LM_BATCH * LM_GEN / warm["decode_s"],
           "tokens_per_s": LM_BATCH * LM_GEN / warm["total_s"],
           "bound_ms_per_step": bound_ms, "bound_by": "bytes",
           "bound_share": bound_ms / step_ms,
           "step_kernels": step_kernels,
           "step_graph_device_ms": graph_ms,
           "graph_bound_share": bound_ms / graph_ms,
           "decode_vs_prefill": checks, "decode_tol": LM_DECODE_TOL,
           "f32_card_vs_cpu_max_abs": f32_err, "f32_layers": LM_F32_LAYERS,
           "f32_cpu_forward_s": cpu_s,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


# ----------------------------------------------------------------- phase 10
# The rest of the LM zoo at full width, in bf16, with lm_serve's batch,
# prompt and greedy tokens: (arch, layers on the card or None for all,
# the float32 card-against-CPU check: full width cut to that many layers,
# None for the uncut model, or "reduced" for the REDUCED config where the
# full-width float32 cut is over 16 GB: arctic's 2 layers are 110 GB,
# jamba's 46 GB, and a CPU copy and forward that size would cost the
# phase minutes).  One H100 cannot hold
# arctic-480b or jamba-1.5-large-398b: arctic keeps 2 of its 35 layers
# (54.9 GB of bf16), jamba the first 2 of its 72 (Mamba + MoE, Mamba +
# dense; one 8-layer period with its attention layer is 89 GB).
LM_ZOO = [
    ("minicpm3_4b", None, 2),
    ("moonshot_v1_16b_a3b", None, 2),
    ("arctic_480b", 2, "reduced"),
    ("jamba_1_5_large_398b", 2, "reduced"),
    ("xlstm_1_3b", None, 2),
    ("qwen2_vl_2b", None, 2),
    ("whisper_base", None, None),
]
# MLA's decode-vs-prefill bound in the JAX package
# (tests/test_models_smoke.py:98-116), held in bf16 at LM_REF_LAYERS and
# in float32 at full depth (62 layers, 16.4 GB).  The other families'
# figures are printed, not gated: the reference gates none of them, MoE
# capacity depends on the tokens in a call, and the mLSTM's two forms
# normalise differently (src/repro/models/layers.py:465-467, :481-483).
LM_MLA_TOL = 0.2
# stub modality inputs of the float32 check: patch embeddings over the
# first tokens (vlm), frames of the encoder (audio)
LM_ZOO_PATCHES, LM_ZOO_FRAMES = 4, 32


def _zoo_inputs(cfg, dev) -> dict:
    """The float32 check's keyword inputs: for qwen2-vl stub patch
    embeddings and three different position streams (temporal and two
    spatial), for whisper stub frames; seeded."""
    rng = np.random.default_rng(SEED)
    kw = {}
    if cfg.frontend == "vision":
        kw["embeds"] = torch.from_numpy(rng.normal(
            size=(2, LM_ZOO_PATCHES, cfg.d_model)).astype(np.float32))
    elif cfg.frontend == "audio":
        kw["embeds"] = torch.from_numpy(rng.normal(
            size=(2, LM_ZOO_FRAMES, cfg.d_model)).astype(np.float32))
    return {k: v.to(dev) for k, v in kw.items()}


def _zoo_positions(cfg, start: int, n: int, dev):
    if cfg.pos != "mrope":
        return {}
    t = torch.arange(start, start + n, device=dev)
    return {"positions": torch.stack([t, t // 2, t % 3])[:, None]
            .expand(3, 2, n)}


def _zoo_card_vs_cpu(cfg32, dev) -> dict:
    """``cfg32`` (float32) on the card and on the CPU from the same
    weights: prefill, then four decode steps from empty caches; the
    largest logit and cache differences.  Stub embeds and, under M-RoPE,
    three different position streams go to both."""
    from repro_torch.models.model import forward, init_cache, init_params

    p_card = init_params(cfg32, torch.Generator(device=dev)
                         .manual_seed(SEED), dev)
    p_cpu = _tree_map(lambda t: t.cpu(), p_card)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg32.vocab, (2, 8)))
    kw = _zoo_inputs(cfg32, dev)
    kw_cpu = {k: v.cpu() for k, v in kw.items()}
    errs = {}
    with torch.no_grad():
        card, _ = forward(p_card, toks.to(dev), cfg32,
                          **kw, **_zoo_positions(cfg32, 0, 8, dev))
        t0 = time.perf_counter()
        cpu, _ = forward(p_cpu, toks, cfg32, **kw_cpu,
                         **_zoo_positions(cfg32, 0, 8, "cpu"))
        cpu_s = time.perf_counter() - t0
        if not torch.isfinite(cpu).all():
            raise AssertionError(f"lm_zoo: {cfg32.name} CPU logits not finite")
        errs["prefill"] = float((card.cpu() - cpu).abs().max())
        # decode: the encoder's frames at every step, no patch embeds
        dkw = kw if cfg32.enc_dec else {}
        dkw_cpu = kw_cpu if cfg32.enc_dec else {}
        c_card = init_cache(cfg32, 2, 8, device=dev)
        c_cpu = init_cache(cfg32, 2, 8, device="cpu")
        step_err = 0.0
        for t in range(4):
            card, c_card = forward(p_card, toks[:, t:t + 1].to(dev), cfg32,
                                   cache=c_card, **dkw,
                                   **_zoo_positions(cfg32, t, 1, dev))
            cpu, c_cpu = forward(p_cpu, toks[:, t:t + 1], cfg32,
                                 cache=c_cpu, **dkw_cpu,
                                 **_zoo_positions(cfg32, t, 1, "cpu"))
            step_err = max(step_err, float((card.cpu() - cpu).abs().max()))
        errs["decode"] = step_err
        leaves_card, leaves_cpu = [], []
        _tree_map(leaves_card.append, c_card["slots"])
        _tree_map(leaves_cpu.append, c_cpu["slots"])
        errs["cache"] = max(float((a.cpu() - b).abs().max())
                            for a, b in zip(leaves_card, leaves_cpu))
    weight_gb = _tree_bytes(p_card) / 1e9
    del p_card, p_cpu, c_card
    torch.cuda.empty_cache()
    if not max(errs.values()) <= LM_F32_TOL:
        raise AssertionError(f"lm_zoo: {cfg32.name} float32 card != CPU: "
                             f"{errs}")
    return {"layers": cfg32.n_layers, "d_model": cfg32.d_model,
            "weight_gb": weight_gb, "max_abs": errs,
            "inputs": sorted(kw) + (["positions (3 streams)"]
                                    if cfg32.pos == "mrope" else []),
            "cpu_prefill_s": cpu_s}


def _zoo_arch(arch: str, cut, check, smi: str, dev="cuda") -> dict:
    """One architecture of the zoo served at full width in bf16 (cut to
    ``cut`` layers when given): ``generate`` twice (the first warms up),
    the output's gates, the step's bytes bound, one decode step in a CUDA
    graph, decode against prefill, and the float32 card-against-CPU
    check (``check``)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.timing import cuda_ms
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import (
        forward, init_cache, init_params, layer_pattern,
    )

    t_arch = time.perf_counter()
    dev = torch.device(dev)
    full_cfg = get_config(arch)
    cfg = (dataclasses.replace(full_cfg, n_layers=cut) if cut
           else full_cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = _tree_bytes(params)
    n_params = _tree_sum(lambda t: t.numel(), params)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    runs = []
    for _ in range(2):
        times = {}
        t0 = time.perf_counter()
        out = generate(cfg, params, prompts, LM_GEN, times)
        runs.append(dict(times, total_s=time.perf_counter() - t0))
    if out.shape != (LM_BATCH, LM_PROMPT + LM_GEN) or not np.array_equal(
            out[:, :LM_PROMPT], prompts):
        raise AssertionError(f"lm_zoo: {arch} bad output {out.shape}")
    if not ((out >= 0) & (out < cfg.vocab)).all():
        raise AssertionError(f"lm_zoo: {arch} token out of the vocabulary")
    warm = runs[-1]
    step_ms = warm["decode_s"] / LM_GEN * 1e3
    # a decode step reads every weight once (a MoE step runs every expert
    # on its capacity rows), and the cache
    cache_bytes = _tree_bytes(init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN,
                                         device=dev)["slots"])
    bound_ms = (weight_bytes + cache_bytes) / PEAK_BYTES * 1e3

    cache = init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
    cache["idx"] = LM_PROMPT
    cur = torch.as_tensor(out[:, LM_PROMPT:LM_PROMPT + 1], dtype=torch.int64,
                          device=dev)

    def step():
        with torch.no_grad():
            return forward(params, cur, cfg, cache=cache)[0]

    eager = step()
    if not torch.isfinite(eager).all():
        raise AssertionError(f"lm_zoo: {arch} non-finite decode logits")
    step_kernels, _ = graph_kernels(step)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step()
    graph_ms = cuda_ms(g.replay, reps=5, batches=3, hide_host=False)
    del g, cache

    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    pattern, _ = layer_pattern(cfg)
    mixers = {s.mixer for s in pattern}
    checks = {}
    if "mla" in mixers:
        checks["bf16_full_depth"] = _decode_vs_prefill(params, cfg, toks,
                                                       LM_MLA_TOL)
        ref_cfg = dataclasses.replace(cfg, n_layers=LM_REF_LAYERS)
        checks[f"bf16_{LM_REF_LAYERS}_layers"] = _decode_vs_prefill(
            _first_layers(params, LM_REF_LAYERS), ref_cfg, toks, LM_MLA_TOL)
        _gate_decode(f"lm_zoo: {arch} bf16",
                     checks[f"bf16_{LM_REF_LAYERS}_layers"], LM_MLA_TOL)
    elif not cfg.moe or "mamba" in mixers:
        # printed only (jamba's cut has MoE too: capacity at T = 4 and
        # T = 64 differs, so its figures mix both effects)
        checks["bf16_on_card_depth"] = _decode_vs_prefill(params, cfg, toks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    if "mla" in mixers:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = init_params(cfg32, torch.Generator(device=dev)
                          .manual_seed(SEED), dev)
        checks["f32_full_depth"] = _decode_vs_prefill(p32, cfg32, toks,
                                                      LM_MLA_TOL)
        _gate_decode(f"lm_zoo: {arch} float32", checks["f32_full_depth"],
                     LM_MLA_TOL)
        del p32
        torch.cuda.empty_cache()

    if check == "reduced":
        cfg32 = dataclasses.replace(reduced_config(arch), dtype="float32")
        skipped = {"full_width_f32_gb_of_the_card_cut": 4 * n_params / 1e9}
    else:
        cfg32 = dataclasses.replace(full_cfg, dtype="float32",
                                    n_layers=check or full_cfg.n_layers)
        skipped = None
    f32 = _zoo_card_vs_cpu(cfg32, dev)

    return {"phase": "lm_zoo", "arch": arch, "card": smi,
            "config": {"n_layers": cfg.n_layers,
                       "n_layers_full": full_cfg.n_layers,
                       "d_model": cfg.d_model, "vocab": cfg.vocab,
                       "pattern": [f"{s.mixer}+{s.ffn}" for s in pattern],
                       "dtype": cfg.dtype},
           "n_params": n_params, "weight_gb": weight_bytes / 1e9,
           "init_s": init_s, "peak_mem_gb": peak_gb,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
           "runs": runs, "prefill_s": warm["prefill_s"],
           "decode_ms_per_step": step_ms,
           "decode_tokens_per_s": LM_BATCH * LM_GEN / warm["decode_s"],
           "tokens_per_s": LM_BATCH * LM_GEN / warm["total_s"],
           "bound_ms_per_step": bound_ms, "bound_by": "bytes",
           "bound_share": bound_ms / step_ms,
           "step_kernels": step_kernels, "step_graph_device_ms": graph_ms,
           "graph_bound_share": bound_ms / graph_ms,
           "decode_vs_prefill": checks,
           "decode_gated": "mla" in mixers,
           "f32_card_vs_cpu": f32, "f32_full_width_left_out": skipped,
           "seconds": time.perf_counter() - t_arch}


def phase_lm_zoo(smi: str) -> dict:
    """Every LM family beyond the dense one (LM_ZOO) served at full
    width through ``launch/serve.generate``, one at a time, each model
    freed before the next; one JSON line each and one for the phase.
    Gates: the output's shape, its prompt kept, every token inside the
    vocabulary, finite logits, MLA's decode within the JAX package's
    bound of the full forward (bf16 at 2 layers, float32 at full depth),
    and the float32 card-against-CPU check within LM_F32_TOL."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for arch, cut, check in LM_ZOO:
        r = _zoo_arch(arch, cut, check, smi)
        emit(r)
        rows.append({k: r[k] for k in ("arch", "weight_gb",
                                       "decode_ms_per_step",
                                       "step_graph_device_ms",
                                       "bound_ms_per_step", "seconds")})
        gc.collect()
        torch.cuda.empty_cache()
    res = {"phase": "lm_zoo", "card": smi, "archs": rows,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.params import PAPER_PARAMS
    from repro_torch.kernels import native

    t_start = time.perf_counter()
    smi = phase_build(native)
    # the LM paths first, in a fresh process: their decode steps are bound
    # by Python dispatch, which the FHE phases' heap would slow down
    phase_lm_serve(smi)
    phase_lm_zoo(smi)
    dist_res = phase_distributed(native)
    kern = phase_kernels(PAPER_PARAMS, native)
    main_res = phase_main(PAPER_PARAMS, native)
    rt = phase_runtime(PAPER_PARAMS, native)
    phase_parity()
    boot = phase_bootstrap(native)
    boot_rows = slice_rows(native, boot)
    served = phase_serve(native)
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
    paths = {
        "runtime_launches": [dict(r, k=PAPER_PARAMS.k,
                                  logn=PAPER_PARAMS.logN)
                             for r in rt["runs"].values()],
        "bootstrap_launches": list(boot["runs"].values()),
        "serve_launches": [served["run"]],
    }
    dist_launches = dist_res["launches"]["fused_ip"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "cuda_launches", "cluster")
    rows = []
    for name, (src, rep, launches) in sources.items():
        r = kern[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches,
                     **{p: path_launches(runs, name)
                        for p, runs in paths.items()},
                     "distributed_launches": (dist_launches
                                              if name == "fused_ip" else 0),
                     **{k: r[k] for k in keys}})
    # the distributed path's own shape, R = 1 without a plaintext:
    # ``launches`` counts that path's calls; the other paths' columns
    # count their calls at this shape
    src, rep, _ = sources["fused_ip"]
    r = dist_res["kernel"]
    key = f"fused_ip {r['shape']}"
    rows.append({"name": "fused_ip_r1", "route": "cuda", "source": src,
                 "replaces": rep, "launches": dist_launches,
                 **{p: sum(run["calls"].get(key, 0) for run in runs)
                    for p, runs in paths.items()},
                 "distributed_launches": dist_res["calls"].get(key, 0),
                 "shape": r["shape"], **{k: r[k] for k in keys}})
    # the bootstrap path's own shapes: ``launches`` counts the calls at
    # the row's shape (and ring degree) in that path's counted runs
    for name, (r, _, key) in boot_rows.items():
        src, rep, _ = sources[name]
        at_shape = {p: sum(run["calls"].get(key, 0) for run in runs
                           if run["logn"] == BOOT_KW["logN"])
                    for p, runs in paths.items()}
        rows.append({"name": f"{name}_logn10", "route": "cuda",
                     "source": src, "replaces": rep,
                     "launches": at_shape["bootstrap_launches"],
                     **at_shape, "distributed_launches": 0,
                     "shape": r["shape"],
                     **{k: r[k] for k in keys}})
    emit({"kernels": rows})
    print(f"card: {smi}; total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
