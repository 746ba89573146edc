"""Measure the NTT, ModUp and BConv kernels of ``src/repro_torch`` at the
paper's shapes, beyond what ``chip_smoke.py`` reports.

    python3 tools/ntt_study.py [--compare SRC_DIR ... | --bconv]

Needs a CUDA card.  Prints one JSON line per measurement:

  * ``sizes``: the forward NTT at (2, 36, 2^16), the inverse at
    (2, 12, 2^16) and (36, 2^16), and ModUp of all digits at level 35
    (B = 1), each with clusters of 4 and of 8 blocks a row, checked
    against the plain versions; beside them, the same ModUp with every
    digit cut to one source row (the reduce's re-reads gone, results not
    checked), and a device copy of the forward's int64 input as a
    yardstick for the memory;
  * ``bconv`` (alone with ``--bconv``): the BConv kernel at the ModDown
    shape (2, 12) -> (2, 36) and the rescale shape (1) -> (35),
    N = 2^16, with every group size G it is built for and 32 or 64
    lanes a tile, checked against the plain version, with the registers
    and spills of each G; beside them, a device copy of the output as a
    yardstick for the memory, and the default geometry built with
    ``-DHE2_BCONV_NO_LOAD``, ``-DHE2_BCONV_NO_STORE`` or both (results not
    checked), to see what the loads, the stores and the arithmetic cost;
  * ``phases``: where one forward and one inverse launch spend their
    time, from the device timestamps that ``ntt.cu`` built with
    ``-DHE2_PROBE`` records at the phase boundaries (``PROBE`` in
    ``csrc/ntt_device.cuh``);
  * ``wrappers`` (with ``--compare``, once for each ``src`` directory
    given, e.g. this tree's and an unpacked older commit's): what the
    engine pays per call, gathers included, for ``poly.ntt`` of
    (2, 36, 2^16), ``poly.intt`` of (2, 12, 2^16), the engine's
    ``_modup`` at level 35 (B = 1), ``poly.bconv`` at the ModDown shape
    (2, 12) -> (2, 36) and the rescale shape (1) -> (35), and the
    engine's ``_moddown2`` of both accumulators at level 35, with the
    kernel launches each makes.  Give the trees in turns (``--compare
    old new new old``) to see the drift between runs.

Times are ``repro_torch.kernels.timing.cuda_ms`` (medians of CUDA-event
means, host enqueueing hidden), in ms; phase times in microseconds.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def residues(rng, primes, shape, dev):
    q = torch.tensor(primes, dtype=torch.int64, device=dev)[:, None]
    return torch.from_numpy(rng.integers(0, 1 << 62, size=shape,
                                         dtype=np.int64)).to(dev) % q


def wrappers(src: str) -> None:
    """Per-call device time of the engine's NTT, ModUp, BConv and ModDown
    entry points of the ``repro_torch`` package under ``src`` (imported in
    this process only; an older tree may lack ``kernels.timing``, so the
    timer is this tree's)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.timing import cuda_ms
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    sys.path[0] = str(Path(src).resolve())
    from repro_torch.core import poly as tpoly
    from repro_torch.core.keyswitch import KeyswitchEngine
    from repro_torch.core.params import PAPER_PARAMS as PP
    from repro_torch.kernels import native as tnative

    dev = torch.device("cuda")
    pc = tpoly.PolyContext(PP, device=dev)
    eng = KeyswitchEngine(pc)
    plan = eng._plan(PP.L)
    rng = np.random.default_rng(2)
    base = PP.q_chain(PP.L)
    x = residues(rng, base, (2, len(base), PP.N), dev)
    xp = residues(rng, PP.p_primes, (2, PP.k, PP.N), dev)
    a = residues(rng, base, (len(base), PP.N), dev)
    x1 = residues(rng, base[-1:], (1, PP.N), dev)
    acc = residues(rng, base + PP.p_primes, (2, len(base) + PP.k, PP.N), dev)
    row = {"src": src}
    for name, fn in (("poly.ntt", lambda: tpoly.ntt(x, base, pc)),
                     ("poly.intt", lambda: tpoly.intt(xp, PP.p_primes, pc)),
                     ("engine._modup", lambda: eng._modup(a, plan)),
                     ("poly.bconv moddown",
                      lambda: tpoly.bconv(xp, PP.p_primes, base, pc)),
                     ("poly.bconv rescale",
                      lambda: tpoly.bconv(x1, base[-1:], base[:-1], pc)),
                     ("engine._moddown2", lambda: eng._moddown2(acc, plan))):
        fn()
        torch.cuda.synchronize()
        before = dict(tnative.LAUNCHES)
        fn()
        row[f"{name} launches"] = {k: v - before[k] for k, v in
                                   tnative.LAUNCHES.items() if v > before[k]}
        row[f"{name} ms"] = cuda_ms(fn)
    emit({"wrappers": row})


def ptxas_bconv(text: str) -> dict:
    """{G: [registers, spill store bytes]} from ``ptxas -v`` of bconv.cu."""
    out = {}
    for part in text.split("Compiling entry function")[1:]:
        g = re.search(r"bconv_kernelILi(\d+)E", part)
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        if g and regs and spill:
            out[int(g.group(1))] = [int(regs.group(1)), int(spill.group(1))]
    return out


def bconv_study(P, pc, rng, xp) -> None:
    """The ``bconv`` lines: every group size the kernel is built for and
    32 or 64 lanes a tile, at the ModDown shape (``xp``, the P limbs of
    both accumulators) and the rescale shape, each checked against the
    plain version; with the registers and spills of each group size."""
    from repro_torch.kernels import native
    from repro_torch.kernels.bconv.ops import (
        GROUP_ROWS, BConvConsts, bconv_plain, geometry,
    )
    from repro_torch.kernels.timing import cuda_ms

    _, report = native.compile_libs(["bconv"])
    if "bconv" in report:
        emit({"bconv_g_regs_spills": ptxas_bconv(report["bconv"]["ptxas"])})
    lib_bc = native.lib("bconv")
    dev, N = xp.device, P.N
    base, kp = P.q_chain(P.L), P.p_primes
    x1 = residues(rng, base[-1:], (1, N), dev)
    for name, src, dst, xx in (("moddown", kp, base, xp),
                               ("rescale", base[-1:], base[:-1], x1)):
        c = BConvConsts(pc.rns, src, dst, dev)
        want = bconv_plain(xx, c.qhat_inv, c.src_q, c.qhat_mod, c.dst_q)
        yy = torch.empty_like(want)
        batch = xx.numel() // (c.ls * N)
        row = {"bconv": name, "shape": list(xx.shape[:-1]) + [c.ld],
               "default": geometry(batch, c.ls, c.ld, P.logN)._asdict()}
        for g, lanes in itertools.product(GROUP_ROWS, (32, 64)):
            geo = geometry(batch, c.ls, c.ld, P.logN, g, lanes)
            fn = (lambda geo=geo: native.invoke(
                lib_bc, "bconv", xx.data_ptr(), yy.data_ptr(),
                c.qhat_inv_m.data_ptr(), c.src_q32.data_ptr(),
                c.src_qn32.data_ptr(), c.cm.data_ptr(),
                c.dst_q32.data_ptr(), c.dst_qn32.data_ptr(), batch, c.ls,
                c.ld, P.logN, c.g_acc, geo.g, geo.lanes, geo.threads,
                geo.tiles, geo.groups))
            yy.zero_()
            fn()
            torch.cuda.synchronize()
            if not torch.equal(yy, want):
                raise AssertionError(f"bconv {name} {geo}")
            row[f"g{g}_l{lanes}_ms"] = cuda_ms(fn, reps=20)
        row["copy_output_ms"] = cuda_ms(lambda: yy.copy_(want), reps=20)
        # the default geometry built without its loads, its stores or both
        geo = geometry(batch, c.ls, c.ld, P.logN)
        for probe in (("HE2_BCONV_NO_LOAD",), ("HE2_BCONV_NO_STORE",),
                      ("HE2_BCONV_NO_LOAD", "HE2_BCONV_NO_STORE")):
            paths, _ = native.compile_libs(["bconv"], defines=probe)
            lib = ctypes.CDLL(str(paths["bconv"]))
            row["+".join(p[10:].lower() for p in probe) + "_ms"] = cuda_ms(
                lambda: native.invoke(
                    lib, "bconv", xx.data_ptr(), yy.data_ptr(),
                    c.qhat_inv_m.data_ptr(), c.src_q32.data_ptr(),
                    c.src_qn32.data_ptr(), c.cm.data_ptr(),
                    c.dst_q32.data_ptr(), c.dst_qn32.data_ptr(), batch,
                    c.ls, c.ld, P.logN, c.g_acc, geo.g, geo.lanes,
                    geo.threads, geo.tiles, geo.groups), reps=20)
        emit(row)


def main() -> int:
    if not torch.cuda.is_available():
        print("ntt_study: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args[:1] == ["--wrappers"]:
        wrappers(args[1])
        return 0
    if args[:1] == ["--compare"]:
        for src in args[1:]:
            r = subprocess.run([sys.executable, __file__, "--wrappers", src],
                               capture_output=True, text=True)
            print(r.stdout, end="", flush=True)
            if r.returncode:
                print(r.stderr[-3000:], file=sys.stderr)
                return r.returncode

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.params import PAPER_PARAMS as P
    from repro_torch.core.poly import PolyContext
    from repro_torch.kernels import native
    from repro_torch.kernels.modup.ops import ModUpConsts, modup_plain
    from repro_torch.kernels.ntt.ops import ntt_fwd_plain, ntt_inv_plain
    from repro_torch.kernels.timing import cuda_ms

    dev = torch.device("cuda")
    pc = PolyContext(P, device=dev)
    tabs = pc.tabs
    t = tabs.mont_tables(dev)
    N = P.N
    rng = np.random.default_rng(1)
    base = P.q_chain(P.L)
    ext = base + P.p_primes
    kp = P.p_primes
    if args[:1] == ["--bconv"]:
        bconv_study(P, pc, rng, residues(rng, kp, (2, P.k, N), dev))
        return 0

    def ntt(library, fn, x, y, primes, logc):
        d = "i" if fn == "ntt_inverse" else "f"
        return lambda: native.invoke(
            library, fn, x.data_ptr(), y.data_ptr(),
            t[f"twist_{d}"].data_ptr(), t[f"tw_{d}"].data_ptr(),
            tabs.row_map(primes, dev).data_ptr(), t["q"].data_ptr(),
            t["qn"].data_ptr(), x.numel() // N, len(primes), P.logN, logc)

    # ------------------------------------------------------------ sizes
    lib_ntt, lib_mu = native.lib("ntt"), native.lib("modup")
    x = residues(rng, base, (2, len(base), N), dev)
    xp = residues(rng, kp, (2, P.k, N), dev)
    x36 = residues(rng, base, (len(base), N), dev)
    mc = ModUpConsts(pc.rns, tabs, P.digit_groups(P.L), base, ext, dev)
    m = mc.mont()
    want = {"fwd": ntt_fwd_plain(x, *tabs.plain_rows(base, dev, False)),
            "inv": ntt_inv_plain(xp, *tabs.plain_rows(kp, dev, True)),
            "inv36": ntt_inv_plain(x36, *tabs.plain_rows(base, dev, True)),
            "modup": modup_plain(x36, mc)}
    one_row = m["digit"].clone()
    one_row[:, 1] = 1
    for logc in (2, 3):
        y, yp, y36 = (torch.empty_like(v) for v in (x, xp, x36))
        ym = torch.empty_like(want["modup"])
        work = torch.empty((1, len(base), N), dtype=torch.int32, device=dev)

        def mu(digit):
            return lambda: native.invoke(
                lib_mu, "modup_all", x36.data_ptr(), ym.data_ptr(),
                work.data_ptr(), m["twist_i"].data_ptr(),
                t["tw_i"].data_ptr(), m["src_map"].data_ptr(),
                m["cm"].data_ptr(), m["own"].data_ptr(), digit.data_ptr(),
                t["twist_f"].data_ptr(), t["tw_f"].data_ptr(),
                m["dst_map"].data_ptr(), t["q"].data_ptr(),
                t["qn"].data_ptr(), 1, len(base), len(ext), mc.dnum,
                mc.alpha, P.logN, logc)
        runs = {
            "fwd": (ntt(lib_ntt, "ntt_forward", x, y, base, logc), y),
            "inv": (ntt(lib_ntt, "ntt_inverse", xp, yp, kp, logc), yp),
            "inv36": (ntt(lib_ntt, "ntt_inverse", x36, y36, base, logc), y36),
            "modup": (mu(m["digit"]), ym),
        }
        row = {"logc": logc}
        for name, (fn, out) in runs.items():
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, want[name]):
                raise AssertionError(f"{name} at logc {logc} != plain")
            row[f"{name}_ms"] = cuda_ms(fn, reps=20)
        row["modup_one_source_row_ms"] = cuda_ms(mu(one_row), reps=20)
        row["copy_fwd_input_ms"] = cuda_ms(lambda: y.copy_(x), reps=20)
        emit({"sizes": row})

    bconv_study(P, pc, rng, xp)

    # ----------------------------------------------------------- phases
    paths, _ = native.compile_libs(["ntt"], defines=("HE2_PROBE",))
    probed = ctypes.CDLL(str(paths["ntt"]))
    names = {"fwd": ["load+top stages+scatter", "barrier", "local stages",
                     "regroup+exchange+store"],
             "inv": ["load+exchange", "local stages", "barrier",
                     "gather+top stages+store"]}
    for kind, fn, xx, primes in (("fwd", "ntt_forward", x, base),
                                 ("inv", "ntt_inverse", xp, kp)):
        yy = torch.empty_like(xx)
        for _ in range(3):
            ntt(probed, fn, xx, yy, primes, 3)()
        torch.cuda.synchronize()
        blocks = (xx.numel() // N) << 3
        buf = (ctypes.c_ulonglong * (blocks * 8))()
        native.invoke(probed, "he2_read_probe", ctypes.addressof(buf),
                      blocks * 8)
        a = np.frombuffer(buf, dtype=np.uint64).reshape(blocks, 8)[:, :5]
        a = a.astype(np.int64)
        start = a[:, 0] - a[:, 0].min()
        dur = np.diff(a, axis=1) / 1e3
        emit({"phases": kind, "logc": 3, "blocks": int(blocks),
              "block_start_us_median_max": [float(np.median(start)) / 1e3,
                                            float(start.max()) / 1e3],
              "launch_span_us": float(a[:, 4].max() - a[:, 0].min()) / 1e3,
              "median_us": dict(zip(names[kind],
                                    np.median(dur, axis=0).round(2)
                                    .tolist())),
              "max_us": dict(zip(names[kind],
                                 dur.max(axis=0).round(2).tolist()))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
