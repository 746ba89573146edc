"""The port's simulator, dataflow mapping and program generators against
the JAX package's.

Both packages' ``sim/`` are numpy and the standard library only, so the
same DFG on the same hardware model must give the same floats: latency,
stall seconds, per-engine busy seconds and energy, and every timeline
entry.  The latencies are those of the modelled accelerators (SHARP,
SHARP-xMU, HE2-SM, HE2-LM), not of any device that runs the port.

``test_prop_bandwidth_monotonic`` (``tests/test_sim_props.py``) fails in
the reference at ``bw=2.0, mode="pipelined"``: the simulator there is
not monotonic in the link bandwidth.  The port's copy must give the same
numbers, so the bandwidth sweep below asserts equality only.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import linear as ref_linear  # noqa: E402
from repro.core.ckks import CKKSContext as RefContext  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.dfg import mapping as ref_mapping  # noqa: E402
from repro.dfg import programs as ref_programs  # noqa: E402
from repro.dfg.pkb import identify_pkbs as ref_identify  # noqa: E402
from repro.runtime import ProgramExecutor as RefExecutor  # noqa: E402
from repro.runtime import TraceContext as RefTrace  # noqa: E402
from repro.runtime import compile_program as ref_compile  # noqa: E402
from repro.runtime.report import program_blocks as ref_blocks  # noqa: E402
from repro import sim as ref_sim  # noqa: E402
from repro.sim import engine as ref_engine  # noqa: E402
from repro.sim import hw as ref_hw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import sim as port_sim  # noqa: E402
from repro_torch.core import linear  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.dfg import mapping, programs  # noqa: E402
from repro_torch.dfg.pkb import identify_pkbs  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ProgramExecutor, TraceContext, compile_program,
)
from repro_torch.runtime.report import program_blocks  # noqa: E402
from repro_torch.sim import engine, hw  # noqa: E402

HW = ["SHARP", "SHARP-xMU", "HE2-SM", "HE2-LM"]
MODES = ["pipelined", "analytic"]
# (strategy, dataflow, fusion): the combinations of tests/test_sim.py
# and benchmarks/common.py
MAPPINGS = [("minks", "EVF", False), ("hoist", "EVF", False),
            ("hoist", "IRF", False), ("hoist", "hybrid", True)]
# tests/test_sim.py's programs
PROGRAMS = {
    "boot_bsgs": lambda pkg: pkg.bootstrapping_dfg(bsgs_bs=4),
    "boot_full": lambda pkg: pkg.bootstrapping_dfg(bsgs_bs=0),
    "helr": lambda pkg: pkg.helr_dfg(bsgs_bs=4),
}
# every generator at a width the simulator's benchmarks use
GENERATORS = {
    **PROGRAMS,
    "helr_no_boot": lambda pkg: pkg.helr_dfg(with_bootstrap=False),
    "resnet20": lambda pkg: pkg.resnet_dfg(n_layers=20),
    "bert": lambda pkg: pkg.bert_dfg(n_layers=2),
    "convbn": lambda pkg: pkg.convbn_example(),
}


def _nodes(g) -> list:
    return [(n.id, n.op.value, n.args, n.limbs, n.ext_limbs, n.attrs)
            for n in g.nodes.values()]


def _result(r) -> dict:
    """Every field of a ``SimResult`` and its derived ratios."""
    out = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    out["volumes"] = dataclasses.asdict(r.volumes)
    for prop in ("edp", "comm_stall_frac", "xpu_util", "xmu_util"):
        out[prop] = getattr(r, prop)
    out["engine_util"] = {e: r.engine_util(e) for e in ref_sim.ENGINES}
    return out


def _block(b) -> tuple:
    return (dataclasses.asdict(b.volumes), b.dnum, b.evk_keys, b.streams_evk)


@pytest.fixture(scope="module")
def dfgs():
    """name -> (reference DFG, port DFG)."""
    return {name: (make(ref_programs).g, make(programs).g)
            for name, make in PROGRAMS.items()}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_program_dfgs_equal(name):
    """The paper's DFG generators build the same graph node for node."""
    make = GENERATORS[name]
    rg, pg = make(ref_programs).g, make(programs).g
    assert pg.N == rg.N
    assert _nodes(pg) == _nodes(rg)


def test_hw_configs_equal():
    assert set(hw.CONFIGS) == set(ref_hw.CONFIGS) == set(HW)
    for name in HW:
        assert (dataclasses.asdict(hw.CONFIGS[name])
                == dataclasses.asdict(ref_hw.CONFIGS[name]))
    assert hw.WORD_BYTES == ref_hw.WORD_BYTES
    assert port_sim.ENGINES == ref_sim.ENGINES


@pytest.mark.parametrize("mode", ["IRF", "EVF", "hybrid"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_mapping_equal(dfgs, name, mode):
    """``map_program`` picks the same dataflow and volumes per PKB."""
    rg, pg = dfgs[name]
    got = mapping.map_program(identify_pkbs(pg), 12, 12, 1 << 15, mode=mode)
    want = ref_mapping.map_program(ref_identify(rg), 12, 12, 1 << 15,
                                   mode=mode)
    assert [(m.strategy, m.dataflow, dataclasses.asdict(m.volumes))
            for m in got] == [(m.strategy, m.dataflow,
                               dataclasses.asdict(m.volumes)) for m in want]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hw_name", HW)
@pytest.mark.parametrize("strategy,dataflow,fusion", MAPPINGS,
                         ids=[f"{s}-{d}{'-fused' if f else ''}"
                              for s, d, f in MAPPINGS])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_simulate_program_equal(dfgs, name, strategy, dataflow, fusion,
                                hw_name, mode):
    rg, pg = dfgs[name]
    want = ref_engine.simulate_program(rg, ref_hw.CONFIGS[hw_name], strategy,
                                       dataflow, fusion=fusion, mode=mode)
    got = engine.simulate_program(pg, hw.CONFIGS[hw_name], strategy,
                                  dataflow, fusion=fusion, mode=mode)
    assert _result(got) == _result(want)
    assert got.latency_s > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bw", [0.25, 0.5, 1.0, 2.0, 4.0, 8.0])
def test_bandwidth_sweep_equal(dfgs, bw, mode):
    """``with_bandwidth(HE2_SM, bw)`` gives the reference's results at
    every bandwidth of ``test_prop_bandwidth_monotonic``'s sweep, the
    failing ``bw=2.0`` (vs 4.0) pipelined case included."""
    rg, pg = dfgs["boot_full"]
    want = ref_engine.simulate_program(
        rg, ref_hw.with_bandwidth(ref_sim.HE2_SM, bw), "hoist", "IRF",
        mode=mode)
    got = engine.simulate_program(
        pg, hw.with_bandwidth(port_sim.HE2_SM, bw), "hoist", "IRF",
        mode=mode)
    assert got.name == want.name
    assert _result(got) == _result(want)


def test_capacity_equal(dfgs):
    rg, pg = dfgs["boot_full"]
    for gb in (2.0, 4.0, 16.0):
        want = ref_engine.simulate_program(
            rg, ref_hw.with_capacity(ref_sim.HE2_LM, gb), "hoist", "hybrid",
            fusion=True)
        got = engine.simulate_program(
            pg, hw.with_capacity(port_sim.HE2_LM, gb), "hoist", "hybrid",
            fusion=True)
        assert _result(got) == _result(want)


# ------------------------ runtime -> simulator ---------------------------

KW = dict(logN=8, L=5, alpha=2, k=3, q_bits=29, scale_bits=29)


@pytest.fixture(scope="module")
def matvec_runs():
    """A BSGS matvec compiled and run once in each package, with its
    report: (reference compiled, reference result, port compiled, port
    result)."""
    rng = np.random.default_rng(11)
    nh = 1 << (KW["logN"] - 1)
    diags = {d: rng.normal(size=nh) for d in range(8)}
    z = rng.normal(size=nh) + 1j * rng.normal(size=nh)
    out = []
    for ctx, trace, comp, lin, ex in (
            (RefContext(RefParams(**KW), seed=7), RefTrace, ref_compile,
             ref_linear, RefExecutor),
            (CKKSContext(CKKSParams(**KW), seed=7, device="cpu"),
             TraceContext, compile_program, linear, ProgramExecutor)):
        tc = trace(ctx.params)
        h = tc.input("x", level=KW["L"], scale=ctx.params.scale)
        tc.output(lin.matvec_bsgs(tc, h, diags, bs=4), "y")
        compiled = comp(tc)
        out += [compiled, ex(ctx).run(compiled, {"x": ctx.encrypt(z)},
                                      with_report=True)]
    return out


def test_matvec_run_equal(matvec_runs):
    rc, rres, pc, pres = matvec_runs
    got = convert.exec_result_to_numpy(pres)["y"]
    want = rres["y"]
    np.testing.assert_array_equal(got["c0"], np.asarray(want.c0))
    np.testing.assert_array_equal(got["c1"], np.asarray(want.c1))
    assert (got["level"], got["scale"]) == (want.level, want.scale)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_program_blocks_equal(matvec_runs, batch):
    rc, _, pc, _ = matvec_runs
    got = [_block(b) for b in program_blocks(pc, batch)]
    assert got == [_block(b) for b in ref_blocks(rc, batch)]
    assert sum(b[0]["modup_count"] for b in got) > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hw_name", HW)
def test_scheduled_result_equal(matvec_runs, hw_name, mode):
    rc, rres, pc, pres = matvec_runs
    want = rres.report.scheduled_result(rc, ref_hw.CONFIGS[hw_name],
                                        mode=mode)
    got = pres.report.scheduled_result(pc, hw.CONFIGS[hw_name], mode=mode)
    assert _result(got) == _result(want)
    assert got.latency_s > 0


# --------------------------- package boundary ---------------------------

def test_slice_imports_no_jax():
    """Bootstrapping and the simulator of the port load neither JAX nor
    any module of the JAX package."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys\n"
        "import repro_torch.core.bootstrap\n"
        "import repro_torch.sim, repro_torch.sim.engine\n"
        "import repro_torch.dfg.mapping, repro_torch.dfg.programs\n"
        "import repro_torch.runtime.report, repro_torch.convert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=src,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"
