"""The port's dry run held against the reference's GSPMD partitioning.

Both sides run the same cells on a small mesh of 8 devices laid out as
``make_small_mesh(8)`` (2 ``data`` x 4 ``model``):

- the reference in a subprocess with JAX on the CPU and
  ``--xla_force_host_platform_device_count=8``: the step under
  ``jax.jit(...).lower().compile()`` (``tools/reference_collectives.py``'s
  ``compiled_step``), per-device FLOPs from ``cost_analysis()`` and
  collective bytes from GSPMD's plan (below);
- the port in another subprocess on a ``fake`` group of 8 ranks
  (``launch.dryrun.dry_run``, as ``tests/test_torch_dryrun_small.py``).

The cells are four REDUCED configs cut to one layer, each with its
train step (batch 8 x 32) and its decode step (batch 8, a 64-token
cache): phi3-medium-14b (4 heads, 2 kv heads), the same with 4 kv
heads, minicpm3 (MLA) and moonshot (MoE).  With one layer the reference
takes its ``reps <= 1`` branch, so its ``cost_analysis`` covers the
whole step and needs no scan correction.

The two sides count by different conventions, so the ratios are held
to bands, not to 1:

- FLOPs: XLA counts every op of the fused, partitioned HLO (a
  transcendental or a compare included); the port counts its eager
  local ops (``OpCounter``: 2 m n k a product, one an output element of
  a pointwise op, one an input element of a reduction).
- Collective bytes: the output bytes of every collective on one
  device.  The reference's are those of GSPMD's plan: every collective
  of the HLO right after SPMD partitioning, in the step's own dtypes
  (``tools/reference_collectives.py``'s ``plan``).  The compiled HLO
  is not the yardstick: XLA's CPU backend then promotes every bf16
  collective to float32 (a GPU backend does not), and the reference's
  ``collective_bytes`` skips the tuple-shaped all-reduces that its
  combiners make; both figures are printed beside the plan's.
- Each ratio is held within 10% of the reading recorded below (torch
  2.13 on the CPU against the JAX package's CPU compile), and inside
  the band the port must meet: FLOPs in [0.5, 1.5]; collective bytes
  in [0.5, 1.5] for training where the heads divide the axis and no
  routing runs, in [0.5, 2.0] elsewhere (with 2 kv heads over a 4-way
  axis GSPMD itself permutes).  A reading that moves needs its cause
  found (``collectives_by_op``) before its record changes.
- Where the heads divide the ``model`` axis (phi3 with 4 kv heads,
  minicpm3), the port's cells force no redistribution.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = pathlib.Path(__file__).resolve().parents[1]

# (cell name, arch, config overrides)
CELLS = [
    ("phi3", "phi3_medium_14b", {}),
    ("phi3_kv4", "phi3_medium_14b", {"n_kv_heads": 4}),
    ("minicpm3", "minicpm3_4b", {}),
    ("moonshot", "moonshot_v1_16b_a3b", {}),
]

# port / reference bands: (train collective bytes, decode collective bytes)
COLL_BAND = {
    "phi3": ((0.5, 2.0), (0.5, 2.0)),
    "phi3_kv4": ((0.5, 1.5), (0.5, 2.0)),
    "minicpm3": ((0.5, 1.5), (0.5, 2.0)),
    "moonshot": ((0.5, 2.0), (0.5, 2.0)),
}
FLOP_BAND = (0.5, 1.5)
# port / reference as recorded: (cell, kind) -> (collective bytes, FLOPs)
RECORDED = {
    ("phi3", "train"): (0.741, 0.895),
    ("phi3", "decode"): (0.747, 0.654),
    ("phi3_kv4", "train"): (0.76, 0.864),
    ("phi3_kv4", "decode"): (1.017, 0.581),
    ("minicpm3", "train"): (0.956, 0.866),
    ("minicpm3", "decode"): (1.014, 0.769),
    ("moonshot", "train"): (0.522, 0.836),
    ("moonshot", "decode"): (0.51, 0.635),
}
DRIFT = 1.1
NOTHING_FORCED = ("phi3_kv4", "minicpm3")

REFERENCE = textwrap.dedent("""
    import json
    import sys
    import tempfile

    sys.path.insert(0, sys.argv[2])
    from reference_collectives import (
        collectives, compiled_step, plan_bytes,
    )
    from repro.launch.dryrun import collective_bytes

    out = {}
    for name, arch, over in json.loads(sys.argv[1]):
        out[name] = {}
        for kind in ("train", "decode"):
            with tempfile.TemporaryDirectory() as tmp:
                c = compiled_step(arch, over, kind, dump_to=tmp)
                plan = plan_bytes(tmp)
            cost = c.cost_analysis()
            cost = cost[0] if isinstance(cost, list) else cost
            text = c.as_text()
            out[name][kind] = {
                "flops": float(cost.get("flops", 0)), "coll": plan,
                "compiled": collective_bytes(text)["total_bytes"],
                "compiled_every": sum(x[1] for x in collectives(text))}
    print(json.dumps(out))
""")

PORT = textwrap.dedent("""
    import dataclasses
    import json
    import sys

    from repro_torch.configs import reduced_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, mesh as M

    TRAIN = ShapeSpec("cmp_train", 32, 8, "train")
    DECODE = ShapeSpec("cmp_decode", 64, 8, "decode")
    out = {}
    try:
        mesh = M.make_small_mesh(8, device="cpu")
        for name, arch, over in json.loads(sys.argv[1]):
            cfg = dataclasses.replace(reduced_config(arch), n_layers=1,
                                      **over)
            out[name] = {}
            for sh in (TRAIN, DECODE):
                r = dryrun.dry_run(cfg, sh, mesh, device="cpu")
                coll = dryrun._result_collectives(r["collectives"])
                out[name][sh.kind] = {
                    "flops": r["flops"], "coll": coll["total_bytes"],
                    "by_kind": coll["bytes"], "counts": coll["counts"],
                    "forced": r["forced"],
                    "by_op": r["collectives_by_op"]}
    finally:
        M.release()
    print(json.dumps(out))
""")


def _run(script: str, pythonpath: str) -> dict:
    env = dict(os.environ, PYTHONPATH=pythonpath, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", script, json.dumps(CELLS),
                          str(REPO / "tools")],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both():
    """(reference, port): the two subprocesses run side by side."""
    src = str(REPO / "src")
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run, REFERENCE, src)
        port = pool.submit(_run, PORT, src)
        return ref.result(), port.result()


def _ratio(port: float, ref: float) -> float:
    return port / ref if ref else float("inf") if port else 1.0


def _held(r: float, band: tuple, recorded: float | None) -> bool:
    """``r`` inside ``band`` and within ``DRIFT`` of its reading."""
    if not band[0] <= r <= band[1]:
        return False
    return recorded is None or recorded / DRIFT <= r <= recorded * DRIFT


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
def test_collective_bytes_within_band(both, cell, kind):
    ref, port = both[0][cell][kind], both[1][cell][kind]
    band = COLL_BAND[cell][kind == "decode"]
    r = _ratio(port["coll"], ref["coll"])
    assert _held(r, band, RECORDED[cell, kind][0]), (
        f"{cell} {kind}: port {port['coll']} B / GSPMD's plan {ref['coll']} "
        f"B = {r:.3f} (band {band}, recorded {RECORDED[cell, kind][0]}); "
        f"compiled for the CPU: {ref['compiled']} B by collective_bytes, "
        f"{ref['compiled_every']} B in all; port by op {port['by_op']}")


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
def test_flops_within_band(both, cell, kind):
    ref, port = both[0][cell][kind], both[1][cell][kind]
    r = _ratio(port["flops"], ref["flops"])
    assert _held(r, FLOP_BAND, RECORDED[cell, kind][1]), (
        f"{cell} {kind}: port {port['flops']} / reference {ref['flops']} "
        f"= {r:.3f} (recorded {RECORDED[cell, kind][1]})")


@pytest.mark.parametrize("cell", NOTHING_FORCED)
def test_nothing_forced_where_heads_divide(both, cell):
    for kind in ("train", "decode"):
        assert both[1][cell][kind]["forced"] == {}, (cell, kind)
