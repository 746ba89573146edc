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

The cells are six REDUCED configs, each with its train step (batch 8 x
32) and its decode step (batch 8, a 64-token cache): cut to one layer,
phi3-medium-14b (4 heads, 2 kv heads), the same with 4 kv heads,
minicpm3 (MLA), moonshot (MoE) and jamba (Mamba with its MoE); and
xlstm at its two REDUCED layers (mLSTM, then sLSTM; 2 heads over the
4-way ``model`` axis).  With one repetition of the layer pattern the
reference takes its ``reps <= 1`` branch (no scan over layers).

The sLSTM is a ``lax.scan`` over the tokens: in the HLO its collectives
appear once, in the ``while`` body, and run once a token.  The
reference's plan bytes count each collective of a ``while`` body times
the loop's trip count, read from the loop's condition (its ROOT compares
the counter with a constant: 32), as ``tools/reference_collectives.py``'s
``plan_bytes`` does; Mamba's ``associative_scan`` is unrolled and needs
no such scaling.  ``cost_analysis`` FLOPs are taken as XLA gives them.

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
  minicpm3), the port's cells force no redistribution; nor do jamba's
  and xlstm's, whose Mamba, mLSTM and sLSTM blocks run as regions.
- jamba and xlstm have bands of their own, below the others': GSPMD
  regroups the ``[xi | z]``, ``[u | z]`` and ``[i | f | z | o]`` columns
  with collective-permutes whose SPMD output counts on every device
  (40,960 B forward in jamba's Mamba, where the port's all-to-all
  receives 16,384), routes every token on every device (as in
  moonshot), all-reduces the gradients of the projections feeding a
  gather where the port reduce-scatters them, and inside the sLSTM's
  ``while`` body all-reduces the gradients of ``w`` and ``r`` over
  ``data`` at every token (524,288 B of xlstm's 1,344,120) and gathers
  each token's input; the port reduces those gradients once.
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
    ("jamba", "jamba_1_5_large_398b", {}),
    ("xlstm", "xlstm_1_3b", {"n_layers": 2}),
]

# port / reference bands: (train collective bytes, decode collective bytes)
COLL_BAND = {
    "phi3": ((0.5, 2.0), (0.5, 2.0)),
    "phi3_kv4": ((0.5, 1.5), (0.5, 2.0)),
    "minicpm3": ((0.5, 1.5), (0.5, 2.0)),
    "moonshot": ((0.5, 2.0), (0.5, 2.0)),
    "jamba": ((0.3, 2.0), (0.25, 2.0)),
    "xlstm": ((0.2, 2.0), (0.3, 2.0)),
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
    ("jamba", "train"): (0.489, 0.783),
    ("jamba", "decode"): (0.349, 0.709),
    ("xlstm", "train"): (0.277, 1.148),
    ("xlstm", "decode"): (0.51, 0.802),
}
DRIFT = 1.1
NOTHING_FORCED = ("phi3_kv4", "minicpm3")
# the cells whose recurrent blocks run as regions
SCAN_CELLS = ("jamba", "xlstm")

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
            cfg = dataclasses.replace(reduced_config(arch),
                                      **{"n_layers": 1, **over})
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


@pytest.mark.parametrize("cell", SCAN_CELLS)
def test_nothing_forced_in_the_scans(both, cell):
    """Mamba, the mLSTM and the sLSTM run as regions: nothing is forced,
    and each region issues collectives of its own."""
    for kind in ("train", "decode"):
        port = both[1][cell][kind]
        assert port["forced"] == {}, (cell, kind, port["forced"])
        mixers = ("mamba",) if cell == "jamba" else ("mlstm", "slstm")
        for region in mixers:
            assert port["by_op"].get(f"region {region}", {}).get("bytes"), \
                (cell, kind, region, port["by_op"])
