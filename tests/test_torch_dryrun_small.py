"""The port's dry run on a small simulated mesh, with no card: the
counterpart of ``tests/test_dryrun_small.py`` (whose JAX test is
``slow``).

Each test runs its cells in a subprocess, on a ``fake`` process group of
8 ranks laid out as ``make_small_mesh(8)`` (2 x 4, ``data`` x
``model``): the group is process-wide, so it never meets another test's
process group.  A train step (batch 8 x 32) and a decode step (batch 8,
cache 64) of each REDUCED config run on DTensors over fake tensors:

- phi3-medium-14b: per-device FLOPs > 0 and below the whole step's,
  all-reduces in training, and the forced redistribution of the
  key/value reshape (2 kv heads over a 4-way ``model`` axis);
- MLA (minicpm3) and MoE (moonshot) here, the hybrid, xLSTM, VLM and
  encoder-decoder families in ``test_torch_dryrun_families.py``;
- on a 1-device mesh, the per-device FLOPs equal the count of the same
  step on plain fake tensors, and the bytes agree within 1e-4 (DTensor
  adds a copy of a few token ids in decode).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import json
    import sys

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import reduced_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, mesh as M

    TRAIN = ShapeSpec("smoke_train", 32, 8, "train")
    DECODE = ShapeSpec("smoke_decode", 64, 8, "decode")


    def summary(r):
        return {"flops": r["flops"], "bytes": r["bytes"],
                "collectives": dryrun._result_collectives(r["collectives"]),
                "forced": r["forced"],
                "param_bytes": r["param_bytes_per_device"]}


    out = {}
    try:
        mesh = M.make_small_mesh(8, device="cpu")
        for arch in sys.argv[1:]:
            if arch == "--one-device":
                continue
            cfg = reduced_config(arch)
            out[arch] = {sh.kind: summary(dryrun.dry_run(cfg, sh, mesh,
                                                         device="cpu"))
                         for sh in (TRAIN, DECODE)}
            fm = FakeTensorMode()
            sds, _ = dryrun._trees(cfg, TRAIN, mesh, "cpu", fm)
            out[arch]["plain_train"] = summary(
                {**dryrun.lower_step(cfg, "train", sds, None, fm),
                 "param_bytes_per_device": 0})
        if "--one-device" in sys.argv:
            cfg = reduced_config("phi3_medium_14b")
            one = M.make_mesh((1, 1), ("data", "model"), device="cpu")
            got = {}
            for sh in (TRAIN, DECODE):
                fm = FakeTensorMode()
                sds, _ = dryrun._trees(cfg, sh, one, "cpu", fm)
                plain = dryrun.lower_step(cfg, sh.kind, sds, None, fm)
                dist = dryrun.dry_run(cfg, sh, one, device="cpu")
                got[sh.kind] = {"plain": [plain["flops"], plain["bytes"]],
                                "mesh": [dist["flops"], dist["bytes"]],
                                "collectives": dist["collectives"]}
            out["one_device"] = got
    finally:
        M.release()
    print(json.dumps(out))
""")


def run_cells(*args: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", SCRIPT, *args], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def check_family(cell: dict) -> None:
    """Both steps ran with work on this device; training reduced its
    gradients; the sharded step did less than the whole one."""
    for kind in ("train", "decode"):
        assert cell[kind]["flops"] > 0 and cell[kind]["bytes"] > 0, kind
        assert cell[kind]["param_bytes"] > 0, kind
    coll = cell["train"]["collectives"]
    assert coll["total_bytes"] > 0
    assert coll["counts"]["all-reduce"] + coll["counts"]["reduce-scatter"] \
        > 0
    assert cell["train"]["flops"] < cell["plain_train"]["flops"]


@pytest.fixture(scope="module")
def cells():
    return run_cells("phi3_medium_14b", "minicpm3_4b",
                     "moonshot_v1_16b_a3b", "--one-device")


def test_dense_train_and_decode(cells):
    c = cells["phi3_medium_14b"]
    check_family(c)
    assert c["train"]["collectives"]["counts"]["all-reduce"] > 0, \
        "DP training must emit all-reduces"
    assert c["decode"]["flops"] < c["train"]["flops"]
    # 2 kv heads over the 4-way model axis: the view is replicated
    assert c["train"]["forced"]["aten.view.default -> replicate model"] > 0


@pytest.mark.parametrize("arch", ["minicpm3_4b", "moonshot_v1_16b_a3b"])
def test_mla_and_moe_train_and_decode(cells, arch):
    check_family(cells[arch])


def test_moe_routing_is_replicated(cells):
    """DTensor has no sharding rule for the expert counts' scatter_add_:
    it runs on whole tensors, and the cell lists it."""
    forced = cells["moonshot_v1_16b_a3b"]["train"]["forced"]
    assert forced["aten.scatter_add_.default -> replicate all (local)"] > 0


def test_one_device_mesh_equals_plain_step(cells):
    for kind, got in cells["one_device"].items():
        assert got["mesh"][0] == got["plain"][0] > 0, kind
        assert got["mesh"][1] == pytest.approx(got["plain"][1], rel=1e-4)
        assert got["collectives"]["all-reduce"] == 0, kind
