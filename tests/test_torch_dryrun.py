"""The port's dry-run modules against the JAX package's, with no card.

- ``configs/shapes``: ``SHAPES``, ``shapes_for``, ``skipped_shapes`` and
  ``SMOKE_SHAPES`` equal.
- ``param_shapes`` (fake tensors) against ``jax.eval_shape`` of the
  reference's ``init_params``: every leaf's shape and dtype, for all ten
  architectures at full width.
- ``param_specs`` against the reference's ``PartitionSpec`` tree (as
  tuples), as configured, with ``fsdp=True``, and in the ``expert_ff``
  variant.
- The sanitized param, opt, batch and cache plans on (16, 16) and
  (2, 16, 16) meshes against the reference's ``launch/plan.py`` on a
  ``jax.sharding.AbstractMesh`` of the same axes; the shard shapes and
  the per-device parameter bytes against ``NamedSharding.shard_shape``.
- ``analyze_cell`` against the reference's on hand-made cells, with the
  reference's hardware constants set to the port's H100 figures and its
  scan correction to 1.0 (attributes set on the module, no file
  changed).
- ``collective_bytes`` on a known all-reduce and all-gather, and on
  the all-gather that a DTensor redistribution issues.

The port's meshes sit over a ``fake`` process group in this process; a
module fixture starts it and ends it, so it never outlives the file.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.launch import plan as ref_plan  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import steps as ref_steps  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.launch import dryrun, mesh as mesh_mod  # noqa: E402
from repro_torch.launch import plan, roofline  # noqa: E402
from repro_torch.models import model, steps  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists (tuples and
    PartitionSpecs are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}#{i}"))
        return out
    return {prefix: tree}


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


@pytest.fixture(scope="module")
def meshes():
    """The port's production meshes (fake group) and the reference's
    abstract meshes of the same axes, by kind."""
    out = {}
    try:
        for kind, (shape, axes) in MESHES.items():
            out[kind] = AbstractMesh(shape, axes)
        yield out
    finally:
        mesh_mod.release()


def _port_mesh(kind):
    return mesh_mod.make_production_mesh(multi_pod=kind == "multi",
                                         device="cpu")


@pytest.fixture(scope="module")
def trees():
    """Per architecture: the reference's and the port's shape-only
    parameter trees."""
    return {a: (ref_steps.param_shapes(ref_get_config(a)),
                steps.param_shapes(get_config(a), device="cpu"))
            for a in ARCHS}


# ------------------------------- shapes -----------------------------------

def test_shapes_equal_reference():
    assert shapes.SHAPES == {
        k: shapes.ShapeSpec(**dataclasses.asdict(v))
        for k, v in ref_shapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC == ref_shapes.SUBQUADRATIC
    assert {k: dataclasses.asdict(v) for k, v in shapes.SMOKE_SHAPES.items()} \
        == {k: dataclasses.asdict(v)
            for k, v in ref_shapes.SMOKE_SHAPES.items()}
    for a in ARCHS:
        assert shapes.shapes_for(a) == ref_shapes.shapes_for(a)
        assert shapes.skipped_shapes(a) == ref_shapes.skipped_shapes(a)


# --------------------------- shapes and specs -----------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_eval_shape(arch, trees):
    ref, got = (_flat(t) for t in trees[arch])
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        assert _dtype(got[k].dtype) == _dtype(ref[k].dtype), k
        assert got[k].device.type == "cpu" and \
            isinstance(got[k], torch._subclasses.fake_tensor.FakeTensor)


def _spec_variants(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    return {"base": (cfg, rcfg),
            "fsdp": (dataclasses.replace(cfg, fsdp=True),
                     dataclasses.replace(rcfg, fsdp=True)),
            "expert_ff": (dryrun.VARIANTS["expert_ff"](cfg),
                          dataclasses.replace(rcfg, expert_shard="ff")),
            "expert_ff_fsdp": (
                dataclasses.replace(cfg, expert_shard="ff", fsdp=True),
                dataclasses.replace(rcfg, expert_shard="ff", fsdp=True))}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, trees):
    ref_sds, sds = trees[arch]
    for name, (cfg, rcfg) in _spec_variants(arch).items():
        ref = _flat(ref_model.param_specs(rcfg, ref_sds))
        got = _flat(model.param_specs(cfg, sds))
        assert sorted(got) == sorted(ref), name
        for k in ref:
            assert got[k] == tuple(ref[k]), (name, k)
    # the default tree is built for the config
    assert model.param_specs(get_config(arch)) == \
        model.param_specs(get_config(arch), sds)


# ------------------------------- plans ------------------------------------

def _ref_specs(tree):
    return {k: tuple(v.spec) for k, v in _flat(tree).items()}


def _port_specs(tree):
    return {k: v.spec for k, v in _flat(tree).items()}


@pytest.mark.parametrize("kind", list(MESHES))
def test_param_and_opt_plans_equal_reference(kind, meshes, trees):
    amesh = meshes[kind]
    pm = _port_mesh(kind)
    for arch in ARCHS:
        ref_sds, sds = trees[arch]
        cfg = get_config(arch)
        ref_pp = ref_plan.param_plan(ref_get_config(arch), amesh, ref_sds)
        pp = plan.param_plan(cfg, pm, sds)
        assert _port_specs(pp) == _ref_specs(ref_pp), arch
        ref_op = ref_plan.opt_plan(None, amesh, None, ref_pp)
        op = plan.opt_plan(cfg, pm, None, pp)
        assert _port_specs(op) == _ref_specs(ref_op), arch
        # shard shapes and the per-device bytes
        ref_flat, flat = _flat(ref_pp), _flat(pp)
        ref_leaves = _flat(ref_sds)
        ref_bytes = 0
        for k, leaf in _flat(sds).items():
            want = ref_flat[k].shard_shape(ref_leaves[k].shape)
            assert flat[k].shard_shape(leaf.shape) == tuple(want), (arch, k)
            ref_bytes += int(np.prod(want)) * ref_leaves[k].dtype.itemsize
        assert dryrun._sharded_bytes(sds, pp) == ref_bytes, arch


@pytest.mark.parametrize("kind", list(MESHES))
def test_batch_and_cache_plans_equal_reference(kind, meshes):
    amesh = meshes[kind]
    pm = _port_mesh(kind)
    fm = FakeTensorMode()
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in shapes.shapes_for(arch):
            ref_b = ref_steps.input_specs(arch, shape)
            got_b = steps.input_specs(arch, shape, device="cpu",
                                      fake_mode=fm)
            assert {k: tuple(v.shape) for k, v in got_b.items()} == \
                {k: tuple(v.shape) for k, v in ref_b.items()}, (arch, shape)
            assert _port_specs(plan.batch_plan(pm, got_b)) == \
                _ref_specs(ref_plan.batch_plan(amesh, ref_b)), (arch, shape)
            if shapes.SHAPES[shape].kind != "decode":
                continue
            ref_c = ref_steps.cache_specs(arch, shape)
            got_c = steps.cache_specs(arch, shape, device="cpu",
                                      fake_mode=fm)
            rflat, gflat = _flat(ref_c["slots"]), _flat(got_c["slots"])
            assert {k: tuple(v.shape) for k, v in gflat.items()} == \
                {k: tuple(v.shape) for k, v in rflat.items()}
            assert {k: _dtype(v.dtype) for k, v in gflat.items()} == \
                {k: _dtype(v.dtype) for k, v in rflat.items()}
            ref_cp = ref_plan.cache_plan(ref_get_config(arch), amesh, ref_c)
            cp = plan.cache_plan(cfg, pm, got_c)
            assert _port_specs(cp) == _ref_specs(ref_cp), (arch, shape)


def test_sanitize_drops_axes_that_do_not_divide(meshes):
    pm = _port_mesh("multi")
    amesh = meshes["multi"]
    from jax.sharding import PartitionSpec as P
    cases = [((("pod", "data"), "model"), (64, 48)),
             ((("pod", "data"), "model"), (48, 40)),
             (("data", None, "model"), (16, 3, 8)),
             ((None,), (5, 7))]
    for spec, shape in cases:
        want = ref_plan.sanitize(P(*spec), shape, amesh)
        assert plan.sanitize(spec, shape, pm) == tuple(want)
    placed = plan.ShardPlan(pm, (("pod", "data"), "model"))
    assert placed.shard_shape((64, 48)) == tuple(
        NamedSharding(amesh, P(("pod", "data"), "model")).shard_shape(
            (64, 48)))
    from torch.distributed.tensor import Replicate, Shard
    assert placed.placements == (Shard(0), Shard(0), Shard(1))
    assert plan.ShardPlan(pm, ()).placements == (Replicate(),) * 3


# ------------------------------ roofline ----------------------------------

def _cell(arch, shape, flops, nbytes, coll, chips=256):
    sh = shapes.SHAPES[shape]
    tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
    return {"arch": arch, "shape": shape, "n_chips": chips,
            "hlo_flops": flops, "hlo_bytes": nbytes,
            "collectives": {"total_bytes": coll},
            "model_flops": 6.0 * 3e9 * tokens, "tokens": tokens}


def test_roofline_equals_reference(monkeypatch):
    assert roofline.PEAK_FLOPS == 989.4e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9
    monkeypatch.setattr(ref_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(ref_roofline, "ICI_BW", roofline.LINK_BW)
    monkeypatch.setattr(ref_roofline, "_scan_correction", lambda r: 1.0)
    cells = [_cell("phi3_medium_14b", "train_4k", 5.4e15, 3.9e13, 1.2e12),
             _cell("stablelm_3b", "decode_32k", 2.0e11, 8.0e9, 1.0e8),
             _cell("jamba_1_5_large_398b", "long_500k", 1.0e9, 4.0e12, 0,
                   chips=512),
             _cell("whisper_base", "prefill_32k", 0.0, 0.0, 0.0)]
    for r in cells:
        assert roofline.analyze_cell(r) == ref_roofline.analyze_cell(r)
    assert roofline.analyze_cell(cells[0])["dominant"] == "collective"
    assert roofline.analyze_cell(cells[2])["dominant"] == "memory"


# ----------------------------- collectives --------------------------------

def test_collective_bytes_counts_known_collectives():
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    try:
        mesh = mesh_mod.make_small_mesh(8, device="cpu")
        group = mesh.get_group("model")               # 4 ranks
        fm = FakeTensorMode()
        with fm:
            x = torch.empty((1024, 256), dtype=torch.float32)
            y = torch.empty((8, 128), dtype=torch.bfloat16)
        counter = dryrun.OpCounter(fm)
        with fm, counter:
            funcol.all_reduce(x, "sum", group).shape
            funcol.all_gather_single(y, 0, group).shape
        c = dryrun.collective_bytes(counter.collectives)
        assert c["bytes"]["all-reduce"] == 1024 * 256 * 4
        assert c["bytes"]["all-gather"] == 32 * 128 * 2
        assert c["counts"] == {"all-reduce": 1, "all-gather": 1,
                               "reduce-scatter": 0, "all-to-all": 0,
                               "collective-permute": 0}
        assert c["total_bytes"] == 1024 * 256 * 4 + 32 * 128 * 2

        # a DTensor redistribution Shard -> Replicate on 'model' is one
        # all-gather of the whole (per-'data'-shard) tensor
        with fm:
            local = torch.empty((4, 64), dtype=torch.float32)
        d = DTensor.from_local(local, mesh, [Replicate(), Shard(0)],
                               run_check=False, shape=(16, 64),
                               stride=(64, 1))
        counter = dryrun.OpCounter(fm)
        with fm, counter:
            d.redistribute(mesh, [Replicate(), Replicate()])
        c = dryrun.collective_bytes(counter.collectives)
        assert c["counts"]["all-gather"] == 1
        assert c["bytes"]["all-gather"] == 16 * 64 * 4
        assert c["total_bytes"] == 16 * 64 * 4
        assert counter.flops == 0
    finally:
        mesh_mod.release()


def test_mesh_group_lifecycle():
    import torch.distributed as dist

    try:
        m = mesh_mod.make_production_mesh(device="cpu")
        assert m.mesh_dim_names == ("data", "model") and m.size() == 256
        assert dist.get_backend() == "fake" and dist.get_world_size() == 256
        assert mesh_mod.dp_axes(m) == ("data",) and mesh_mod.dp_size(m) == 16
        m = mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
        assert m.size() == 512 and dist.get_world_size() == 512
        assert mesh_mod.dp_axes(m) == ("pod", "data")
        assert mesh_mod.batch_pspec(m, 256) == (("pod", "data"),)
        assert mesh_mod.batch_pspec(m, 16) == ("data",)
        assert mesh_mod.batch_pspec(m, 1) == (None,)
    finally:
        mesh_mod.release()
    assert not dist.is_initialized()


def test_mesh_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_mod.make_production_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.param_shapes(get_config("phi3_medium_14b"))


def test_modules_import_no_jax():
    """The dry-run modules import neither jax nor the JAX package."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "import repro_torch.configs.shapes\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(repo / "src")))
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
