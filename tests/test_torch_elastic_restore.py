"""Elastic restore onto a mesh: a checkpoint written by the JAX package
(parameters and AdamW state of phi3-medium-14b's REDUCED config with
``fsdp=True``, so that leaves shard over both mesh axes) is restored by
the port's ``CheckpointManager.restore(shardings=...)`` onto a 2 x 2
``("data", "model")`` mesh of 4 gloo ranks, with ``launch/plan.py``'s
placements.  The ranks are spawned by one subprocess and meet through a
file in the test's tmp dir.  Each rank's local shard of every leaf must
equal, bit for bit, the slice of the reference's array that its mesh
coordinates name under the leaf's spec (axes split a dimension in mesh
order, major to minor); a replicated leaf (the norms, the step) is whole
on every rank.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.train import checkpoint as ref_checkpoint  # noqa: E402
from repro.train import optimizer as ref_optimizer  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
STEP = 7

RANKS = textwrap.dedent("""
    import dataclasses
    import json
    import multiprocessing as mp
    import sys

    import numpy as np


    def local_slices(mesh, spec, shape, rank):
        # the slice of a tensor of `shape` that `rank` holds under `spec`:
        # the axes' coordinates in mesh order, major to minor
        from repro_torch.launch.mesh import axis_size, entry_axes

        pos = (mesh.mesh == rank).nonzero()[0]
        coords = {n: int(c) for n, c in zip(mesh.mesh_dim_names, pos)}
        out = []
        for dim, n in enumerate(shape):
            entry = spec[dim] if dim < len(spec) else None
            start, size = 0, n
            for a in entry_axes(entry):
                size //= axis_size(mesh, a)
                start += coords[a] * size
            out.append(slice(start, start + size))
        return tuple(out), coords


    def rank_main(rank, world, tmp):
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor

        from repro_torch.configs import reduced_config
        from repro_torch.launch import plan
        from repro_torch.models.steps import param_shapes
        from repro_torch.train.checkpoint import CheckpointManager, _flatten

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                world_size=world, rank=rank)
        try:
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            cfg = dataclasses.replace(reduced_config("phi3_medium_14b"),
                                      fsdp=True)
            sds = param_shapes(cfg, device="cpu")
            p_plan = plan.param_plan(cfg, mesh, sds)
            shardings = {"params": p_plan,
                         "opt": plan.opt_plan(cfg, mesh, None, p_plan)}
            step, state = CheckpointManager(f"{tmp}/ckpt").restore(
                shardings=shardings)
            plans = _flatten(shardings)
            out, meta = {}, {}
            for k, v in _flatten(state).items():
                assert isinstance(v, DTensor), k
                assert tuple(v.placements) == plans[k].placements, k
                local = v.to_local()
                if local.dtype == torch.bfloat16:
                    local = local.view(torch.int16)
                out[k.replace("/", "|")] = local.numpy()
                sl, coords = local_slices(mesh, plans[k].spec,
                                          tuple(v.shape), rank)
                meta[k] = [[s.start, s.stop] for s in sl]
            np.savez(f"{tmp}/rank{rank}.npz", **out)
            with open(f"{tmp}/rank{rank}.json", "w") as f:
                json.dump({"step": step, "slices": meta, "coords": coords},
                          f)
            dist.barrier()
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        world, tmp = int(sys.argv[1]), sys.argv[2]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, world, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=240)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
        print(json.dumps({"exitcodes": codes}))
        sys.exit(0 if all(c == 0 for c in codes) else 1)
""")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}#{i}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    """The reference's state (numpy, by checkpoint key) and each rank's
    restored shards and slices."""
    tmp = tmp_path_factory.mktemp("elastic")
    rcfg = dataclasses.replace(ref_reduced("phi3_medium_14b"), fsdp=True)
    rp = ref_model.init_params(rcfg, jax.random.PRNGKey(5))
    rs = ref_optimizer.AdamW(state_dtype="bfloat16").init(rp)
    rs["m"] = jax.tree.map(lambda p: (p * 0.5).astype(jnp.bfloat16), rp)
    rs["step"] = jnp.asarray(STEP, jnp.int32)
    state = {"params": rp, "opt": rs}
    ref_checkpoint.CheckpointManager(
        str(tmp / "ckpt"), async_write=False).save(STEP, state)
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(WORLD), str(tmp)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    import json

    ranks = {r: (np.load(tmp / f"rank{r}.npz"),
                 json.loads((tmp / f"rank{r}.json").read_text()))
             for r in range(WORLD)}
    want = {k: np.asarray(v) for k, v in _flat(state).items()}
    return want, ranks


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_every_rank_holds_its_slice(restored):
    want, ranks = restored
    assert len(want) > 20
    for r, (shards, meta) in ranks.items():
        assert meta["step"] == STEP
        assert sorted(meta["slices"]) == sorted(want)
        for k, w in want.items():
            sl = tuple(slice(a, b) for a, b in meta["slices"][k])
            got = shards[k.replace("/", "|")]
            exp = _bits(w)[sl]
            assert got.shape == exp.shape, (r, k)
            np.testing.assert_array_equal(got.view(exp.dtype), exp,
                                          err_msg=f"rank {r} {k}")


def test_shards_cover_both_axes(restored):
    """The plan shards over both axes: wq is split on 'data' (fsdp) and
    'model', the embedding on 'model', and the ranks' shards of each
    leaf tile it exactly once."""
    want, ranks = restored
    coords = {r: m["coords"] for r, (_, m) in ranks.items()}
    assert sorted((c["data"], c["model"]) for c in coords.values()) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    wq = "/params/blocks#0/attn/wq"
    shapes = {tuple(b - a for a, b in ranks[r][1]["slices"][wq])
              for r in ranks}
    full = want[wq].shape
    assert shapes == {(full[0], full[1] // 2, full[2] // 2)}
    for k, w in want.items():
        seen = np.zeros(w.shape, np.int64)
        for r in ranks:
            seen[tuple(slice(a, b) for a, b in ranks[r][1]["slices"][k])] \
                += 1
        # replicated on the axes a leaf is not split over: each element
        # is held by (world / number of shards) ranks
        assert seen.min() == seen.max() >= 1, k
