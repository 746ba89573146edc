"""The port's distributed keyswitch (IRF / EVF over torch.distributed)
against the JAX package's ``core/distributed.py``.

At ``tests/test_distributed.py``'s shape (dnum = 3, L = 16, N = 256,
``default_rng(0)``, primes ``536608769 + 4096 i``): the single-device
inner product in process, bit for bit, and IRF and EVF over 8 gloo ranks
in one subprocess, whose gathered shards must equal the JAX package's
``reference_ip`` on the same arrays, bit for bit.  Each rank counts the
bytes its all-to-all sends off the rank; they must equal
``comm_bytes_per_device``, and IRF must move fewer than EVF.

The ranks meet through a file in the test's own temporary directory (no
port, so parallel test workers cannot collide), and nothing here
initialises a process group in the test process.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import distributed as ref_dist  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.kernels.fused_ip.ops import IPConsts  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
DNUM, L, N, WORLD = 3, 16, 256, 8


@pytest.fixture(scope="module")
def data():
    """tests/test_distributed.py's arrays and the JAX reference on them."""
    rng = np.random.default_rng(0)
    qs = np.array([536608769 + 4096 * i for i in range(L)],
                  dtype=np.uint64)[:, None]
    digits = rng.integers(0, 2**29, (DNUM, L, N)).astype(np.uint64)
    evk = rng.integers(0, 2**29, (DNUM, 2, L, N)).astype(np.uint64)
    ref = ref_dist.reference_ip(jnp.asarray(digits), jnp.asarray(evk),
                                jnp.asarray(qs))
    return {"qs": qs, "digits": digits, "evk": evk,
            "ref": [np.asarray(r) for r in ref]}


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_reference_ip_equals_jax(data):
    got = distributed.reference_ip(_t(data["digits"]), _t(data["evk"]),
                                   data["qs"])
    for g, r in zip(got, data["ref"]):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), r)


@pytest.mark.parametrize("limbs", [slice(0, L), slice(4, 6)])
def test_local_ip_equals_jax(data, limbs):
    """``_local_ip`` of the port (the fused IP's plain version) against the
    JAX package's ``_local_ip``, on all limbs and on one rank's two."""
    d, k = data["digits"][:, limbs], data["evk"][:, :, limbs]
    q = data["qs"][limbs]
    want = ref_dist._local_ip(jnp.asarray(d), jnp.asarray(k), jnp.asarray(q))
    got = distributed._local_ip(_t(d), _t(k),
                                IPConsts(tuple(int(x) for x in q[:, 0]),
                                         torch.device("cpu")))
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64),
                                      np.asarray(r))


@pytest.mark.parametrize("kind", distributed.KINDS)
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_comm_bytes_per_device_equals_jax(kind, p):
    for dnum, ext, n in ((DNUM, L, N), (3, 48, 1 << 16)):
        assert (distributed.comm_bytes_per_device(kind, dnum, ext, n, p)
                == ref_dist.comm_bytes_per_device(kind, dnum, ext, n, p))


RANKS = textwrap.dedent("""
    import json
    import multiprocessing as mp
    import sys

    import numpy as np


    def rank_main(rank, world, tmp):
        import torch
        import torch.distributed as dist

        from repro_torch.core import distributed

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                world_size=world, rank=rank)
        try:
            a = np.load(f"{tmp}/inputs.npz")
            L, N = a["qs"].shape[0], a["digits"].shape[-1]
            cs, ls = N // world, L // world
            digits = torch.from_numpy(
                a["digits"][:, :, rank * cs:(rank + 1) * cs].astype(np.int64))
            evk = torch.from_numpy(
                a["evk"][:, :, rank * ls:(rank + 1) * ls].astype(np.int64))
            res = {}
            for kind, make in (("IRF", distributed.ip_irf),
                               ("EVF", distributed.ip_evf)):
                fn, n = make()
                assert n == world
                meas = distributed.measure_collectives(fn, digits, evk,
                                                       a["qs"])
                acc0, acc1 = fn(digits, evk, a["qs"])
                res[kind] = np.stack([acc0.numpy(), acc1.numpy()])
                res[kind + "_meas"] = np.array(json.dumps(meas))
            np.savez(f"{tmp}/rank{rank}.npz", **res)
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


@pytest.fixture(scope="module")
def gloo_run(data, tmp_path_factory):
    """IRF and EVF on 8 gloo ranks: {rank: npz of its shards and counted
    bytes}."""
    tmp = tmp_path_factory.mktemp("gloo")
    np.savez(tmp / "inputs.npz", qs=data["qs"], digits=data["digits"],
             evk=data["evk"])
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(WORLD), str(tmp)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return {r: np.load(tmp / f"rank{r}.npz") for r in range(WORLD)}


def test_irf_gathers_to_reference(gloo_run, data):
    """IRF's output is limb-sharded: rank r holds limbs r*L/P .. (r+1)*L/P."""
    got = np.concatenate([gloo_run[r]["IRF"] for r in range(WORLD)], axis=1)
    for c in range(2):
        np.testing.assert_array_equal(got[c].astype(np.uint64),
                                      data["ref"][c])


def test_evf_gathers_to_reference(gloo_run, data):
    """EVF's output is coefficient-sharded: rank r holds coefficients
    r*N/P .. (r+1)*N/P of every limb."""
    got = np.concatenate([gloo_run[r]["EVF"] for r in range(WORLD)], axis=2)
    for c in range(2):
        np.testing.assert_array_equal(got[c].astype(np.uint64),
                                      data["ref"][c])


def test_counted_bytes_equal_analytic(gloo_run):
    """Every rank's all-to-all sent what ``comm_bytes_per_device`` says,
    in one collective, and IRF moved fewer bytes than EVF (the paper's
    Fig. 3 trade-off for one keyswitch)."""
    sent = {}
    for kind in distributed.KINDS:
        want = distributed.comm_bytes_per_device(kind, DNUM, L, N, WORLD)
        for r in range(WORLD):
            meas = json.loads(str(gloo_run[r][kind + "_meas"]))
            assert meas["bytes"]["all-to-all"] == want, (kind, r, meas)
            assert meas["total_bytes"] == want
            assert meas["counts"]["all-to-all"] == 1
        sent[kind] = want
    assert sent["IRF"] < sent["EVF"]


def test_distributed_imports_no_jax():
    """The distributed module loads without JAX or the JAX package."""
    code = ("import sys; import repro_torch.core.distributed; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
