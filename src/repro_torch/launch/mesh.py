"""Production meshes, on a simulated job of H100s.

Counterpart of the JAX package's ``launch/mesh.py``.  The reference
forces 512 host devices and lays them out with ``jax.make_mesh``; here
a ``fake`` process group of 256 or 512 ranks stands for the job, this
process being rank 0 (one H100 of it), and a ``DeviceMesh`` lays the
ranks out.  A fake group carries no data: its collectives return at
once, and the dry run reads only their shapes.

Functions, not module-level constants: importing this module starts no
process group (the group is process-wide, so its owner starts and ends
it).  ``make_*_mesh`` start the fake group of the mesh's size, ending a
fake group of another size first; ``release`` ends it.  A group of
another backend is left alone, and asking for a mesh then raises.

``sharding`` maps a spec tuple (``models.model.param_specs``' form: an
entry per tensor dimension, ``None``, an axis name or a tuple of axis
names) to DTensor placements, one per mesh dimension.  A dimension
named by several mesh axes is split over each in mesh order, major to
minor, as ``("pod", "data")`` is in the reference.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core.poly import resolve_device


def _fake_group(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks, this process rank 0."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group is running; the "
                "simulated mesh needs the process to itself")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    # registers the "fake" backend with c10d
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def release() -> None:
    """End the fake process group, if one is running."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake group of
    prod(shape) ranks, on ``device``'s type (the card by default)."""
    device = resolve_device(device)
    world = 1
    for n in shape:
        world *= n
    _fake_group(world)
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """(16, 16) ``("data", "model")``: 256 H100s, or (2, 16, 16)
    ``("pod", "data", "model")``: 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_small_mesh(devices: int = 8, *, device="cuda") -> DeviceMesh:
    """Reduced mesh for the CPU dry-run tests: (devices // 4, 4)."""
    return make_mesh((devices // 4, 4), ("data", "model"), device=device)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Pure data-parallel axes (pod folds into DP)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def dp_size(mesh: DeviceMesh) -> int:
    s = 1
    for a in dp_axes(mesh):
        s *= axis_size(mesh, a)
    return s


def pspec(*entries) -> tuple:
    """A spec tuple, its entries written as ``PartitionSpec`` keeps them:
    a tuple of one axis name becomes the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def batch_pspec(mesh: DeviceMesh, batch: int) -> tuple:
    """Shard batch over DP axes when divisible, else replicate."""
    axes = dp_axes(mesh)
    if batch % dp_size(mesh) == 0:
        return pspec(axes)
    if "data" in axes and batch % axis_size(mesh, "data") == 0:
        return pspec("data")
    return pspec(None)


def entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharding(mesh: DeviceMesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that tensor dimension d names, ``Replicate()`` on the
    others (and on a dimension of size 1, which splits nothing)."""
    names = mesh.mesh_dim_names
    out: list = [Replicate()] * mesh.ndim
    seen: set = set()
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"axes {entry} are not in the mesh's order "
                             f"{names}")
        for i in idx:
            if i in seen:
                raise ValueError(f"mesh axis {names[i]} named twice in "
                                 f"{spec}")
            seen.add(i)
            if mesh.size(i) > 1:
                out[i] = Shard(dim)
    return tuple(out)


def shard_shape(mesh: DeviceMesh, spec: tuple,
                shape: tuple[int, ...]) -> tuple[int, ...]:
    """Shape of one device's shard (every named axis must divide its
    dimension, as ``plan.sanitize`` ensures)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in entry_axes(entry):
            n = axis_size(mesh, a)
            if out[dim] % n:
                raise ValueError(f"axis {a} ({n}) does not divide "
                                 f"dimension {dim} of {tuple(shape)}")
            out[dim] //= n
    return tuple(out)
