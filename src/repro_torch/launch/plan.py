"""Sharding plans: mesh-aware specs for params, optimizer state, batches
and decode caches, with divisibility sanitization (axes that do not
divide a dimension are dropped rather than failing at run time).

Counterpart of the JAX package's ``launch/plan.py``.  Where the
reference returns a ``NamedSharding`` a leaf, these return a
``ShardPlan``: the sanitized spec tuple (an entry per dimension, as
``models.model.param_specs`` writes them) and its DTensor placements on
the mesh (``launch.mesh.sharding``).
"""
from __future__ import annotations

import dataclasses

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import batch_pspec, dp_axes, pspec
from repro_torch.models.model import param_specs
from repro_torch.train.tree import tree_map


@dataclasses.dataclass(frozen=True, eq=False)
class ShardPlan:
    """One leaf's sharding: ``spec`` and its ``placements`` on ``mesh``."""
    mesh: DeviceMesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        return mesh_mod.sharding(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple[int, ...]:
        return mesh_mod.shard_shape(self.mesh, self.spec, tuple(shape))


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def _axes_size(mesh, entry) -> int:
    s = 1
    for a in mesh_mod.entry_axes(entry):
        s *= mesh_mod.axis_size(mesh, a)
    return s


def sanitize(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Drop spec axes that don't divide the corresponding dimension."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return pspec(*(entry if dim % _axes_size(mesh, entry) == 0 else None
                   for dim, entry in zip(shape, entries)))


def sanitize_tree(specs, shapes, mesh):
    return tree_map(lambda sp, sh: sanitize(sp, tuple(sh.shape), mesh),
                    specs, shapes, is_leaf=_is_spec)


def param_plan(cfg: ModelConfig, mesh, param_sds):
    specs = sanitize_tree(param_specs(cfg, param_sds), param_sds, mesh)
    return tree_map(lambda s: ShardPlan(mesh, s), specs, is_leaf=_is_spec)


def opt_plan(cfg: ModelConfig, mesh, opt_sds, param_shardings):
    """m/v inherit the param sharding (ZeRO-style); step replicated."""
    return {"m": param_shardings, "v": param_shardings,
            "step": ShardPlan(mesh, ())}


def batch_plan(mesh, batch_sds):
    out = {}
    for k, v in batch_sds.items():
        if k in ("tokens", "labels"):
            out[k] = ShardPlan(mesh, batch_pspec(mesh, v.shape[0]))
        elif k == "positions":
            bp = batch_pspec(mesh, v.shape[-2] if v.ndim == 3 else
                             v.shape[0])
            out[k] = ShardPlan(mesh, pspec(None, *bp) if v.ndim == 3
                               else bp)
        elif k == "embeds":
            out[k] = ShardPlan(mesh, sanitize((dp_axes(mesh), None, None),
                                              tuple(v.shape), mesh))
        else:
            out[k] = ShardPlan(mesh, ())
    return out


def cache_plan(cfg: ModelConfig, mesh, cache_sds):
    """Decode caches: batch over DP, long axes over 'model'.

    KV seq axis is model-sharded (sequence-sharded KV attention) because
    GQA head counts (often 8) don't divide the 16-way model axis; SSM
    states shard their feature axis instead."""
    dp = dp_axes(mesh)
    table = {
        "k": (None, dp, "model", None, None),       # (reps, B, S, KV, hd)
        "v": (None, dp, "model", None, None),
        "c_kv": (None, dp, "model", None),          # (reps, B, S, rank)
        "k_rope": (None, dp, "model", None, None),  # (reps, B, S, 1, rd)
        "conv": (None, dp, None, "model"),          # (reps, B, dc-1, di)
        "ssm": (None, dp, "model", None),           # (reps, B, di, ds)
        "C": (None, dp, None, "model", None),       # (reps, B, H, hd, hd)
        "n": (None, dp, None, "model"),             # (reps, B, H, hd)
        "h": (None, dp, "model"),                   # (reps, B, d)
        "c": (None, dp, "model"),
    }

    def leaf_spec(name, sds):
        if name in table:
            return sanitize(table[name], tuple(sds.shape), mesh)
        return ()

    slots = [{k: ShardPlan(mesh, leaf_spec(k, v)) for k, v in slot.items()}
             for slot in cache_sds["slots"]]
    return {"slots": slots, "idx": ShardPlan(mesh, ())}
