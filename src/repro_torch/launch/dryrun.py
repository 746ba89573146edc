"""Multi-pod dry run: run every (arch x shape x mesh) cell's real step on
shape-only tensors sharded over a simulated job of H100s.

Counterpart of the JAX package's ``launch/dryrun.py``.  Where the
reference lowers and compiles the jitted train / prefill / serve step
against ``ShapeDtypeStruct`` inputs on a forced 512-device mesh, this
runs the port's own step functions (``models.steps``) once, eagerly,
on DTensors whose local shards are fake tensors (``FakeTensorMode``:
shapes and dtypes, no memory, no arithmetic), over a ``fake`` process
group of 256 or 512 ranks (``launch.mesh``).  This process is rank 0,
so every count below is one device's:

* ``hlo_flops`` / ``hlo_bytes``: the FLOPs and bytes of the local ops
  that rank 0 runs on its shards.  A matrix product counts 2 m n k
  (``torch.utils.flop_counter``'s formulas), an elementwise op one
  FLOP an output element, a reduction one an input element; an op
  reads each tensor input once and writes each output once, and a
  view moves nothing.  The names are the reference's keys; the
  numbers are counts of the port's eager ops, not of compiled HLO.
* ``collectives``: the output bytes of every ``c10d_functional``
  collective issued on rank 0 (``collective_bytes``), and
  ``collectives_by_op``: the same bytes by what issued them, the
  ``models.partition`` region (``region attention``, ``region mlp
  backward``, ...), the DTensor op being dispatched, or the autograd
  node whose backward ran.
* ``memory_analysis``: the local bytes of the step's arguments and
  outputs; no temp figure (``torch.distributed._tools.mem_tracker``
  counts a DTensor at its global size under fake tensors).
* ``param_bytes_per_device`` / ``state_bytes_per_device``: from the
  plan's shard shapes, as the reference's ``_sharded_bytes``.

The port runs each layer eagerly, so these counts already cover every
layer (the reference's cost analysis counts a scanned layer once).

The embedding lookup, attention, MLA, the MLP, the MoE, the head, the
loss and the greedy pick run as ``models.partition`` partitions them:
the plan of the reference's GSPMD partitioner, with every collective
placed by that module, so their counts do not depend on the torch
version.  The ops between them (norms, residual adds, the optimizer)
and the blocks it does not partition (Mamba, mLSTM, sLSTM) go to
DTensor's own sharding rules.  Where DTensor cannot partition one of
those ops (a view that splits a sharded dimension unevenly, an op
without a sharding rule), in the forward or the backward pass,
``Repartition`` moves that op's DTensor inputs to ``Replicate`` on the
offending mesh dimensions and runs it again.  Each such redistribution
is a collective and is counted as one; the cell's JSON lists those ops
under ``forced_redistributions``.  What the model computes does not
change.  DTensor's choices differ between torch versions, so the counts
of a cell that reaches them are those of the torch that ran it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3_medium_14b \\
      --shape train_4k --mesh single [--device cpu] [--layers N]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] \\
      [--workers 4]

Results cached as JSON under results/dryrun_torch/ (incremental).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import n_active_params
from repro_torch.configs.shapes import SHAPES, shapes_for
from repro_torch.launch import plan as plan_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import partition
from repro_torch.models.model import init_cache
from repro_torch.models.steps import (
    batch_specs, make_prefill_step, make_serve_step, make_train_step,
    param_shapes,
)
from repro_torch.train.optimizer import AdamW
from repro_torch.train.tree import leaves, tree_map

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch"

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
# c10d_functional op (overload packet name) -> the reference's kind
_COLLECTIVE = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "isend": "collective-permute", "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "logsumexp", "_softmax", "_log_softmax",
    "cumsum", "cumprod", "norm", "linalg_vector_norm", "argmax", "argmin",
    "any", "all", "topk", "sort",
}
# ops that read or write no tensor data of their own
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "wait_tensor",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "set_", "device",
}


def collective_bytes(calls) -> dict:
    """Sum the output bytes of every collective: ``calls`` is an
    iterable of (c10d_functional op name, output bytes), as
    ``OpCounter.collectives`` records them.  Returns the reference's
    dict (``bytes`` and ``counts`` per kind, ``total_bytes``)."""
    out = dict.fromkeys(KINDS, 0)
    counts = dict.fromkeys(KINDS, 0)
    for name, nbytes in calls:
        kind = _COLLECTIVE[name]
        out[kind] += nbytes
        counts[kind] += 1
    return {"bytes": out, "counts": counts,
            "total_bytes": sum(out.values())}


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the local ops run on fake tensors of ``fake_mode``: FLOPs,
    bytes and collectives.  DTensor ops are passed on to DTensor (whose
    local ops come back here on the shards); ops on fake tensors of
    another mode (DTensor's own shape propagation) are not counted."""

    def __init__(self, fake_mode: FakeTensorMode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int]] = []
        # op whose dispatch issued each collective, in ``collectives``' order
        self.coll_ops: list[str] = []
        self.op_stack: list[str] = []
        self.by_op: dict[str, list[int]] = {}   # name: [calls, flops, bytes]
        self.paused = 0
        self.journal: list | None = None

    def begin(self) -> None:
        """Journal what is counted from now, until ``commit``/``rollback``."""
        self.journal = []

    def commit(self) -> None:
        self.journal = None

    def rollback(self) -> None:
        """Take back everything counted since ``begin``."""
        for name, flops, nbytes in self.journal:
            if name is None:
                self.collectives.pop()
                self.coll_ops.pop()
                continue
            self.flops -= flops
            self.bytes -= nbytes
            rec = self.by_op[name]
            rec[0] -= 1
            rec[1] -= flops
            rec[2] -= nbytes
        self.journal = None

    def _label(self) -> str:
        """What issued a collective: the DTensor op being dispatched, the
        ``models.partition`` region running, or the autograd node whose
        backward runs."""
        if self.op_stack:
            return self.op_stack[-1]
        region = partition.region_name()
        if region is not None:
            return f"region {region}"
        current = getattr(torch._C, "_current_autograd_node", None)
        node = current() if current is not None else None
        if node is not None:
            return f"backward {node.name()}"
        return "(between ops)"

    def _ours(self, ts) -> bool:
        for t in ts:
            if isinstance(t, FakeTensor):
                return t.fake_mode is self.fake_mode
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops.aten.equal.default:
            # DTensor compares the masks of two _MaskPartial placements
            # with torch.equal, which fake tensors cannot answer: masks
            # of one shape are taken as equal
            a, b = args
            return a.shape == b.shape and a.dtype == b.dtype
        out = func(*args, **kwargs)
        if self.paused:
            return out
        outs = list(_tensors(out if isinstance(out, (list, tuple))
                             else (out,)))
        ins = list(_tensors(args)) + list(_tensors(kwargs.values()))
        if not self._ours(outs or ins):
            return out
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "_dtensor") \
                and name in _COLLECTIVE:
            self.collectives.append((name, sum(map(_nbytes, outs))))
            self.coll_ops.append(self._label())
            if self.journal is not None:
                self.journal.append((None, 0, 0))
            return out
        if func.is_view or name in _FREE:
            return out
        packet = func._overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags:
            flops = sum(t.numel() for t in outs)
        elif name in _REDUCTIONS and ins:
            flops = ins[0].numel()
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.flops += flops
        self.bytes += nbytes
        rec = self.by_op.setdefault(name, [0, 0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        if self.journal is not None:
            self.journal.append((name, flops, nbytes))
        return out


def _map_dtensors(fn, xs):
    if isinstance(x := xs, DTensor):
        return fn(x)
    if isinstance(xs, (list, tuple)):
        return type(xs)(_map_dtensors(fn, x) for x in xs)
    if isinstance(xs, dict):
        return {k: _map_dtensors(fn, v) for k, v in xs.items()}
    return xs


def _dtensors(xs):
    if isinstance(xs, DTensor):
        yield xs
    elif isinstance(xs, (list, tuple)):
        for x in xs:
            yield from _dtensors(x)
    elif isinstance(xs, dict):
        for x in xs.values():
            yield from _dtensors(x)


class Repartition(TorchDispatchMode):
    """Runs each DTensor op as it is; where DTensor refuses it (in the
    forward or the backward pass), moves the op's DTensor inputs to
    ``Replicate`` on the fewest mesh dimensions that let it run: first
    the one the error names, then each sharded one alone (minor first),
    then all; last, replicated on every dimension and run on the local
    (whole) tensors, its outputs replicated.  The choice is cached per
    (op, inputs' shapes, placements and other arguments), and every
    forced redistribution is counted by ``counter`` (which sits below
    this mode) and tallied in ``forced``."""

    LOCAL = "local"

    def __init__(self, counter: OpCounter):
        super().__init__()
        self.counter = counter
        self.choice: dict = {}
        self.forced: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        self.counter.op_stack.append(str(func))
        try:
            return self._dispatch(func, args, kwargs)
        finally:
            self.counter.op_stack.pop()

    def _dispatch(self, func, args, kwargs):
        self.counter.begin()
        try:
            out = self._settle(func, _unstrided(func(*args, **kwargs)))
            self.counter.commit()
            return out
        except Exception as err:  # noqa: BLE001 - DTensor's refusals vary
            self.counter.rollback()
            first = err
        ds = list(_dtensors((args, kwargs)))
        key = (func, _spec_key(args), _spec_key(kwargs))
        if key not in self.choice:
            self.choice[key] = self._search(func, args, kwargs, ds, first)
        dims = self.choice[key]
        out = self._run(func, args, kwargs, dims)
        mesh = ds[0].device_mesh
        self._tally(func, "replicate", "all (local)" if dims == self.LOCAL
                    else ",".join(mesh.mesh_dim_names[i] for i in dims))
        return self._settle(func, out)

    def _tally(self, func, action: str, dims: str) -> None:
        name = str(func)
        what = f"{action} {dims}"
        rec = self.forced.setdefault(f"{name} -> {what}",
                                     {"op": name, "action": what,
                                      "count": 0})
        rec["count"] += 1

    def _settle(self, func, out):
        """A masked partial sum (what DTensor makes of a gather or an
        embedding lookup over a sharded dimension) is reduced at once,
        as GSPMD does: later views of it lose their masks in DTensor."""
        if not isinstance(out, DTensor):
            return out
        masked = [i for i, p in enumerate(out.placements)
                  if type(p).__name__ == "_MaskPartial"]
        if not masked:
            return out
        pl = [Replicate() if i in masked else p
              for i, p in enumerate(out.placements)]
        self._tally(func, "reduce", ",".join(
            out.device_mesh.mesh_dim_names[i] for i in masked))
        return out.redistribute(out.device_mesh, pl)

    def _candidates(self, ds, err):
        sharded = sorted({i for d in ds for i, p in enumerate(d.placements)
                          if not p.is_replicate()})
        out = []
        m = re.search(r"mesh dim(?:ension)?\s*(\d+)", str(err))
        if m and int(m.group(1)) in sharded:
            out.append((int(m.group(1)),))
        out += [(i,) for i in reversed(sharded) if (i,) not in out]
        if len(sharded) > 1:
            out.append(tuple(sharded))
        out.append(self.LOCAL)
        return out

    def _search(self, func, args, kwargs, ds, err):
        self.counter.paused += 1
        tried = []
        try:
            for dims in self._candidates(ds, err):
                try:
                    _unstrided(self._run(func, args, kwargs, dims))
                    return dims
                except Exception as e:  # noqa: BLE001
                    tried.append(f"{dims}: {type(e).__name__}: {e}"[:600])
        finally:
            self.counter.paused -= 1
        raise RuntimeError(f"{func} refused with every input placement "
                           f"tried: {tried}") from err

    def _run(self, func, args, kwargs, dims):
        if dims == self.LOCAL:
            mesh = next(_dtensors((args, kwargs))).device_mesh
            whole = [Replicate()] * mesh.ndim

            def local(d: DTensor):
                return d.redistribute(mesh, whole)._local_tensor

            out = func(*_map_dtensors(local, args),
                       **_map_dtensors(local, kwargs))
            if func._schema.is_mutable and isinstance(args[0], DTensor):
                return args[0]   # written on a whole copy: shapes only
            return _map_tensors(
                lambda t: t if isinstance(t, DTensor) else
                DTensor.from_local(t, mesh, whole, run_check=False), out)

        def move(d: DTensor):
            pl = [Replicate() if i in dims else p
                  for i, p in enumerate(d.placements)]
            return d.redistribute(d.device_mesh, pl)

        out = func(*_map_dtensors(move, args),
                   **_map_dtensors(move, kwargs))
        if func._schema.is_mutable and isinstance(args[0], DTensor):
            return args[0]
        return out


def _spec_key(xs):
    """A hashable stand-in for an op's arguments: DTensors by shape,
    dtype and placements, plain tensors by shape and dtype."""
    if isinstance(xs, DTensor):
        return ("D", tuple(xs.shape), xs.dtype, tuple(xs.placements))
    if isinstance(xs, torch.Tensor):
        return ("T", tuple(xs.shape), xs.dtype)
    if isinstance(xs, (list, tuple)):
        return tuple(_spec_key(x) for x in xs)
    if isinstance(xs, dict):
        return tuple((k, _spec_key(v)) for k, v in sorted(xs.items()))
    return xs if isinstance(xs, (int, float, bool, str, type(None))) \
        else repr(xs)


def _unstrided(out):
    """``out``, unless a DTensor in it is sharded with a stride (what
    DTensor makes of a view that merges a sharded dimension with the
    dimensions before it): DTensor cannot move such a shard of fake
    tensors (it reads the shard's offsets as data), so the op is refused
    and runs with its inputs replicated instead."""
    for t in _dtensors(out if isinstance(out, (list, tuple)) else (out,)):
        if any(type(p).__name__ == "_StridedShard" for p in t.placements):
            raise RuntimeError(f"strided shard {t.placements}")
    return out


def _map_tensors(fn, xs):
    if isinstance(xs, torch.Tensor):
        return fn(xs)
    if isinstance(xs, (list, tuple)):
        return type(xs)(_map_tensors(fn, x) for x in xs)
    return xs


def _place(fake_mode, t: torch.Tensor, plan: plan_mod.ShardPlan) -> DTensor:
    """A DTensor of ``t``'s global shape and dtype under ``plan``, its
    local shard a fresh fake tensor."""
    with fake_mode:
        local = torch.empty(plan.shard_shape(t.shape), dtype=t.dtype,
                            device=t.device)
    return DTensor.from_local(local, plan.mesh, plan.placements,
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())


def _local_bytes(tree) -> int:
    return sum(_nbytes(x.to_local() if isinstance(x, DTensor) else x)
               for x in leaves(tree) if isinstance(x, torch.Tensor))


def _sharded_bytes(sds_tree, plans) -> int:
    """Per-device bytes of ``sds_tree`` under ``plans`` (from the plan's
    shard shapes, as the reference's ``NamedSharding.shard_shape``);
    leaves that are not tensors (a cache's ``idx``) hold none."""
    total = 0
    for leaf, ns in zip(leaves(sds_tree), leaves(plans)):
        if isinstance(leaf, torch.Tensor):
            total += math.prod(ns.shard_shape(leaf.shape)) \
                * leaf.element_size()
    return total


@contextlib.contextmanager
def _propagation_uncounted(counter: OpCounter):
    """DTensor runs each new op once at its global shape to learn its
    output's metadata (``ShardingPropagator._propagate_tensor_meta_
    non_cached``); that run is not the device's work.  Newer torch runs
    it under the active fake mode, so ``counter`` would count it: the
    propagator's method is wrapped, for this context, to pause it."""
    sp = DTensor._op_dispatcher.sharding_propagator
    name = "_propagate_tensor_meta_non_cached"
    inner = getattr(sp, name)
    own = name in vars(sp)

    def paused(*args, **kwargs):
        counter.paused += 1
        try:
            return inner(*args, **kwargs)
        finally:
            counter.paused -= 1

    setattr(sp, name, paused)
    try:
        yield
    finally:
        if own:
            setattr(sp, name, inner)
        else:
            delattr(sp, name)


def _register_missing_rules() -> None:
    """Sharding rules some torch versions lack for ops the steps reach:
    ``detach_`` follows ``detach`` (the output keeps the input's
    placements)."""
    prop = DTensor._op_dispatcher.sharding_propagator
    aten = torch.ops.aten
    for op, like in ((aten.detach_.default, aten.detach.default),):
        if op not in prop.op_strategy_funcs and like in prop.op_strategy_funcs:
            prop.register_op_strategy(op, prop.op_strategy_funcs[like])


def lower_step(cfg, kind: str, sds: dict, plans: dict | None,
               fake_mode: FakeTensorMode) -> dict:
    """Run one step (``kind``: train | prefill | decode) of ``cfg`` on the
    shape-only trees ``sds`` (``params``, ``batch``, and ``opt`` with
    ``optimizer`` or ``cache``), placed as DTensors by ``plans``, or as
    they are if ``plans`` is None, and count it: ``flops``, ``bytes``,
    ``collectives``, ``forced`` and ``output_bytes``."""
    if plans is None:
        place = {k: sds[k] for k in ("params", "opt", "batch", "cache")
                 if k in sds}
    else:
        place = {k: tree_map(lambda t, p: _place(fake_mode, t, p), sds[k],
                             plans[k]) for k in plans if k != "cache"}
        if "cache" in plans:
            place["cache"] = {
                "slots": tree_map(lambda t, p: _place(fake_mode, t, p),
                                  sds["cache"]["slots"],
                                  plans["cache"]["slots"]),
                "idx": sds["cache"]["idx"]}
    _register_missing_rules()
    counter = OpCounter(fake_mode)
    repart = Repartition(counter)
    with fake_mode, counter, repart, implicit_replication(), \
            _propagation_uncounted(counter):
        if kind == "train":
            step = make_train_step(cfg, sds["optimizer"])
            out = step(place["params"], place["opt"], place["batch"])
        elif kind == "prefill":
            out = make_prefill_step(cfg)(place["params"], place["batch"])
        else:
            out = make_serve_step(cfg)(place["params"], place["cache"],
                                       place["batch"])
    coll = collective_bytes(counter.collectives)
    by_op: dict = {}
    for op, (_, nbytes) in zip(counter.coll_ops, counter.collectives):
        rec = by_op.setdefault(op, [0, 0])
        rec[0] += 1
        rec[1] += nbytes
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collectives": {**coll["bytes"],
                            **{f"n_{k}": v for k, v in
                               coll["counts"].items()}},
            "collectives_by_op": {
                op: {"count": n, "bytes": b} for op, (n, b) in
                sorted(by_op.items(), key=lambda kv: -kv[1][1])},
            "forced": {k: r["count"] for k, r in repart.forced.items()},
            "forced_ops": {k: {x: y for x, y in r.items() if x != "count"}
                           for k, r in repart.forced.items()},
            "output_bytes": _local_bytes(out),
            "top_ops": dict(sorted(counter.by_op.items(),
                                   key=lambda kv: -kv[1][2])[:8])}


def _with_cap1(c):
    return dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, capacity_factor=1.0))


VARIANTS = {
    "base": lambda c: c,
    "ce_softmax": lambda c: dataclasses.replace(c, ce_impl="softmax"),
    "expert_ff": lambda c: dataclasses.replace(c, expert_shard="ff"),
    "cap1": _with_cap1,
}


def _trees(cfg, shape, mesh, device, fake_mode) -> tuple[dict, dict]:
    """The shape-only trees of one cell and their plans on ``mesh``."""
    sds = {"params": param_shapes(cfg, device=device, fake_mode=fake_mode),
           "batch": batch_specs(cfg, shape, device=device,
                                fake_mode=fake_mode)}
    plans = {"params": plan_mod.param_plan(cfg, mesh, sds["params"]),
             "batch": plan_mod.batch_plan(mesh, sds["batch"])}
    if shape.kind == "train":
        opt = AdamW(state_dtype=cfg.optimizer_state_dtype)
        with fake_mode:
            sds["opt"] = opt.init(sds["params"])
        sds["optimizer"] = opt
        plans["opt"] = plan_mod.opt_plan(cfg, mesh, sds["opt"],
                                         plans["params"])
    if shape.kind == "decode":
        with fake_mode:
            sds["cache"] = init_cache(cfg, shape.global_batch,
                                      shape.seq_len, device=device)
        plans["cache"] = plan_mod.cache_plan(cfg, mesh, sds["cache"])
    return sds, plans


def dry_run(cfg, shape, mesh, device="cuda") -> dict:
    """One cell's per-device counts: ``cfg``'s step at ``shape`` (a
    ``ShapeSpec``) on ``mesh``."""
    fake_mode = FakeTensorMode()
    sds, plans = _trees(cfg, shape, mesh, device, fake_mode)
    t0 = time.time()
    counts = lower_step(cfg, shape.kind, sds, plans, fake_mode)
    counts["run_s"] = time.time() - t0
    counts["argument_bytes"] = sum(
        _sharded_bytes(sds[k], plans[k]) for k in plans)
    param_bytes_dev = _sharded_bytes(sds["params"], plans["params"])
    state_bytes_dev = param_bytes_dev
    if shape.kind == "train":
        state_bytes_dev += 2 * param_bytes_dev  # m, v (dtype-scaled below)
    counts["param_bytes_per_device"] = param_bytes_dev
    counts["state_bytes_per_device"] = state_bytes_dev
    return counts


def _result_collectives(c: dict) -> dict:
    b = {k: c[k] for k in KINDS}
    return {"bytes": b, "counts": {k: c[f"n_{k}"] for k in KINDS},
            "total_bytes": sum(b.values())}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             force: bool = False, variant: str = "base", device="cuda",
             layers: int | None = None) -> dict:
    """Run one cell and cache its JSON.  ``layers``: run the model's
    first ``layers`` layers instead of its whole depth (the cell's
    ``layers_run`` says so); the counts are then the cut model's."""
    RESULTS.mkdir(parents=True, exist_ok=True)
    suffix = "" if variant == "base" else f"__{variant}"
    out_path = RESULTS / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    t0 = time.time()
    cfg = VARIANTS[variant](get_config(arch))
    run_cfg = cfg if layers is None else dataclasses.replace(
        cfg, n_layers=layers)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device=device)
    counts = dry_run(run_cfg, shape, mesh, device=device)
    t_total = time.time() - t0

    n_par = cfg.n_params()
    n_act = n_active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6 * n_act * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2 * n_act * tokens
    else:
        tokens = shape.global_batch
        model_flops = 2 * n_act * tokens

    coll = _result_collectives(counts["collectives"])
    forced = sorted(({**counts["forced_ops"][k], "count": n}
                     for k, n in counts["forced"].items()),
                    key=lambda r: -r["count"])
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant, "device": str(device),
        "torch": torch.__version__,
        "n_chips": mesh.size(),
        "status": "ok",
        "layers": cfg.n_layers, "layers_run": run_cfg.n_layers,
        "lower_s": counts["run_s"], "compile_s": 0.0, "total_s": t_total,
        "hlo_flops": counts["flops"],
        "hlo_bytes": counts["bytes"],
        "cost_analysis": {"flops": counts["flops"],
                          "bytes accessed": counts["bytes"]},
        "memory_analysis": {
            "argument_size_bytes": counts["argument_bytes"],
            "output_size_bytes": counts["output_bytes"],
            "temp_size_bytes": None,
            "error": "no per-device temp figure: mem_tracker counts a "
                     "DTensor at its global size under fake tensors"},
        "collectives": coll,
        "forced_redistributions": forced,
        "collectives_by_op": counts["collectives_by_op"],
        "top_ops_by_bytes": counts["top_ops"],
        "param_bytes_per_device": counts["param_bytes_per_device"],
        "state_bytes_per_device": counts["state_bytes_per_device"],
        "n_params": n_par, "n_active_params": n_act,
        "model_flops": model_flops,
        "tokens": tokens,
    }
    out_path.write_text(json.dumps(result, indent=2))
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind} ({variant}): "
          f"run {counts['run_s']:.1f}s ({run_cfg.n_layers} of "
          f"{cfg.n_layers} layers), flops/device "
          f"{counts['flops']:.3e}, collectives "
          f"{coll['total_bytes']/1e9:.2f} GB, {len(forced)} forced "
          "redistributions", flush=True)
    return result


def _argv(arch, shape, mesh_kind, variant, device, layers, force):
    out = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
           "--variant", variant, "--device", str(device)]
    if layers is not None:
        out += ["--layers", str(layers)]
    return out + (["--force"] if force else [])


def run_cells(cells, *, workers: int, variant: str = "base",
              device="cuda", force: bool = False) -> dict:
    """Run ``cells`` ((arch, shape, mesh kind, layers) each) in processes
    of their own, ``workers`` at a time: the fake process group is
    process-wide, so a cell of another mesh size needs a process of its
    own anyway.  Returns {cell: (exit code, output)}; each cell's JSON
    (or ``.FAILED``) is in ``RESULTS``."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(pathlib.Path(__file__).resolve().parents[2])]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    todo, running, done = list(cells), [], {}
    while todo or running:
        while todo and len(running) < workers:
            cell = todo.pop(0)
            proc = subprocess.Popen(
                _argv(*cell[:3], variant, device, cell[3], force), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((cell, proc))
        time.sleep(0.2)
        for item in list(running):
            cell, proc = item
            if proc.poll() is not None:
                done[cell] = (proc.returncode, proc.stdout.read())
                running.remove(item)
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="base", choices=list(VARIANTS))
    ap.add_argument("--device", default="cuda",
                    help="device type of the simulated mesh (cpu: no card)")
    ap.add_argument("--layers", type=int, default=None,
                    help="run the model's first LAYERS layers (default: "
                         "the whole depth)")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells run in processes of their own, this many "
                         "at a time (default: one after another here)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in shapes_for(arch):
                for m in meshes:
                    cells.append((arch, shape, m))
    else:
        cells = [(args.arch, args.shape, m) for m in meshes]

    failures = []
    if args.workers > 1:
        t0 = time.time()
        done = run_cells([(*c, args.layers) for c in cells],
                         workers=args.workers, variant=args.variant,
                         device=args.device, force=args.force)
        for (arch, shape, m, _), (rc, log) in done.items():
            lines = [x for x in log.splitlines()
                     if x.startswith("[dryrun] ") and " x " in x]
            print(lines[0] if rc == 0 and lines else log[-3000:],
                  flush=True)
            if rc != 0:
                failures.append((arch, shape, m, f"exit {rc}"))
        print(f"[dryrun] {len(cells)} cells, {args.workers} workers: "
              f"{time.time() - t0:.1f} s")
    for arch, shape, m in cells if args.workers <= 1 else []:
        try:
            run_cell(arch, shape, m, force=args.force,
                     variant=args.variant, device=args.device,
                     layers=args.layers)
        except Exception as e:  # noqa: BLE001 - recorded, reported below
            traceback.print_exc()
            failures.append((arch, shape, m, str(e)))
            RESULTS.mkdir(parents=True, exist_ok=True)
            (RESULTS / f"{arch}__{shape}__{m}.FAILED").write_text(
                traceback.format_exc())
    print(f"\n[dryrun] {len(cells) - len(failures)}/{len(cells)} cells ok")
    for f in failures:
        print("  FAILED:", f[:3])
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
