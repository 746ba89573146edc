"""Checkpoints with atomic commit and async writes, on torch tensors.

Counterpart of the JAX package's ``train/checkpoint.py``, with its
layout byte for byte, so that a checkpoint written by either package
restores in the other:

    <dir>/step_<N>/shard_0.npz + MANIFEST.json, the manifest written
    LAST: a directory without one is incomplete and ignored on restore.
    A step is written under ``.tmp_step_<N>`` and renamed (atomic
    commit).  Keys are ``_flatten``'s paths with ``/`` escaped to ``|``;
    a bf16 leaf is saved as a ``uint16`` view and named ``"bfloat16"``
    in the manifest's ``dtypes``.

``save`` copies every tensor to host numpy before its writer thread
starts, so the caller may update its tensors in place at once.
``restore`` reads bf16 back through ``torch.int16`` -> ``torch.bfloat16``
and places every leaf on ``device``; with ``shardings`` (a tree of
``launch.plan.ShardPlan``, as ``param_plan`` / ``opt_plan`` give them)
it places each leaf it names as a DTensor on that plan's mesh: the
reference's elastic re-shard, onto a mesh that may differ from the one
that saved the checkpoint.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.core.poly import resolve_device


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}

    def insert(container, parts, value):
        head = parts[0]
        is_list = head.startswith("#")
        key = int(head[1:]) if is_list else head
        if len(parts) == 1:
            if is_list:
                while len(container) <= key:
                    container.append(None)
                container[key] = value
            else:
                container[key] = value
            return
        nxt_is_list = parts[1].startswith("#")
        if is_list:
            while len(container) <= key:
                container.append(None)
            if container[key] is None:
                container[key] = [] if nxt_is_list else {}
            insert(container[key], parts[1:], value)
        else:
            if key not in container:
                container[key] = [] if nxt_is_list else {}
            insert(container[key], parts[1:], value)

    for path, v in flat.items():
        parts = []
        for seg in path.strip("/").split("/"):
            while "#" in seg:
                pre, _, rest = seg.partition("#")
                if pre:
                    parts.append(pre)
                seg = "#" + rest
                idx = ""
                i = 1
                while i < len(seg) and seg[i].isdigit():
                    idx += seg[i]
                    i += 1
                parts.append("#" + idx)
                seg = seg[i:]
            if seg:
                parts.append(seg)
        insert(root, parts, v)
    return root


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None

    # ------------------------------ save ------------------------------
    def save(self, step: int, state: dict, block: bool = False):
        """state: a pytree of tensors, numpy arrays or numbers."""
        self.wait()   # never two writers at once (same-step collision)
        flat = _flatten(state)
        host, dtypes = {}, {}
        for k, v in flat.items():
            host[k], dtypes[k] = _host(v)

        def _write():
            tmp = self.dir / f".tmp_step_{step}"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "shard_0.npz",
                     **{k.replace("/", "|"): v for k, v in host.items()})
            (tmp / "MANIFEST.json").write_text(json.dumps({
                "step": step, "time": time.time(),
                "keys": sorted(host.keys()), "n_shards": 1,
                "dtypes": dtypes,
            }))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)            # atomic commit
            self._gc()

        if self.async_write and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ----------------------------- restore ----------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "MANIFEST.json").exists():   # complete checkpoints only
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int | None = None, device="cuda",
                shardings=None):
        """Returns (step, state), every leaf a tensor on ``device`` in
        its saved dtype (a scalar as a 0-d tensor); (None, None) when
        there is no complete checkpoint.  A leaf that ``shardings``
        names is a DTensor placed by its plan, on the plan's mesh's
        device type; every rank reads the whole array and keeps its own
        shard, so placing it moves no data between ranks."""
        if shardings is not None:
            device = next(iter(_flatten(shardings).values())) \
                .mesh.device_type
        device = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        dtypes = manifest.get("dtypes", {})
        flat = {}
        with np.load(d / "shard_0.npz") as data:
            for k in data.files:
                key = k.replace("|", "/")
                flat[key] = _tensor(data[k], dtypes.get(key), device)
        if shardings is not None:
            plans = _flatten(shardings)
            flat = {k: distribute_tensor(v, plans[k].mesh,
                                         plans[k].placements,
                                         src_data_rank=None)
                    if k in plans else v for k, v in flat.items()}
        return step, _unflatten(flat)


def _host(v) -> tuple[np.ndarray, str]:
    """A host copy of ``v`` (a tensor, array or number), never a view of
    a tensor that the caller may update in place, and its dtype's name;
    a bf16 tensor as its uint16 bits (npz cannot round-trip bf16)."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        bf16 = t.dtype == torch.bfloat16
        a = np.array((t.view(torch.int16) if bf16 else t).cpu().numpy(),
                     copy=True)
        return (a.view(np.uint16), "bfloat16") if bf16 else (a, str(a.dtype))
    a = np.array(v, copy=True)
    return a, str(a.dtype)


def _tensor(a: np.ndarray, dtype: str | None, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)
