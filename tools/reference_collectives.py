"""List every collective of the JAX package's compiled dry-run step on the
small 8-device mesh, tuple-shaped ones included.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_collectives.py \\
        phi3_medium_14b '{"n_kv_heads": 4}' train

Arguments: an architecture, JSON overrides of its REDUCED config (cut to
one layer here, as ``tests/test_torch_dryrun_vs_reference.py`` cuts it),
and ``train`` (batch 8 x 32) or ``decode`` (batch 8, a 64-token cache);
an ``n_layers`` among the overrides replaces the cut.
Prints one line a collective of the compiled HLO (kind, output bytes,
shape, replica groups, the op it came from), then the totals three ways:

- ``collective_bytes``: ``repro.launch.dryrun.collective_bytes`` of the
  compiled HLO, what the reference's dry run reports (it skips the
  tuple-shaped collectives that XLA's combiners make);
- ``every_collective``: every collective of the compiled HLO;
- ``plan``: every collective of the HLO right after SPMD partitioning,
  GSPMD's own plan in the step's dtypes, each collective of a ``while``
  body (a ``lax.scan``: the sLSTM's) times the loop's trip count, read
  from its condition.  XLA's CPU backend then moves
  16-bit collectives as float32 (its ``all-reduce-promotion`` and
  ``float-normalization-bf16`` passes), which a GPU backend does not,
  so the compiled HLO's bf16 collectives count twice their bytes.

A reference-side tool: it imports JAX.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402
import glob  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import tempfile  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config  # noqa: E402
from repro.launch import plan as plan_mod  # noqa: E402
from repro.launch.dryrun import _DTYPE_BYTES, collective_bytes  # noqa: E402
from repro.launch.mesh import make_small_mesh  # noqa: E402
from repro.models.model import init_cache, init_params  # noqa: E402
from repro.models.steps import make_serve_step, make_train_step  # noqa: E402
from repro.train.optimizer import AdamW  # noqa: E402

_ANY = re.compile(
    r"=\s*(\([^=]*?\)|\w+\[[\d,]*\]\S*)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")


def compiled_step(arch: str, over: dict, kind: str,
                  dump_to: str | None = None):
    """The reference's step, compiled on the small mesh; ``dump_to``
    receives the HLO right after SPMD partitioning (``plan_bytes``)."""
    opts = None if dump_to is None else {
        "xla_dump_to": dump_to, "xla_dump_hlo_pass_re": "spmd-partitioning"}
    mesh = make_small_mesh(8)
    cfg = dataclasses.replace(reduced_config(arch), **{"n_layers": 1, **over})
    params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    p_plan = plan_mod.param_plan(cfg, mesh, params)
    with mesh:
        if kind == "train":
            opt = AdamW(state_dtype=cfg.optimizer_state_dtype)
            opt_sds = jax.eval_shape(opt.init, params)
            batch = {"tokens": jax.ShapeDtypeStruct((8, 32), jnp.int32),
                     "labels": jax.ShapeDtypeStruct((8, 32), jnp.int32)}
            o_plan = plan_mod.opt_plan(cfg, mesh, opt_sds, p_plan)
            b_plan = plan_mod.batch_plan(mesh, batch)
            return jax.jit(make_train_step(cfg, opt),
                           in_shardings=(p_plan, o_plan, b_plan),
                           out_shardings=(p_plan, o_plan, None)).lower(
                params, opt_sds, batch).compile(compiler_options=opts)
        cache = jax.eval_shape(lambda: init_cache(cfg, 8, 64))
        c_plan = plan_mod.cache_plan(cfg, mesh, cache)
        dec = {"tokens": jax.ShapeDtypeStruct((8, 1), jnp.int32)}
        d_plan = plan_mod.batch_plan(mesh, dec)
        return jax.jit(make_serve_step(cfg),
                       in_shardings=(p_plan, c_plan, d_plan),
                       out_shardings=(None, c_plan)).lower(
            params, cache, dec).compile(compiler_options=opts)


def collectives(text: str):
    """(kind, output bytes, output shape, the HLO line) of every
    collective of HLO ``text``, tuple-shaped ones included."""
    out = []
    for line in text.splitlines():
        m = _ANY.search(line)
        if not m:
            continue
        nbytes = 0
        for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", m.group(1)):
            b = _DTYPE_BYTES.get(dt, 4)
            for d in dims.split(","):
                if d:
                    b *= int(d)
            nbytes += b
        out.append((m.group(2), nbytes, m.group(1), line))
    return out


def computations(text: str) -> dict[str, list[str]]:
    """The lines of each computation of HLO ``text``, by name."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"^(?:ENTRY\s+)?%([\w.\-]+)\s*\(.*\{\s*$", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def trip_count(cond: list[str]) -> int:
    """Iterations of a ``while`` whose condition computation is ``cond``:
    its ROOT compares the counter (from 0) LT a constant, as the loops of
    ``lax.scan`` do."""
    consts = dict(re.findall(r"%([\w.\-]+) = s32\[\] constant\((\d+)\)",
                             "\n".join(cond)))
    for line in cond:
        m = re.search(r"ROOT .*compare\(%[\w.\-]+, %([\w.\-]+)\), "
                      r"direction=LT", line)
        if m and m.group(1) in consts:
            return int(consts[m.group(1)])
    raise ValueError("no trip count in a while condition")


def loop_multipliers(text: str) -> dict[str, int]:
    """How often each computation runs in one step: 1, or for a while
    body its loop's trip count times its caller's multiplier."""
    comps = computations(text)
    mult = {name: 1 for name in comps}
    loops = []
    for name, lines in comps.items():
        for line in lines:
            m = re.search(r" while\(.*condition=%([\w.\-]+), "
                          r"body=%([\w.\-]+)", line)
            if m:
                loops.append((name, m.group(2), trip_count(comps[m.group(1)])))
    for _ in loops:  # nested loops settle within len(loops) passes
        for caller, body, trips in loops:
            mult[body] = trips * mult[caller]
    return mult


def scaled_collectives(text: str):
    """(kind, output bytes, computation, times it runs a step) of every
    collective of HLO ``text``: a collective inside a ``while`` body
    (``lax.scan``: the sLSTM's scan over the tokens) appears once in the
    text and runs once an iteration."""
    mult = loop_multipliers(text)
    return [(kind, nbytes, name, mult[name])
            for name, lines in computations(text).items()
            for kind, nbytes, _, _ in collectives("\n".join(lines))]


def plan_bytes(dump_to: str) -> int:
    """Output bytes of every collective GSPMD placed, a collective in a
    loop's body counted once an iteration: the HLO that
    ``compiled_step(..., dump_to)`` wrote right after SPMD partitioning."""
    path, = glob.glob(f"{dump_to}/*after_spmd-partitioning*")
    with open(path) as f:
        return sum(n * k for _, n, _, k in scaled_collectives(f.read()))


def main() -> None:
    arch, over, kind = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
    with tempfile.TemporaryDirectory() as tmp:
        text = compiled_step(arch, over, kind, dump_to=tmp).as_text()
        plan = plan_bytes(tmp)
    every = collectives(text)
    for kind_, nbytes, shape, line in every:
        groups = re.search(r"replica_groups=(\S+?),", line)
        op = re.search(r'op_name="([^"]*)"', line)
        print(kind_, nbytes, shape[:60],
              groups.group(1) if groups else "",
              op.group(1)[-60:] if op else "")
    print(json.dumps({"collective_bytes": collective_bytes(text)[
        "total_bytes"], "every_collective": sum(c[1] for c in every),
        "plan": plan}))


if __name__ == "__main__":
    main()
