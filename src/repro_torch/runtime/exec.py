"""Executor: run a ``CompiledProgram`` on the port's ``CKKSContext``.

The port of the JAX package's ``runtime/exec.py``.  Two entry points:

* :meth:`ProgramExecutor.run` — one ciphertext per program input.
  Hoisted steps sharing an anchor share ONE ModUp (``ctx.hoist_digits``
  once per anchor, digits fed to every block); relin steps run the
  shared ``core.ckks.tensor_product`` + the engine's ``relin`` family
  (``MultiRelinStep``: per-term d2 ModUps, one merged ModDown);
  everything is dispatched through the exact same engine entry points
  the eager path uses, which is what makes ``fusion=False``
  compilation bit-exact with eager code.

* :meth:`ProgramExecutor.run_batched` — a LIST of independent
  ciphertexts per input.  The inputs are stacked along a leading axis
  and the whole batch flows through the engine's ``*_batched`` entry
  points: each kernel launch covers every ciphertext, elementwise ops
  broadcast over the leading axis, and plaintext/evk tensors are shared
  across the batch.  A rescale of the batch is one ``poly.rescale`` call
  over both components of every ciphertext.  Results are bit-exact with
  the per-ct run.

The engine counts each new (plan, batch width) pair in
``engine.trace_counts``, as the reference counts its jit traces: a
repeated ``(program plan, width)`` pair adds nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import poly
from repro_torch.core.ckks import CKKSContext, Ciphertext, Plaintext, \
    tensor_product
from repro_torch.dfg.graph import OpKind
from repro_torch.errors import (
    InvalidRequestError, ModulusChainMismatchError, ScaleDriftError,
)
from repro_torch.runtime.compile import CompiledProgram
from repro_torch.runtime.lower import (
    EagerStep, HoistedStep, KeyswitchFamilyStep, MultiHoistedStep,
    MultiRelinStep, RelinStep,
)


@dataclasses.dataclass
class ExecResult:
    outputs: dict[str, Ciphertext | list[Ciphertext]]
    report: object | None = None

    def __getitem__(self, tag: str):
        return self.outputs[tag]


class ProgramExecutor:
    """Binds compiled programs to one ``CKKSContext``.

    Plaintext encodings are cached per (program, plaintext) so repeated
    executions reuse the engine's hoisted plaintext/evk tensor caches.
    """

    def __init__(self, ctx: CKKSContext):
        self.ctx = ctx
        self._pt_cache: dict[tuple, Plaintext] = {}
        # pins compiled programs so the id()-based cache keys can never
        # be recycled by a different program; bounded FIFO
        self._pins: dict[int, CompiledProgram] = {}
        self._pins_max = 32

    def _pin(self, compiled: CompiledProgram) -> None:
        if id(compiled) in self._pins:
            return
        while len(self._pins) >= self._pins_max:
            dead, _ = self._pins.popitem()
            self._pt_cache = {k: v for k, v in self._pt_cache.items()
                              if k[0] != dead}
        self._pins[id(compiled)] = compiled

    def _encode_spec(self, compiled: CompiledProgram, pid: int) -> Plaintext:
        """Encode a traced plaintext spec exactly as the eager path would
        (same values/level/scale floats); cached per (program, pt)."""
        key = (id(compiled), "pt", pid)
        if key not in self._pt_cache:
            spec = compiled.pt_specs[pid]
            self._pt_cache[key] = self.ctx.encode(
                spec.values, level=spec.level, scale=spec.scale)
        return self._pt_cache[key]

    # ------------------------- public API ------------------------------
    def run(self, compiled: CompiledProgram,
            inputs: dict[str, Ciphertext],
            with_report: bool = False,
            validate: bool = False) -> ExecResult:
        """``validate=True`` turns on the per-step invariant checker:
        ciphertext health (level/scale/limb range) verified at every
        keyswitch-block boundary and output.  Opt-in per request — the
        checks are torch reductions outside the engine, so its plan
        caches (and ``trace_counts``) are untouched, but on the card
        each check pays a device sync."""
        return self._run(compiled, inputs, batch=0,
                         with_report=with_report, validate=validate)

    def run_batched(self, compiled: CompiledProgram,
                    inputs: dict[str, list[Ciphertext]],
                    with_report: bool = False,
                    validate: bool = False) -> ExecResult:
        """Execute over B independent ciphertexts per input at once."""
        if not self.ctx.use_engine:
            raise NotImplementedError("batched execution needs the engine")
        batch = None
        stacked = {}
        for tag, cts in inputs.items():
            if len({(c.level, c.scale) for c in cts}) != 1:
                raise ModulusChainMismatchError(
                    f"batched inputs for '{tag}' mix levels/scales",
                    hint="a batch must be homogeneous; split mixed-"
                         "level requests into separate dispatches",
                    tag=tag,
                    levels=sorted({c.level for c in cts}),
                    scales=sorted({c.scale for c in cts}))
            batch = len(cts) if batch is None else batch
            if len(cts) != batch:
                raise InvalidRequestError(
                    f"input '{tag}' has {len(cts)} ciphertexts but the "
                    f"batch width is {batch}",
                    hint="every input tag must carry one ciphertext "
                         "per batch slot",
                    tag=tag)
            stacked[tag] = Ciphertext(
                torch.stack([c.c0 for c in cts]),
                torch.stack([c.c1 for c in cts]),
                cts[0].level, cts[0].scale,
            )
        res = self._run(compiled, stacked, batch=batch,
                        with_report=with_report, validate=validate)
        outputs = {
            tag: [Ciphertext(ct.c0[b], ct.c1[b], ct.level, ct.scale)
                  for b in range(batch)]
            for tag, ct in res.outputs.items()
        }
        return ExecResult(outputs, res.report)

    # ------------------------- execution loop --------------------------
    def _run(self, compiled: CompiledProgram, inputs, batch: int,
             with_report: bool, validate: bool = False) -> ExecResult:
        ctx = self.ctx
        self._pin(compiled)
        missing = [t for t in compiled.inputs if t not in inputs]
        if missing:
            raise InvalidRequestError(
                "request is missing program input tags",
                hint="supply one ciphertext (list) per traced input",
                missing=missing, expected=sorted(compiled.inputs))
        before = ctx.counters.snapshot()
        values: dict[int, Ciphertext] = {}
        digits: dict[int, object] = {}
        outputs: dict[str, Ciphertext] = {}
        # Prefetch the enabled flag once: the disabled hot path is one
        # boolean per step (plus the no-op run span below).
        tracing = obs.TRACER.enabled
        with obs.span("exec.run", batch=batch,
                      n_steps=len(compiled.steps), validate=validate):
            for step in compiled.steps:
                if tracing:
                    self._exec_step_traced(compiled, step, values, digits,
                                           outputs, inputs, batch, validate)
                else:
                    self._exec_step(compiled, step, values, digits,
                                    outputs, inputs, batch, validate)
                if validate and isinstance(step, KeyswitchFamilyStep):
                    try:
                        self._check_block(step, values[step.out])
                    except Exception as err:
                        self._note_validate_failure(compiled, step, err)
                        raise
            if validate:
                for tag, ct in outputs.items():
                    ctx.check_ciphertext(ct, where=f"output '{tag}'")
        report = None
        if with_report:
            from repro_torch.runtime.report import build_report

            report = build_report(
                compiled, ctx, ctx.counters.delta(before),
                batch=max(batch, 1),
            )
        return ExecResult(outputs, report)

    # ------------------------- step dispatch ---------------------------
    def _exec_step(self, compiled, step, values, digits, outputs, inputs,
                   batch: int, validate: bool) -> None:
        if isinstance(step, HoistedStep):
            self._exec_hoisted(compiled, step, values, digits, batch)
        elif isinstance(step, MultiHoistedStep):
            self._exec_multi(compiled, step, values, digits, batch)
        elif isinstance(step, RelinStep):
            self._exec_relin(compiled, step, values, batch)
        elif isinstance(step, MultiRelinStep):
            self._exec_multi_relin(compiled, step, values, batch)
        else:
            self._exec_eager(compiled, step, values, outputs, inputs,
                             batch, validate)

    def _step_label(self, compiled, step) -> tuple[str, int]:
        if isinstance(step, KeyswitchFamilyStep):
            return type(step).__name__, step.out
        return compiled.dfg.nodes[step.nid].op.value, step.nid

    def _exec_step_traced(self, compiled, step, values, digits, outputs,
                          inputs, batch: int, validate: bool) -> None:
        """Tracing mirror of ``_exec_step``: one span per step carrying
        the real wall clock (a device synchronize after the step on the
        card, which is why this path is opt-in) and the op counts the
        step actually incremented.  The dispatched code is identical, so
        the engine's plan counts see the same keys."""
        ctx = self.ctx
        label, out_id = self._step_label(compiled, step)
        before = ctx.counters.snapshot()
        eng = ctx.engine if ctx.use_engine else None
        with obs.span(f"exec.step.{label}", out=out_id, batch=batch,
                      level=getattr(step, "level", None),
                      backend=eng.backend if eng else "none",
                      interpret=False) as sp:
            self._exec_step(compiled, step, values, digits, outputs,
                            inputs, batch, validate)
            out = values.get(out_id)
            if out is not None and out.c0.is_cuda:
                torch.cuda.synchronize(out.c0.device)
            d = ctx.counters.delta(before)
            sp.set_attrs(modup=d.modup, moddown=d.moddown, ip=d.ip,
                         keyswitch=d.keyswitch, relin=d.relin)

    def _note_validate_failure(self, compiled, step, err) -> None:
        """Chaos-run traces show WHERE a poisoned ciphertext was caught:
        attach the failing block's dfg.hoist step volumes to the trace
        before the typed error propagates."""
        if not obs.TRACER.enabled:
            return
        from repro_torch.runtime.report import step_volumes

        v = step_volumes(compiled, step)
        vols = {}
        if v is not None:
            vols = {f: getattr(v, f, 0) for f in
                    ("modup_count", "moddown_count", "ip_count",
                     "keyswitch_count", "relin_count", "evk_set_words",
                     "comm_up_words", "comm_down_words")}
        obs.event("exec.validate_failure",
                  step=type(step).__name__, out=step.out,
                  level=step.level, error=type(err).__name__,
                  detail=str(err), **vols)

    # ------------------------- hoisted steps ---------------------------
    def _exec_hoisted(self, compiled, step: HoistedStep, values, digits,
                      batch: int) -> None:
        ctx = self.ctx
        ct = values[step.anchor]
        lvl = ct.level
        assert lvl == step.level, "anchor level drifted from the trace"
        pts = None
        if step.pt_terms is not None:
            pts = [self._step_pt(compiled, step, s) for s in step.steps]
        dig = None
        if ctx.use_engine and any(s != 0 for s in step.steps):
            dig = digits.get(step.anchor)
            if dig is None:
                dig = (ctx.engine.modup_batched(ct.c1, lvl) if batch
                       else ctx.hoist_digits(ct))
                digits[step.anchor] = dig
        if batch:
            out = self._hoisted_batched(ct, step, pts, dig)
        else:
            out = ctx.hoisted_rotation_sum(ct, step.steps, pts,
                                           rescale=False, digits=dig)
        self._finish(compiled, step.out, out, values)

    def _hoisted_batched(self, ct, step: HoistedStep, pts, dig):
        """Batched mirror of ``CKKSContext.hoisted_rotation_sum`` —
        including its step-0 split (identity terms are plain EWOs, never
        keyswitches)."""
        ctx = self.ctx
        lvl = ct.level
        nz = [i for i, s in enumerate(step.steps) if s != 0]
        out = None
        if nz:
            nz_steps = [step.steps[i] for i in nz]
            nz_pts = [pts[i] for i in nz] if pts is not None else None
            gs = [ctx.pc.rns.galois_for_rotation(s) for s in nz_steps]
            keys = [ctx.keys.rot_key(s) for s in nz_steps]
            pm_ext = pm_base = None
            if nz_pts is not None:
                pm_ext, pm_base = ctx._pm_stack(tuple(nz_pts), lvl)
            c0, c1 = ctx.engine.hoisted_rotation_sum_batched(
                ct.c0, ct.c1, gs, keys, lvl, pm_ext, pm_base, digits=dig,
            )
            scale = ct.scale * (nz_pts[0].scale if nz_pts is not None
                                else 1.0)
            out = Ciphertext(c0, c1, lvl, scale)
        return ctx.add_zero_step_terms(out, ct, step.steps, pts)

    def _exec_multi(self, compiled, step: MultiHoistedStep, values,
                    digits, batch: int) -> None:
        """Multi-anchor accumulation: one ModUp per (uncached) anchor,
        per-term IPs summed in the extended basis, ONE ModDown."""
        ctx = self.ctx
        if not ctx.use_engine:
            raise NotImplementedError(
                "exact=False multi-anchor steps require the engine path")
        lvl = step.level
        c0s, digs, gs, keys = [], [], [], []
        for anchor, s in step.rot_terms:
            ct = values[anchor]
            assert ct.level == lvl, "anchor level drifted from the trace"
            dig = digits.get(anchor)
            if dig is None:
                dig = (ctx.engine.modup_batched(ct.c1, lvl) if batch
                       else ctx.hoist_digits(ct))
                digits[anchor] = dig
            c0s.append(ct.c0)
            digs.append(dig)
            gs.append(ctx.pc.rns.galois_for_rotation(s))
            keys.append(ctx.keys.rot_key(s))
        if batch:
            c0, c1 = ctx.engine.multi_hoisted_rotation_sum_batched(
                c0s, digs, gs, keys, lvl)
        else:
            c0, c1 = ctx.engine.multi_hoisted_rotation_sum(
                c0s, digs, gs, keys, lvl)
        out = Ciphertext(c0, c1, lvl, values[step.rot_terms[0][0]].scale)
        for anchor in step.passthrough:
            out = ctx.add(out, values[anchor])
        self._finish(compiled, step.out, out, values)

    # ------------------------- relin steps -----------------------------
    def _exec_relin(self, compiled, step: RelinStep, values,
                    batch: int) -> None:
        """One CMULT through the keyswitch family: shared tensor product
        + engine relin (ModUp -> IP -> ModDown -> folds, one plan).
        Bit-exact with eager ``CKKSContext.multiply(rescale=False)``."""
        ctx = self.ctx
        a, b = values[step.args[0]], values[step.args[1]]
        lvl = step.level
        assert a.level == lvl and b.level == lvl, \
            "relin operand level drifted from the trace"
        if not ctx.use_engine:
            out = ctx.multiply(a, b, rescale=False)
        else:
            mods = ctx.pc.mods(ctx.chain(lvl))
            d0, d1, d2 = tensor_product(a, b, mods)
            key = ctx.keys.mult_key
            if batch:
                c0, c1 = ctx.engine.relin_batched(d0, d1, d2, key, lvl)
            else:
                c0, c1 = ctx.engine.relin(d0, d1, d2, key, lvl)
            out = Ciphertext(c0, c1, lvl, a.scale * b.scale)
        self._finish(compiled, step.out, out, values)

    def _exec_multi_relin(self, compiled, step: MultiRelinStep, values,
                          batch: int) -> None:
        """Sum-of-CMult closure: per-term d2 ModUp (the engine's shared
        ``modup`` entry point, same digits interface as the rotations),
        all relin IPs accumulated in the extended basis, ONE ModDown."""
        ctx = self.ctx
        if not ctx.use_engine:
            raise NotImplementedError(
                "exact=False multi-relin steps require the engine path")
        lvl = step.level
        mods = ctx.pc.mods(ctx.chain(lvl))
        d0s, d1s, digs = [], [], []
        scale = None
        for _nid, (an, bn) in step.cmults:
            a, b = values[an], values[bn]
            assert a.level == lvl and b.level == lvl, \
                "relin operand level drifted from the trace"
            d0, d1, d2 = tensor_product(a, b, mods)
            d0s.append(d0)
            d1s.append(d1)
            digs.append(ctx.engine.modup_batched(d2, lvl) if batch
                        else ctx.engine.modup(d2, lvl))
            scale = a.scale * b.scale if scale is None else scale
        key = ctx.keys.mult_key
        if batch:
            c0, c1 = ctx.engine.multi_relin_sum_batched(
                d0s, d1s, digs, key, lvl)
        else:
            c0, c1 = ctx.engine.multi_relin_sum(d0s, d1s, digs, key, lvl)
        out = Ciphertext(c0, c1, lvl, scale)
        for nid in step.passthrough:
            out = ctx.add(out, values[nid])
        self._finish(compiled, step.out, out, values)

    def _step_pt(self, compiled, step: HoistedStep, s: int) -> Plaintext:
        """The (possibly fused) plaintext multiplying Rot_s(anchor)."""
        terms = step.pt_terms[s]
        specs = compiled.pt_specs
        (c0, fs0) = terms[0]
        if len(terms) == 1 and c0 == 1.0 and len(fs0) == 1 \
                and fs0[0][1] == 0:
            # exact single-plaintext term: encode precisely as traced
            return self._encode_spec(compiled, fs0[0][0])
        key = (id(compiled), "fused", step.out, s)
        if key not in self._pt_cache:
            val = None
            for c, fs in terms:
                term = np.asarray(c, dtype=complex)
                for pid, r in fs:
                    term = term * np.roll(specs[pid].values, -r)
                val = term if val is None else val + term
            self._pt_cache[key] = self.ctx.encode(
                val, level=step.level, scale=step.pt_scale)
        return self._pt_cache[key]

    # ------------------------- invariant checker -----------------------
    def _check_block(self, step, ct: Ciphertext) -> None:
        """Block-boundary invariants (opt-in): the ciphertext leaving a
        keyswitch-family step is healthy and still on the traced level.
        Raises typed ``CiphertextError``s."""
        where = f"{type(step).__name__}(out={step.out})"
        if ct.level != step.level:
            raise ModulusChainMismatchError(
                f"level drifted off the trace at {where}",
                hint="the executed program diverged from its trace — "
                     "recompile the program for this context",
                level=ct.level, traced=step.level)
        self.ctx.check_ciphertext(ct, where=where)

    # ------------------------- eager steps -----------------------------
    def _node_pt(self, compiled, node) -> Plaintext:
        return self._encode_spec(compiled, node.attrs["pt"])

    def _exec_eager(self, compiled, step: EagerStep, values, outputs,
                    inputs, batch: int, validate: bool = False) -> None:
        ctx = self.ctx
        node = compiled.dfg.nodes[step.nid]
        op = node.op
        a = values[node.args[0]] if node.args else None
        if op == OpKind.INPUT:
            tag = node.attrs["tag"]
            ct = inputs[tag]
            # user-input validation: typed (asserts vanish under -O)
            if ct.level != node.attrs["level"]:
                raise ModulusChainMismatchError(
                    f"input '{tag}' level disagrees with the trace",
                    hint="encrypt the input at the program's traced "
                         "level (or recompile for this level)",
                    tag=tag, level=ct.level,
                    traced=node.attrs["level"])
            traced_scale = node.attrs["scale"]
            if not abs(ct.scale / traced_scale - 1.0) < 1e-9:
                raise ScaleDriftError(
                    f"input '{tag}' scale disagrees with the trace",
                    hint="encrypt the input at the program's traced "
                         "scale",
                    tag=tag, scale=ct.scale, traced=traced_scale)
            if validate:
                ctx.check_ciphertext(ct, where=f"input '{tag}'")
            values[step.nid] = ct
            return
        if op == OpKind.OUTPUT:
            outputs[node.attrs["tag"]] = a
            return
        if op == OpKind.ROT:
            out = self._rotate(a, node.attrs["steps"], batch)
        elif op == OpKind.CONJ:
            out = self._conjugate(a, batch)
        elif op == OpKind.CADD:
            out = ctx.add(a, values[node.args[1]])
        elif op == OpKind.CSUB:
            out = ctx.sub(a, values[node.args[1]])
        elif op == OpKind.CSCALE:
            out = ctx.double(a)
        elif op == OpKind.PMUL:
            out = ctx.pt_mul(a, self._node_pt(compiled, node),
                             rescale=False)
        elif op == OpKind.PADD:
            out = ctx.pt_add(a, self._node_pt(compiled, node))
        elif op == OpKind.RESCALE:
            out = self._rescale(a, batch)
        elif op == OpKind.MOD_RAISE:
            out = self._mod_raise(a, batch)
        elif op == OpKind.LEVEL_DOWN:
            n = node.attrs["target"] + 1
            out = Ciphertext(a.c0[..., :n, :], a.c1[..., :n, :],
                             node.attrs["target"], a.scale)
        else:
            raise NotImplementedError(f"cannot execute {op.value}")
        self._finish(compiled, step.nid, out, values)

    def _finish(self, compiled, nid: int, out: Ciphertext, values) -> None:
        """Replay the trace-time scale float (identical arithmetic to the
        eager path; for fused blocks it pins the unfused trajectory)."""
        scale = compiled.dfg.nodes[nid].attrs.get("scale")
        if scale is not None:
            out.scale = scale
        values[nid] = out

    # ----- batched op mirrors (engine *_batched + broadcasting EWOs) ---
    def _rotate(self, ct, steps: int, batch: int) -> Ciphertext:
        ctx = self.ctx
        if not batch:
            return ctx.rotate(ct, steps)
        g = ctx.pc.rns.galois_for_rotation(steps)
        c0, c1 = ctx.engine.apply_galois_batched(
            ct.c0, ct.c1, g, ctx.keys.rot_key(steps), ct.level)
        return Ciphertext(c0, c1, ct.level, ct.scale)

    def _conjugate(self, ct, batch: int) -> Ciphertext:
        ctx = self.ctx
        if not batch:
            return ctx.conjugate(ct)
        g = ctx.pc.rns.galois_conjugate()
        c0, c1 = ctx.engine.apply_galois_batched(
            ct.c0, ct.c1, g, ctx.keys.conj_key, ct.level)
        return Ciphertext(c0, c1, ct.level, ct.scale)

    def _mod_raise(self, ct, batch: int) -> Ciphertext:
        """Bootstrap boundary (centered-CRT lift on the host) — executed
        per ciphertext even under batching."""
        ctx = self.ctx
        if not batch:
            return ctx.mod_raise(ct)
        outs = [ctx.mod_raise(Ciphertext(ct.c0[b], ct.c1[b], ct.level,
                                         ct.scale))
                for b in range(int(ct.c0.shape[0]))]
        return Ciphertext(torch.stack([o.c0 for o in outs]),
                          torch.stack([o.c1 for o in outs]),
                          outs[0].level, ct.scale)

    def _rescale(self, ct, batch: int) -> Ciphertext:
        """A batch's rescale is one ``poly.rescale`` over both components
        of every ciphertext: one INTT, one BConv and one NTT launch."""
        ctx = self.ctx
        if not batch:
            return ctx.rescale(ct)
        lvl = ct.level
        out = poly.rescale(torch.stack([ct.c0, ct.c1]), lvl, ctx.pc)
        q_last = ctx.chain(lvl)[-1]
        return Ciphertext(out[0], out[1], lvl - 1, ct.scale / q_last)
