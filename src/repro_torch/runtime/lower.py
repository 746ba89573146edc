"""Lowering: traced DFG + fusion plan -> executable hoisted/eager steps.

Each PKB (or fused PKB group) is *lifted*: the expression under each of
its sinks is rewritten, by the identities the paper's HERO framework is
built on, into a canonical linear combination

    sink = sum_t  coeff_t * [ prod_f roll(pt_f, -r_f) ] * Rot_{s_t}(anchor)

using Rot_a(Rot_b(x)) = Rot_{a+b}(x) and Rot_s(pt * x) =
roll(pt, -s) * Rot_s(x) (Eq. (4) of the paper).  A lifted sink lowers to
ONE ``hoisted_rotation_sum`` engine invocation; sinks sharing an anchor
ciphertext share one ModUp (cross-block double hoisting).  Anything that
does not lift — PAdds inside a region, for instance — falls back to
eager per-op execution, which keeps the compiled path bit-exact with
the eager one by construction.  Multi-anchor PKBs (the giant-step
blocks of BSGS, whose rotations consume different ciphertexts) stay
eager under ``exact=True``; with ``exact=False`` they lower to
``MultiHoistedStep``s that accumulate every rotation's IP in the
extended basis and close the sum with ONE ModDown.

Relinearization is lowered through the same keyswitch-family hierarchy
(see ``KeyswitchFamilyStep``): every CMULT node becomes a ``RelinStep``
on the engine's ``relin`` entry point (bit-exact with eager
``CKKSContext.multiply``), and with ``exact=False`` the sum-of-CMult
closures of the BSGS Chebyshev evaluation (CAdd trees over >= 2
same-level CMULTs, ``polyeval.eval_chebyshev_bsgs``'s giant-step
product sums) merge into ``MultiRelinStep``s — all relin IPs of the
closure accumulate in the extended basis and ONE ModDown closes the
block, the relin analogue of the multi-anchor rotation lowering.

With ``fusion=True`` the lift is allowed to recurse across the members
of an ``optimal_fusion`` group, composing serial PKBs into one block
(strictly fewer ModUps/ModDowns, numerically equivalent).  Without it
the lift stops at direct rotations of the anchor, which preserves
bit-exactness.
"""
from __future__ import annotations

import dataclasses

from repro_torch import obs
from repro_torch.dfg.fusion import optimal_fusion
from repro_torch.dfg.graph import OpKind
from repro_torch.dfg.pkb import PKB, identify_pkbs
from repro_torch.runtime.compile import CompiledProgram, TraceContext

# A term key: (rotation step, sorted ((pt id, roll), ...) factor tuple).
Term = tuple[int, tuple[tuple[int, int], ...]]


class Unliftable(Exception):
    """Raised when a sink expression has no hoisted-rotation-sum form."""


class KeyswitchFamilyStep:
    """Base of every step dispatched on the keyswitch engine.

    The keyswitch family has two flavors sharing the ModUp -> IP ->
    ModDown datapath: *rotation* (``HoistedStep``/``MultiHoistedStep``,
    per-step galois keys, digits rotated in the eval domain) and
    *relinearization* (``RelinStep``/``MultiRelinStep``, the d2
    tensor-product component against the one program-wide mult key).
    The ``Multi*`` variants of both accumulate several terms' IPs in the
    extended basis and close them with ONE ModDown (``exact=False``
    lowering only — the merged approximate-FBC rounding differs from
    the per-term trajectory).  All subclasses carry ``out`` (the DFG
    node the step produces) and ``level``.
    """

    family = "keyswitch"
    out: int
    level: int


@dataclasses.dataclass
class HoistedStep(KeyswitchFamilyStep):
    """One hoisted-rotation-sum invocation producing node ``out``."""

    family = "rotation"

    out: int
    anchor: int
    level: int
    steps: list[int]                        # sorted distinct steps
    # step -> [(coeff, factors)], or None for a pure rotation sum
    pt_terms: dict[int, list[tuple[float, tuple]]] | None
    pt_scale: float = 1.0                   # combined plaintext scale
    exact: bool = True                      # single-factor, unrotated pts
    fused_members: int = 1
    fresh_modup: bool = True                # False -> digits shared

    @property
    def n_rot(self) -> int:
        return len(self.steps)


@dataclasses.dataclass
class MultiHoistedStep(KeyswitchFamilyStep):
    """One multi-anchor accumulation closed by a SINGLE ModDown.

    ``sink = sum_i Rot_{s_i}(anchor_i) [+ sum_j passthrough_j]`` where
    the rotations consume DIFFERENT anchor ciphertexts (the giant-step
    phase of BSGS).  Each anchor still needs its own ModUp (shared with
    any sibling hoisted block via the program-wide digits cache), but
    the per-rotation IP results accumulate in the extended basis and
    ONE ModDown closes the whole sum — versus one ModDown per rotation
    on the eager path.  Trades bit-exactness for the ModDown saving
    (``exact=False`` lowering only): the approximate-FBC rounding of the
    merged ModDowns differs from the per-rotation trajectory.
    """

    out: int
    level: int
    rot_terms: list[tuple[int, int]]        # (anchor nid, step != 0)
    passthrough: list[int]                  # anchors added unrotated
    # anchors whose ModUp this step performs (not already cached when
    # the step runs); filled in program order by ``lower_program``
    fresh_anchors: list[int] = dataclasses.field(default_factory=list)

    family = "rotation"

    @property
    def n_rot(self) -> int:
        return len(self.rot_terms)

    @property
    def steps(self) -> list[int]:
        return [s for _, s in self.rot_terms]


@dataclasses.dataclass
class RelinStep(KeyswitchFamilyStep):
    """One engine relinearization producing CMULT node ``out``.

    Executed via ``KeyswitchEngine.relin(_batched)``: tensor product of
    the two argument ciphertexts, ModUp of d2 on the shared plan cache,
    IP against the mult key, one ModDown, base-domain folds — bit-exact
    with the eager ``CKKSContext.multiply`` (``exact=True`` safe)."""

    family = "relin"

    out: int
    level: int
    args: tuple[int, int]                   # (a nid, b nid)


@dataclasses.dataclass
class MultiRelinStep(KeyswitchFamilyStep):
    """One sum-of-CMult closure closed by a SINGLE ModDown.

    ``sink = sum_i CMult(a_i, b_i) [+ sum_j passthrough_j]`` — the
    giant-step product sums of the BSGS Chebyshev evaluation
    (``polyeval.eval_chebyshev_bsgs``).  Each term still pays its own d2
    ModUp (d2 tensors are fresh per CMult), but all relin IPs against
    the shared mult key accumulate in the extended basis and ONE
    ModDown closes the whole sum — versus one ModDown per CMult on the
    per-term path.  ``exact=False`` lowering only (merged ModDown
    rounding), the relin analogue of ``MultiHoistedStep``."""

    family = "relin"

    out: int
    level: int
    cmults: list[tuple[int, tuple[int, int]]]   # (cmult nid, (a, b))
    passthrough: list[int]                      # terms added unmerged

    @property
    def n_relin(self) -> int:
        return len(self.cmults)


@dataclasses.dataclass
class EagerStep:
    """Execute one DFG node directly on the context."""

    nid: int


def _lift(dfg, sink: int, anchor: int, allowed_rots: set[int],
          nh: int) -> tuple[dict[Term, float], set[int]]:
    """Rewrite the expression under ``sink`` over rotations of ``anchor``.

    Returns (terms, visited-interior-nodes).  Raises Unliftable when the
    walk reaches anything outside {anchor, allowed rots, PMul, CAdd,
    CSub, CScale}."""
    memo: dict[int, dict[Term, float]] = {}
    visited: set[int] = set()

    def ev(nid: int) -> dict[Term, float]:
        if nid == anchor:
            return {(0, ()): 1.0}
        if nid in memo:
            return memo[nid]
        node = dfg.nodes[nid]
        if node.op == OpKind.ROT and nid in allowed_rots:
            s = node.attrs["steps"] % nh
            out: dict[Term, float] = {}
            for (t, fs), c in ev(node.args[0]).items():
                key = ((t + s) % nh,
                       tuple(sorted((p, (r + s) % nh) for p, r in fs)))
                out[key] = out.get(key, 0.0) + c
        elif node.op == OpKind.PMUL:
            pid = node.attrs["pt"]
            out = {}
            for (t, fs), c in ev(node.args[0]).items():
                key = (t, tuple(sorted(fs + ((pid, 0),))))
                out[key] = out.get(key, 0.0) + c
        elif node.op in (OpKind.CADD, OpKind.CSUB):
            out = dict(ev(node.args[0]))
            sign = -1.0 if node.op == OpKind.CSUB else 1.0
            for k, c in ev(node.args[1]).items():
                out[k] = out.get(k, 0.0) + sign * c
        elif node.op == OpKind.CSCALE:
            c0 = float(node.attrs.get("c", 2))
            out = {k: c * c0 for k, c in ev(node.args[0]).items()}
        else:
            raise Unliftable(f"node {nid} ({node.op.value}) blocks hoisting")
        memo[nid] = out
        visited.add(nid)
        return out

    return ev(sink), visited


def _build_step(dfg, sink: int, anchor: int, terms: dict[Term, float],
                pt_specs, exact_only: bool, fused_members: int,
                allow_bare: bool = False) -> HoistedStep:
    """Validate lifted terms and shape them into a HoistedStep."""
    terms = {k: c for k, c in terms.items() if c != 0.0}
    if not terms:
        raise Unliftable("empty expression")
    if not allow_bare:
        if all(s == 0 for (s, _) in terms):
            raise Unliftable("no rotation work — plain EWOs stay eager")
        if len(terms) == 1 and not next(iter(terms))[1]:
            # a lone pt-less rotation is exactly ctx.rotate — keep it
            # eager so the compiled trajectory matches eager bit for bit
            raise Unliftable("single bare rotation")
    with_pt = any(fs for (_, fs) in terms)
    by_step: dict[int, list[tuple[float, tuple]]] = {}
    scale = None
    for (s, fs), c in terms.items():
        if with_pt and not fs:
            raise Unliftable("mixed pt/no-pt terms")
        if not fs and c != 1.0:
            raise Unliftable("scaled pure-rotation term")
        if exact_only and (c != 1.0 or len(fs) > 1
                           or any(r != 0 for _, r in fs)):
            raise Unliftable("needs the Eq. (4) rewrite (fusion only)")
        if fs:
            term_scale = 1.0
            for p, _ in fs:
                term_scale *= pt_specs[p].scale
            if scale is None:
                scale = term_scale
            elif abs(term_scale / scale - 1.0) > 1e-9:
                raise Unliftable("inconsistent combined plaintext scales")
        by_step.setdefault(s, []).append((c, fs))
    node = dfg.nodes[sink]
    return HoistedStep(
        out=sink, anchor=anchor, level=node.limbs - 1,
        steps=sorted(by_step), pt_terms=by_step if with_pt else None,
        pt_scale=scale if scale is not None else 1.0,
        exact=exact_only, fused_members=fused_members,
    )


def _lift_multi(dfg, sink: int, interior: set[int], allowed_rots: set[int],
                nh: int) -> tuple[dict[tuple[int, int], float], set[int]]:
    """Rewrite ``sink`` as sum_i c_i * Rot_{s_i}(anchor_i) over SEVERAL
    anchors.  Anchors are discovered dynamically: any node outside the
    PKB's ``interior`` (region + rotations) terminates the walk as a
    term anchor — this covers both true ModUp anchors and step-0
    passthrough values (e.g. the unrotated first giant-step group of
    BSGS).  Returns ({(anchor, step): coeff}, visited interior nodes);
    raises Unliftable at an in-region op with no rotation-sum form
    (plaintext factors stay on the single-anchor path)."""
    memo: dict[int, dict[tuple[int, int], float]] = {}
    visited: set[int] = set()

    def ev(nid: int) -> dict[tuple[int, int], float]:
        if nid != sink and nid not in interior:
            return {(nid, 0): 1.0}
        if nid in memo:
            return memo[nid]
        node = dfg.nodes[nid]
        if node.op == OpKind.ROT and nid in allowed_rots:
            s = node.attrs["steps"] % nh
            out: dict[tuple[int, int], float] = {}
            for (a, t), c in ev(node.args[0]).items():
                key = (a, (t + s) % nh)
                out[key] = out.get(key, 0.0) + c
        elif node.op in (OpKind.CADD, OpKind.CSUB):
            out = dict(ev(node.args[0]))
            sign = -1.0 if node.op == OpKind.CSUB else 1.0
            for k, c in ev(node.args[1]).items():
                out[k] = out.get(k, 0.0) + sign * c
        elif node.op == OpKind.CSCALE:
            c0 = float(node.attrs.get("c", 2))
            out = {k: c * c0 for k, c in ev(node.args[0]).items()}
        else:
            raise Unliftable(f"node {nid} ({node.op.value}) blocks "
                             f"multi-anchor hoisting")
        memo[nid] = out
        visited.add(nid)
        return out

    return ev(sink), visited


def _lower_multi(dfg, pkb: PKB,
                 nh: int) -> tuple[list[MultiHoistedStep], set[int]]:
    """Lower one multi-anchor PKB (giant-step shape) to single-ModDown
    accumulation steps.  Only pure rotation sums with unit coefficients
    over same-level anchors lift; anything else stays eager."""
    interior = pkb.region | set(pkb.rotations)
    allowed = set(pkb.rotations)
    out_steps: list[MultiHoistedStep] = []
    consumed: set[int] = set()
    for sink in sorted(pkb.out_sinks):
        terms, visited = _lift_multi(dfg, sink, interior, allowed, nh)
        terms = {k: c for k, c in terms.items() if c != 0.0}
        if any(c != 1.0 for c in terms.values()):
            raise Unliftable("scaled multi-anchor term")
        rot_terms = sorted((a, s) for (a, s) in terms if s != 0)
        passthrough = sorted(a for (a, s) in terms if s == 0)
        if len(rot_terms) < 2 or len({a for a, _ in rot_terms}) < 2:
            raise Unliftable("no multi-anchor rotation work")
        anchor_limbs = ({dfg.nodes[a].limbs for a, _ in rot_terms}
                        | {dfg.nodes[a].limbs for a in passthrough})
        if anchor_limbs != {dfg.nodes[sink].limbs}:
            raise Unliftable("anchors at differing levels")
        inner = visited - {sink}
        for nid in inner:             # conservative: no escaping values
            if dfg.succs(nid) - visited:
                raise Unliftable("interior value escapes the region")
        out_steps.append(MultiHoistedStep(
            out=sink, level=dfg.nodes[sink].limbs - 1,
            rot_terms=rot_terms, passthrough=passthrough,
        ))
        consumed |= inner
    return out_steps, consumed


_SUM_OPS = {OpKind.CADD, OpKind.CSUB, OpKind.CSCALE}


def _lift_sum(dfg, sink: int) -> tuple[dict[int, float], set[int]]:
    """Rewrite ``sink`` as sum_i c_i * term_i over non-EWO terms.

    The relin analogue of ``_lift_multi``'s walk: descends through
    CAdd/CSub/CScale only; every other node terminates as a term.
    Returns ({term nid: coeff}, visited interior nodes incl. sink)."""
    memo: dict[int, dict[int, float]] = {}
    visited: set[int] = set()

    def ev(nid: int) -> dict[int, float]:
        node = dfg.nodes[nid]
        if nid != sink and node.op not in _SUM_OPS:
            return {nid: 1.0}
        if nid in memo:
            return memo[nid]
        if node.op in (OpKind.CADD, OpKind.CSUB):
            out = dict(ev(node.args[0]))
            sign = -1.0 if node.op == OpKind.CSUB else 1.0
            for k, c in ev(node.args[1]).items():
                out[k] = out.get(k, 0.0) + sign * c
        elif node.op == OpKind.CSCALE:
            c0 = float(node.attrs.get("c", 2))
            out = {k: c * c0 for k, c in ev(node.args[0]).items()}
        else:
            raise Unliftable(f"node {nid} ({node.op.value}) is no sum")
        memo[nid] = out
        visited.add(nid)
        return out

    return ev(sink), visited


def _relin_closures(dfg, blocked: set[int]) -> tuple[
        dict[int, MultiRelinStep], set[int], set[int]]:
    """Identify sum-of-CMult closures: maximal CAdd trees over >= 2
    same-level unit-coefficient CMULT terms whose values never escape.

    ``blocked``: nodes already claimed by the rotation lowering — a
    closure may not overlap them.  Returns (sink -> step, consumed
    interior nodes, claimed CMULT nids)."""
    steps: dict[int, MultiRelinStep] = {}
    consumed: set[int] = set()
    claimed: set[int] = set()
    for nid in reversed(dfg.topo_order()):
        node = dfg.nodes[nid]
        if node.op not in (OpKind.CADD, OpKind.CSUB):
            continue
        if nid in consumed or nid in blocked:
            continue
        try:
            terms, visited = _lift_sum(dfg, nid)
        except Unliftable:
            continue
        terms = {k: c for k, c in terms.items() if c != 0.0}
        cmults = sorted(t for t in terms
                        if dfg.nodes[t].op == OpKind.CMULT)
        if len(cmults) < 2:
            continue
        if any(terms[t] != 1.0 for t in terms):
            continue                  # scaled terms: keep per-term relin
        if any(dfg.nodes[t].limbs != node.limbs for t in cmults):
            continue                  # terms at differing levels
        if any(t in claimed or t in blocked for t in cmults):
            continue
        inner = (visited - {nid}) | set(cmults)
        if inner & blocked:
            continue
        # conservative: neither interior sums nor merged CMULT values
        # may be consumed outside the closure (their base-domain values
        # are never materialized)
        if any(dfg.succs(v) - visited for v in inner):
            continue
        passthrough = sorted(t for t in terms if t not in cmults)
        if any(dfg.nodes[t].limbs != node.limbs for t in passthrough):
            continue
        steps[nid] = MultiRelinStep(
            out=nid, level=node.limbs - 1,
            cmults=[(t, dfg.nodes[t].args) for t in cmults],
            passthrough=passthrough,
        )
        consumed |= visited - {nid}
        claimed |= set(cmults)
    return steps, consumed, claimed


_DESCEND = {OpKind.CADD, OpKind.CSUB, OpKind.CSCALE, OpKind.PMUL,
            OpKind.PADD}


def _lower_group(dfg, members: list[PKB], nh: int, pt_specs,
                 exact_only: bool) -> tuple[list[HoistedStep], set[int]]:
    """Lower one (possibly fused) PKB group.

    Each sink is lifted whole when possible; a sink whose expression
    mixes in foreign values (e.g. the final CAdd of BSGS sums one baby
    block with the ROTATED other — entangled by the commutative forward
    walk) is decomposed instead: we descend through its EWOs/rotations
    and lower every MAXIMAL liftable subtree, leaving the rest eager.
    This reproduces the eager block structure exactly while still
    sharing one ModUp across all blocks on the same anchor.

    Raises Unliftable only when nothing in the group lifts."""
    first, last = members[0], members[-1]
    # in_anchors walks backward through commutative EWOs and may look
    # THROUGH the value the rotations actually consume — either past a
    # merge CAdd (the re/im merge feeding SlotToCoeff) or past a
    # non-commutative EWO like the PADD closing a Chebyshev activation
    # (whose _lift would fail even though the block hoists fine off the
    # PADD output).  When every rotation reads the same direct
    # argument, that argument IS the anchor; only when the arguments
    # differ do we fall back to the walked anchor, and true
    # multi-anchor blocks (BSGS giant steps) stay on the multi/eager
    # path.
    args = {dfg.nodes[r].args[0] for r in first.rotations}
    if len(args) == 1:
        anchor = next(iter(args))
    elif len(first.in_anchors) == 1:
        anchor = next(iter(first.in_anchors))
    else:
        raise Unliftable("multi-anchor PKB")
    anchor_level = dfg.nodes[anchor].limbs - 1
    allowed = set()
    for m in members:
        allowed |= set(m.rotations)

    steps: dict[int, HoistedStep] = {}
    consumed: set[int] = set()
    tried: set[int] = set()

    def collect(nid: int) -> None:
        if nid in tried or nid == anchor:
            return
        tried.add(nid)
        node = dfg.nodes[nid]
        if node.limbs - 1 == anchor_level:
            try:
                terms, visited = _lift(dfg, nid, anchor, allowed, nh)
                steps[nid] = _build_step(dfg, nid, anchor, terms, pt_specs,
                                         exact_only, len(members))
                consumed.update(visited)
                return
            except Unliftable:
                pass
        if node.op in _DESCEND or (node.op == OpKind.ROT
                                   and nid in allowed):
            for arg in set(node.args):
                collect(arg)

    for sink in sorted(last.out_sinks):
        collect(sink)
    if not steps:
        raise Unliftable("no liftable subexpression in group")
    # interior values with consumers outside the lowered region stay
    # live: lower them as their own (ModUp-sharing) hoisted steps
    for nid in sorted(consumed):
        if nid in steps:
            continue
        if dfg.succs(nid) - consumed:
            terms, _ = _lift(dfg, nid, anchor, allowed, nh)
            nz = {k: c for k, c in terms.items() if c != 0.0}
            if len(nz) == 1 and not next(iter(nz))[1]:
                # exactly ctx.rotate: the single-rotation hoisted
                # trajectory rounds differently from the eager rotate
                # the trace recorded, so re-materialize it eagerly
                consumed.discard(nid)
                continue
            steps[nid] = _build_step(dfg, nid, anchor, terms, pt_specs,
                                     exact_only, len(members),
                                     allow_bare=True)
    return list(steps.values()), consumed - set(steps)


def lower_program(tc: TraceContext, fusion: bool = False,
                  capacity_words: float | None = None,
                  max_group: int = 4, exact: bool = True) -> CompiledProgram:
    params = tc.params
    dfg = tc.g
    nh = params.num_slots
    with obs.span("compile.identify_pkbs", nodes=len(dfg.nodes)) as sp:
        pkbs = sorted(identify_pkbs(dfg), key=lambda p: p.layer)
        sp.set_attrs(n_pkbs=len(pkbs))
    plan = None
    if fusion and pkbs:
        with obs.span("compile.fusion", n_pkbs=len(pkbs),
                      max_group=max_group):
            plan = optimal_fusion(
                pkbs, params.k, params.alpha, nh,
                capacity_words=(capacity_words if capacity_words is not None
                                else float("inf")),
                max_group=max_group,
            )
        groups = plan.groups
    else:
        groups = [[i] for i in range(len(pkbs))]

    hoisted: dict[int, HoistedStep] = {}      # out nid -> step
    multi: dict[int, MultiHoistedStep] = {}
    consumed: set[int] = set()
    for group in groups:
        members = [pkbs[i] for i in group]
        tries = [members] if len(members) == 1 else [members] + [
            [m] for m in members
        ]
        lowered: set[int] = set()             # id() of lowered members
        for attempt in tries:
            try:
                steps, interior = _lower_group(
                    dfg, attempt, nh, tc.pt_specs,
                    exact_only=(len(attempt) == 1),
                )
            except Unliftable:
                continue
            for st in steps:
                hoisted[st.out] = st
            consumed |= interior
            lowered.update(id(m) for m in attempt)
            if attempt is members:
                break
        # members that lowered nowhere: multi-anchor accumulation when
        # bit-exactness was waived, plain eager execution otherwise
        if not exact:
            for m in members:
                if id(m) in lowered:
                    continue
                try:
                    msteps, interior = _lower_multi(dfg, m, nh)
                except Unliftable:
                    continue
                for st in msteps:
                    multi[st.out] = st
                consumed |= interior

    # Relinearization: CMULTs join the keyswitch family.  exact=False
    # first merges sum-of-CMult closures into single-ModDown
    # MultiRelinSteps; every remaining CMULT lowers to a (bit-exact)
    # RelinStep on the engine's relin entry point.
    multi_relin: dict[int, MultiRelinStep] = {}
    if not exact:
        blocked = (consumed | set(hoisted) | set(multi))
        multi_relin, r_consumed, r_claimed = _relin_closures(dfg, blocked)
        consumed |= r_consumed | r_claimed
    relin: dict[int, RelinStep] = {}
    for nid, node in dfg.nodes.items():
        if node.op == OpKind.CMULT and nid not in consumed:
            relin[nid] = RelinStep(out=nid, level=node.limbs - 1,
                                   args=tuple(node.args))

    # Order steps along the topo order; the first (multi-)hoisted step
    # touching an anchor performs its (shared) ModUp.
    steps: list = []
    seen_anchor: set[int] = set()
    for nid in dfg.topo_order():
        if nid in hoisted:
            st = hoisted[nid]
            # a step with only identity terms never keyswitches, so it
            # neither performs nor claims the anchor's shared ModUp
            has_ks = any(s != 0 for s in st.steps)
            st.fresh_modup = has_ks and st.anchor not in seen_anchor
            if has_ks:
                seen_anchor.add(st.anchor)
            steps.append(st)
        elif nid in multi:
            mst = multi[nid]
            term_anchors = list(dict.fromkeys(a for a, _ in mst.rot_terms))
            mst.fresh_anchors = [a for a in term_anchors
                                 if a not in seen_anchor]
            seen_anchor.update(term_anchors)
            steps.append(mst)
        elif nid in relin:
            steps.append(relin[nid])
        elif nid in multi_relin:
            steps.append(multi_relin[nid])
        elif nid in consumed:
            continue
        else:
            steps.append(EagerStep(nid))

    return CompiledProgram(
        params=params, dfg=dfg, pt_specs=tc.pt_specs, inputs=dict(tc.inputs),
        outputs=dict(tc.outputs), steps=steps, pkbs=pkbs, fusion_plan=plan,
        fused=fusion, exact=exact,
    )
