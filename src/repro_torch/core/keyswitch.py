"""Batched keyswitch engine: ModUp -> IP -> ModDown on the four kernels.

Counterpart of the JAX package's ``core/keyswitch.py``, following its
``"pallas"`` branch:

  * ModUp is one call of the all-digit ModUp kernel (``kernels/modup``),
    natural eval order in and out, own limbs passed through inside it;
  * the inner product is one fused-IP launch (``kernels/fused_ip``) that
    also sums over the rotations of a hoisted block and folds in the
    PModUp'd plaintexts;
  * ModDown runs batched over both accumulator polynomials: INTT of the
    P limbs, BConv P -> Q (``kernels/bconv``), NTT (``kernels/ntt``).

Each kernel wrapper runs its plain version on CPU tensors and its CUDA
kernel on CUDA tensors, so the same bodies serve both devices.  Every
body is written once on ``(..., l, N)`` tensors: the ``*_batched`` entry
points pass a leading batch dimension where ``jax.vmap`` stood.

There is no jit.  A plan is a cached ``KeyswitchPlan`` of constants per
level; ``trace_counts[key]`` counts the distinct dispatch shapes seen per
plan key (the op signature, plus the batch width for ``*_batched``
calls), the counterpart of the reference's jit traces.  A repeat dispatch
never raises it.  evk and plaintext tensors are per-``id(evk)`` device
caches resolved at dispatch time.

With ``repro_torch.obs`` tracing on, the engine emits the reference's
events under the same names and attribute keys: ``engine.kernel_dispatch``
at every public entry point, ``engine.jit_trace`` where a new dispatch
shape is counted in ``trace_counts``, and ``engine.evk_admit`` where a
key enters the cache.  ``backend`` is the device type (``"cuda"`` or
``"cpu"``); ModUp is always the one-call kernel (``modup="fused"``), and
nothing is interpreted.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import poly
from repro_torch.core.counters import OpCounters
from repro_torch.errors import ModulusChainMismatchError
from repro_torch.kernels.bconv.ops import bconv
from repro_torch.kernels.fused_ip.ops import IPConsts, fused_ip
from repro_torch.kernels.modup.ops import ModUpConsts, modup

if TYPE_CHECKING:
    from repro_torch.core.keys import EvalKey


def ext_rows(params, level: int) -> np.ndarray:
    """Rows of a full-basis (Q_L u P) evk tensor active at ``level``."""
    L, k = params.L, params.k
    return np.concatenate(
        [np.arange(level + 1), np.arange(L + 1, L + 1 + k)]
    )


class KeyswitchPlan:
    """Per-level constants: kernel tables and mods."""

    def __init__(self, pc: poly.PolyContext, level: int):
        params = pc.params
        dev = pc.device
        self.level = level
        self.base: tuple[int, ...] = params.q_chain(level)
        self.ext: tuple[int, ...] = self.base + params.p_primes
        self.groups = params.digit_groups(level)
        self.dnum = len(self.groups)
        self.alpha = max(len(D) for D in self.groups)
        self.group_sizes = tuple(len(D) for D in self.groups)
        self.l = len(self.base)
        self.l_ext = len(self.ext)
        self.k = len(params.p_primes)
        self.N = params.N

        self.base_mods = pc.mods(self.base)
        self.ext_mods = pc.mods(self.ext)

        # --- ModUp: every digit, own limbs passed through ---
        self.modup = ModUpConsts(pc.rns, pc.tabs, self.groups, self.base,
                                 self.ext, dev)

        # --- IP and ModDown (P -> Q_level) constants ---
        self.ip = IPConsts(self.ext, dev)
        self.md_bconv = pc.bconv_consts(params.p_primes, self.base)
        self.pinv = pc.tensor(pc.rns.p_inv_mod_q(level))


class KeyswitchEngine:
    """Batched keyswitch over a ``PolyContext``.

    One plan per level; evk tensors stacked and level-sliced once per key
    and cached."""

    def __init__(self, pc: poly.PolyContext,
                 counters: OpCounters | None = None):
        self.pc = pc
        self.params = pc.params
        self.counters = counters if counters is not None else OpCounters()
        self._plans: dict[int, KeyswitchPlan] = {}
        self._seen: set[tuple] = set()
        self._evk_full: dict[int, tuple] = {}     # id(evk) -> (evk, stacked)
        self._evk_level: dict[tuple, torch.Tensor] = {}
        self._evk_group: dict[tuple, torch.Tensor] = {}
        self._perm_cache: dict[tuple, torch.Tensor] = {}
        self.trace_counts: dict[tuple, int] = {}

    @property
    def backend(self) -> str:
        """The device type the engine runs on: ``"cuda"`` or ``"cpu"``."""
        return self.pc.device.type

    # ------------------------- op counting -----------------------------
    def _note_keyswitch(self, plan: KeyswitchPlan, m: int = 1) -> None:
        c = self.counters
        c.note_modup(plan.l, plan.l_ext, plan.group_sizes, plan.N, m)
        c.note_ip(plan.dnum, plan.l_ext, plan.N, 1, m)
        c.note_moddown(plan.l, plan.k, plan.N, m)
        c.keyswitch += m

    def _note_hoisted(self, plan: KeyswitchPlan, n_rot: int,
                      with_modup: bool, m: int = 1) -> None:
        c = self.counters
        if with_modup:
            c.note_modup(plan.l, plan.l_ext, plan.group_sizes, plan.N, m)
        c.note_ip(plan.dnum, plan.l_ext, plan.N, n_rot, m)
        c.note_moddown(plan.l, plan.k, plan.N, m)
        c.keyswitch += m * n_rot
        c.rotation += m * n_rot
        c.hoisted_blocks += m

    def _note_relin(self, plan: KeyswitchPlan, with_modup: bool,
                    n: int = 1, m: int = 1) -> None:
        """n relinearizations of m ciphertexts sharing one ModDown each
        (n > 1: a merged multi-relin block — ONE ModDown total)."""
        c = self.counters
        if with_modup:
            c.note_modup(plan.l, plan.l_ext, plan.group_sizes, plan.N,
                         m * n)
        c.note_ip(plan.dnum, plan.l_ext, plan.N, n, m)
        c.note_moddown(plan.l, plan.k, plan.N, m)
        c.keyswitch += m * n
        c.relin += m * n
        if n > 1:
            c.relin_blocks += m

    def _note_multi(self, plan: KeyswitchPlan, n: int, m: int = 1) -> None:
        c = self.counters
        c.note_ip(plan.dnum, plan.l_ext, plan.N, n, m)
        c.note_moddown(plan.l, plan.k, plan.N, m)
        c.keyswitch += m * n
        c.rotation += m * n

    # ------------------------- plans -----------------------------------
    def _plan(self, level: int) -> KeyswitchPlan:
        if level not in self._plans:
            self._plans[level] = KeyswitchPlan(self.pc, level)
        return self._plans[level]

    def _dispatch(self, key: tuple, width: int | None = None) -> None:
        """Count the first dispatch of each (plan key, batch width)."""
        if (key, width) not in self._seen:
            self._seen.add((key, width))
            n = self.trace_counts.get(key, 0) + 1
            self.trace_counts[key] = n
            # a plan key seen again at a new width is a retrace
            obs.event("engine.jit_trace", key=str(key), count=n,
                      retrace=n > 1)

    def _note_dispatch(self, op: str) -> None:
        """Kernel-dispatch event, one per public entry point call."""
        obs.event("engine.kernel_dispatch", op=op, backend=self.backend,
                  modup="fused", interpret=False)

    # ------------------------- evk stacking ----------------------------
    def _admit_evk(self, evk: EvalKey) -> None:
        """Cache-admission guard: an evk generated under different
        ``CKKSParams`` (wrong digit count or extended-basis shape) is
        rejected here, at the cache boundary.  Runs only on cache miss."""
        p = self.params
        want_digits = p.dnum
        want_shape = (2, p.L + 1 + p.k, p.N)
        if len(evk.digits) != want_digits:
            raise ModulusChainMismatchError(
                "evk digit count disagrees with the engine's params",
                hint="the key was generated under different CKKSParams; "
                     "regenerate it with this context's KeyChain",
                evk_digits=len(evk.digits), dnum=want_digits)
        got = tuple(evk.digits[0].shape)
        if got != want_shape:
            raise ModulusChainMismatchError(
                "evk digit shape disagrees with the extended basis",
                hint="the key was generated under a different modulus "
                     "chain; regenerate it with this context's KeyChain",
                evk_shape=got, expected=want_shape)

    def _evk_stacked(self, evk: EvalKey) -> torch.Tensor:
        """(dnum_full, 2, L+1+k, N) int64, cached per key object."""
        key = id(evk)
        if key not in self._evk_full:
            self._admit_evk(evk)
            self._evk_full[key] = (evk, torch.stack(evk.digits))
            obs.event("engine.evk_admit", cached=len(self._evk_full))
        return self._evk_full[key][1]

    def evk_tensor(self, evk: EvalKey, level: int) -> torch.Tensor:
        """Level-sliced evk tensor (dnum, 2, l_ext, N).  Cached."""
        key = (id(evk), level)
        if key not in self._evk_level:
            plan = self._plan(level)
            full = self._evk_stacked(evk)
            rows = torch.from_numpy(ext_rows(self.params, level)).to(
                full.device)
            self._evk_level[key] = full[: plan.dnum][:, :, rows].contiguous()
        return self._evk_level[key]

    def evk_group_tensor(self, evks: list[EvalKey],
                         level: int) -> torch.Tensor:
        """(R, dnum, 2, l_ext, N) stack for a hoisted rotation group.
        Bounded (FIFO eviction) — rotation groups vary across programs."""
        key = (tuple(id(k) for k in evks), level)
        if key not in self._evk_group:
            while len(self._evk_group) >= 64:
                self._evk_group.pop(next(iter(self._evk_group)))
            self._evk_group[key] = torch.stack(
                [self.evk_tensor(k, level) for k in evks]
            )
        return self._evk_group[key]

    def perm_tensor(self, galois_list: list[int]) -> torch.Tensor:
        """(R, N) eval-domain automorphism gather indices."""
        key = tuple(galois_list)
        if key not in self._perm_cache:
            self._perm_cache[key] = self.pc.tensor(np.stack(
                [self.pc.rns.autom_eval_perm(g) for g in galois_list]
            ))
        return self._perm_cache[key]

    # ------------------------- bodies on (..., l, N) --------------------
    def _modup(self, a, plan: KeyswitchPlan):
        """(..., l, N) eval -> (..., dnum, l_ext, N) eval, all digits."""
        return modup(a.contiguous(), plan.modup)

    def _ip(self, digits, evk, plan: KeyswitchPlan):
        """(..., dnum, l_ext, N) x (dnum, 2, l_ext, N) -> (..., 2, l_ext, N)."""
        return fused_ip(digits.unsqueeze(-4), evk[None], None, plan.ip)

    def _moddown2(self, acc, plan: KeyswitchPlan):
        """ModDown of both accumulators: (..., 2, l_ext, N) -> (..., 2, l, N)."""
        xq, xp = acc[..., : plan.l, :], acc[..., plan.l :, :]
        xpc = poly.intt(xp, self.params.p_primes, self.pc)
        conv = poly.ntt(bconv(xpc, plan.md_bconv), plan.base, self.pc)
        bm = plan.base_mods[:, None]
        diff = (xq + bm - conv) % bm
        return diff * plan.pinv[:, None] % bm

    def _ks_body(self, a, evk, plan: KeyswitchPlan):
        d = self._moddown2(self._ip(self._modup(a, plan), evk, plan), plan)
        return d[..., 0, :, :], d[..., 1, :, :]

    def _galois_body(self, c0, c1, perm, evk, plan: KeyswitchPlan):
        d0, d1 = self._ks_body(c1[..., perm], evk, plan)
        bm = plan.base_mods[:, None]
        return (c0[..., perm] + d0) % bm, d1

    def _hoist_core(self, plan: KeyswitchPlan, c0, digits, perms, evk_all,
                    pm_ext, pm_base):
        """Hoisted-rotation-sum body AFTER ModUp: rotate digits, one fused
        IP over every rotation, one batched ModDown."""
        # One gather rotates ALL digits for ALL rotations.
        d_rot = digits[..., perms].movedim(-2, -4).contiguous()
        acc = fused_ip(d_rot, evk_all, pm_ext, plan.ip)
        bm = plan.base_mods[:, None]
        c0r = c0[..., perms].movedim(-2, -3)           # (..., R, l, N)
        if pm_base is not None:
            c0r = c0r * pm_base % bm
        base0 = c0r.sum(dim=-3) % bm
        d = self._moddown2(acc, plan)
        return (base0 + d[..., 0, :, :]) % bm, d[..., 1, :, :]

    def _multi_core(self, plan: KeyswitchPlan, c0s, digits, perms, evk_all):
        """Multi-anchor body: c0s (..., n, l, N), digits (..., n, dnum,
        l_ext, N); rotate each term by ITS perm, IP against ITS evk, sum
        in the extended basis, close with ONE ModDown."""
        p4 = perms[:, None, None, :].expand(digits.shape)
        d_rot = torch.gather(digits, -1, p4)
        acc = fused_ip(d_rot, evk_all, None, plan.ip)
        bm = plan.base_mods[:, None]
        c0r = torch.gather(c0s, -1, perms[:, None, :].expand(c0s.shape))
        base0 = c0r.sum(dim=-3) % bm
        d = self._moddown2(acc, plan)
        return (base0 + d[..., 0, :, :]) % bm, d[..., 1, :, :]

    def _relin_core(self, plan: KeyswitchPlan, d0, d1, digits, evk):
        """IP + ModDown of relin digits, folded into (d0, d1)."""
        d = self._moddown2(self._ip(digits, evk, plan), plan)
        bm = plan.base_mods[:, None]
        return (d0 + d[..., 0, :, :]) % bm, (d1 + d[..., 1, :, :]) % bm

    def _multi_relin_core(self, plan: KeyswitchPlan, d0s, d1s, digits, evk):
        """Multi-relin body: every term's IP against the SHARED mult key
        sums in the extended basis; ONE ModDown closes the sum."""
        acc = fused_ip(digits, evk[None], None, plan.ip)
        bm = plan.base_mods[:, None]
        base0 = d0s.sum(dim=-3) % bm
        base1 = d1s.sum(dim=-3) % bm
        d = self._moddown2(acc, plan)
        return (base0 + d[..., 0, :, :]) % bm, (base1 + d[..., 1, :, :]) % bm

    # ------------------------- public API ------------------------------
    # Each entry point emits its dispatch event, counts its ops, resolves
    # its key tensors (an admission emits its event) and only then counts
    # the dispatch shape, in the reference's order of events.
    def keyswitch(self, a, evk: EvalKey, level: int):
        """ModUp -> IP -> ModDown of poly ``a``: (d0, d1) under Q_level."""
        self._note_dispatch("keyswitch")
        plan = self._plan(level)
        self._note_keyswitch(plan)
        ek = self.evk_tensor(evk, level)
        self._dispatch(("keyswitch", level))
        return self._ks_body(a, ek, plan)

    def apply_galois(self, c0, c1, galois: int, evk: EvalKey, level: int):
        """Fused rotate: eval-domain automorphism + keyswitch of c1."""
        self._note_dispatch("rotate")
        plan = self._plan(level)
        self._note_keyswitch(plan)
        self.counters.rotation += 1
        perm = self.perm_tensor([galois])[0]
        ek = self.evk_tensor(evk, level)
        self._dispatch(("galois", level))
        return self._galois_body(c0, c1, perm, ek, plan)

    def modup(self, a, level: int):
        """Standalone ModUp of poly ``a`` -> (dnum, l_ext, N) digits,
        shareable across hoisted blocks anchored on the same ciphertext."""
        self._note_dispatch("modup")
        plan = self._plan(level)
        self.counters.note_modup(plan.l, plan.l_ext, plan.group_sizes,
                                 plan.N)
        self._dispatch(("modup", level))
        return self._modup(a, plan)

    def hoisted_rotation_sum(self, c0, c1, galois_list: list[int],
                             evks: list[EvalKey], level: int,
                             pm_ext=None, pm_base=None, digits=None):
        """sum_r [pt_r *] Rot(ct, r): ONE ModUp, ONE (batched) ModDown.

        pm_ext/pm_base: (R, l_ext, N) / (R, l, N) PModUp'd plaintexts.
        ``digits``: pre-computed ModUp digits from :meth:`modup` — the
        internal ModUp is skipped (bit-exact with the monolithic path).
        """
        self._note_dispatch("hoisted_rotation_sum")
        plan = self._plan(level)
        n_rot = len(galois_list)
        self._note_hoisted(plan, n_rot, digits is None)
        perms = self.perm_tensor(galois_list)
        evk_all = self.evk_group_tensor(evks, level)
        with_pt = pm_base is not None
        name = "hoisted" if digits is None else "hoisted_digits"
        self._dispatch((name, level, n_rot, with_pt))
        if digits is None:
            digits = self._modup(c1, plan)
        return self._hoist_core(plan, c0, digits, perms, evk_all, pm_ext,
                                pm_base)

    def multi_hoisted_rotation_sum(self, c0s, digits_list, galois_list,
                                   evks, level: int):
        """sum_i Rot_{g_i}(ct_i) over DIFFERENT anchor ciphertexts with
        ONE ModDown: per-term IPs accumulate in the extended basis; a
        single batched ModDown closes the sum."""
        self._note_dispatch("multi_hoisted_rotation_sum")
        plan = self._plan(level)
        n = len(galois_list)
        self._note_multi(plan, n)
        perms = self.perm_tensor(galois_list)
        evk_all = self.evk_group_tensor(evks, level)
        self._dispatch(("multi_hoisted", level, n))
        return self._multi_core(plan, torch.stack(c0s),
                                torch.stack(digits_list), perms, evk_all)

    def relin(self, d0, d1, d2, evk: EvalKey, level: int, digits=None):
        """Relinearize a degree-2 ciphertext: (d0, d1) + KS(d2); the ModUp
        is skipped when pre-computed ``digits`` are passed."""
        self._note_dispatch("relin")
        plan = self._plan(level)
        self._note_relin(plan, digits is None)
        ek = self.evk_tensor(evk, level)
        self._dispatch(("relin", level, digits is not None))
        if digits is None:
            digits = self._modup(d2, plan)
        return self._relin_core(plan, d0, d1, digits, ek)

    def multi_relin_sum(self, d0s, d1s, digits_list, evk: EvalKey,
                        level: int):
        """sum_i [(d0_i, d1_i) + KS(d2_i)] with ONE ModDown; digits are
        per-term pre-computed ModUps of the d2 components."""
        self._note_dispatch("multi_relin_sum")
        plan = self._plan(level)
        n = len(digits_list)
        self._note_relin(plan, with_modup=False, n=n)
        ek = self.evk_tensor(evk, level)
        self._dispatch(("multi_relin", level, n))
        return self._multi_relin_core(
            plan, torch.stack(d0s), torch.stack(d1s),
            torch.stack(digits_list), ek)

    # -------- batched public API (leading ct axis) ----------------------
    def keyswitch_batched(self, ab, evk: EvalKey, level: int):
        """Batched keyswitch of (B, l, N) polys."""
        self._note_dispatch("keyswitch_batched")
        plan = self._plan(level)
        m = int(ab.shape[0])
        self._note_keyswitch(plan, m=m)
        ek = self.evk_tensor(evk, level)
        self._dispatch(("keyswitch_b", level), m)
        return self._ks_body(ab, ek, plan)

    def apply_galois_batched(self, c0b, c1b, galois: int, evk: EvalKey,
                             level: int):
        self._note_dispatch("rotate_batched")
        plan = self._plan(level)
        m = int(c0b.shape[0])
        self._note_keyswitch(plan, m=m)
        self.counters.rotation += m
        perm = self.perm_tensor([galois])[0]
        ek = self.evk_tensor(evk, level)
        self._dispatch(("galois_b", level), m)
        return self._galois_body(c0b, c1b, perm, ek, plan)

    def modup_batched(self, ab, level: int):
        self._note_dispatch("modup_batched")
        plan = self._plan(level)
        m = int(ab.shape[0])
        self.counters.note_modup(plan.l, plan.l_ext, plan.group_sizes,
                                 plan.N, m=m)
        self._dispatch(("modup_b", level), m)
        return self._modup(ab, plan)

    def multi_hoisted_rotation_sum_batched(self, c0s, digits_list,
                                           galois_list, evks, level: int):
        """Batched multi-anchor accumulation: per-term (B, l, N) c0s and
        (B, dnum, l_ext, N) digits."""
        self._note_dispatch("multi_hoisted_rotation_sum_batched")
        plan = self._plan(level)
        n = len(galois_list)
        m = int(c0s[0].shape[0])
        self._note_multi(plan, n, m)
        perms = self.perm_tensor(galois_list)
        evk_all = self.evk_group_tensor(evks, level)
        self._dispatch(("multi_hoisted_b", level, n), m)
        return self._multi_core(
            plan, torch.stack(c0s, dim=1), torch.stack(digits_list, dim=1),
            perms, evk_all)

    def relin_batched(self, d0b, d1b, d2b, evk: EvalKey, level: int,
                      digits=None):
        """Batched relinearization of (B, l, N) degree-2 components
        (``digits``: (B, dnum, l_ext, N))."""
        self._note_dispatch("relin_batched")
        plan = self._plan(level)
        m = int(d0b.shape[0])
        self._note_relin(plan, digits is None, m=m)
        ek = self.evk_tensor(evk, level)
        self._dispatch(("relin_b", level, digits is not None), m)
        if digits is None:
            digits = self._modup(d2b, plan)
        return self._relin_core(plan, d0b, d1b, digits, ek)

    def multi_relin_sum_batched(self, d0s, d1s, digits_list,
                                evk: EvalKey, level: int):
        """Batched multi-relin accumulation: per-term (B, l, N) d0/d1 and
        (B, dnum, l_ext, N) digits."""
        self._note_dispatch("multi_relin_sum_batched")
        plan = self._plan(level)
        n = len(digits_list)
        m = int(d0s[0].shape[0])
        self._note_relin(plan, with_modup=False, n=n, m=m)
        ek = self.evk_tensor(evk, level)
        self._dispatch(("multi_relin_b", level, n), m)
        return self._multi_relin_core(
            plan, torch.stack(d0s, dim=1), torch.stack(d1s, dim=1),
            torch.stack(digits_list, dim=1), ek)

    def hoisted_rotation_sum_batched(self, c0b, c1b, galois_list,
                                     evks, level: int, pm_ext=None,
                                     pm_base=None, digits=None):
        """(B, l, N) c0/c1 (or (B, dnum, l_ext, N) pre-computed
        ``digits``), shared perm/evk/plaintext tensors."""
        self._note_dispatch("hoisted_rotation_sum_batched")
        plan = self._plan(level)
        n_rot = len(galois_list)
        m = int(c0b.shape[0])
        self._note_hoisted(plan, n_rot, digits is None, m=m)
        perms = self.perm_tensor(galois_list)
        evk_all = self.evk_group_tensor(evks, level)
        with_pt = pm_base is not None
        self._dispatch(("hoisted_b", level, n_rot, with_pt,
                        digits is not None), m)
        if digits is None:
            digits = self._modup(c1b, plan)
        return self._hoist_core(plan, c0b, digits, perms, evk_all, pm_ext,
                                pm_base)
