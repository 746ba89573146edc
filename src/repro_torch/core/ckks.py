"""RNS-CKKS scheme: encrypt/decrypt, EWOs, keyswitch, rotation, hoisting.

Counterpart of the JAX package's ``core/ckks.py`` on int64 torch tensors.
Ciphertext polynomials are (level+1, N) residues in EVAL (NTT) domain on
the context's device.  ModUp/ModDown follow the paper's xPU pipeline
(INTT -> BConv -> NTT).  The hoisted-rotation API implements "double
hoisting": one ModUp per ciphertext, one ModDown per linear combination.

A context runs on the card by default (``device="cuda"``); the CPU runs
only when the caller asks for it, and then every kernel wrapper takes its
plain version.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import poly
from repro_torch.core.counters import OpCounters
from repro_torch.core.encoding import Encoder, centered_crt
from repro_torch.core.keys import EvalKey, KeyChain, sample_gaussian, to_rns, uniform_rns
from repro_torch.core.keyswitch import KeyswitchEngine, ext_rows
from repro_torch.core.params import CKKSParams
from repro_torch.errors import (
    CorruptCiphertextError, LevelExhaustedError,
    ModulusChainMismatchError, ScaleDriftError,
)


@dataclasses.dataclass
class Ciphertext:
    c0: torch.Tensor  # (level+1, N) eval domain
    c1: torch.Tensor
    level: int
    scale: float

    @property
    def n_limbs(self) -> int:
        return self.level + 1


@dataclasses.dataclass(eq=False)
class Plaintext:
    m: torch.Tensor  # (level+1, N) eval domain
    level: int
    scale: float
    # level -> PModUp'd extended-basis lift (see CKKSContext._pmodup)
    pmodup_cache: dict = dataclasses.field(default_factory=dict, repr=False)


def tensor_product(a: Ciphertext, b: Ciphertext, mods) -> tuple:
    """(d0, d1, d2) of the degree-2 ciphertext product, pre-relin.
    Elementwise mod-q ops broadcast over an optional leading batch axis."""
    d0 = poly.mul(a.c0, b.c0, mods)
    d1 = poly.add(
        poly.mul(a.c0, b.c1, mods), poly.mul(a.c1, b.c0, mods), mods
    )
    d2 = poly.mul(a.c1, b.c1, mods)
    return d0, d1, d2


class CKKSContext:
    """Everything needed to run CKKS programs functionally.

    ``device`` is where every tensor lives and every kernel runs ("cuda"
    by default; "cpu" runs the kernels' plain versions).
    ``use_engine=False`` takes the seed per-digit/per-rotation loop path
    (kept for parity tests — both paths are bit-exact).
    """

    def __init__(self, params: CKKSParams, seed: int = 1234,
                 hamming_weight: int | None = None, device="cuda",
                 use_engine: bool = True):
        self.params = params
        self.pc = poly.PolyContext(params, device=device)
        self.device = self.pc.device
        self.encoder = Encoder(params)
        self.keys = KeyChain(
            params, self.pc, seed=seed, hamming_weight=hamming_weight
        )
        self.rng = np.random.default_rng(seed + 1)
        # Op counters, shared with the engine so both dispatch paths
        # tally into one place.
        self.counters = OpCounters()
        self.engine = KeyswitchEngine(self.pc, counters=self.counters)
        self.use_engine = use_engine
        # (pt ids, level) -> (pts, pm_ext, pm_base); the pts tuple pins
        # the objects so ids cannot be reused.  Bounded (FIFO eviction).
        self._pm_stacks: dict[tuple, tuple] = {}
        self._pm_stacks_max = 32

    # ------------------------- helpers --------------------------------
    def chain(self, level: int) -> tuple[int, ...]:
        return self.params.q_chain(level)

    def ext_basis(self, level: int) -> tuple[int, ...]:
        return self.chain(level) + self.params.p_primes

    def _ext_rows(self, level: int) -> torch.Tensor:
        """Rows of a full-basis evk active at ``level``."""
        return self.pc.tensor(ext_rows(self.params, level))

    # ------------------------- encode / encrypt ------------------------
    def encode(self, z, level: int | None = None,
               scale: float | None = None) -> Plaintext:
        level = self.params.L if level is None else level
        scale = self.params.scale if scale is None else scale
        primes = self.chain(level)
        m = self.encoder.encode(np.asarray(z), scale, primes)
        m_eval = poly.ntt(self.pc.tensor(m), primes, self.pc)
        return Plaintext(m=m_eval, level=level, scale=scale)

    def encrypt(self, z, level: int | None = None,
                scale: float | None = None) -> Ciphertext:
        pt = self.encode(z, level, scale)
        level = pt.level
        primes = self.chain(level)
        mods = self.pc.mods(primes)
        N = self.params.N
        a = poly.ntt(self.pc.tensor(uniform_rns(self.rng, primes, N)),
                     primes, self.pc)
        e = poly.ntt(
            self.pc.tensor(to_rns(sample_gaussian(self.rng, N), primes)),
            primes, self.pc,
        )
        s = self._sk_rows(level)
        b = poly.add(poly.sub(e, poly.mul(a, s, mods), mods), pt.m, mods)
        return Ciphertext(c0=b, c1=a, level=level, scale=pt.scale)

    def _sk_rows(self, level: int) -> torch.Tensor:
        return self.keys.s_eval[: level + 1]

    def decrypt(self, ct: Ciphertext) -> np.ndarray:
        primes = self.chain(ct.level)
        mods = self.pc.mods(primes)
        m_eval = poly.add(
            ct.c0, poly.mul(ct.c1, self._sk_rows(ct.level), mods), mods
        )
        m_coeff = poly.intt(m_eval, primes, self.pc)
        return self.encoder.decode(m_coeff.cpu().numpy(), ct.scale, primes)

    # ------------------------- guard checks ----------------------------
    def _require_same_level(self, a: Ciphertext, b: Ciphertext,
                            op: str) -> None:
        if a.level != b.level:
            raise ModulusChainMismatchError(
                f"{op}: operand levels disagree",
                hint="bring operands to a common level with level_down",
                lhs_level=a.level, rhs_level=b.level)

    def _require_pt_level(self, ct: Ciphertext, pt: Plaintext,
                          op: str) -> None:
        if pt.level < ct.level:
            raise ModulusChainMismatchError(
                f"{op}: plaintext encoded below the ciphertext level",
                hint="re-encode the plaintext at level >= ct.level",
                ct_level=ct.level, pt_level=pt.level)

    def check_ciphertext(self, ct: Ciphertext, where: str = "") -> None:
        """Ciphertext health guard: level sane, scale finite, limbs in
        range.  Raises a typed ``CiphertextError`` on the first violated
        invariant.  The residue check is a plain reduction and touches no
        engine plan (``engine.trace_counts`` stays flat)."""
        tag = f" at {where}" if where else ""
        if not 0 <= ct.level <= self.params.L:
            raise LevelExhaustedError(
                f"ciphertext level out of range{tag}",
                hint="bootstrap (or re-encrypt) before more rescales",
                level=ct.level, L=self.params.L)
        s = float(ct.scale)
        if not np.isfinite(s) or s <= 0.0:
            raise ScaleDriftError(
                f"ciphertext scale is not a positive finite float{tag}",
                hint="the producing op corrupted the scale trajectory",
                scale=ct.scale, level=ct.level)
        n = ct.level + 1
        for name, comp in (("c0", ct.c0), ("c1", ct.c1)):
            if comp.shape[-2] != n:
                raise ModulusChainMismatchError(
                    f"{name} carries {comp.shape[-2]} limbs but level "
                    f"{ct.level} needs {n}{tag}",
                    hint="ciphertext limbs and level drifted apart",
                    limbs=comp.shape[-2], level=ct.level)
        mods = self.pc.mods(self.chain(ct.level))[:, None]
        for name, comp in (("c0", ct.c0), ("c1", ct.c1)):
            if comp.is_floating_point():
                if bool(torch.isnan(comp).any()):
                    raise CorruptCiphertextError(
                        f"NaN limb in {name}{tag}",
                        hint="a kernel produced NaN output",
                        component=name, level=ct.level)
                continue
            bad = int(((comp >= mods) | (comp < 0)).sum())
            if bad:
                raise CorruptCiphertextError(
                    f"{bad} residue(s) of {name} out of [0, q){tag}",
                    hint="upstream data corruption — do not decrypt; "
                         "re-encrypt and resubmit the request",
                    component=name, level=ct.level, bad_residues=bad)

    # ------------------------- EWOs ------------------------------------
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._require_same_level(a, b, "add")
        mods = self.pc.mods(self.chain(a.level))
        return Ciphertext(
            poly.add(a.c0, b.c0, mods), poly.add(a.c1, b.c1, mods),
            a.level, a.scale,
        )

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._require_same_level(a, b, "sub")
        mods = self.pc.mods(self.chain(a.level))
        return Ciphertext(
            poly.sub(a.c0, b.c0, mods), poly.sub(a.c1, b.c1, mods),
            a.level, a.scale,
        )

    def pt_add(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        self._require_pt_level(a, pt, "pt_add")
        mods = self.pc.mods(self.chain(a.level))
        return Ciphertext(
            poly.add(a.c0, pt.m[: a.n_limbs], mods), a.c1, a.level, a.scale
        )

    def pt_mul(self, a: Ciphertext, pt: Plaintext,
               rescale: bool = True) -> Ciphertext:
        self._require_pt_level(a, pt, "pt_mul")
        mods = self.pc.mods(self.chain(a.level))
        out = Ciphertext(
            poly.mul(a.c0, pt.m[: a.n_limbs], mods),
            poly.mul(a.c1, pt.m[: a.n_limbs], mods),
            a.level, a.scale * pt.scale,
        )
        return self.rescale(out) if rescale else out

    # ------------------------- level management ------------------------
    def rescale(self, ct: Ciphertext) -> Ciphertext:
        lvl = ct.level
        if lvl < 1:
            raise LevelExhaustedError(
                "rescale at level 0: the modulus chain is exhausted",
                hint="bootstrap the ciphertext before further mults",
                level=lvl)
        q_last = self.chain(lvl)[-1]
        c0 = poly.rescale(ct.c0, lvl, self.pc)
        c1 = poly.rescale(ct.c1, lvl, self.pc)
        return Ciphertext(c0, c1, lvl - 1, ct.scale / q_last)

    def level_down(self, ct: Ciphertext, target: int) -> Ciphertext:
        if not 0 <= target <= ct.level:
            raise ModulusChainMismatchError(
                "level_down target outside [0, ct.level]",
                hint="level_down only drops limbs; it cannot raise",
                target=target, level=ct.level)
        n = target + 1
        return Ciphertext(ct.c0[:n], ct.c1[:n], target, ct.scale)

    def mod_raise(self, ct: Ciphertext) -> Ciphertext:
        """Lift a level-0 ciphertext to the full chain (exact, coeffs < q0):
        each component is brought to the coefficient domain, centered-
        lifted off the q0 basis, and re-NTT'd over the full chain."""
        p = self.params
        if ct.level != 0:
            raise ModulusChainMismatchError(
                "mod_raise expects a level-0 ciphertext",
                hint="consume the remaining levels (or level_down) first",
                level=ct.level)
        base = (p.q_primes[0],)
        full = p.q_chain(p.L)
        out = []
        for comp in (ct.c0, ct.c1):
            coeff = poly.intt(comp, base, self.pc)
            centered = centered_crt(coeff.cpu().numpy(), base)
            lifted = to_rns(centered.astype(np.int64), full)
            out.append(poly.ntt(self.pc.tensor(lifted), full, self.pc))
        return Ciphertext(out[0], out[1], p.L, ct.scale)

    # ------------------------- keyswitch core --------------------------
    # The batched engine (core/keyswitch.py) is the default hot path; the
    # seed per-digit loop methods below are kept as the bit-exact
    # reference baseline for the parity tests.
    def modup_digits(self, a: torch.Tensor, level: int) -> list[torch.Tensor]:
        """Decompose+ModUp a (level+1, N) poly to the extended basis."""
        groups = self.params.digit_groups(level)
        target = self.ext_basis(level)
        out = []
        row = 0
        for D in groups:
            digit = a[row : row + len(D)]
            out.append(
                poly.modup_digit(digit, D, target, self.pc, eval_domain=True)
            )
            row += len(D)
        return out

    def inner_product(self, digits: list[torch.Tensor], evk: EvalKey,
                      level: int) -> tuple[torch.Tensor, torch.Tensor]:
        """IP over the extended basis: (sum_j d_j*evk_j0, sum_j d_j*evk_j1)."""
        rows = self._ext_rows(level)
        ext = self.ext_basis(level)
        mods = self.pc.mods(ext)
        acc0 = acc1 = None
        for j, d in enumerate(digits):
            k = evk.digits[j]
            t0 = poly.mul(d, k[0][rows], mods)
            t1 = poly.mul(d, k[1][rows], mods)
            acc0 = t0 if acc0 is None else poly.add(acc0, t0, mods)
            acc1 = t1 if acc1 is None else poly.add(acc1, t1, mods)
        return acc0, acc1

    def _note_seed_ks(self, level: int, n_ip: int = 1,
                      modups: int = 1) -> None:
        """Seed-path analogue of the engine's dispatch-time counting."""
        c = self.counters
        groups = tuple(len(D) for D in self.params.digit_groups(level))
        l, ext = level + 1, level + 1 + self.params.k
        N = self.params.N
        for _ in range(modups):
            c.note_modup(l, ext, groups, N)
        c.note_ip(len(groups), ext, N, n_ip)
        c.note_moddown(l, self.params.k, N)
        c.keyswitch += n_ip

    def keyswitch_seed(self, a: torch.Tensor, evk: EvalKey,
                       level: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Seed per-digit keyswitch: ModUp -> IP -> ModDown loops."""
        self._note_seed_ks(level)
        digits = self.modup_digits(a, level)
        acc0, acc1 = self.inner_product(digits, evk, level)
        d0 = poly.moddown(acc0, level, self.pc)
        d1 = poly.moddown(acc1, level, self.pc)
        return d0, d1

    def keyswitch(self, a: torch.Tensor, evk: EvalKey,
                  level: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Full keyswitch of poly ``a``: ModUp -> IP -> ModDown."""
        if self.use_engine:
            return self.engine.keyswitch(a, evk, level)
        return self.keyswitch_seed(a, evk, level)

    # ------------------------- mult / rotate ---------------------------
    def multiply(self, a: Ciphertext, b: Ciphertext,
                 rescale: bool = True) -> Ciphertext:
        """CMult: tensor product + relinearization of d2 (the engine's
        ``relin``, or the seed per-digit loops; bit-exact, identical
        ``OpCounters``)."""
        self._require_same_level(a, b, "multiply")
        lvl = a.level
        mods = self.pc.mods(self.chain(lvl))
        d0, d1, d2 = tensor_product(a, b, mods)
        if self.use_engine:
            c0, c1 = self.engine.relin(d0, d1, d2, self.keys.mult_key, lvl)
        else:
            self.counters.relin += 1
            e0, e1 = self.keyswitch_seed(d2, self.keys.mult_key, lvl)
            c0, c1 = poly.add(d0, e0, mods), poly.add(d1, e1, mods)
        out = Ciphertext(c0, c1, lvl, a.scale * b.scale)
        return self.rescale(out) if rescale else out

    def square(self, a: Ciphertext, rescale: bool = True) -> Ciphertext:
        return self.multiply(a, a, rescale=rescale)

    def double(self, ct: Ciphertext) -> Ciphertext:
        """2*ct without scale change (cheap: residues doubled mod q)."""
        mods = self.pc.mods(self.chain(ct.level))
        two = torch.full_like(mods, 2)
        return Ciphertext(
            poly.mul_scalar(ct.c0, two, mods),
            poly.mul_scalar(ct.c1, two, mods),
            ct.level, ct.scale,
        )

    def _apply_galois(self, ct: Ciphertext, galois: int,
                      evk: EvalKey) -> Ciphertext:
        lvl = ct.level
        if self.use_engine:
            c0, c1 = self.engine.apply_galois(ct.c0, ct.c1, galois, evk, lvl)
            return Ciphertext(c0, c1, lvl, ct.scale)
        primes = self.chain(lvl)
        mods = self.pc.mods(primes)
        self.counters.rotation += 1
        c0r = poly.automorphism(ct.c0, primes, galois, self.pc)
        c1r = poly.automorphism(ct.c1, primes, galois, self.pc)
        d0, d1 = self.keyswitch_seed(c1r, evk, lvl)
        return Ciphertext(
            poly.add(c0r, d0, mods), d1, lvl, ct.scale
        )

    def rotate(self, ct: Ciphertext, steps: int) -> Ciphertext:
        steps = steps % self.params.num_slots
        if steps == 0:
            return ct
        g = self.pc.rns.galois_for_rotation(steps)
        return self._apply_galois(ct, g, self.keys.rot_key(steps))

    def conjugate(self, ct: Ciphertext) -> Ciphertext:
        g = self.pc.rns.galois_conjugate()
        return self._apply_galois(ct, g, self.keys.conj_key)

    # ------------------------- hoisted rotations -----------------------
    def hoist_digits(self, ct: Ciphertext) -> torch.Tensor | None:
        """ModUp of ct.c1 for reuse across hoisted blocks (engine only);
        None on the seed path, which has no digits-in entry point."""
        if not self.use_engine:
            return None
        return self.engine.modup(ct.c1, ct.level)

    def hoisted_rotation_sum(
        self, ct: Ciphertext, steps_list: list[int],
        pts: list[Plaintext] | None = None, rescale: bool = True,
        digits: torch.Tensor | None = None,
    ) -> Ciphertext:
        """sum_r pt_r * Rot(ct, r) with ONE ModUp and ONE ModDown.

        The ModUp of c1 is shared across all rotations; per-rotation IP
        results (and PModUp'd plaintext muls) are accumulated in the
        extended basis; a single ModDown closes the block.  ``digits``
        (from :meth:`hoist_digits`) skips even that ModUp.  Step-0 terms
        never touch the keyswitch machinery: they contribute a plain
        (pt-mul'd) base-domain add.
        """
        steps_norm = [s % self.params.num_slots for s in steps_list]
        nz = [i for i, s in enumerate(steps_norm) if s != 0]
        out = None
        if nz:
            nz_steps = [steps_norm[i] for i in nz]
            nz_pts = [pts[i] for i in nz] if pts is not None else None
            out = self._hoisted_block(ct, nz_steps, nz_pts, digits)
        out = self.add_zero_step_terms(out, ct, steps_norm, pts)
        if pts is not None and rescale:
            out = self.rescale(out)
        return out

    def add_zero_step_terms(self, out, ct: Ciphertext, steps_norm, pts):
        """Fold the identity (step-0) terms of a hoisted block into
        ``out`` as plain base-domain EWOs."""
        for i, s in enumerate(steps_norm):
            if s != 0:
                continue
            term = (self.pt_mul(ct, pts[i], rescale=False)
                    if pts is not None else ct)
            out = term if out is None else self.add(out, term)
        return out

    def _require_block_pts(self, pts, level: int) -> None:
        for pt in pts:
            if pt.level != level:
                raise ModulusChainMismatchError(
                    "hoisted block plaintexts must sit at the ciphertext "
                    "level", hint="re-encode the plaintexts at ct.level",
                    ct_level=level, pt_level=pt.level)

    def _hoisted_block(
        self, ct: Ciphertext, steps_list: list[int],
        pts: list[Plaintext] | None, digits: torch.Tensor | None,
    ) -> Ciphertext:
        """The keyswitch part of a hoisted block (nonzero steps only)."""
        lvl = ct.level
        if self.use_engine:
            gs = [self.pc.rns.galois_for_rotation(s) for s in steps_list]
            keys = [self.keys.rot_key(s) for s in steps_list]
            pm_ext = pm_base = None
            if pts is not None:
                self._require_block_pts(pts, lvl)
                pm_ext, pm_base = self._pm_stack(tuple(pts), lvl)
            c0, c1 = self.engine.hoisted_rotation_sum(
                ct.c0, ct.c1, gs, keys, lvl, pm_ext, pm_base, digits=digits,
            )
            out_scale = ct.scale * (pts[0].scale if pts is not None else 1.0)
            return Ciphertext(c0, c1, lvl, out_scale)
        if digits is not None:
            raise ValueError("digits sharing requires the engine path")
        return self._hoisted_rotation_sum_seed(ct, steps_list, pts,
                                               rescale=False)

    def _hoisted_rotation_sum_seed(
        self, ct: Ciphertext, steps_list: list[int],
        pts: list[Plaintext] | None = None, rescale: bool = True,
    ) -> Ciphertext:
        """Seed path: per-rotation automorphism/IP loops (reference)."""
        lvl = ct.level
        self._note_seed_ks(lvl, n_ip=len(steps_list))
        self.counters.rotation += len(steps_list)
        self.counters.hoisted_blocks += 1
        base = self.chain(lvl)
        ext = self.ext_basis(lvl)
        base_mods = self.pc.mods(base)
        ext_mods = self.pc.mods(ext)
        digits = self.modup_digits(ct.c1, lvl)
        if pts is not None:
            self._require_block_pts(pts, lvl)

        acc0e = acc1e = None
        base0 = None
        for i, steps in enumerate(steps_list):
            steps = steps % self.params.num_slots
            g = self.pc.rns.galois_for_rotation(steps)
            key = self.keys.rot_key(steps)
            # sigma_r commutes with ModUp (coefficient-wise BConv).
            dig_r = [
                poly.automorphism(d, ext, g, self.pc) for d in digits
            ]
            ks0, ks1 = self.inner_product(dig_r, key, lvl)
            c0r = poly.automorphism(ct.c0, base, g, self.pc)
            if pts is not None:
                pm_ext = self._pmodup(pts[i], lvl)
                ks0 = poly.mul(ks0, pm_ext, ext_mods)
                ks1 = poly.mul(ks1, pm_ext, ext_mods)
                c0r = poly.mul(c0r, pts[i].m[: lvl + 1], base_mods)
            acc0e = ks0 if acc0e is None else poly.add(acc0e, ks0, ext_mods)
            acc1e = ks1 if acc1e is None else poly.add(acc1e, ks1, ext_mods)
            base0 = c0r if base0 is None else poly.add(base0, c0r, base_mods)

        d0 = poly.moddown(acc0e, lvl, self.pc)
        d1 = poly.moddown(acc1e, lvl, self.pc)
        out_scale = ct.scale * (pts[0].scale if pts is not None else 1.0)
        out = Ciphertext(
            poly.add(base0, d0, base_mods), d1, lvl, out_scale
        )
        if pts is not None and rescale:
            out = self.rescale(out)
        return out

    def _pmodup(self, pt: Plaintext, level: int) -> torch.Tensor:
        """PModUp: EXACT lift of a plaintext to the extended basis.

        Unlike ciphertext ModUp, the lift must be exact (centered CRT):
        the approximate-FBC +k*Q error would multiply the keyswitch noise.
        Plaintext coefficients are small, so the exact lift is a centered
        lift + reduction.  Cached on the plaintext per level.
        """
        if level in pt.pmodup_cache:
            return pt.pmodup_cache[level]
        base = self.chain(level)
        ext = self.ext_basis(level)
        coeff = poly.intt(pt.m[: level + 1], base, self.pc)
        centered = centered_crt(coeff.cpu().numpy(), base)
        new = tuple(p for p in ext if p not in base)
        lifted = np.stack(
            [(centered % q).astype(np.int64) for q in new]
        )
        conv_eval = poly.ntt(self.pc.tensor(lifted), new, self.pc)
        out = torch.cat([pt.m[: level + 1], conv_eval], dim=0)
        pt.pmodup_cache[level] = out
        return out

    def _pm_stack(self, pts: tuple[Plaintext, ...], level: int):
        """(pm_ext, pm_base) stacks for a hoisted block, cached per
        (pts, level) like the engine's evk group tensors."""
        key = (tuple(id(pt) for pt in pts), level)
        if key not in self._pm_stacks:
            pm_ext = torch.stack([self._pmodup(pt, level) for pt in pts])
            pm_base = torch.stack([pt.m[: level + 1] for pt in pts])
            while len(self._pm_stacks) >= self._pm_stacks_max:
                self._pm_stacks.pop(next(iter(self._pm_stacks)))
            self._pm_stacks[key] = (pts, pm_ext, pm_base)
        return self._pm_stacks[key][1:]
