"""CKKS bootstrapping: ModRaise -> CoeffToSlot -> EvalMod -> SlotToCoeff.

Follows the FFT-like factorized bootstrapping of Chen-Chillotti-Song [6]
(the paper's configuration: "FFT-like bootstrapping with three stages").

Factorization trick: the special FFT splits into radix-2 stage matrices
with exactly 3 generalized diagonals {0, +gap, -gap}.  The bit-reversal
permutation is NOT applied homomorphically: C2S (DIF direction) leaves
slots in bit-reversed order, EvalMod is slot-wise (order-agnostic), and
S2C (DIT direction) consumes bit-reversed input — the permutations cancel.

Stages are merged into ``n_groups`` (default 3) dense products whose
diagonals are evaluated as BSGS matvecs (shape-derived baby-step block
size unless ``bsgs_bs`` overrides it) — these are precisely the serial
PKB chains of the paper's bootstrapping DFG (Sec. IV).

Every pipeline method only touches the context's public op API, so the
same source runs EITHER eagerly on a ``CKKSContext`` OR symbolically
under the compiled runtime's ``repro_torch.runtime.compile.TraceContext``:
:meth:`Bootstrapper.compile` traces the full ModRaise -> C2S -> re/im
split -> EvalMod x2 -> merge -> S2C pipeline and lowers it through
``repro_torch.runtime`` (baby-step blocks share one ModUp per anchor; with
``exact=False`` the giant-step rotations of each matvec close with ONE
ModDown — see ``runtime.lower.MultiHoistedStep``).

A copy of the JAX package's ``core/bootstrap.py`` on the port's
``CKKSContext``.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core import linear
from repro_torch.core.ckks import CKKSContext, Ciphertext
from repro_torch.core.polyeval import (
    chebyshev_coeffs, eval_chebyshev, eval_chebyshev_bsgs,
)


# --------------------- stage matrices (numpy, exact) ---------------------

def _c2s_stage_diags(enc, ln: int) -> dict[int, np.ndarray]:
    """Diagonals of one fft_special_inv stage (block length ln)."""
    nh, M = enc.Nh, enc.M
    lenh, lenq = ln >> 1, ln << 2
    d0 = np.zeros(nh, dtype=complex)
    dp = np.zeros(nh, dtype=complex)   # offset +lenh
    dm = np.zeros(nh, dtype=complex)   # offset -lenh (== nh-lenh)
    idx = (lenq - (enc.rot_group[:lenh] % lenq)) * (M // lenq)
    w = enc.ksi[idx]
    for t in range(nh):
        pos = t % ln
        if pos < lenh:
            d0[t] = 1.0
            dp[t] = 1.0
        else:
            j = pos - lenh
            d0[t] = -w[j]
            dm[t] = w[j]
    return _merge_diags(nh, d0, dp, dm, lenh)


def _merge_diags(nh, d0, dp, dm, lenh):
    """Offsets +lenh and -lenh coincide when ln == nh — merge, don't clobber."""
    out = {0: d0}
    po, mo = lenh, (nh - lenh) % nh
    if po == mo:
        out[po] = dp + dm
    else:
        out[po] = dp
        out[mo] = dm
    return out


def _s2c_stage_diags(enc, ln: int) -> dict[int, np.ndarray]:
    """Diagonals of one fft_special stage (block length ln)."""
    nh, M = enc.Nh, enc.M
    lenh, lenq = ln >> 1, ln << 2
    d0 = np.zeros(nh, dtype=complex)
    dp = np.zeros(nh, dtype=complex)
    dm = np.zeros(nh, dtype=complex)
    idx = (enc.rot_group[:lenh] % lenq) * (M // lenq)
    w = enc.ksi[idx]
    for t in range(nh):
        pos = t % ln
        if pos < lenh:
            d0[t] = 1.0
            dp[t] = w[pos]
        else:
            j = pos - lenh
            d0[t] = -w[j]
            dm[t] = 1.0
    return _merge_diags(nh, d0, dp, dm, lenh)


def _diags_to_matrix(diags: dict[int, np.ndarray], nh: int) -> np.ndarray:
    A = np.zeros((nh, nh), dtype=complex)
    for d, v in diags.items():
        for t in range(nh):
            A[t, (t + d) % nh] = v[t]
    return A


def _group(mats: list[np.ndarray], n_groups: int) -> list[np.ndarray]:
    """Compose consecutive stage matrices into n_groups products.

    mats are in APPLICATION order (mats[0] applied first)."""
    n = len(mats)
    sizes = [n // n_groups + (1 if i < n % n_groups else 0)
             for i in range(n_groups)]
    out, i = [], 0
    for s in sizes:
        g = mats[i]
        for m in mats[i + 1 : i + s]:
            g = m @ g
        out.append(g)
        i += s
    return out


def auto_bsgs_bs(offsets, nh: int) -> int:
    """Shape-derived baby-step block size for diagonal offsets.

    The merged FFT stage matrices have diagonals at MULTIPLES of a gap
    (the radix stride), so the d = i*bs + j split of Eq. (3) only
    exposes shared baby steps when bs is a multiple of that stride: we
    take bs = g * 2^floor(log2(sqrt(m))) where g = gcd of the (nonzero)
    offsets and the slot count and m the diagonal count — the largest
    power-of-two baby count not above sqrt(m), which minimizes
    baby + giant rotations.  Returns 0 (dense single hoisted block) when
    the matrix is too sparse for the split to expose any giant-step
    structure."""
    offs = [d % nh for d in offsets if d % nh]
    if len(offsets) < 4 or not offs:
        return 0
    g = math.gcd(nh, *offs)
    n_baby = 1 << (math.isqrt(len(offsets)).bit_length() - 1)
    return g * n_baby if n_baby >= 2 else 0


class Bootstrapper:
    """``bsgs_bs``: baby-step block size for the stage matvecs.  ``None``
    (default) derives it per matrix via :func:`auto_bsgs_bs`; ``0`` forces
    the dense single-block ``matvec_diag`` path; any other value is used
    as-is whenever the matrix's diagonal offsets span more than one
    giant-step group (``d // bs``) — otherwise the split would expose no
    giant-step structure and the dense path is taken."""

    def __init__(self, ctx: CKKSContext, n_groups: int = 3,
                 mod_K: int = 6, cheb_degree: int = 40,
                 bsgs_bs: int | None = None,
                 cheb_bs: int | None = None):
        self.ctx = ctx
        enc = ctx.encoder
        nh = enc.Nh
        self.n_groups = n_groups
        self.mod_K = mod_K
        self.cheb_degree = cheb_degree
        self.bsgs_bs = bsgs_bs
        # EvalMod polynomial evaluation: ``None`` (default) evaluates the
        # Chebyshev approximant with giant-step products
        # (``polyeval.eval_chebyshev_bsgs``, O(sqrt d) CMults whose sums
        # compile to merged-ModDown relin blocks); ``0`` forces the dense
        # T_k recurrence; any other value overrides the baby-step count.
        self.cheb_bs = cheb_bs

        # C2S: fft_special_inv stages applied ln=Nh..2, bitrev omitted,
        # 1/nh folded into the last group.
        lns = [1 << s for s in range(enc.Nh.bit_length() - 1, 0, -1)]
        c2s_mats = [
            _diags_to_matrix(_c2s_stage_diags(enc, ln), nh) for ln in lns
        ]
        self.c2s_groups = _group(c2s_mats, n_groups)
        self.c2s_groups[-1] = self.c2s_groups[-1] / nh

        # S2C: fft_special stages applied ln=2..Nh on bit-reversed input.
        lns_f = [1 << s for s in range(1, enc.Nh.bit_length())]
        s2c_mats = [
            _diags_to_matrix(_s2c_stage_diags(enc, ln), nh) for ln in lns_f
        ]
        self.s2c_groups = _group(s2c_mats, n_groups)

        # EvalMod: F(x) = sin(2*pi*x)/(2*pi) on [-K-1/2, K+1/2].
        K = mod_K + 0.5
        self.eval_range = K
        self.cheb = chebyshev_coeffs(
            lambda t: np.sin(2 * np.pi * K * t) / (2 * np.pi), cheb_degree
        )

    # ------------------------------------------------------------------
    def mod_raise(self, ct: Ciphertext) -> Ciphertext:
        """Lift a level-0 ciphertext to the full chain (exact, coeffs < q0)."""
        return CKKSContext.mod_raise(self.ctx, ct)

    def _matvec(self, ctx, ct: Ciphertext, mat: np.ndarray) -> Ciphertext:
        diags = linear.matrix_diagonals(mat)
        bs = self.bsgs_bs
        if bs is None:
            bs = auto_bsgs_bs(sorted(diags), ctx.params.num_slots)
        if bs and len({d // bs for d in diags}) > 1:
            return linear.matvec_bsgs(ctx, ct, diags, bs)
        return linear.matvec_diag(ctx, ct, diags)

    def coeff_to_slot(self, ct: Ciphertext, ctx=None) -> Ciphertext:
        ctx = self.ctx if ctx is None else ctx
        for g in self.c2s_groups:
            ct = self._matvec(ctx, ct, g)
        return ct

    def slot_to_coeff(self, ct: Ciphertext, ctx=None) -> Ciphertext:
        ctx = self.ctx if ctx is None else ctx
        for g in self.s2c_groups:
            ct = self._matvec(ctx, ct, g)
        return ct

    def eval_mod(self, ct: Ciphertext, q0_over_scale: float,
                 ctx=None) -> Ciphertext:
        """EvalMod on real-valued slots: x = m/q0 + I -> ~m/q0."""
        ctx = self.ctx if ctx is None else ctx
        nh = ctx.params.num_slots
        # normalize to [-1, 1]: u = x / K
        pre = ctx.encode(
            np.full(nh, 1.0 / (self.eval_range * q0_over_scale)),
            level=ct.level,
        )
        u = ctx.pt_mul(ct, pre, rescale=True)
        if self.cheb_bs == 0:
            out = eval_chebyshev(ctx, u, self.cheb)
        else:
            out = eval_chebyshev_bsgs(ctx, u, self.cheb, bs=self.cheb_bs)
        post = ctx.encode(np.full(nh, q0_over_scale), level=out.level)
        return ctx.pt_mul(out, post, rescale=True)

    # ------------------------------------------------------------------
    def bootstrap(self, ct: Ciphertext, ctx=None) -> Ciphertext:
        """Full pipeline.  Input at level 0, output at a higher level.

        ``ctx`` defaults to the eager context; passing the runtime's
        ``TraceContext`` records the same pipeline as a DFG instead (see
        :meth:`compile`)."""
        ctx = self.ctx if ctx is None else ctx
        p = ctx.params
        nh = p.num_slots
        q0 = p.q_primes[0]

        raised = ctx.mod_raise(ct)
        t = self.coeff_to_slot(raised, ctx)

        # split real/imag: re = (t + conj t)/2, im = (t - conj t)/(2i)
        tc = ctx.conjugate(t)
        half = ctx.encode(np.full(nh, 0.5), level=t.level)
        re = ctx.pt_mul(ctx.add(t, tc), half, rescale=True)
        mhalf_i = ctx.encode(np.full(nh, -0.5j), level=t.level)
        im = ctx.pt_mul(ctx.sub(t, tc), mhalf_i, rescale=True)

        q0_over_scale = q0 / ct.scale
        re_m = self.eval_mod(re, q0_over_scale, ctx)
        im_m = self.eval_mod(im, q0_over_scale, ctx)

        lvl = min(re_m.level, im_m.level)
        i_pt = ctx.encode(np.full(nh, 1.0j), level=lvl, scale=1.0)
        im_i = ctx.pt_mul(ctx.level_down(im_m, lvl), i_pt, rescale=False)
        merged = ctx.add(ctx.level_down(re_m, lvl), im_i)

        return self.slot_to_coeff(merged, ctx)

    # ------------------------------------------------------------------
    def compile(self, input_scale: float | None = None,
                fusion: bool = False, exact: bool = True):
        """Trace the full bootstrap pipeline and lower it through the
        compiled runtime (``repro_torch.runtime``).

        The traced program takes one level-0 input tagged ``"ct"`` (its
        scale must match ``input_scale``, default the params scale) and
        produces one output tagged ``"out"``.  ``exact=True`` (default)
        keeps the lowering bit-exact with :meth:`bootstrap`; ``exact=
        False`` additionally lowers the multi-anchor giant-step PKBs of
        every BSGS stage to single-ModDown blocks (numerically close but
        not bit-identical — the accumulation crosses ModDown boundaries).
        """
        from repro_torch.runtime import TraceContext, compile_program

        params = self.ctx.params
        scale = params.scale if input_scale is None else input_scale
        tc = TraceContext(params)
        h = tc.input("ct", level=0, scale=scale)
        out = self.bootstrap(h, ctx=tc)
        tc.output(out, "out")
        return compile_program(tc, fusion=fusion, exact=exact)
