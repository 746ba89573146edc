"""Homomorphic polynomial evaluation in the Chebyshev basis.

Used by EvalMod in bootstrapping (scaled-sine approximation) and by HELR
(sigmoid).  Chebyshev recurrences keep coefficients O(1) on [-1, 1]
(power-basis coefficients of sine approximants blow up exponentially).

Scale management: every ciphertext carries an exact float scale; all
cross-term additions go through ``align`` which mod-switches and
scale-corrects via a constant multiplication.

All helpers take the context as a parameter and only use its public op
API (encode/pt_mul/multiply/double/level_down/...), so they run
unchanged against either the functional ``CKKSContext`` or the
runtime's symbolic ``repro_torch.runtime.compile.TraceContext`` — the same
source compiles through the DFG runtime and executes eagerly.  The
compiled bootstrap (``core.bootstrap.Bootstrapper.compile``) traces the
two EvalMod Chebyshev branches through here; every ``mul_const`` /
``align`` scale decision is recorded on the nodes and replayed by the
executor, which is what keeps that pipeline bit-exact end to end.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.ckks import CKKSContext, Ciphertext


def mul_const(ctx: CKKSContext, ct: Ciphertext, c: complex,
              target_scale: float) -> Ciphertext:
    """ct * c with the product's post-rescale scale forced to target_scale."""
    q_last = ctx.chain(ct.level)[-1]
    pt_scale = target_scale * q_last / ct.scale
    pt = ctx.encode(
        np.full(ctx.params.num_slots, complex(c)),
        level=ct.level, scale=pt_scale,
    )
    out = ctx.pt_mul(ct, pt, rescale=True)
    out.scale = target_scale  # exact by construction
    return out


def add_const(ctx: CKKSContext, ct: Ciphertext, c: complex) -> Ciphertext:
    pt = ctx.encode(
        np.full(ctx.params.num_slots, complex(c)),
        level=ct.level, scale=ct.scale,
    )
    return ctx.pt_add(ct, pt)


def align(ctx: CKKSContext, ct: Ciphertext, level: int,
          scale: float) -> Ciphertext:
    """Bring ct to (level, scale): mod-switch down + constant-mul fixup."""
    assert level <= ct.level
    if abs(ct.scale / scale - 1.0) < 1e-12:
        return ctx.level_down(ct, level)
    if level == ct.level:
        # need a scale fix but no level to burn — multiply and land lower
        raise ValueError("cannot fix scale without a spare level")
    ct = ctx.level_down(ct, level + 1)
    return ctx.level_down(mul_const(ctx, ct, 1.0, scale), level)


class ChebyshevEvaluator:
    """Builds T_k(x) ciphertexts on demand and combines them."""

    def __init__(self, ctx: CKKSContext, ct_x: Ciphertext):
        self.ctx = ctx
        self.ct = ct_x
        self.T: dict[int, Ciphertext] = {1: ct_x}

    def get(self, k: int) -> Ciphertext:
        if k in self.T:
            return self.T[k]
        ctx = self.ctx
        if k % 2 == 0:
            half = self.get(k // 2)
            sq = ctx.multiply(half, half, rescale=True)
            out = add_const(ctx, ctx.double(sq), -1.0)
        else:
            a, b = (k + 1) // 2, (k - 1) // 2
            ta, tb = self.get(a), self.get(b)
            lvl = min(ta.level, tb.level)
            if abs(ta.scale / tb.scale - 1.0) > 1e-9:
                lvl -= 1
                scale = ctx.params.scale
                ta = align(ctx, ta, lvl, scale)
                tb = align(ctx, tb, lvl, scale)
            else:
                ta, tb = ctx.level_down(ta, lvl), ctx.level_down(tb, lvl)
            prod = ctx.multiply(ta, tb, rescale=True)
            prod2 = ctx.double(prod)
            # T_a*T_b*2 - T_{a-b};  a-b == 1 here.
            t1 = self.get(1)
            t1a = align(ctx, t1, prod2.level, prod2.scale)
            out = ctx.sub(prod2, t1a)
        self.T[k] = out
        return out


def eval_chebyshev(ctx: CKKSContext, ct: Ciphertext,
                   coeffs: np.ndarray, tol: float = 1e-13,
                   ev: ChebyshevEvaluator | None = None) -> Ciphertext:
    """sum_k coeffs[k] * T_k(ct) for x in [-1, 1].

    ``ev``: a shared :class:`ChebyshevEvaluator` whose T_k cache is
    reused (and extended) instead of rebuilding the basis — the BSGS
    evaluation routes its sub-polynomials through here.
    """
    d = len(coeffs) - 1
    if ev is None:
        ev = ChebyshevEvaluator(ctx, ct)
    needed = [k for k in range(1, d + 1) if abs(coeffs[k]) > tol]
    for k in needed:
        ev.get(k)
    min_lvl = min(ev.T[k].level for k in needed) - 1
    target_scale = ctx.params.scale
    acc = None
    for k in needed:
        tk = ev.T[k]
        tk = ctx.level_down(tk, min_lvl + 1)
        term = mul_const(ctx, tk, complex(coeffs[k]), target_scale)
        term = ctx.level_down(term, min_lvl)
        acc = term if acc is None else ctx.add(acc, term)
    return add_const(ctx, acc, complex(coeffs[0]))


# ---------------------- BSGS (Paterson-Stockmeyer) -----------------------

def _trim_degree(c, tol: float) -> int:
    d = len(c) - 1
    while d > 0 and abs(c[d]) <= tol:
        d -= 1
    return d


def cheb_divmod(c: np.ndarray, g: int) -> tuple[np.ndarray, np.ndarray]:
    """Chebyshev-basis division: c = q * T_g + r with deg r < g.

    Uses 2*T_g*T_i = T_{g+i} + T_{g-i}: q_0 = c_g, q_i = 2*c_{g+i}, and
    r_{g-i} = c_{g-i} - c_{g+i}.  Requires deg(c) <= 2g (guaranteed when
    g is the largest power-of-two giant step below deg(c))."""
    d = len(c) - 1
    assert g <= d <= 2 * g, (d, g)
    q = np.zeros(d - g + 1, dtype=complex)
    r = np.array(c[:g], dtype=complex)
    q[0] = c[g]
    for i in range(1, d - g + 1):
        q[i] = 2 * c[g + i]
        r[g - i] -= c[g + i]
    return q, r


def eval_chebyshev_bsgs(ctx: CKKSContext, ct: Ciphertext,
                        coeffs: np.ndarray, bs: int | None = None,
                        tol: float = 1e-13) -> Ciphertext:
    """sum_k coeffs[k] * T_k(ct) via baby-step/giant-step products.

    Paterson-Stockmeyer in the Chebyshev basis: only T_1..T_bs and the
    giant steps T_{2^j * bs} are materialized (``bs`` defaults to the
    power of two nearest sqrt(deg)); the polynomial is peeled into
    quotient/remainder chains by :func:`cheb_divmod`, so the evaluation
    becomes a SUM of giant-step products q_i(x) * T_{g_i}(x) — O(sqrt d)
    CMults instead of the O(d) of the dense T_k recurrence.

    Every product of one closure is built at a common level WITHOUT
    rescaling (scales pinned to scale^2 exactly), summed, and closed by
    ONE rescale: traced through the compiled runtime this is a
    sum-of-CMult closure, which ``runtime.lower`` turns into a
    ``MultiRelinStep`` — all relin IPs accumulate in the extended basis
    and ONE ModDown closes the block (``exact=False``).
    """
    d = _trim_degree(coeffs, tol)
    if bs is None:
        bs = 1 << max(1, round(math.log2(math.sqrt(d + 1))))
    if d < max(bs, 2) or d < 4:
        return eval_chebyshev(ctx, ct, coeffs[: d + 1], tol=tol)
    ev = ChebyshevEvaluator(ctx, ct)
    g_top = bs
    while g_top * 2 <= d:
        g_top *= 2
    for g in [bs << j for j in range((g_top // bs).bit_length())]:
        ev.get(g)                     # giants built shallow-first
    return _ps_eval(ctx, ev, np.asarray(coeffs[: d + 1], dtype=complex),
                    bs, tol)


def _ps_eval(ctx: CKKSContext, ev: ChebyshevEvaluator, c: np.ndarray,
             bs: int, tol: float) -> Ciphertext:
    """One recursion level of the BSGS evaluation: peel giant-step
    products off ``c``, evaluate the quotients (recursively), and close
    products + remainder terms with a single rescale."""
    d = _trim_degree(c, tol)
    if d < bs:
        return eval_chebyshev(ctx, ev.ct, c[: d + 1], tol=tol, ev=ev)

    prods: list[tuple[np.ndarray, int]] = []
    rem = np.array(c[: d + 1], dtype=complex)
    while _trim_degree(rem, tol) >= bs:
        dr = _trim_degree(rem, tol)
        g = bs
        while g * 2 <= dr:
            g *= 2
        q, rem = cheb_divmod(rem[: dr + 1], g)
        prods.append((q, g))

    # constant quotients need no CMult — they are plain pt-mul terms
    pairs: list[tuple[Ciphertext, int]] = []
    direct: list[tuple[complex, int]] = []
    for q, g in prods:
        if _trim_degree(q, tol) == 0:
            if abs(q[0]) > tol:
                direct.append((complex(q[0]), g))
            continue
        pairs.append((_ps_eval(ctx, ev, q, bs, tol), g))
    direct += [(complex(rem[b]), b)
               for b in range(1, _trim_degree(rem, tol) + 1)
               if abs(rem[b]) > tol]
    # one closure: every product CMult and pt-mul passthrough lands at
    # the same level and the exact scale^2, summed, then ONE rescale
    S = ctx.params.scale
    P = S * S
    lvls = [min(qe.level - 1, ev.get(g).level) for qe, g in pairs]
    lvls += [ev.get(k).level for _, k in direct]
    lvl = min(lvls)
    nh = ctx.params.num_slots
    acc = None
    for qe, g in pairs:
        tg = ctx.level_down(ev.get(g), lvl)
        qel = align(ctx, qe, lvl, P / tg.scale)
        prod = ctx.multiply(qel, tg, rescale=False)
        prod.scale = P                # exact by construction
        acc = prod if acc is None else ctx.add(acc, prod)
    for coef, k in direct:
        tk = ctx.level_down(ev.get(k), lvl)
        pt = ctx.encode(np.full(nh, complex(coef)), level=lvl,
                        scale=P / tk.scale)
        term = ctx.pt_mul(tk, pt, rescale=False)
        term.scale = P
        acc = term if acc is None else ctx.add(acc, term)
    out = ctx.rescale(acc)
    if abs(rem[0]) > tol:
        out = add_const(ctx, out, complex(rem[0]))
    return out


def eval_poly_horner(ctx: CKKSContext, ct: Ciphertext,
                     coeffs: np.ndarray) -> Ciphertext:
    """Power-basis Horner — for short, well-conditioned polynomials
    (e.g. HELR's degree-3/5/7 sigmoid).  acc <- acc*x + c_k."""
    acc = None
    for c in coeffs[::-1]:
        if acc is None:
            acc = ("const", complex(c))
            continue
        if isinstance(acc, tuple):
            acc = mul_const(ctx, ct, acc[1], ctx.params.scale)
        else:
            lvl = min(acc.level, ct.level)
            if acc.level != lvl or abs(acc.scale - ctx.params.scale) > 1e-9:
                acc = align(ctx, acc, lvl - 1, ctx.params.scale)
                lvl -= 1
            acc = ctx.multiply(acc, ctx.level_down(ct, lvl), rescale=True)
        acc = add_const(ctx, acc, complex(c))
    return acc


def chebyshev_coeffs(fn, degree: int):
    """Chebyshev interpolation of fn on [-1, 1]."""
    k = np.arange(degree + 1)
    x = np.cos(np.pi * (k + 0.5) / (degree + 1))
    return np.polynomial.chebyshev.chebfit(x, fn(x), degree)
