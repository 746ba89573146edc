"""Homomorphic linear transforms: diagonal method + BSGS.

y = A @ z for an (nh x nh) complex matrix A is computed as
    y = sum_d diag_d(A) * rot_d(z)
over the non-zero generalized diagonals d.  BSGS splits d = i*bs + j
(Eq. (3) of the paper) — exactly the two-serial-PKB structure HERO fuses.
Both paths use the hoisted rotation-sum primitive (one ModUp per block).

Both functions only touch the context's public op API, so they run
eagerly on a ``CKKSContext`` or trace through the compiled runtime's
``repro_torch.runtime.compile.TraceContext`` unchanged — the compiled path
additionally shares one ModUp across all baby-step blocks and, with
``fusion=True``, collapses baby x giant into a single hoisted block.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.ckks import CKKSContext, Ciphertext


def matrix_diagonals(A: np.ndarray, tol: float = 1e-12) -> dict[int, np.ndarray]:
    """Generalized diagonals diag_d[i] = A[i, (i+d) mod nh], nonzero only.

    Each diagonal is one gather (exact, so the values equal the JAX
    package's element loop)."""
    nh = A.shape[0]
    idx = np.arange(nh)
    out = {}
    for d in range(nh):
        diag = A[idx, (idx + d) % nh]
        if np.abs(diag).max() > tol:
            out[d] = diag
    return out


def matvec_diag(ctx: CKKSContext, ct: Ciphertext,
                diags: dict[int, np.ndarray], rescale: bool = True) -> Ciphertext:
    """Single-PKB evaluation: one hoisted block over all diagonals."""
    steps = sorted(diags)
    pts = [ctx.encode(diags[d], level=ct.level) for d in steps]
    return ctx.hoisted_rotation_sum(ct, steps, pts, rescale=rescale)


def matvec_bsgs(ctx: CKKSContext, ct: Ciphertext,
                diags: dict[int, np.ndarray], bs: int,
                rescale: bool = True) -> Ciphertext:
    """BSGS evaluation: baby-step PKB (bs rotations, hoisted) feeding a
    giant-step PKB (<=gs rotations, hoisted).

    y = sum_i rot_{i*bs}( sum_j rot_{-i*bs}(diag_{i*bs+j}) * rot_j(z) )
    """
    nh = ctx.params.num_slots
    groups: dict[int, dict[int, np.ndarray]] = {}
    for d, v in diags.items():
        groups.setdefault(d // bs, {})[d % bs] = v

    inner_cts: list[Ciphertext] = []
    giant_steps: list[int] = []
    for i, inner in sorted(groups.items()):
        steps = sorted(inner)
        pts = [
            ctx.encode(np.roll(inner[j], i * bs), level=ct.level)
            for j in steps
        ]
        # Baby-step PKB: shared ModUp across the j-rotations of this group.
        inner_cts.append(
            ctx.hoisted_rotation_sum(ct, steps, pts, rescale=False)
        )
        giant_steps.append((i * bs) % nh)

    # Giant-step PKB: rotate each combined result once and sum.
    out = None
    for g, ict in zip(giant_steps, inner_cts):
        rot = ctx.rotate(ict, g)
        out = rot if out is None else ctx.add(out, rot)
    return ctx.rescale(out) if rescale else out


def matvec_plain(A: np.ndarray, z: np.ndarray) -> np.ndarray:
    return A @ z
