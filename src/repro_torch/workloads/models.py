"""Encrypted-inference model zoo: packed dense layers + polynomial acts.

The paper's end-to-end claims (Table IV) rest on application workloads,
not bootstrapping alone — this module defines the models those
workloads run.  A :class:`Dense` layer is a diagonally-banded weight
matrix evaluated with the BSGS matvec from :mod:`repro_torch.core.linear`
(baby-step PKB feeding a giant-step PKB, Eq. (3)), an optional bias
added as a plaintext at the ciphertext's exact (level, scale), and an
optional activation evaluated as a Chebyshev interpolant through
:func:`repro_torch.core.polyeval.eval_chebyshev_bsgs` (Paterson-Stockmeyer,
O(sqrt d) CMults).  Because every op goes through the context's public
API, the SAME layer code runs eagerly on a ``CKKSContext`` or traces
through ``runtime.TraceContext``.

Magnitude discipline: activations are interpolated on [-1, 1], so
weights are row-normalized to a configurable inf-norm ``gain`` and
sample inputs are bounded; the bootstrap-shaped MLP additionally keeps
every intermediate at |m| ~ 1e-2 because EvalMod's sine approximation
is only linear near 0 (m/q0 must stay small — see ``core/bootstrap.py``).

A port of the JAX package's ``workloads/models.py`` that works at the
paper's nh = 2^15 slots: a :class:`Dense` layer holds its generalized
diagonals (offset -> (nh,) array), never the dense nh x nh matrix (8 GiB
at nh = 2^15), and its plaintext reference is the banded product
``y = sum_d diag_d * roll(x, -d)``.  The constructors keep the JAX
package's signatures and rng draw order, and the diagonals equal its
``linear.matrix_diagonals(_band_matrix(...))`` bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import linear
from repro_torch.core.polyeval import chebyshev_coeffs, eval_chebyshev_bsgs

# Rows of the dense band summed at once by ``_row_abs_sums``: 2^21 words
# (16 MiB) a block.
_BLOCK_WORDS = 1 << 21


@dataclasses.dataclass(frozen=True)
class Activation:
    """A pointwise nonlinearity and its Chebyshev interpolant."""

    name: str
    fn: Callable[[np.ndarray], np.ndarray]
    degree: int
    coeffs: np.ndarray = dataclasses.field(repr=False, default=None)

    def __post_init__(self):
        if self.coeffs is None:
            object.__setattr__(
                self, "coeffs", chebyshev_coeffs(self.fn, self.degree))


def sigmoid4(degree: int = 15) -> Activation:
    """sigmoid(4t) on [-1, 1] — the logistic-regression link (HELR-style
    rescaled argument so the transition is visible inside the
    interpolation interval).  Chebyshev error: ~2e-3 at degree 7,
    ~6e-6 at degree 15."""
    return Activation("sigmoid4", lambda t: 1.0 / (1.0 + np.exp(-4.0 * t)),
                      degree)


def scaled_tanh(scale: float = 0.1, degree: int = 7) -> Activation:
    """scale * tanh(t): an odd activation whose output magnitude stays
    ~``scale`` — the bootstrap-friendly nonlinearity (post-activation
    messages must sit in EvalMod's near-linear sine region)."""
    return Activation(f"tanh*{scale:g}",
                      lambda t, s=scale: s * np.tanh(t), degree)


def banded_matvec(diags: dict[int, np.ndarray], x: np.ndarray) -> np.ndarray:
    """``A @ x`` of the matrix with generalized diagonals ``diags``:
    ``sum_d diag_d * roll(x, -d)``, in ascending offset order."""
    return sum(diags[d] * np.roll(x, -d) for d in sorted(diags))


@dataclasses.dataclass
class Dense:
    """One packed dense layer: diagonal matvec -> +bias -> activation."""

    name: str
    diags: dict[int, np.ndarray]      # offset -> (nh,) real, nonzero only
    bias: np.ndarray | None = None    # (nh,) real
    act: Activation | None = None
    bs: int = 4                       # BSGS baby-step block size

    @property
    def nh(self) -> int:
        return len(next(iter(self.diags.values())))

    def apply(self, ctx, ct):
        """Evaluate the layer on any context exposing the public op API
        (eager ``CKKSContext`` or ``runtime.TraceContext``)."""
        giants = {d // self.bs for d in self.diags}
        if self.bs > 0 and len(giants) > 1:
            out = linear.matvec_bsgs(ctx, ct, self.diags, bs=self.bs)
        else:
            out = linear.matvec_diag(ctx, ct, self.diags)
        if self.bias is not None:
            # pt_add keeps ct.scale and adds pt.m raw: the bias MUST be
            # encoded at the ciphertext's exact (level, scale).
            pt = ctx.encode(self.bias, level=out.level, scale=out.scale)
            out = ctx.pt_add(out, pt)
        if self.act is not None:
            out = eval_chebyshev_bsgs(ctx, out, self.act.coeffs)
        return out

    def reference(self, x: np.ndarray) -> np.ndarray:
        y = banded_matvec(self.diags, x)
        if self.bias is not None:
            y = y + self.bias
        return self.act.fn(np.real(y)) if self.act is not None else y


@dataclasses.dataclass
class Workload:
    """An encrypted-inference application: a stack of Dense layers plus
    the plaintext reference and a seeded input sampler."""

    name: str
    layers: list[Dense]
    input_mag: float = 1.0            # sample() magnitude bound
    tolerance: float = 5e-3           # decrypt-accuracy floor (gated)

    @property
    def nh(self) -> int:
        return self.layers[0].nh

    def apply(self, ctx, ct):
        for layer in self.layers:
            ct = layer.apply(ctx, ct)
        return ct

    def reference(self, x: np.ndarray) -> np.ndarray:
        for layer in self.layers:
            x = layer.reference(x)
        return np.real(x)

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        return rng.uniform(-1.0, 1.0, self.nh) * self.input_mag


def _row_abs_sums(nh: int, band: dict[int, np.ndarray],
                  block_words: int = _BLOCK_WORDS) -> np.ndarray:
    """``np.abs(A).sum(axis=1)`` of the nh x nh matrix with the given
    generalized diagonals, built and summed a block of rows at a time:
    each row is summed over the same nh words in the same order as the
    dense matrix's row, so the sums are equal bit for bit, and no
    nh x nh array exists."""
    rows = max(1, block_words // nh)
    out = np.empty(nh)
    for r0 in range(0, nh, rows):
        idx = np.arange(r0, min(nh, r0 + rows))
        blk = np.zeros((len(idx), nh))
        for d, vals in band.items():
            blk[idx - r0, (idx + d) % nh] = vals[idx]
        out[idx] = np.abs(blk).sum(axis=1)
    return out


def _band_diagonals(nh: int, offsets, rng: np.random.Generator,
                    gain: float) -> dict[int, np.ndarray]:
    """The generalized diagonals of the JAX package's ``_band_matrix``:
    a random matrix supported on the given diagonals, row-normalized so
    the inf-norm is exactly ``gain`` (keeps matvec outputs inside the
    activation's interpolation interval).  One ``uniform`` draw per
    offset, in order; an offset that wraps onto an earlier one
    overwrites it, as the dense assignment does."""
    band: dict[int, np.ndarray] = {}
    for d in offsets:
        band[d % nh] = rng.uniform(-1.0, 1.0, nh)
    norm = gain / _row_abs_sums(nh, band)
    diags = {d: band[d] * norm for d in sorted(band)}
    return {d: v for d, v in diags.items() if np.abs(v).max() > 1e-12}


def logreg(nh: int, seed: int = 0, degree: int = 15, n_diags: int = 8,
           bs: int = 4, gain: float = 0.8) -> Workload:
    """Packed logistic regression: one banded matvec + sigmoid(4t).

    Level cost: 1 (matvec) + 8 (degree-15 Chebyshev) = 9 levels."""
    rng = np.random.default_rng(seed)
    diags = _band_diagonals(nh, range(n_diags), rng, gain)
    b = rng.uniform(-0.1, 0.1, nh)
    layer = Dense("logits", diags, bias=b, act=sigmoid4(degree), bs=bs)
    return Workload("logreg", [layer], input_mag=1.0, tolerance=5e-3)


def mlp(nh: int, seed: int = 0, n_diags: int = 8, bs: int = 4,
        gain: float = 0.8) -> Workload:
    """Two dense layers with degree-7 sigmoid activations.  Level
    cost: (1+6) + (1+6) = 14 levels (degree-7 Chebyshev error ~2e-3;
    a degree-3 head would blow the 6e-3 decrypt floor at ~2e-2)."""
    rng = np.random.default_rng(seed)
    d1 = _band_diagonals(nh, range(n_diags), rng, gain)
    b1 = rng.uniform(-0.1, 0.1, nh)
    d2 = _band_diagonals(nh, range(n_diags), rng, gain)
    b2 = rng.uniform(-0.1, 0.1, nh)
    layers = [
        Dense("hidden", d1, bias=b1, act=sigmoid4(degree=7), bs=bs),
        Dense("head", d2, bias=b2, act=sigmoid4(degree=7), bs=bs),
    ]
    return Workload("mlp", layers, input_mag=1.0, tolerance=6e-3)


def mlp_bootstrap(nh: int, seed: int = 0, n_diags: int = 8,
                  bs: int = 4, gain: float = 0.8) -> Workload:
    """The bootstrap-exercising MLP: magnitudes kept ~1e-2 so the
    mid-pipeline bootstrap's EvalMod stays in its accurate region.

    Layer 1 costs 1 + 6 = 7 levels (degree-7 scaled tanh); layer 2 is a
    bias-free linear head (1 level).  Compiled with ``input_level=7``
    the planner must splice a bootstrap between them."""
    rng = np.random.default_rng(seed)
    d1 = _band_diagonals(nh, range(n_diags), rng, gain)
    b1 = rng.uniform(-0.02, 0.02, nh)
    d2 = _band_diagonals(nh, range(n_diags), rng, gain)
    layers = [
        Dense("hidden", d1, bias=b1, act=scaled_tanh(0.1, degree=7), bs=bs),
        Dense("head", d2, bias=None, act=None, bs=bs),
    ]
    return Workload("mlp_boot", layers, input_mag=0.3, tolerance=2e-2)
