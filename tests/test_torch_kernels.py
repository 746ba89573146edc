"""The port's kernels (``src/repro_torch/kernels``) against the JAX
package's.

On the CPU every wrapper runs its kernel's plain version, so these tests
hold each plain version bit-exact against the reference's uint64
``*_oracle`` and, at logN=8, against the reference's ``pallas_call`` in
interpret mode.  The host mirror of the device Montgomery arithmetic
(``csrc/modarith.cuh``) is held against Python integers.  The CUDA
kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``), where they are compared with the same plain
versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.core.rns import RNSContext as RefRNS  # noqa: E402
from repro.kernels.bconv.ops import bconv_kernel, bconv_oracle  # noqa: E402
from repro.kernels.fused_ip.ops import fused_ip_kernel, fused_ip_oracle  # noqa: E402
from repro.kernels.modup.ops import modup_digit as ref_modup_digit  # noqa: E402
from repro.kernels.modup.ops import modup_digit_oracle  # noqa: E402
from repro.kernels.ntt.ops import (  # noqa: E402
    ntt_fwd as ref_ntt_fwd, ntt_fwd_oracle, ntt_inv_oracle, tables_for,
)
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.core.rns import RNSContext  # noqa: E402
from repro_torch.kernels import modops  # noqa: E402
from repro_torch.kernels.bconv.ops import BConvConsts, bconv, bconv_plain  # noqa: E402
from repro_torch.kernels.fused_ip.ops import IPConsts, fused_ip, fused_ip_plain  # noqa: E402
from repro_torch.kernels.modup.ops import (  # noqa: E402
    ModUpDigitConsts, modup_digit_plain,
)
from repro_torch.kernels.ntt.ops import (  # noqa: E402
    NTTTables, cluster_bits, ntt_fwd, ntt_fwd_plain, ntt_inv, ntt_inv_plain,
)


def _both(**kw):
    return RefParams(**kw), CKKSParams(**kw)


def _res(rng, primes, shape):
    """uint32 residues of shape (..., len(primes), N)."""
    q = np.array(primes, dtype=np.uint64)[:, None]
    return (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % q
            ).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(ref).astype(np.int64))


# ------------------------------ modops ----------------------------------

@pytest.mark.parametrize("q", [0x3FFFE001, 1073479681, 536608769,
                               536215553, 40961])
def test_mont_mul_host_matches_python_ints(q):
    """The device formula (64-bit product, one reduction, R = 2^32) gives
    the fully reduced a*b mod q for b in Montgomery form."""
    rng = np.random.default_rng(q)
    a = rng.integers(0, q, 4096, dtype=np.int64)
    b = rng.integers(0, q, 4096, dtype=np.int64)
    qn = modops.qinv_neg_host(q)
    assert (q * qn + 1) % (1 << 32) == 0
    b_m = modops.to_mont_host(b, q)
    assert all(int(bm) == (int(bb) << 32) % q for bm, bb in zip(b_m, b))
    got = modops.mont_mul_host(a, b_m, q, qn)
    want = [(int(x) * int(y)) % q for x, y in zip(a, b)]
    assert got.astype(np.int64).tolist() == want
    # a * b * 2^-32 for normal-form b, undone by 2^64 mod q
    r = modops.mont_mul_host(a, b, q, qn)
    fixed = modops.mont_mul_host(r, np.full_like(r, modops.r_pow_host(q, 2)),
                                 q, qn)
    assert fixed.astype(np.int64).tolist() == want


def test_u32_packing_round_trips():
    vals = [0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]
    packed = modops.as_u32(vals)
    assert packed.dtype == np.int32
    assert packed.view(np.uint32).astype(np.int64).tolist() == vals


# ------------------------------- NTT -------------------------------------

@pytest.fixture(scope="module")
def ntt_case():
    rp, tp = _both(logN=8, L=3, alpha=2, k=2, q_bits=29)
    return tables_for(rp), NTTTables(RNSContext(tp)), tp


@pytest.fixture(scope="module")
def bitrev(ntt_case):
    """The JAX engine's bridge between its kernels' bit-reversed order and
    natural order (``KeyswitchPlan.bitrev``, from the reference RNS)."""
    return RefRNS(RefParams(logN=8, L=3, alpha=2, k=2, q_bits=29)).bitrev


def test_ntt_tables_equal_reference(ntt_case):
    ref, port, _ = ntt_case
    for name in ("tw_f", "tw_i", "twist_f", "twist_i"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name).astype(np.int64))


@pytest.mark.parametrize("batch", [None, 3])
def test_ntt_plain_vs_oracle(ntt_case, bitrev, batch):
    """Natural order at both ends: the forward equals the reference's
    oracle after the engine's bit-reversal bridge, the inverse takes the
    natural order back to the coefficients."""
    ref, port, p = ntt_case
    primes = p.q_chain(p.L)
    rng = np.random.default_rng(7)
    shape = (len(primes), p.N) if batch is None else (batch, len(primes), p.N)
    x = _res(rng, primes, shape)
    fwd = ntt_fwd(_t(x), primes, port)
    inv = ntt_inv(fwd, primes, port)
    rows = [x] if batch is None else list(x)
    f_rows = [fwd] if batch is None else list(fwd)
    for xr, fr in zip(rows, f_rows):
        _eq(fr, np.asarray(ntt_fwd_oracle(jnp.asarray(xr), primes,
                                          ref))[..., bitrev])
        br = np.asarray(fr)[..., bitrev].astype(np.uint32)
        _eq(ntt_inv(fr, primes, port),
            ntt_inv_oracle(jnp.asarray(br), primes, ref))
    _eq(inv, x)


def test_ntt_repeated_primes_and_pallas_interpret(ntt_case, bitrev):
    """Tiled primes (two polys in one call) and the Pallas kernel in
    interpret mode, bridged to natural order, give the same rows."""
    ref, port, p = ntt_case
    primes = p.q_chain(p.L) + p.p_primes
    tiled = primes * 2
    rng = np.random.default_rng(8)
    x = _res(rng, tiled, (len(tiled), p.N))
    got = ntt_fwd(_t(x), tiled, port)
    _eq(got, np.asarray(ref_ntt_fwd(jnp.asarray(x), tiled, ref,
                                    interpret=True))[..., bitrev])
    twist, tw, q = port.plain_rows(tiled, "cpu", inverse=False)
    assert torch.equal(got, ntt_fwd_plain(_t(x), twist, tw, q))
    twist, tw, q = port.plain_rows(tiled, "cpu", inverse=True)
    back = ntt_inv(got, tiled, port)
    assert torch.equal(back, ntt_inv_plain(got, twist, tw, q))
    _eq(back, x)


@pytest.mark.parametrize("logn,want", [
    (5, 0), (8, 0), (10, 0), (11, 0), (12, 0), (13, 0), (14, 1), (15, 2),
    (16, 3), (17, 3),
])
def test_cluster_bits_per_shape(logn, want):
    """A row is spread over as few blocks as hold it at 2^13 words each,
    at most eight."""
    assert cluster_bits(logn) == want


def test_wrappers_raise_off_cpu_without_kernel(ntt_case):
    """A tensor that is not on the CPU never takes the plain version:
    anything but a contiguous CUDA tensor is refused."""
    _, port, p = ntt_case
    primes = p.q_chain(p.L)
    x = torch.zeros((len(primes), p.N), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        ntt_fwd(x, primes, port)
    with pytest.raises(TypeError):
        ntt_fwd(torch.zeros((len(primes), p.N), dtype=torch.int32), primes,
                port)
    with pytest.raises(ValueError, match="expected"):
        ntt_fwd(torch.zeros((len(primes) + 1, p.N), dtype=torch.int64),
                primes, port)


# ------------------------------ BConv ------------------------------------

@pytest.mark.parametrize("logn,ls,ld,batch", [
    (6, 2, 2, None), (8, 3, 2, 2), (8, 4, 4, None), (8, 1, 5, 3),
])
def test_bconv_plain_vs_oracle(logn, ls, ld, batch):
    rp, tp = _both(logN=logn, L=max(ls - 1, 1), alpha=1, k=ld, q_bits=29)
    rrns = RefRNS(rp)
    src, dst = tp.q_chain(ls - 1), tp.p_primes[:ld]
    c = BConvConsts(RNSContext(tp), src, dst, "cpu")
    rng = np.random.default_rng(logn + ls)
    shape = (ls, tp.N) if batch is None else (batch, ls, tp.N)
    x = _res(rng, src, shape)
    got = bconv(_t(x), c)
    assert torch.equal(got, bconv_plain(_t(x), c.qhat_inv, c.src_q,
                                        c.qhat_mod, c.dst_q))
    rows = [x] if batch is None else list(x)
    g_rows = [got] if batch is None else list(got)
    for xr, gr in zip(rows, g_rows):
        _eq(gr, bconv_oracle(jnp.asarray(xr), src, dst, rrns))
    if batch is None and logn == 8:
        _eq(got, bconv_kernel(jnp.asarray(x), src, dst, rrns,
                              interpret=True))


# ----------------------------- fused IP ----------------------------------

@pytest.mark.parametrize("dnum,with_pt", [(1, False), (2, True), (3, False),
                                          (3, True)])
def test_fused_ip_plain_vs_oracle(dnum, with_pt):
    p = CKKSParams(logN=8, L=4, alpha=1, k=1, q_bits=29)
    primes = p.q_chain(4)
    q = np.array(primes, dtype=np.uint32)
    c = IPConsts(primes, "cpu")
    rng = np.random.default_rng(dnum * 10 + with_pt)
    n = p.N
    digits = _res(rng, primes, (dnum, len(primes), n))
    evk = _res(rng, primes, (dnum, 2, len(primes), n))
    pt = _res(rng, primes, (len(primes), n)) if with_pt else None
    got = fused_ip(_t(digits)[None], _t(evk)[None],
                   _t(pt)[None] if with_pt else None, c)
    e0, e1 = fused_ip_oracle(digits, evk, pt, q)
    _eq(got[0], e0)
    _eq(got[1], e1)
    if dnum == 3 and with_pt:
        k0, k1 = fused_ip_kernel(digits, evk, pt, q, interpret=True)
        _eq(got[0], k0)
        _eq(got[1], k1)


@pytest.mark.parametrize("shared_evk,with_pt", [(False, True), (True, False)])
def test_fused_ip_rotation_axis_and_batch(shared_evk, with_pt):
    """Summing R rotations inside the kernel equals the reference's
    per-rotation calls summed mod q; a leading batch axis is per row."""
    p = CKKSParams(logN=7, L=3, alpha=1, k=1, q_bits=29)
    primes = p.q_chain(3)
    q = np.array(primes, dtype=np.uint64)
    c = IPConsts(primes, "cpu")
    rng = np.random.default_rng(3)
    B, R, dnum, l, n = 2, 3, 2, len(primes), p.N
    digits = _res(rng, primes, (B, R, dnum, l, n))
    evk = _res(rng, primes, (1 if shared_evk else R, dnum, 2, l, n))
    pt = _res(rng, primes, (R, l, n)) if with_pt else None
    got = fused_ip(_t(digits), _t(evk), _t(pt) if with_pt else None, c)
    assert got.shape == (B, 2, l, n)
    for b in range(B):
        acc = np.zeros((2, l, n), dtype=np.uint64)
        for r in range(R):
            e = fused_ip_oracle(digits[b, r], evk[0 if shared_evk else r],
                                pt[r] if with_pt else None, q)
            acc = (acc + np.stack([np.asarray(v) for v in e])) % q[:, None]
        _eq(got[b], acc)
    assert torch.equal(got, fused_ip_plain(_t(digits), _t(evk),
                                           _t(pt) if with_pt else None, c.q))


def test_fused_ip_rejects_mismatched_shapes():
    p = CKKSParams(logN=7, L=2, alpha=1, k=1, q_bits=29)
    c = IPConsts(p.q_chain(2), "cpu")
    d = torch.zeros((2, 2, 3, p.N), dtype=torch.int64)
    with pytest.raises(ValueError, match="evk"):
        fused_ip(d, torch.zeros((3, 2, 2, 3, p.N), dtype=torch.int64), None,
                 c)
    with pytest.raises(ValueError, match="pt"):
        fused_ip(d, torch.zeros((2, 2, 2, 3, p.N), dtype=torch.int64),
                 torch.zeros((1, 3, p.N), dtype=torch.int64), c)


# ------------------------------ ModUp ------------------------------------

@pytest.fixture(scope="module")
def modup_case():
    # level 4 of L=5, alpha=2: digits of 2, 2 and 1 primes (short last)
    rp, tp = _both(logN=8, L=5, alpha=2, k=3, q_bits=29, scale_bits=26)
    return RefRNS(rp), tables_for(rp), RNSContext(tp), tp


@pytest.mark.parametrize("level", [5, 4])
def test_modup_plain_vs_oracle(modup_case, level):
    rrns, rtabs, trns, p = modup_case
    tabs = NTTTables(trns)
    ext = p.q_chain(level) + p.p_primes
    rng = np.random.default_rng(level)
    for D in p.digit_groups(level):
        c = ModUpDigitConsts(trns, tabs, D, ext, "cpu")
        for batch in (None, 2):
            shape = (len(D), p.N) if batch is None else (batch, len(D), p.N)
            x = _res(rng, D, shape)
            got = modup_digit_plain(_t(x), **c.plain())
            rows = [x] if batch is None else list(x)
            g_rows = [got] if batch is None else list(got)
            for xr, gr in zip(rows, g_rows):
                _eq(gr, modup_digit_oracle(jnp.asarray(xr), D, ext, rtabs,
                                           rrns))


def test_modup_consts_and_pallas_interpret(modup_case):
    rrns, rtabs, trns, p = modup_case
    from repro.kernels.modup.ops import ModUpDigitConsts as RefConsts

    tabs = NTTTables(trns)
    level = 4
    ext = p.q_chain(level) + p.p_primes
    D = p.digit_groups(level)[-1]               # the short digit
    c = ModUpDigitConsts(trns, tabs, D, ext, "cpu")
    ref = RefConsts(rrns, rtabs, D, ext)
    np.testing.assert_array_equal(c.twist_i_scaled_np,
                                  ref.twist_i_scaled.astype(np.int64))
    np.testing.assert_array_equal(c.qhat_mod_np, ref.qhat_mod.astype(np.int64))
    x = _res(np.random.default_rng(1), D, (len(D), p.N))
    _eq(modup_digit_plain(_t(x), **c.plain()),
        ref_modup_digit(jnp.asarray(x), D, ext, rtabs, rrns, interpret=True))
