"""The port's host tables and polynomial layer against the JAX package.

Same parameters on both sides: the prime chains, every RNS table, the
basis-conversion constants, the automorphism permutations, every
``poly`` function and the encoder must agree exactly (the port on the
CPU, i.e. through the kernels' plain versions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import poly as rpoly  # noqa: E402
from repro.core.encoding import Encoder as RefEncoder  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro_torch.core import poly  # noqa: E402
from repro_torch.core.encoding import Encoder  # noqa: E402
from repro_torch.core.params import (  # noqa: E402
    BOOT_TEST_PARAMS, SMALL_TEST_PARAMS, CKKSParams,
)

CONFTEST = dict(logN=9, L=5, alpha=2, k=3, q_bits=29, scale_bits=29)
PARAM_SETS = {
    "conftest": CONFTEST,
    "small": {f: getattr(SMALL_TEST_PARAMS, f) for f in
              ("logN", "L", "alpha", "k", "q_bits", "q0_bits", "scale_bits")},
    "boot": {f: getattr(BOOT_TEST_PARAMS, f) for f in
             ("logN", "L", "alpha", "k", "q_bits", "q0_bits", "scale_bits")},
}


@pytest.fixture(scope="module", params=sorted(PARAM_SETS))
def pcs(request):
    kw = PARAM_SETS[request.param]
    return (rpoly.PolyContext(RefParams(**kw)),
            poly.PolyContext(CKKSParams(**kw), device="cpu"))


def _res(rng, primes, n, batch=()):
    q = np.array(primes, dtype=np.uint64)[:, None]
    return rng.integers(0, 1 << 62, size=batch + (len(primes), n),
                        dtype=np.uint64) % q


def _eq(port, ref):
    np.testing.assert_array_equal(port.cpu().numpy(),
                                  np.asarray(ref).astype(np.int64))


def test_prime_chain_and_rns_tables(pcs):
    rpc, tpc = pcs
    rp, tp = rpc.params, tpc.params
    assert rp.q_primes == tp.q_primes and rp.p_primes == tp.p_primes
    assert rp.P == tp.P and rp.dnum == tp.dnum
    for lvl in (tp.L, tp.L - 1, 1):
        assert rp.digit_groups(lvl) == tp.digit_groups(lvl)
    r, t = rpc.rns, tpc.rns
    for name in ("moduli", "psi_pows", "psi_inv_pows", "n_inv", "bitrev"):
        np.testing.assert_array_equal(getattr(t, name),
                                      getattr(r, name).astype(np.int64))
    for s in range(tp.logN):
        np.testing.assert_array_equal(t.stage_tw[s], r.stage_tw[s])
        np.testing.assert_array_equal(t.stage_tw_inv[s], r.stage_tw_inv[s])
    for lvl in (tp.L, 2):
        np.testing.assert_array_equal(t.p_inv_mod_q(lvl), r.p_inv_mod_q(lvl))
        np.testing.assert_array_equal(t.q_last_inv(lvl), r.q_last_inv(lvl))
        groups = tp.digit_groups(lvl)
        ext = tp.q_chain(lvl) + tp.p_primes
        for src, dst in [(groups[-1], ext), (tp.p_primes, tp.q_chain(lvl))]:
            for a, b in zip(t.bconv_consts(src, dst), r.bconv_consts(src, dst)):
                np.testing.assert_array_equal(a, b.astype(np.int64))


def test_automorphism_tables(pcs):
    rpc, tpc = pcs
    r, t = rpc.rns, tpc.rns
    gs = [t.galois_for_rotation(s) for s in (1, 5, 100)] + [t.galois_conjugate()]
    assert gs == [r.galois_for_rotation(s) for s in (1, 5, 100)] + [
        r.galois_conjugate()]
    for g in gs:
        np.testing.assert_array_equal(t.autom_eval_perm(g),
                                      r.autom_eval_perm(g))
        for a, b in zip(t.autom_tables(g), r.autom_tables(g)):
            np.testing.assert_array_equal(a, b.astype(np.int64))


@pytest.fixture(scope="module")
def conftest_pcs():
    return (rpoly.PolyContext(RefParams(**CONFTEST)),
            poly.PolyContext(CKKSParams(**CONFTEST), device="cpu"))


@pytest.mark.parametrize("lvl", [5, 4])
def test_poly_functions(conftest_pcs, lvl):
    """Every poly function, port (CPU) against reference (jnp uint64);
    level 4 splits the chain into digits of 2, 2 and 1 primes."""
    rpc, tpc = conftest_pcs
    p = tpc.params
    rng = np.random.default_rng(lvl)
    base = p.q_chain(lvl)
    ext = base + p.p_primes
    a, b = _res(rng, base, p.N), _res(rng, base, p.N)
    ta, tb = tpc.tensor(a), tpc.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    rm, tm = rpc.mods(base), tpc.mods(base)
    for fn in (rpoly.add, rpoly.sub, rpoly.mul):
        _eq(getattr(poly, fn.__name__)(ta, tb, tm), fn(ja, jb, rm))
    _eq(poly.neg(ta, tm), rpoly.neg(ja, rm))
    s = _res(rng, base, 1)[:, 0]
    _eq(poly.mul_scalar(ta, tpc.tensor(s), tm),
        rpoly.mul_scalar(ja, jnp.asarray(s), rm))
    _eq(poly.ntt(ta, base, tpc), rpoly.ntt(ja, base, rpc))
    _eq(poly.intt(ta, base, tpc), rpoly.intt(ja, base, rpc))
    _eq(poly.bconv(ta, base, p.p_primes, tpc),
        rpoly.bconv(ja, base, p.p_primes, rpc))
    for D in p.digit_groups(lvl):
        x = a[[base.index(q) for q in D]]
        _eq(poly.modup_digit(tpc.tensor(x), D, ext, tpc),
            rpoly.modup_digit(jnp.asarray(x), D, ext, rpc))
    xe = _res(rng, ext, p.N)
    _eq(poly.moddown(tpc.tensor(xe), lvl, tpc),
        rpoly.moddown(jnp.asarray(xe), lvl, rpc))
    _eq(poly.rescale(ta, lvl, tpc), rpoly.rescale(ja, lvl, rpc))
    for g in (rpc.rns.galois_for_rotation(3), rpc.rns.galois_conjugate()):
        _eq(poly.automorphism(ta, base, g, tpc),
            rpoly.automorphism(ja, base, g, rpc))
        _eq(poly.automorphism_eval(ta, g, tpc),
            rpoly.automorphism_eval(ja, g, rpc))


def test_poly_batched_rows_equal_unbatched(pcs):
    """A leading batch dimension computes each row independently."""
    _, tpc = pcs
    p = tpc.params
    rng = np.random.default_rng(1)
    lvl = p.L - 1
    base = p.q_chain(lvl)
    xb = tpc.tensor(_res(rng, base, p.N, (3,)))
    for fn in (lambda x: poly.ntt(x, base, tpc),
               lambda x: poly.intt(x, base, tpc),
               lambda x: poly.rescale(x, lvl, tpc),
               lambda x: poly.bconv(x, base, p.p_primes, tpc)):
        got = fn(xb)
        assert torch.equal(got, torch.stack([fn(r) for r in xb]))


def test_encoder_encode_decode(pcs):
    rpc, tpc = pcs
    p = tpc.params
    re, te = RefEncoder(rpc.params), Encoder(p)
    rng = np.random.default_rng(2)
    z = rng.normal(size=p.num_slots) + 1j * rng.normal(size=p.num_slots)
    primes = p.q_chain(p.L)
    for scale in (p.scale, 2.0**70):          # 2^70: the big-int path
        m = te.encode(z, scale, primes)
        np.testing.assert_array_equal(m, re.encode(z, scale, primes)
                                      .astype(np.int64))
    m = te.encode(z[:7], p.scale, primes)     # short input zero-pads
    np.testing.assert_array_equal(m, re.encode(z[:7], p.scale, primes)
                                  .astype(np.int64))
    np.testing.assert_array_equal(te.decode(m, p.scale, primes),
                                  re.decode(m.astype(np.uint64), p.scale,
                                            primes))
