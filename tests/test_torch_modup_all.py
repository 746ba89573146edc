"""The port's all-digit ModUp and the natural-order keyswitch path
against the JAX package, at the repo's logN = 10 test parameters.

``modup`` (on the CPU: its plain version, the per-digit reference body
bridged to natural order) must equal the JAX engine's ``modup`` at a
level whose digits are even and at one whose last digit is short,
unbatched and batched, on the reference's jnp backend; its Pallas
backend (interpret mode, about 12 s a case here) is held at the short
digit.  The port's keyswitch engine must equal the reference's op for
op on keyswitch, rotate, hoisted rotation sum and relinearization, given
the same keys.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.keys import EvalKey as RefEvalKey  # noqa: E402
from repro.core.keyswitch import KeyswitchEngine as RefEngine  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.core.poly import PolyContext as RefPoly  # noqa: E402
from repro_torch.core.keys import EvalKey  # noqa: E402
from repro_torch.core.keyswitch import KeyswitchEngine  # noqa: E402
from repro_torch.core.params import SMALL_TEST_PARAMS, CKKSParams  # noqa: E402
from repro_torch.core.poly import PolyContext  # noqa: E402
from repro_torch.kernels.modup.ops import ModUpConsts, modup, modup_plain  # noqa: E402

# logN = 10, L = 5, alpha = 2: level 5 has digits (2, 2, 2), level 4
# (2, 2, 1)
KW = {f: getattr(SMALL_TEST_PARAMS, f) for f in
      ("logN", "L", "alpha", "k", "q_bits", "q0_bits", "scale_bits")}
SEED = 13


@pytest.fixture(scope="module")
def engines():
    port = KeyswitchEngine(PolyContext(CKKSParams(**KW), device="cpu"))
    refs = {b: RefEngine(RefPoly(RefParams(**KW), backend=b))
            for b in ("jnp", "pallas")}
    return port, refs


def _res(rng, primes, n, batch=()):
    q = np.array(primes, dtype=np.int64)[:, None]
    return rng.integers(0, 1 << 62, size=batch + (len(primes), n),
                        dtype=np.int64) % q


@pytest.mark.parametrize("backend,level,batch", [
    ("jnp", 5, None), ("jnp", 5, 2), ("jnp", 4, None), ("jnp", 4, 2),
    ("pallas", 4, None),
])
def test_modup_all_equals_reference_engine(engines, backend, level, batch):
    port, refs = engines
    ref = refs[backend]
    p = port.params
    assert ([len(D) for D in p.digit_groups(level)]
            == ([2, 2, 2] if level == 5 else [2, 2, 1]))
    primes = p.q_chain(level)
    rng = np.random.default_rng(level * 10 + (batch or 0))
    x = _res(rng, primes, p.N, () if batch is None else (batch,))
    got = port.modup(torch.from_numpy(x), level) if batch is None else \
        port.modup_batched(torch.from_numpy(x), level)
    want = ref.modup(x.astype(np.uint64), level) if batch is None else \
        ref.modup_batched(x.astype(np.uint64), level)
    plan = port._plan(level)
    assert got.shape == x.shape[:-2] + (plan.dnum, plan.l_ext, p.N)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_modup_consts_layout(engines):
    """The kernel's tables: each digit's source rows, own rows passed
    through, and the reduce constants of a short last digit padded."""
    port, _ = engines
    c = port._plan(4).modup
    assert isinstance(c, ModUpConsts)
    assert c.digit_np.tolist() == [[0, 2], [2, 2], [4, 1]]
    for d, D in enumerate(c.groups):
        for e, q in enumerate(c.ext):
            want = c.base.index(q) if q in D else -1
            assert c.own_np[d, e] == want
    m = c.mont()
    assert tuple(m["cm"].shape) == (c.dnum, c.alpha, c.l_ext)
    assert int(m["cm"][2, 1].abs().sum()) == 0
    assert tuple(m["twist_i"].shape) == (c.l, port.params.N)
    x = torch.from_numpy(_res(np.random.default_rng(0), c.base,
                              port.params.N))
    assert torch.equal(modup(x, c), modup_plain(x, c))
    with pytest.raises(ValueError, match="expected"):
        modup(x[:-1], c)


def _keys(rng, p, n_keys):
    """Random eval keys, the same residues on both sides."""
    ext = p.q_primes + p.p_primes
    arrs = [[_res(rng, ext, p.N, (2,)) for _ in range(p.dnum)]
            for _ in range(n_keys)]
    return ([RefEvalKey([jnp.asarray(d.astype(np.uint64)) for d in a])
             for a in arrs],
            [EvalKey([torch.from_numpy(d) for d in a]) for a in arrs])


def _pairs_equal(port_out, ref_out):
    for t, r in zip(port_out, ref_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r).astype(np.int64))


def test_engine_ops_equal_reference(engines):
    """Keyswitch, rotate, hoisted rotation sum (with plaintexts) and
    relinearization through the all-digit ModUp, engine to engine with the
    same keys, at the short last digit.  The same ops through whole
    contexts (key generation included), at an even and a short digit, are
    held in ``test_torch_ckks.py`` at logN = 9."""
    level = 4
    port, refs = engines
    ref = refs["jnp"]
    p = port.params
    rng = np.random.default_rng(100 + level)
    rk, tk = _keys(rng, p, 3)
    base = p.q_chain(level)
    c0, c1, c2 = (_res(rng, base, p.N) for _ in range(3))
    u = [x.astype(np.uint64) for x in (c0, c1, c2)]
    t = [torch.from_numpy(x) for x in (c0, c1, c2)]
    _pairs_equal(port.keyswitch(t[1], tk[0], level),
                 ref.keyswitch(u[1], rk[0], level))
    g = [port.pc.rns.galois_for_rotation(s) for s in (1, 3)]
    _pairs_equal(port.apply_galois(t[0], t[1], g[1], tk[1], level),
                 ref.apply_galois(u[0], u[1], g[1], rk[1], level))
    ext = base + p.p_primes
    pm_ext = _res(rng, ext, p.N, (2,))
    pm_base = pm_ext[:, : len(base)].copy()
    _pairs_equal(
        port.hoisted_rotation_sum(t[0], t[1], g, tk[1:], level,
                                  torch.from_numpy(pm_ext),
                                  torch.from_numpy(pm_base)),
        ref.hoisted_rotation_sum(u[0], u[1], g, rk[1:], level,
                                 jnp.asarray(pm_ext.astype(np.uint64)),
                                 jnp.asarray(pm_base.astype(np.uint64))))
    _pairs_equal(port.relin(t[0], t[1], t[2], tk[0], level),
                 ref.relin(u[0], u[1], u[2], rk[0], level))
