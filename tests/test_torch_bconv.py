"""The BConv kernel's lazy reduction and launch geometry, on the CPU.

``csrc/bconv.cu`` sums ``g_acc`` products in 64 bits before one
Montgomery reduction.  Its numpy mirror (``modops.bconv_lazy_host``) is
held against Python integers, the port's plain version and the JAX
package's uint64 oracle, on random residues and on the extreme where
every residue is ``q - 1`` under the largest primes below 2^30.  The grid
that the wrapper picks (``kernels/bconv/ops.py: geometry``) is checked
to cover every output word once at the shapes the repo runs.  The kernel
itself runs on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.core.rns import RNSContext as RefRNS  # noqa: E402
from repro.kernels.bconv.ops import bconv_oracle  # noqa: E402
from repro_torch.core import nt, params as tparams  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.core.rns import RNSContext  # noqa: E402
from repro_torch.kernels import modops  # noqa: E402
from repro_torch.kernels.bconv.ops import (  # noqa: E402
    COLS, MAX_THREADS, BConvConsts, bconv_plain, geometry,
)


def _largest_primes(count: int, below: int = 1 << 30) -> list[int]:
    out, n = [], below - 1
    while len(out) < count:
        if nt.is_prime(n):
            out.append(n)
        n -= 2
    return out


def _consts(src, dst):
    """(qhat_inv_i mod q_i, qhat_i mod d_j) on Python integers."""
    prod = 1
    for q in src:
        prod *= q
    qhat_inv = np.array([pow(prod // q, -1, q) for q in src], dtype=np.int64)
    qhat_mod = np.array([[(prod // q) % d for d in dst] for q in src],
                        dtype=np.int64).reshape(len(src), len(dst))
    return qhat_inv, qhat_mod


def _int_bconv(x, src, dst):
    """Exact fast basis conversion on Python integers."""
    prod = 1
    for q in src:
        prod *= q
    t = [[int(v) * pow(prod // q, -1, q) % q for v in row]
         for row, q in zip(x, src)]
    return [[sum(t[i][c] * ((prod // src[i]) % d) for i in range(len(src))) % d
             for c in range(len(x[0]))] for d in dst]


def _mirror(x, src, dst, qhat_inv, cm):
    sq, dq = np.array(src, np.int64), np.array(dst, np.int64)
    return modops.bconv_lazy_host(x, modops.to_mont_host(qhat_inv, sq), sq,
                                  cm, dq, modops.lazy_terms(src))


@pytest.mark.parametrize("fill", ["random", "q_minus_1"])
@pytest.mark.parametrize("ls", [1, 3, 4, 5, 11, 12])
def test_bconv_lazy_host_matches_ints(ls, fill):
    """The lazy accumulate-and-reduce gives the exact conversion, with
    groups of 4 products (primes just below 2^30) cut short when 4 does
    not divide ls, on random residues and at the all-(q-1) extreme."""
    primes = _largest_primes(ls + 6)
    src, dst = tuple(primes[:ls]), tuple(primes[ls:])
    assert modops.lazy_terms(src) == 4
    n = 64
    q = np.array(src, dtype=np.int64)[:, None]
    if fill == "random":
        x = np.random.default_rng(ls).integers(0, 1 << 62, (ls, n)) % q
    else:
        x = np.broadcast_to(q - 1, (ls, n)).copy()
    qhat_inv, qhat_mod = _consts(src, dst)
    sq, dq = np.array(src, np.int64), np.array(dst, np.int64)
    got = _mirror(x, src, dst, qhat_inv,
                  modops.to_mont_host(qhat_mod, dq[None, :]))
    want = _int_bconv(x.tolist(), src, dst)
    assert got.astype(np.int64).tolist() == want
    plain = bconv_plain(torch.from_numpy(x), torch.from_numpy(qhat_inv),
                        torch.from_numpy(sq), torch.from_numpy(qhat_mod),
                        torch.from_numpy(dq))
    assert plain.tolist() == want
    rrns = RefRNS(RefParams(logN=4, L=1, alpha=1, k=1))
    ref = bconv_oracle(jnp.asarray(x.astype(np.uint32)), src, dst, rrns)
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64), want)
    if fill == "q_minus_1":
        # the sums' own extreme: every scaled word q_i - 1 (qhat_inv = 1)
        # and every constant d_j - 1
        worst = _mirror(x, src, dst, np.ones(ls, np.int64),
                        np.broadcast_to(dq - 1, (ls, len(dst))))
        want = [[sum((q - 1) * (d - 1) for q in src) * pow(2, -32, d) % d] * n
                for d in dst]
        assert worst.astype(np.int64).tolist() == want


def test_bconv_lazy_host_refuses_a_larger_group():
    """The bound matters: 16 products of 30-bit words overflow the 64-bit
    sum, and the mirror says so instead of wrapping.  (With q = 2^30 - 1,
    2^30 = 1 mod q, so qhat_inv_m = 4 scales q - 1 to itself.)"""
    top = (1 << 30) - 1
    assert modops.lazy_terms([top]) == 4 and 4 * top < 1 << 32
    x = np.full((16, 4), top - 1, dtype=np.int64)
    with pytest.raises(OverflowError):
        modops.bconv_lazy_host(x, [4] * 16, [top] * 16,
                               np.full((16, 1), top - 1), [top], 16)


@pytest.mark.parametrize("src_kind,ld", [("p", 7), ("last", 6), ("digit", 3)])
def test_bconv_lazy_host_on_repo_constants(src_kind, ld):
    """With the constants ``BConvConsts`` hands the kernel (ModDown's
    P -> Q, rescale's last prime -> the rest, a ModUp digit), the mirror
    equals the plain version; 30-bit primes give groups of 4, 29-bit
    primes groups of 8."""
    for bits, want_g in ((30, 4), (29, 8)):
        p = CKKSParams(logN=6, L=ld, alpha=3, k=5, q_bits=bits, q0_bits=bits)
        rns = RNSContext(p)
        chain = p.q_chain(ld)
        src, dst = {"p": (p.p_primes, chain),
                    "last": (chain[-1:], chain[:-1]),
                    "digit": (chain[:3], chain[3:] + p.p_primes)}[src_kind]
        c = BConvConsts(rns, src, dst, "cpu")
        assert c.g_acc == want_g
        rng = np.random.default_rng(bits + ld)
        x = torch.from_numpy(rng.integers(0, 1 << 62, (c.ls, p.N))) % \
            c.src_q[:, None]
        got = modops.bconv_lazy_host(
            x.numpy(), c.qhat_inv_m.numpy().view(np.uint32), c.src_q.numpy(),
            c.cm.numpy().view(np.uint32), c.dst_q.numpy(), c.g_acc)
        want = bconv_plain(x, c.qhat_inv, c.src_q, c.qhat_mod, c.dst_q)
        np.testing.assert_array_equal(got.astype(np.int64), want.numpy())


@pytest.mark.parametrize("name", ["PAPER_PARAMS", "SMALL_TEST_PARAMS",
                                  "BOOT_TEST_PARAMS"])
def test_repo_primes_fit_the_lazy_reduction(name):
    """Every prime of the repo's parameter sets lies in (2^29, 2^30): the
    kernel takes it, and its sums hold 4 products."""
    p = getattr(tparams, name)
    primes = p.q_primes + p.p_primes
    assert all((1 << 29) < q < (1 << 30) for q in primes)
    assert modops.lazy_terms(primes) == 4


def _cells(geo, batch, ld, logn):
    """How often the kernel's index arithmetic (``csrc/bconv.cu``) writes
    each word of the (batch, ld, N) output."""
    n = 1 << logn
    k = np.arange(geo.blocks)
    tile, b = k % geo.tiles, k // geo.tiles
    h = np.arange(geo.threads)
    lane, slot = h % geo.lanes, h // geo.lanes
    slots = geo.threads // geo.lanes
    hits = np.zeros(batch * ld * n, dtype=np.int64)
    for s in range(0, geo.groups, slots):
        grp = slot + s
        for g in range(geo.g):
            j = grp * geo.g + g
            keep = (grp < geo.groups) & (j < ld)
            pair = tile[:, None] * geo.lanes + lane[None, keep]
            row = b[:, None] * ld + j[None, keep]
            for c in range(COLS):
                hits += np.bincount((row * n + pair * COLS + c).ravel(),
                                    minlength=hits.size)
    return hits


@pytest.mark.parametrize("batch,ls,ld,logn", [
    (2, 12, 36, 16), (2, 12, 35, 16), (2, 12, 34, 16),  # ModDown, PAPER
    (1, 1, 35, 16), (1, 1, 34, 16), (1, 1, 33, 16),     # rescale, PAPER
    (1, 12, 36, 16), (2, 3, 7, 16),                     # ModUp digit, parity
    (3, 2, 3, 10), (1, 1, 1, 8), (2, 32, 45, 8), (1, 5, 2, 4),
])
def test_bconv_geometry_covers_every_word_once(batch, ls, ld, logn):
    """Every (batch, destination row, column) is written once, by the
    wrapper's geometry and by the ones ``tools/ntt_study.py`` tries."""
    for g, lanes in ((None, None), (2, 64), (4, 32), (6, 64)):
        geo = geometry(batch, ls, ld, logn, g, lanes)
        assert 1 <= geo.lanes <= geo.threads <= MAX_THREADS
        assert geo.threads % geo.lanes == 0
        assert geo.lanes * COLS * geo.tiles == 1 << logn
        assert geo.groups == -(-ld // geo.g)
        assert geo.blocks == batch * geo.tiles
        assert np.all(_cells(geo, batch, ld, logn) == 1), geo
