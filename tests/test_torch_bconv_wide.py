"""BConv at every source width the reference runs, on the CPU.

ModDown converts from the k primes of P, with k >= alpha
(``core/params.py``); a dnum = 1 chain of the paper's size (logN = 16,
L = 35, alpha = k = 36) converts 36 source rows into 36.  The CUDA kernel
(``csrc/bconv.cu``) takes more than ``CHUNK`` = 32 rows with its
tensor-core kernel; here the wrapper's checks, its plain version, the
narrow kernel's lazy reduction (``modops.bconv_lazy_host``) and the
tensor-core kernel's arithmetic (``modops.bconv_tc_host``: byte
products, int32 sums by byte weight, one Montgomery recombination an
output word, residues carried across chunks of source rows) are held
against the JAX package's uint64 oracle at 36 and 64 source rows, at 4,
and at the largest prime below 2^30.  The kernels themselves run on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``kernels``
phase).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.core.rns import RNSContext as RefRNS  # noqa: E402
from repro.kernels.bconv.ops import bconv_oracle  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.core.rns import RNSContext  # noqa: E402
from repro_torch.kernels import modops  # noqa: E402
from repro_torch.kernels.bconv.ops import (  # noqa: E402
    CHUNK, BConvConsts, bconv, bconv_plain, geometry, tc_stride,
)

# a dnum = 1 chain: alpha = k = 36 primes of P, at a ring small enough
# for the oracle's uint64 arithmetic on the CPU
WIDE = dict(logN=6, L=35, alpha=36, k=36)
# the largest primes below 2^30 (2^30 - 35, 2^30 - 41): the widest
# residues and constants the kernels take
LARGEST = (1073741789, 1073741783)


def _x(rng, c, lead=()):
    q = c.src_q[:, None]
    return torch.from_numpy(
        rng.integers(0, 1 << 62, lead + (c.ls, 1 << c.logn))) % q


@pytest.mark.parametrize("ls,ld", [(36, 36), (64, 7), (33, 1)])
def test_wide_bconv_plain_and_mirror_equal_oracle(ls, ld):
    """``bconv`` (the plain version on a CPU tensor) and the kernel's
    lazy reduction equal the reference's oracle at ls > CHUNK: ModDown
    P -> Q of a dnum = 1 chain (36 -> 36), and wider sources."""
    assert ls > CHUNK
    p = CKKSParams(**dict(WIDE, k=max(ls, 36), alpha=36))
    rns = RNSContext(p)
    src, dst = p.p_primes[:ls], p.q_chain(p.L)[:ld]
    c = BConvConsts(rns, src, dst, "cpu")
    rng = np.random.default_rng(ls * 100 + ld)
    x = _x(rng, c, (2,))
    got = bconv(x, c)
    assert got.shape == (2, ld, p.N)
    rrns = RefRNS(RefParams(**dict(WIDE, k=max(ls, 36), alpha=36)))
    for b in range(2):
        ref = bconv_oracle(jnp.asarray(x[b].numpy().astype(np.uint32)),
                           tuple(src), tuple(dst), rrns)
        want = np.asarray(ref).astype(np.int64)
        np.testing.assert_array_equal(got[b].numpy(), want)
        mirror = modops.bconv_lazy_host(
            x[b].numpy(), c.qhat_inv_m.numpy().view(np.uint32),
            c.src_q.numpy(), c.cm.numpy().view(np.uint32), c.dst_q.numpy(),
            c.g_acc)
        np.testing.assert_array_equal(mirror.astype(np.int64), want)


def test_wide_bconv_wrapper_checks():
    """The wrapper takes 36 source rows at the paper's ring degree and
    refuses a wrong row count, a wrong ring degree and a dtype other
    than int64 before it computes anything."""
    p = CKKSParams(**dict(WIDE, logN=16))
    c = BConvConsts(RNSContext(p), p.p_primes, p.q_chain(p.L), "cpu")
    assert (c.ls, c.ld, c.logn) == (36, 36, 16)
    geo = geometry(2, c.ls, c.ld, c.logn)
    assert geo.groups * geo.g >= 36 and geo.blocks == 2 * geo.tiles
    small = CKKSParams(**WIDE)
    cs = BConvConsts(RNSContext(small), small.p_primes,
                     small.q_chain(small.L), "cpu")
    with pytest.raises(ValueError, match="expected"):
        bconv(torch.zeros((2, 35, small.N), dtype=torch.int64), cs)
    with pytest.raises(ValueError, match="expected"):
        bconv(torch.zeros((2, 36, small.N // 2), dtype=torch.int64), cs)
    with pytest.raises(TypeError, match="int64"):
        bconv(torch.zeros((2, 36, small.N), dtype=torch.int32), cs)


def test_wide_bconv_unaligned_operand_on_the_cpu():
    """An operand 8 bytes past a 16-byte boundary (what the card's
    kernel loads with two 8-byte copies) converts as an aligned copy of
    it does."""
    p = CKKSParams(**WIDE)
    c = BConvConsts(RNSContext(p), p.p_primes, p.q_chain(p.L), "cpu")
    rng = np.random.default_rng(7)
    x = _x(rng, c)
    flat = torch.empty(x.numel() + 1, dtype=torch.int64)
    odd = flat[1:].view(x.shape)
    odd.copy_(x)
    assert odd.data_ptr() % 16 == 8
    assert torch.equal(bconv(odd, c), bconv_plain(
        x, c.qhat_inv, c.src_q, c.qhat_mod, c.dst_q))


def _oracle(x, src, dst):
    """The reference's uint64 oracle on (ls, N) residues."""
    rrns = RefRNS(RefParams(**WIDE))
    return np.asarray(bconv_oracle(jnp.asarray(x.astype(np.uint32)),
                                   tuple(src), tuple(dst), rrns)
                      ).astype(np.int64)


def _tc_mirror(x, src, dst, chunk=64):
    """``modops.bconv_tc_host`` with the wrapper's constants for primes
    ``src`` -> ``dst`` (any primes below 2^30), from Python integers."""
    prod = 1
    for q in src:
        prod *= q
    qhat_inv = [pow(prod // q, -1, q) for q in src]
    qhat_mod = np.array([[(prod // q) % d for d in dst] for q in src],
                        dtype=np.int64)
    qinv_m = [int(modops.to_mont_host(np.array([v]), q)[0])
              for v, q in zip(qhat_inv, src)]
    return modops.bconv_tc_host(x, np.array(qinv_m, dtype=np.uint64),
                                np.array(src), qhat_mod, np.array(dst),
                                chunk).astype(np.int64)


@pytest.mark.parametrize("ls,ld,chunk", [(36, 36, 64), (64, 7, 64),
                                         (33, 1, 64), (4, 36, 64),
                                         (36, 36, 8)])
def test_tensor_core_mirror_equals_oracle(ls, ld, chunk):
    """The tensor-core kernel's arithmetic (``modops.bconv_tc_host``, on
    the wrapper's own constants) equals the reference's oracle, on random
    and on all-(q-1) residues: ModDown of a dnum = 1 chain (36 -> 36),
    64 and 33 source rows, 4, and 36 rows in chunks of 8 (the residues
    carried from chunk to chunk, as past the kernel's 64); and the
    wrapper lays the kernel's constants out as the kernel reads them."""
    p = CKKSParams(**dict(WIDE, k=max(ls, 36), alpha=36))
    src, dst = p.p_primes[:ls], p.q_chain(p.L)[:ld]
    c = BConvConsts(RNSContext(p), src, dst, "cpu")
    # the kernel's constants: zero-padded to whole K steps and tc_stride
    # columns; the byte weights, d and -d^-1 with the last column repeated
    tc_c = c.tc_c.numpy().view(np.uint32)
    assert tc_c.shape == (-(-ls // 8) * 8, tc_stride(ld))
    assert np.array_equal(tc_c[:ls, :ld], c.qhat_mod.numpy())
    assert not tc_c[ls:].any() and not tc_c[:, ld:].any()
    epi = c.tc_epi.numpy().view(np.uint32).astype(np.int64)
    assert np.array_equal(epi[:7, :ld], modops.byte_weights_mont(
        dst, 7))
    assert np.array_equal(epi[7:, :ld], np.stack(
        [c.dst_q.numpy(), c.dst_qn32.numpy().view(np.uint32)]))
    assert (epi[:, ld:] == epi[:, ld - 1:ld]).all()
    assert np.array_equal(c.tc_src.numpy().view(np.uint32)[:, :3].T, np.stack(
        [c.qhat_inv_m.numpy().view(np.uint32), c.src_q.numpy(),
         c.src_qn32.numpy().view(np.uint32)]))
    rng = np.random.default_rng(ls * 10 + ld)
    rand = _x(rng, c).numpy()
    top = np.repeat(c.src_q.numpy()[:, None] - 1, p.N, 1)
    for x in (rand, top):
        got = modops.bconv_tc_host(
            x, c.qhat_inv_m.numpy().view(np.uint32), c.src_q.numpy(),
            tc_c[:ls, :ld], c.dst_q.numpy(), chunk)
        np.testing.assert_array_equal(got.astype(np.int64),
                                      _oracle(x, src, dst))


def test_tensor_core_mirror_at_the_largest_prime():
    """Residues and constants just below 2^30: a source prime and a
    destination prime of 2^30 - 35 and 2^30 - 41, beside four of the
    chain's, on random and on all-(q-1) residues (the bytes' top values,
    the int32 sums' and the recombination's largest operands)."""
    p = CKKSParams(**WIDE)
    src = (LARGEST[0],) + tuple(p.p_primes[:3])
    dst = (LARGEST[1],) + tuple(p.q_chain(p.L)[:3])
    rng = np.random.default_rng(30)
    q = np.array(src, dtype=np.int64)[:, None]
    rand = rng.integers(0, 1 << 62, (4, p.N)) % q
    top = np.repeat(q - 1, p.N, 1)
    for x in (rand, top):
        np.testing.assert_array_equal(_tc_mirror(x, src, dst),
                                      _oracle(x, src, dst))
