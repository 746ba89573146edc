"""BConv at every source width the reference runs, on the CPU.

ModDown converts from the k primes of P, with k >= alpha
(``core/params.py``); a dnum = 1 chain of the paper's size (logN = 16,
L = 35, alpha = k = 36) converts 36 source rows into 36.  The CUDA kernel
(``csrc/bconv.cu``) takes them ``CHUNK`` = 32 at a time; here the
wrapper's checks, its plain version and the kernel's lazy reduction
(``modops.bconv_lazy_host``, summed across the chunk boundary as the
kernel sums it) are held against the JAX package's uint64 oracle at
36 and 64 source rows.  The kernel itself runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``kernels`` phase).
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
    CHUNK, BConvConsts, bconv, bconv_plain, geometry,
)

# a dnum = 1 chain: alpha = k = 36 primes of P, at a ring small enough
# for the oracle's uint64 arithmetic on the CPU
WIDE = dict(logN=6, L=35, alpha=36, k=36)


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
