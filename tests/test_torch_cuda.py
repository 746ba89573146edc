"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a device.
They import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.core.rns import RNSContext  # noqa: E402
from repro_torch.kernels.bconv.ops import BConvConsts, bconv, bconv_plain  # noqa: E402
from repro_torch.kernels.fused_ip.ops import IPConsts, fused_ip, fused_ip_plain  # noqa: E402
from repro_torch.kernels.modup.ops import (  # noqa: E402
    ModUpDigitConsts, modup_digit, modup_digit_plain,
)
from repro_torch.kernels.ntt.ops import (  # noqa: E402
    NTTTables, ntt_fwd, ntt_fwd_plain, ntt_inv, ntt_inv_plain,
)


def _res(rng, primes, shape):
    q = np.array(primes, dtype=np.int64)[:, None]
    return torch.from_numpy(
        rng.integers(0, 1 << 62, size=shape, dtype=np.int64) % q)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("logn", [8, 12])
def test_cuda_kernels_equal_plain(cuda, logn):
    """Every kernel against its plain version on the card, both NTT
    launch layouts (one launch at logN <= 11, two above)."""
    p = CKKSParams(logN=logn, L=4, alpha=2, k=3, q_bits=29)
    rns = RNSContext(p)
    tabs = NTTTables(rns)
    rng = np.random.default_rng(logn)
    base = p.q_chain(4)
    ext = base + p.p_primes
    x = _res(rng, base, (2, len(base), p.N)).to(cuda)
    for inverse, fn in ((False, ntt_fwd), (True, ntt_inv)):
        plain = ntt_inv_plain if inverse else ntt_fwd_plain
        assert torch.equal(fn(x, base, tabs),
                           plain(x, *tabs.plain_rows(base, cuda, inverse)))
    c = BConvConsts(rns, base, p.p_primes, cuda)
    assert torch.equal(bconv(x, c), bconv_plain(x, c.qhat_inv, c.src_q,
                                                c.qhat_mod, c.dst_q))
    ipc = IPConsts(ext, cuda)
    dig = _res(rng, ext, (2, 3, 2, len(ext), p.N)).to(cuda)
    evk = _res(rng, ext, (3, 2, 2, len(ext), p.N)).to(cuda)
    pt = _res(rng, ext, (3, len(ext), p.N)).to(cuda)
    assert torch.equal(fused_ip(dig, evk, pt, ipc),
                       fused_ip_plain(dig, evk, pt, ipc.q))
    for D in p.digit_groups(4):
        mc = ModUpDigitConsts(rns, tabs, D, ext, cuda)
        xd = _res(rng, D, (2, len(D), p.N)).to(cuda)
        assert torch.equal(modup_digit(xd, mc),
                           modup_digit_plain(xd, **mc.plain()))


@pytest.mark.cuda
def test_cuda_context_equals_cpu_context(cuda):
    """The scheme on the card gives the CPU's residues op for op, across
    a uniform and a short last digit."""
    from repro_torch.core.ckks import CKKSContext

    p = CKKSParams(logN=10, L=5, alpha=2, k=3, q_bits=29, scale_bits=26)
    outs = []
    for dev in (cuda, "cpu"):
        ctx = CKKSContext(p, seed=4, device=dev)
        rng = np.random.default_rng(0)
        z = rng.normal(size=p.num_slots) + 1j * rng.normal(size=p.num_slots)
        ct = ctx.encrypt(z)
        m = ctx.multiply(ct, ct)
        pts = [ctx.encode(rng.normal(size=p.num_slots), level=m.level)
               for _ in range(2)]
        outs.append([ct, m, ctx.rotate(m, 3), ctx.conjugate(ct),
                     ctx.hoisted_rotation_sum(m, [1, 2], pts),
                     ctx.rotate(ctx.level_down(ct, 4), 1)])
    for a, b in zip(*outs):
        assert a.level == b.level
        assert torch.equal(a.c0.cpu(), b.c0) and torch.equal(a.c1.cpu(), b.c1)
