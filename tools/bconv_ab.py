"""Time the BConv kernel of a checkout at the paper's ModDown and rescale
shapes, to hold two versions of the kernel against each other on one
card.

    python3 tools/bconv_ab.py TREE

TREE is the root of a checkout (``.`` for this one; another commit
unpacked with ``git archive`` into a directory that ``.gitignore``
lists); its ``src/repro_torch`` is imported and its kernels are built
under its own ``build/``.  Needs a CUDA card.  At PAPER_PARAMS
(logN=16): ModDown converts the k = 12 primes of P of both accumulators
into the 36 primes of the chain, (2, 12) -> (2, 36); a rescale converts
the last prime into the 35 below it, (1, 1) -> (1, 35).  Each result is
held equal to ``bconv_plain`` first; then five medians of
``kernels.timing.cuda_ms`` each.  Prints one JSON line: the tree, the
median of the five for each shape, and all five.  Run two trees in
turns in one call (A, B, B, A) to compare them.
"""
import json
import statistics
import sys

tree = sys.argv[1]
sys.path.insert(0, tree + "/src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.params import PAPER_PARAMS as P  # noqa: E402
from repro_torch.core.rns import RNSContext  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.bconv.ops import BConvConsts, bconv, bconv_plain  # noqa: E402
from repro_torch.kernels.timing import cuda_ms  # noqa: E402


def main() -> None:
    native.build_all()
    rns = RNSContext(P)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def res(primes, shape):
        q = np.array(primes, dtype=np.int64)[:, None]
        return torch.from_numpy(rng.integers(0, 1 << 62, size=shape,
                                             dtype=np.int64) % q).to(dev)

    out = {}
    l = P.L + 1
    for name, src, ld, lead in (("moddown", P.p_primes, l, (2,)),
                                ("rescale", P.q_primes[l - 1:l], l - 1, (1,))):
        cc = BConvConsts(rns, src, P.q_chain(ld - 1), dev)
        x = res(src, lead + (len(src), P.N))
        assert torch.equal(bconv(x, cc), bconv_plain(
            x, cc.qhat_inv, cc.src_q, cc.qhat_mod, cc.dst_q))
        out[name] = [cuda_ms(lambda: bconv(x, cc)) for _ in range(5)]
    print(json.dumps({"tree": tree, **{k: statistics.median(v)
                                       for k, v in out.items()},
                      "all": out}))


if __name__ == "__main__":
    main()
