"""Time the BConv kernels of a checkout at the paper's ModDown and rescale
shapes and at the ModDown of a dnum = 1 chain, to hold two versions of
the kernels against each other on one card.

    python3 tools/bconv_ab.py TREE

TREE is the root of a checkout (``.`` for this one; another commit
unpacked with ``git archive`` into a directory that ``.gitignore``
lists); its ``src/repro_torch`` is imported and its kernels are built
under its own ``build/``.  Needs a CUDA card.  At PAPER_PARAMS
(logN=16): ModDown converts the k = 12 primes of P of both accumulators
into the 36 primes of the chain, (2, 12) -> (2, 36); a rescale converts
the last prime into the 35 below it, (1, 1) -> (1, 35).  A chain of the
same size with one digit (alpha = k = 36) converts 36 primes into 36 at
its ModDown, (2, 36) -> (2, 36) (``dnum1``).  The ModDown shape is
also timed on an operand 8 bytes past a 16-byte boundary
(``moddown_unaligned``) and, where the tree's ``bconv.cu`` has the
``HE2_BCONV_TC_ONLY`` study build, on the tensor-core kernel
(``moddown_tensor_core``), which that shape does not take by default.
Each result is held equal to ``bconv_plain`` first; then five medians
of ``kernels.timing.cuda_ms`` each.  Prints one JSON line: the tree, the median of the five for each
shape, and all five.  Run two trees in turns in one call (A, B, B, A)
to compare them.
"""
import ctypes
import json
import statistics
import sys

tree = sys.argv[1]
sys.path.insert(0, tree + "/src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.params import PAPER_PARAMS as P  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
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
    P1 = CKKSParams(logN=P.logN, L=P.L, alpha=l, k=l)
    lib = native.lib("bconv")
    tc = None
    if "HE2_BCONV_TC_ONLY" in (native.CSRC / "bconv.cu").read_text():
        paths, _ = native.compile_libs(["bconv"],
                                       defines=("HE2_BCONV_TC_ONLY",))
        tc = ctypes.CDLL(str(paths["bconv"]))
    # (name, context, source primes, destination primes, leading shape,
    #  operand 8 bytes past a 16-byte boundary, library)
    cases = [("moddown", rns, P.p_primes, P.q_chain(P.L), (2,), False, lib),
             ("moddown_unaligned", rns, P.p_primes, P.q_chain(P.L), (2,),
              True, lib),
             ("rescale", rns, P.q_primes[l - 1:l], P.q_chain(l - 2), (1,),
              False, lib),
             ("dnum1", RNSContext(P1), P1.p_primes, P1.q_chain(P1.L), (2,),
              False, lib)]
    if tc is not None:
        cases.append(("moddown_tensor_core", rns, P.p_primes,
                      P.q_chain(P.L), (2,), False, tc))
    for name, r, src, dst, lead, odd, library in cases:
        cc = BConvConsts(r, src, dst, dev)
        x = res(src, lead + (len(src), P.N))
        if odd:
            flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            x = flat[1:].view(x.shape).copy_(x)
            assert x.data_ptr() % 16 == 8
        native._libs["bconv"] = library
        assert torch.equal(bconv(x, cc), bconv_plain(
            x, cc.qhat_inv, cc.src_q, cc.qhat_mod, cc.dst_q))
        out[name] = [cuda_ms(lambda: bconv(x, cc)) for _ in range(5)]
        native._libs["bconv"] = lib
    print(json.dumps({"tree": tree, **{k: statistics.median(v)
                                       for k, v in out.items()},
                      "all": out}))


if __name__ == "__main__":
    main()
