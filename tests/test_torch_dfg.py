"""The port's copy of ``dfg/`` against the JAX package's.

The same programs are traced in both packages (``TraceContext`` at the
runtime tests' parameters, and ``ProgramBuilder`` at paper width, where
the fusion DP has real choices to make).  Keyswitch layers, the PKBs of
``identify_pkbs``, the plans of ``optimal_fusion`` and the ``OpVolumes``
of ``dfg.hoist`` must be equal.  Nothing here needs a ciphertext.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import linear as ref_linear  # noqa: E402
from repro.core import polyeval as ref_polyeval  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.dfg import fusion as ref_fusion  # noqa: E402
from repro.dfg import hoist as ref_hoist  # noqa: E402
from repro.dfg import pkb as ref_pkb  # noqa: E402
from repro.dfg.trace import ProgramBuilder as RefBuilder  # noqa: E402
from repro.runtime import TraceContext as RefTrace  # noqa: E402
from repro_torch.core import linear, polyeval  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.dfg import fusion, hoist, pkb  # noqa: E402
from repro_torch.dfg.trace import ProgramBuilder  # noqa: E402
from repro_torch.runtime import TraceContext  # noqa: E402

KW = dict(logN=9, L=9, alpha=2, k=3, q_bits=29, scale_bits=29)
REF = dict(trace=RefTrace, params=RefParams, linear=ref_linear,
           polyeval=ref_polyeval, builder=RefBuilder, pkb=ref_pkb,
           fusion=ref_fusion, hoist=ref_hoist)
PORT = dict(trace=TraceContext, params=CKKSParams, linear=linear,
            polyeval=polyeval, builder=ProgramBuilder, pkb=pkb,
            fusion=fusion, hoist=hoist)


def _diags(nh, steps, seed=3):
    rng = np.random.default_rng(seed)
    return {d: rng.normal(size=nh) for d in steps}


def _coeffs():
    return polyeval.chebyshev_coeffs(
        lambda t: np.sin(2 * np.pi * 1.5 * t) / (2 * np.pi), 15)


def _traced(body):
    def build(pkg):
        tc = pkg["trace"](pkg["params"](**KW))
        h = tc.input("x", level=KW["L"], scale=tc.params.scale)
        tc.output(body(pkg, tc, h, tc.params.num_slots), "y")
        return tc.g, tc.params
    return build


def _paper_chain(pkg):
    """Three serial BSGS-like PKBs at paper width (logN=16, alpha=12)."""
    b = pkg["builder"](N=1 << 16, alpha=12)
    h = b.input(36)
    for steps in ((1, 2, 3, 4), (8, 16, 24), (32, 64)):
        h = b.sum_tree([h.rot(s).pmul(f"pt{s}") for s in steps]).rescale()
    h.output()
    return b.g, None


PROGRAMS = {
    "diag": _traced(lambda pkg, tc, h, nh: pkg["linear"].matvec_diag(
        tc, h, _diags(nh, range(8)))),
    "bsgs2": _traced(lambda pkg, tc, h, nh: pkg["linear"].matvec_bsgs(
        tc, h, _diags(nh, range(8)), bs=2)),
    "bsgs4": _traced(lambda pkg, tc, h, nh: pkg["linear"].matvec_bsgs(
        tc, h, _diags(nh, (0, 1, 2, 3, 9, 11, 17)), bs=4)),
    "cheb": _traced(lambda pkg, tc, h, nh: pkg["polyeval"].eval_chebyshev(
        tc, h, _coeffs())),
    "cheb_bsgs": _traced(
        lambda pkg, tc, h, nh: pkg["polyeval"].eval_chebyshev_bsgs(
            tc, h, _coeffs())),
    "paper_chain": _paper_chain,
}


def _pkb_view(p) -> tuple:
    return (type(p).__name__, p.layer, list(p.rotations),
            sorted(p.in_anchors), sorted(p.out_sinks), sorted(p.region),
            p.n_rot, p.indeg, p.outdeg, list(p.steps), p.limbs, p.dnum)


def _both(name):
    """(reference, port) of graph, params, PKBs."""
    out = []
    for pkg in (REF, PORT):
        g, params = PROGRAMS[name](pkg)
        pkbs = sorted(pkg["pkb"].identify_pkbs(g), key=lambda p: p.layer)
        out.append((g, params, pkbs))
    return out


def _k_alpha(params):
    return (params.k, params.alpha) if params else (12, 12)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_graph_and_layers_equal(name):
    (rg, _, _), (pg, _, _) = _both(name)
    assert [(n.id, n.op.value, n.args, n.limbs, n.attrs)
            for n in pg.nodes.values()] == [
        (n.id, n.op.value, n.args, n.limbs, n.attrs)
        for n in rg.nodes.values()]
    assert pkb.keyswitch_layers(pg) == ref_pkb.keyswitch_layers(rg)
    assert (pkb.pkb_parallelism_histogram(pg)
            == ref_pkb.pkb_parallelism_histogram(rg))


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_identify_pkbs_equal(name):
    (_, _, rp), (_, _, pp) = _both(name)
    assert [_pkb_view(p) for p in pp] == [_pkb_view(p) for p in rp]


@pytest.mark.parametrize("max_group", [2, 4])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_optimal_fusion_equal(name, max_group):
    (_, params, rp), (g, _, pp) = _both(name)
    k, alpha = _k_alpha(params)
    nh = g.N // 2
    plans = [mod.optimal_fusion(pk, k, alpha, nh, capacity_words=cap,
                                max_group=max_group)
             for mod, pk in ((ref_fusion, rp), (fusion, pp))
             for cap in (float("inf"), 1e9)]
    for r, p in zip(plans[:2], plans[2:]):
        assert p.groups == r.groups
        assert p.score == r.score
        assert [_pkb_view(f) for f in p.fused] == [_pkb_view(f) for f in r.fused]


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_op_volumes_equal(name):
    (rg, params, rp), (pg, _, pp) = _both(name)
    k, alpha = _k_alpha(params)
    nh = pg.N // 2
    for strategy in ("hoist", "minks", "plain"):
        for flow in ("IRF", "EVF"):
            got = [dataclasses.asdict(hoist.pkb_volumes(
                p, k, alpha, strategy, flow, nh)) for p in pp]
            want = [dataclasses.asdict(ref_hoist.pkb_volumes(
                p, k, alpha, strategy, flow, nh)) for p in rp]
            assert got == want
            assert dataclasses.asdict(hoist.program_volumes(
                pg, pp, k, alpha, strategy, flow, nh)) == dataclasses.asdict(
                ref_hoist.program_volumes(rg, rp, k, alpha, strategy, flow,
                                          nh))
    blocks, residual = hoist.non_pkb_blocks(pg, pp, k, alpha)
    ref_blocks, ref_residual = ref_hoist.non_pkb_blocks(rg, rp, k, alpha)
    assert [dataclasses.asdict(v) for v in blocks] == [
        dataclasses.asdict(v) for v in ref_blocks]
    assert dataclasses.asdict(residual) == dataclasses.asdict(ref_residual)


@pytest.mark.parametrize("l", [1, 6, 7, 12, 36])
def test_keyswitch_volume_pieces_equal(l):
    for fn in ("modup_volumes", "ip_volumes"):
        assert dataclasses.asdict(getattr(hoist, fn)(l, 3, 2, 512)) \
            == dataclasses.asdict(getattr(ref_hoist, fn)(l, 3, 2, 512))
    assert dataclasses.asdict(hoist.moddown_volumes(l, 12, 12, 1 << 16, 2)) \
        == dataclasses.asdict(ref_hoist.moddown_volumes(l, 12, 12, 1 << 16, 2))
    assert hoist.evk_words(l, 3, 2, 512) == ref_hoist.evk_words(l, 3, 2, 512)
