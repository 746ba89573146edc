"""The port's keyswitch engine on its own: batched entry points, plan
counting, the seed path, guards, device selection and import hygiene.

Everything runs on the CPU through the kernels' plain versions; the
reference comparison of the same ops is in ``test_torch_ckks.py``.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.ckks import Ciphertext, CKKSContext  # noqa: E402
from repro_torch.core.keys import EvalKey  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.errors import (  # noqa: E402
    CorruptCiphertextError, LevelExhaustedError, ModulusChainMismatchError,
    ScaleDriftError,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
PARAMS = CKKSParams(logN=8, L=5, alpha=2, k=3, q_bits=29, scale_bits=26)
B = 3


@pytest.fixture(scope="module")
def ctx():
    return CKKSContext(PARAMS, seed=5, device="cpu")


@pytest.fixture(scope="module")
def cts(ctx):
    rng = np.random.default_rng(0)
    nh = PARAMS.num_slots
    return [ctx.encrypt(rng.normal(size=nh) + 1j * rng.normal(size=nh))
            for _ in range(B)]


def _stack(cts, attr):
    return torch.stack([getattr(c, attr) for c in cts])


def _pairs_equal(batched, rows):
    for b, r in zip(batched, zip(*rows)):
        assert torch.equal(b, torch.stack(r))


@pytest.mark.parametrize("level", [5, 4])
def test_batched_entry_points_equal_stacked(ctx, cts, level):
    """Every *_batched call equals the stacked unbatched calls."""
    eng, keys = ctx.engine, ctx.keys
    cs = [ctx.level_down(c, level) for c in cts]
    c0b, c1b = _stack(cs, "c0"), _stack(cs, "c1")
    mk = keys.mult_key
    _pairs_equal(eng.keyswitch_batched(c1b, mk, level),
                 [eng.keyswitch(c.c1, mk, level) for c in cs])
    g = ctx.pc.rns.galois_for_rotation(3)
    rk = keys.rot_key(3)
    _pairs_equal(eng.apply_galois_batched(c0b, c1b, g, rk, level),
                 [eng.apply_galois(c.c0, c.c1, g, rk, level) for c in cs])
    digb = eng.modup_batched(c1b, level)
    digs = [eng.modup(c.c1, level) for c in cs]
    assert torch.equal(digb, torch.stack(digs))
    steps = [1, 2]
    gs = [ctx.pc.rns.galois_for_rotation(s) for s in steps]
    ks = [keys.rot_key(s) for s in steps]
    pts = [ctx.encode(np.full(PARAMS.num_slots, 0.5 + s), level=level)
           for s in steps]
    pm_ext, pm_base = ctx._pm_stack(tuple(pts), level)
    for pm in ((None, None), (pm_ext, pm_base)):
        _pairs_equal(eng.hoisted_rotation_sum_batched(c0b, c1b, gs, ks,
                                                      level, *pm),
                     [eng.hoisted_rotation_sum(c.c0, c.c1, gs, ks, level,
                                               *pm) for c in cs])
        _pairs_equal(eng.hoisted_rotation_sum_batched(
            c0b, None, gs, ks, level, *pm, digits=digb),
            [eng.hoisted_rotation_sum(c.c0, None, gs, ks, level, *pm,
                                      digits=d) for c, d in zip(cs, digs)])
    _pairs_equal(eng.relin_batched(c0b, c1b, c0b, mk, level),
                 [eng.relin(c.c0, c.c1, c.c0, mk, level) for c in cs])
    _pairs_equal(eng.relin_batched(c0b, c1b, None, mk, level, digits=digb),
                 [eng.relin(c.c0, c.c1, None, mk, level, digits=d)
                  for c, d in zip(cs, digs)])
    _pairs_equal(eng.multi_relin_sum_batched([c0b, c1b], [c1b, c0b],
                                             [digb, digb], mk, level),
                 [eng.multi_relin_sum([c.c0, c.c1], [c.c1, c.c0], [d, d],
                                      mk, level) for c, d in zip(cs, digs)])
    _pairs_equal(eng.multi_hoisted_rotation_sum_batched(
        [c0b, c1b], [digb, digb], gs, ks, level),
        [eng.multi_hoisted_rotation_sum([c.c0, c.c1], [d, d], gs, ks, level)
         for c, d in zip(cs, digs)])


def test_batched_counters_scale_with_width(ctx, cts):
    eng = ctx.engine
    c1b = _stack(cts, "c1")
    mk = ctx.keys.mult_key
    before = ctx.counters.snapshot()
    eng.keyswitch(cts[0].c1, mk, PARAMS.L)
    one = ctx.counters.delta(before)
    before = ctx.counters.snapshot()
    eng.keyswitch_batched(c1b, mk, PARAMS.L)
    many = ctx.counters.delta(before)
    for k, v in one.as_dict().items():
        assert many.as_dict()[k] == B * v


def test_repeat_dispatch_keeps_trace_counts(ctx, cts):
    """A plan is counted once per (key, batch width): repeats with fresh
    data add nothing; a new width adds one."""
    eng = ctx.engine
    lvl = PARAMS.L
    c = cts[0]
    ctx.multiply(c, c)
    ctx.rotate(c, 1)
    eng.keyswitch_batched(_stack(cts[:2], "c1"), ctx.keys.mult_key, lvl)
    before = dict(eng.trace_counts)
    ctx.multiply(cts[1], cts[2])
    ctx.rotate(cts[2], 1)
    eng.keyswitch_batched(_stack(cts[1:], "c1"), ctx.keys.mult_key, lvl)
    assert dict(eng.trace_counts) == before
    eng.keyswitch_batched(_stack(cts[:1], "c1"), ctx.keys.mult_key, lvl)
    key = ("keyswitch_b", lvl)
    assert eng.trace_counts[key] == before[key] + 1


def test_seed_path_equals_engine(cts):
    """use_engine=False (per-digit loops) is bit-exact with the engine
    and tallies the same OpCounters."""
    a = CKKSContext(PARAMS, seed=9, device="cpu")
    b = CKKSContext(PARAMS, seed=9, device="cpu", use_engine=False)
    rng = np.random.default_rng(1)
    nh = PARAMS.num_slots
    z = rng.normal(size=nh) + 1j * rng.normal(size=nh)
    ca, cb = a.encrypt(z), b.encrypt(z)
    ws = [rng.normal(size=nh) for _ in range(2)]
    outs = []
    for c, ct in ((a, ca), (b, cb)):
        pts = [c.encode(w) for w in ws]
        outs.append([c.multiply(ct, ct), c.rotate(ct, 5), c.conjugate(ct),
                     c.hoisted_rotation_sum(ct, [1, 4]),
                     c.hoisted_rotation_sum(ct, [2, 3], pts),
                     c.rotate(c.level_down(ct, 4), 2)])
    for x, y in zip(*outs):
        assert x.level == y.level
        assert torch.equal(x.c0, y.c0) and torch.equal(x.c1, y.c1)
    assert a.counters.as_dict() == b.counters.as_dict()
    assert b.hoist_digits(cb) is None
    with pytest.raises(ValueError, match="engine"):
        b.hoisted_rotation_sum(cb, [1], digits=a.hoist_digits(ca))


def test_evk_admission_guard(ctx, cts):
    good = ctx.keys.rot_key(1)
    with pytest.raises(ModulusChainMismatchError, match="digit count"):
        ctx.engine.keyswitch(cts[0].c1, EvalKey(good.digits[:1]), PARAMS.L)
    bad = EvalKey([d[:, :-1] for d in good.digits])
    with pytest.raises(ModulusChainMismatchError, match="shape"):
        ctx.engine.keyswitch(cts[0].c1, bad, PARAMS.L)


def test_guards_raise_port_errors(ctx, cts):
    c = cts[0]
    ctx.check_ciphertext(c)
    with pytest.raises(ScaleDriftError):
        ctx.check_ciphertext(Ciphertext(c.c0, c.c1, c.level, float("nan")))
    with pytest.raises(LevelExhaustedError):
        ctx.check_ciphertext(Ciphertext(c.c0, c.c1, PARAMS.L + 1, c.scale))
    with pytest.raises(ModulusChainMismatchError):
        ctx.check_ciphertext(Ciphertext(c.c0[:-1], c.c1, c.level, c.scale))
    for bad_val in (PARAMS.q_primes[0], -1):
        c0 = c.c0.clone()
        c0[0, 0] = bad_val
        with pytest.raises(CorruptCiphertextError):
            ctx.check_ciphertext(Ciphertext(c0, c.c1, c.level, c.scale))
    with pytest.raises(LevelExhaustedError):
        ctx.rescale(ctx.level_down(c, 0))
    with pytest.raises(ModulusChainMismatchError):
        ctx.add(c, ctx.level_down(c, 3))
    with pytest.raises(ModulusChainMismatchError):
        ctx.mod_raise(c)
    with pytest.raises(ModulusChainMismatchError):
        ctx.pt_mul(c, ctx.encode(np.ones(4), level=2))


def test_cuda_requested_without_a_card_raises(monkeypatch):
    """The default device is the card; with none, construction raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CKKSContext(PARAMS)
    with pytest.raises(RuntimeError, match="cuda"):
        CKKSContext(PARAMS, device="cuda")


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for m in _imports(f):
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {m}"
