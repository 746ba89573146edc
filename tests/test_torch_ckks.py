"""The port's CKKS scheme against the JAX package's, bit for bit.

Both contexts get the same parameters and seed, so they draw the same
keys and masks; every op must give equal residues, equal decryptions and
equal ``OpCounters``.  The port runs on the CPU (the kernels' plain
versions).  Both sides request keys in the same order, because a key is
drawn from the chain's generator when first asked for.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.ckks import CKKSContext as RefContext  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402

# conftest-sized; level 4 splits into digits of 2, 2 and 1 (short last)
KW = dict(logN=9, L=5, alpha=2, k=3, q_bits=29, scale_bits=29)
SEED = 11


@pytest.fixture(scope="module")
def pair():
    ref = RefContext(RefParams(**KW), seed=SEED)
    port = CKKSContext(CKKSParams(**KW), seed=SEED, device="cpu")
    rng = np.random.default_rng(3)
    nh = port.params.num_slots
    z = rng.normal(size=nh) + 1j * rng.normal(size=nh)
    return ref, port, z, ref.encrypt(z), port.encrypt(z)


def _arr(x):
    return (x.cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).astype(np.int64))


def _same(r, t):
    """Equal residues (and level/scale) of a ref and a port ciphertext."""
    assert r.level == t.level and r.scale == t.scale
    np.testing.assert_array_equal(_arr(t.c0), _arr(r.c0))
    np.testing.assert_array_equal(_arr(t.c1), _arr(r.c1))


def _counters(ref, port):
    assert port.counters.as_dict() == ref.counters.as_dict()


def test_keys_and_encryption_equal(pair):
    ref, port, z, cr, ct = pair
    np.testing.assert_array_equal(_arr(port.keys.s_eval), _arr(ref.keys.s_eval))
    np.testing.assert_array_equal(port.keys.s_coeffs, ref.keys.s_coeffs)
    for kr, kt in ((ref.keys.mult_key, port.keys.mult_key),
                   (ref.keys.rot_key(1), port.keys.rot_key(1)),
                   (ref.keys.conj_key, port.keys.conj_key)):
        for dr, dt in zip(kr.digits, kt.digits):
            np.testing.assert_array_equal(_arr(dt), _arr(dr))
    _same(cr, ct)
    np.testing.assert_array_equal(port.decrypt(ct), ref.decrypt(cr))


def test_multiply_rescale_equal(pair):
    ref, port, z, cr, ct = pair
    mr, mt = ref.multiply(cr, cr), port.multiply(ct, ct)
    _same(mr, mt)
    _counters(ref, port)
    dt = port.decrypt(mt)
    np.testing.assert_array_equal(dt, ref.decrypt(mr))
    assert np.abs(dt - z * z).max() < 1e-3


@pytest.mark.parametrize("steps", [1, 7])
def test_rotate_equal(pair, steps):
    ref, port, z, cr, ct = pair
    rr, rt = ref.rotate(cr, steps), port.rotate(ct, steps)
    _same(rr, rt)
    _counters(ref, port)
    assert np.abs(port.decrypt(rt) - np.roll(z, -steps)).max() < 1e-3


def test_conjugate_equal(pair):
    ref, port, z, cr, ct = pair
    _same(ref.conjugate(cr), port.conjugate(ct))
    _counters(ref, port)


def test_hoisted_rotation_sums_equal(pair):
    """Without pt, with pt (a step-0 term included), and from shared
    ``digits=``."""
    ref, port, z, cr, ct = pair
    _same(ref.hoisted_rotation_sum(cr, [1, 2, 3]),
          port.hoisted_rotation_sum(ct, [1, 2, 3]))
    rng = np.random.default_rng(4)
    ws = [rng.normal(size=port.params.num_slots) for _ in range(3)]
    pr = [ref.encode(w) for w in ws]
    pt = [port.encode(w) for w in ws]
    hr = ref.hoisted_rotation_sum(cr, [0, 1, 2], pr)
    ht = port.hoisted_rotation_sum(ct, [0, 1, 2], pt)
    _same(hr, ht)
    want = sum(w * np.roll(z, -s) for w, s in zip(ws, [0, 1, 2]))
    assert np.abs(port.decrypt(ht) - want).max() < 1e-3
    dr, dt = ref.hoist_digits(cr), port.hoist_digits(ct)
    np.testing.assert_array_equal(_arr(dt), _arr(dr))
    _same(ref.hoisted_rotation_sum(cr, [1, 3], pr[:2], digits=dr),
          port.hoisted_rotation_sum(ct, [1, 3], pt[:2], digits=dt))
    _counters(ref, port)


def test_keyswitch_at_lower_level_short_digit(pair):
    ref, port, z, cr, ct = pair
    lr, lt = ref.level_down(cr, 4), port.level_down(ct, 4)
    assert [len(D) for D in port.params.digit_groups(4)] == [2, 2, 1]
    _same(ref.rotate(lr, 1), port.rotate(lt, 1))
    for a, b in zip(ref.keyswitch(lr.c1, ref.keys.mult_key, 4),
                    port.keyswitch(lt.c1, port.keys.mult_key, 4)):
        np.testing.assert_array_equal(_arr(b), _arr(a))
    _counters(ref, port)


def test_multi_sums_equal(pair):
    """The merged-ModDown entry points, engine to engine."""
    ref, port, z, cr, ct = pair
    re, te = ref.engine, port.engine
    lvl = ct.level
    gs = [port.pc.rns.galois_for_rotation(s) for s in (1, 2)]
    dr, dt = re.modup(cr.c1, lvl), te.modup(ct.c1, lvl)
    out_r = re.multi_hoisted_rotation_sum(
        [cr.c0, cr.c0], [dr, dr], gs,
        [ref.keys.rot_key(1), ref.keys.rot_key(2)], lvl)
    out_t = te.multi_hoisted_rotation_sum(
        [ct.c0, ct.c0], [dt, dt], gs,
        [port.keys.rot_key(1), port.keys.rot_key(2)], lvl)
    for a, b in zip(out_r, out_t):
        np.testing.assert_array_equal(_arr(b), _arr(a))
    out_r = re.multi_relin_sum([cr.c0, cr.c1], [cr.c1, cr.c0], [dr, dr],
                               ref.keys.mult_key, lvl)
    out_t = te.multi_relin_sum([ct.c0, ct.c1], [ct.c1, ct.c0], [dt, dt],
                               port.keys.mult_key, lvl)
    for a, b in zip(out_r, out_t):
        np.testing.assert_array_equal(_arr(b), _arr(a))
    _counters(ref, port)


def test_elementwise_ops_and_mod_raise(pair):
    ref, port, z, cr, ct = pair
    _same(ref.add(cr, cr), port.add(ct, ct))
    _same(ref.sub(cr, ref.double(cr)), port.sub(ct, port.double(ct)))
    pr, pt = ref.encode(z[::-1].copy()), port.encode(z[::-1].copy())
    _same(ref.pt_add(cr, pr), port.pt_add(ct, pt))
    _same(ref.pt_mul(cr, pr), port.pt_mul(ct, pt))
    lr, lt = ref.level_down(cr, 0), port.level_down(ct, 0)
    _same(ref.mod_raise(lr), port.mod_raise(lt))
    _counters(ref, port)


def test_convert_round_trips_reference_state(pair):
    """A reference ciphertext and key chain cross to the port as numpy
    arrays; the port multiplies and rotates them exactly as the
    reference does, and the result crosses back unchanged."""
    ref, port, z, cr, ct = pair
    pc = port.pc
    chain = convert.keychain_from_numpy(
        pc, ref.keys.s_coeffs,
        mult_key=np.stack([np.asarray(d) for d in ref.keys.mult_key.digits]),
        rot_keys={1: np.stack([np.asarray(d)
                               for d in ref.keys.rot_key(1).digits])})
    ctx = CKKSContext(CKKSParams(**KW), seed=SEED, device="cpu")
    ctx.keys = chain
    c = convert.ciphertext_from_numpy(pc, np.asarray(cr.c0),
                                      np.asarray(cr.c1), cr.level, cr.scale)
    _same(cr, c)
    m = ctx.multiply(c, c)
    _same(ref.multiply(cr, cr), m)
    _same(ref.rotate(cr, 1), ctx.rotate(c, 1))
    back = convert.ciphertext_to_numpy(m)
    assert back["c0"].dtype == np.uint64 and back["level"] == m.level
    np.testing.assert_array_equal(back["c1"].astype(np.int64), _arr(m.c1))
    state = convert.keychain_to_numpy(chain)
    np.testing.assert_array_equal(state["s_coeffs"], ref.keys.s_coeffs)
    np.testing.assert_array_equal(
        state["mult_key"].astype(np.int64),
        np.stack([_arr(d) for d in ref.keys.mult_key.digits]))
    pr = ref.encode(z[:4])
    pt = convert.plaintext_from_numpy(pc, np.asarray(pr.m), pr.level,
                                      pr.scale)
    np.testing.assert_array_equal(
        convert.plaintext_to_numpy(pt)["m"], np.asarray(pr.m))
    np.testing.assert_array_equal(
        ctx.decrypt(ctx.pt_add(c, pt)),
        ref.decrypt(ref.pt_add(cr, pr)))
    np.testing.assert_array_equal(_arr(jnp.asarray(back["c0"])), _arr(m.c0))
