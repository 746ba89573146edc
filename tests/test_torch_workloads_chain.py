"""The port's planner and compiled workload chains against the JAX
package's, and the port's own runs of them.

- The planner and the compiled chains: ``plan_cuts``, the segments and
  their ``summary()``, ``predicted_modups``, ``workload_blocks`` and
  ``scheduled_result`` equal the JAX package's at the shapes of
  ``tests/test_workloads.py`` (symbolic, no ciphertext runs).
- The port's own sandwich on the CPU: ``run_batched`` equals
  ``run_eager`` bit for bit at fewer ModUps, ``reconcile()`` matches, and
  the decryption is within the workload's tolerance; the
  bootstrap-inserted chain too.
- The package boundary: ``repro_torch.workloads`` and
  ``repro_torch.serve`` load neither JAX nor the JAX package.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.workloads as ref_wl  # noqa: E402
from repro.core.bootstrap import Bootstrapper as RefBootstrapper  # noqa: E402
from repro.core.ckks import CKKSContext as RefContext  # noqa: E402
from repro.core.params import CKKSParams as RefParams  # noqa: E402
from repro.sim import hw as ref_hw  # noqa: E402
from repro.workloads import models as ref_models  # noqa: E402
import repro_torch.workloads as wl  # noqa: E402
from repro_torch.core.bootstrap import Bootstrapper  # noqa: E402
from repro_torch.core.ckks import CKKSContext  # noqa: E402
from repro_torch.core.params import CKKSParams  # noqa: E402
from repro_torch.sim import hw  # noqa: E402
from repro_torch.workloads import models  # noqa: E402
from test_torch_sim import _block, _result  # noqa: E402

# tests/test_workloads.py's shapes: the workload context, and the deep
# bootstrap-capable context and its Bootstrapper
W_KW = dict(logN=8, L=14, alpha=2, k=3, q_bits=29, scale_bits=29)
BOOT_KW = dict(logN=8, L=19, alpha=4, k=4, q_bits=29, scale_bits=29,
               q0_bits=30)
BOOT_CTX = dict(seed=7, hamming_weight=8)
BOOT_BTP = dict(n_groups=2, mod_K=3, cheb_degree=27)


# ------------------------- planner and compiler --------------------------

@pytest.fixture(scope="module")
def contexts():
    """(reference, port) contexts and Bootstrappers at ``BOOT_KW``; the
    symbolic tests only read their params and trace the Bootstrapper."""
    ref = RefContext(RefParams(**BOOT_KW), **BOOT_CTX)
    port = CKKSContext(CKKSParams(**BOOT_KW), device="cpu", **BOOT_CTX)
    return {"ref": (ref, RefBootstrapper(ref, **BOOT_BTP)),
            "port": (port, Bootstrapper(port, **BOOT_BTP))}


CHAINS = {
    # (model function, params, input_level, with the Bootstrapper)
    "logreg": ("logreg", W_KW, 9, False),
    "mlp": ("mlp", W_KW, None, False),
    "mlp_boot": ("mlp_bootstrap", BOOT_KW, 7, True),
    "mlp_boot_deep": ("mlp_bootstrap", BOOT_KW, None, True),
}


def _compile(pkg, contexts, name, fusion=False, exact=True):
    model_fn, kw, level, boot = CHAINS[name]
    mods, wlp, params, side = ((ref_models, ref_wl, RefParams, "ref")
                               if pkg == "ref" else
                               (models, wl, CKKSParams, "port"))
    p = params(**kw)
    m = getattr(mods, model_fn)(p.num_slots, bs=4)
    btp = contexts[side][1] if boot else None
    plan = wlp.plan_cuts(m, p, btp=btp, input_level=level)
    wp = wlp.compile_workload(m, p, btp=btp, input_level=level,
                              fusion=fusion, exact=exact)
    return plan, wp


def _plan(plan) -> dict:
    out = {f.name: getattr(plan, f.name)
           for f in dataclasses.fields(plan) if f.name != "cuts"}
    out["cuts"] = [dataclasses.asdict(c) for c in plan.cuts]
    return out


@pytest.mark.parametrize("fusion,exact", [(False, True), (True, False)])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_compiled_workload_equal(contexts, name, fusion, exact):
    """The plan, the segments, the summary, the predicted ModUps, the
    feed of the group scheduler and its result equal the JAX package's."""
    rplan, rwp = _compile("ref", contexts, name, fusion, exact)
    pplan, pwp = _compile("port", contexts, name, fusion, exact)
    assert _plan(pplan) == _plan(rplan)
    assert pwp.summary() == rwp.summary()
    assert pwp.predicted_modups() == rwp.predicted_modups()
    assert [(s.kind, s.span, s.in_tag, s.out_tag, s.closed)
            for s in pwp.segments] == [(s.kind, s.span, s.in_tag, s.out_tag,
                                        s.closed) for s in rwp.segments]
    for batch in (1, 2):
        assert [_block(b) for b in wl.workload_blocks(pwp, batch)] == [
            _block(b) for b in ref_wl.workload_blocks(rwp, batch)]
    got = wl.scheduled_result(pwp, hw.CONFIGS["HE2-SM"], batch=2)
    want = ref_wl.scheduled_result(rwp, ref_hw.CONFIGS["HE2-SM"], batch=2)
    assert _result(got) == _result(want)
    assert got.latency_s > 0


def test_plan_errors_equal():
    """Level exhaustion without a Bootstrapper is the same typed error."""
    from repro.errors import LevelExhaustedError as RefExhausted
    from repro_torch.errors import LevelExhaustedError

    with pytest.raises(RefExhausted, match="Bootstrapper") as want:
        ref_wl.plan_cuts(ref_models.mlp_bootstrap(128), RefParams(**W_KW),
                         input_level=7)
    with pytest.raises(LevelExhaustedError, match="Bootstrapper") as got:
        wl.plan_cuts(models.mlp_bootstrap(128), CKKSParams(**W_KW),
                     input_level=7)
    assert str(got.value) == str(want.value)


# ---------------------- the port's own sandwich (CPU) --------------------

def _sandwich(ctx, m, wp, xs, btp=None, input_level=None):
    """``tests/test_workloads.py``'s gates on the port: batched compiled
    == per-ct eager replay bit for bit, strictly fewer ModUps, exact
    reconcile, decryption within the workload's tolerance."""
    cts = [ctx.encrypt(x, level=input_level) for x in xs]
    c = ctx.counters
    s0 = c.snapshot()
    exps = [wp.run_eager(ctx, ct, btp=btp) for ct in cts]
    d_eager = c.delta(s0)
    s1 = c.snapshot()
    res = wl.WorkloadExecutor(ctx).run_batched(wp, cts, with_report=True)
    d_comp = c.delta(s1)
    for got, exp in zip(res.output, exps, strict=True):
        assert (got.level, got.scale) == (exp.level, exp.scale)
        assert torch.equal(got.c0, exp.c0) and torch.equal(got.c1, exp.c1)
    assert d_comp.modup < d_eager.modup, (d_comp.modup, d_eager.modup)
    rec = res.reconcile()
    assert rec["counts_match"], rec
    assert len(rec["segments"]) == len(wp.segments)
    for x, got in zip(xs, res.output, strict=True):
        err = np.abs(ctx.decrypt(got).real - m.reference(x)).max()
        assert err < m.tolerance, (err, m.tolerance)
    return res


@pytest.mark.parametrize("name,level", [("logreg", 9), ("mlp", None)])
def test_port_batched_equals_eager(name, level):
    ctx = CKKSContext(CKKSParams(**W_KW), seed=7, device="cpu")
    m = getattr(models, name)(ctx.params.num_slots, bs=4)
    wp = wl.compile_workload(m, ctx.params, input_level=level)
    assert wp.n_bootstraps == 0 and len(wp.segments) == 1
    rng = np.random.default_rng(42)
    _sandwich(ctx, m, wp, [m.sample(rng) for _ in range(2)],
              input_level=level)


def test_port_bootstrap_insertion(contexts):
    """The bootstrap-inserted chain (compute -> bootstrap -> compute) at
    input level 7: compiled == eager bit for bit at fewer ModUps, within
    2e-2 of the banded reference."""
    ctx, btp = contexts["port"]
    m = models.mlp_bootstrap(ctx.params.num_slots, bs=4)
    wp = wl.compile_workload(m, ctx.params, btp=btp, input_level=7)
    assert wp.n_bootstraps == 1 and len(wp.segments) == 3
    _sandwich(ctx, m, wp, [m.sample(np.random.default_rng(42))], btp=btp,
              input_level=7)


# --------------------------- package boundary ----------------------------

def test_workloads_and_serve_import_no_jax():
    """``repro_torch.workloads`` and ``repro_torch.serve`` load neither
    JAX nor any module of the JAX package."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys\n"
        "import repro_torch.workloads, repro_torch.serve\n"
        "import repro_torch.serve.simfeed, repro_torch.convert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=src,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"
