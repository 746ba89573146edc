"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a device.
They import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.params import PAPER_PARAMS, CKKSParams  # noqa: E402
from repro_torch.core.rns import RNSContext  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.bconv.ops import BConvConsts, bconv, bconv_plain  # noqa: E402
from repro_torch.kernels.fused_ip.ops import IPConsts, fused_ip, fused_ip_plain  # noqa: E402
from repro_torch.kernels.modup.ops import ModUpConsts, modup, modup_plain  # noqa: E402
from repro_torch.kernels.ntt.ops import (  # noqa: E402
    NTTTables, cluster_bits, ntt_fwd, ntt_fwd_plain, ntt_inv, ntt_inv_plain,
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
    """Every kernel against its plain version on the card, the all-digit
    ModUp at an even and at a short last digit."""
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
    for level in (4, 3):  # digits (2, 2, 1) and (2, 2)
        chain = p.q_chain(level)
        mc = ModUpConsts(rns, tabs, p.digit_groups(level), chain,
                         chain + p.p_primes, cuda)
        xd = _res(rng, chain, (2, len(chain), p.N)).to(cuda)
        assert torch.equal(modup(xd, mc), modup_plain(xd, mc))


@pytest.mark.cuda
@pytest.mark.parametrize("logn", [8, 12, 16])
def test_cuda_bconv_sweep(cuda, logn):
    """The BConv kernel equals its plain version word for word across
    source and destination row counts (groups of 4 source rows cut short,
    padded row groups), unbatched and in batches of 1 to 3, on random and
    all-(q-1) residues; every call is one CUDA launch without a cluster."""
    p = CKKSParams(logN=logn, L=44, alpha=1, k=33)
    rns = RNSContext(p)
    rng = np.random.default_rng(logn)
    native.build_all()
    for ls in (1, 2, 5, 11, 12, 32):
        for ld in (1, 3, 34, 35, 36, 45):
            c = BConvConsts(rns, p.p_primes[:ls], p.q_chain(44)[:ld], cuda)
            for lead in ((), (1,), (2,), (3,)):
                rand = _res(rng, c.src, lead + (ls, p.N)).to(cuda)
                top = (c.src_q[:, None] - 1).expand(rand.shape).contiguous()
                for x in (rand, top):
                    native.launch_log("bconv")
                    got = bconv(x, c)
                    assert native.launch_log("bconv") == (1, [1])
                    assert torch.equal(got, bconv_plain(
                        x, c.qhat_inv, c.src_q, c.qhat_mod, c.dst_q)), \
                        (ls, ld, lead)


@pytest.mark.cuda
def test_cuda_bconv_refuses(cuda):
    """A non-contiguous operand raises before any launch; nothing falls
    back.  More than 32 source rows and an operand that is not 16-byte
    aligned are no longer refused (``test_cuda_bconv_wide_and_unaligned``
    runs them)."""
    p = CKKSParams(logN=8, L=44, alpha=1, k=33)
    rns = RNSContext(p)
    native.build_all()
    native.launch_log("bconv")
    c = BConvConsts(rns, p.p_primes[:4], p.q_chain(44)[:3], cuda)
    x = torch.zeros((p.N, 4), dtype=torch.int64, device=cuda).T
    with pytest.raises(ValueError, match="not contiguous"):
        bconv(x, c)
    assert native.launch_log("bconv") == (0, [])


@pytest.mark.cuda
@pytest.mark.parametrize("logn", [8, 16])
def test_cuda_bconv_wide_and_unaligned(cuda, logn):
    """Source rows past the kernel's chunk of 32 (ModDown at dnum = 1:
    36 -> 36; 33 and 64 rows), unbatched and batched, and operands 8
    bytes past a 16-byte boundary: one CUDA launch a call, equal to the
    plain version word for word."""
    p = CKKSParams(logN=logn, L=35, alpha=36, k=64)
    rns = RNSContext(p)
    rng = np.random.default_rng(logn + 36)
    native.build_all()
    for ls, ld in ((36, 36), (33, 1), (64, 45), (12, 36), (1, 35)):
        c = BConvConsts(rns, p.p_primes[:ls], p.q_chain(35)[:ld], cuda)
        for lead in ((), (2,)):
            x = _res(rng, c.src, lead + (ls, p.N)).to(cuda)
            flat = torch.empty(x.numel() + 1, dtype=torch.int64, device=cuda)
            odd = flat[1:].view(x.shape)
            odd.copy_(x)
            assert odd.data_ptr() % 16 == 8
            want = bconv_plain(x, c.qhat_inv, c.src_q, c.qhat_mod, c.dst_q)
            for operand in (x, odd):
                native.launch_log("bconv")
                got = bconv(operand, c)
                assert native.launch_log("bconv") == (1, [1])
                assert torch.equal(got, want), (ls, ld, lead)


@pytest.mark.cuda
@pytest.mark.parametrize("logn", [10, 12, 14, 15, 16])
def test_cuda_ntt_natural_order(cuda, logn):
    """One CUDA launch a call, natural order at both ends, equal to the
    plain version: unbatched, batched and with repeated primes, on one
    block a row (logN <= 13) and on clusters of 2 (logN 14), 4 (logN 15)
    and 8 (logN 16), as the library's own launch log reports."""
    p = CKKSParams(logN=logn, L=5, alpha=2, k=2, q_bits=29)
    tabs = NTTTables(RNSContext(p))
    rng = np.random.default_rng(logn)
    base = p.q_chain(p.L)
    tiled = base + p.p_primes + base[:2]
    cases = [(base, ()), (base, (2,)), (tiled, (3,)), (base[:1], (12,)),
             (base[:1], (40,))]
    cluster = 1 << cluster_bits(logn)
    for primes, lead in cases:
        x = _res(rng, primes, lead + (len(primes), p.N)).to(cuda)
        before = native.LAUNCHES["ntt"]
        native.build_all()
        native.launch_log("ntt")
        f = ntt_fwd(x, primes, tabs)
        assert native.launch_log("ntt") == (1, [cluster])
        assert torch.equal(f, ntt_fwd_plain(
            x, *tabs.plain_rows(primes, cuda, False)))
        assert torch.equal(ntt_inv(f, primes, tabs), x)
        assert native.launch_log("ntt") == (1, [cluster])
        assert torch.equal(ntt_inv(x, primes, tabs), ntt_inv_plain(
            x, *tabs.plain_rows(primes, cuda, True)))
        assert native.LAUNCHES["ntt"] == before + 3


@pytest.mark.cuda
def test_cuda_modup_all_paper_level(cuda):
    """The all-digit ModUp at the paper's logN = 16, level 35 (digits of
    12) and level 34 (12, 12, 11), one wrapper call each, two CUDA
    launches in clusters of 8."""
    P = PAPER_PARAMS
    rns = RNSContext(P)
    tabs = NTTTables(rns)
    rng = np.random.default_rng(35)
    for level, batch in ((35, ()), (34, (2,))):
        chain = P.q_chain(level)
        mc = ModUpConsts(rns, tabs, P.digit_groups(level), chain,
                         chain + P.p_primes, cuda)
        x = _res(rng, chain, batch + (len(chain), P.N)).to(cuda)
        before = native.LAUNCHES["modup"]
        native.build_all()
        native.launch_log("modup")
        got = modup(x, mc)
        assert native.LAUNCHES["modup"] == before + 1
        assert native.launch_log("modup") == (2, [8, 8])
        assert torch.equal(got, modup_plain(x, mc))


@pytest.mark.cuda
def test_cuda_refused_launch_raises(cuda):
    """A shape the kernel does not take, or a cluster size it does not
    launch, raises at the call; nothing falls back, nothing is launched."""
    native.build_all()
    native.launch_log("ntt")
    p = CKKSParams(logN=4, L=1, alpha=1, k=1, q_bits=29)
    tabs = NTTTables(RNSContext(p))
    x = torch.zeros((2, p.N), dtype=torch.int64, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ntt_fwd(x, p.q_chain(1), tabs)
    p = CKKSParams(logN=12, L=1, alpha=1, k=1, q_bits=29)
    tabs = NTTTables(RNSContext(p))
    x = torch.zeros((2, p.N), dtype=torch.int64, device=cuda)
    y = torch.empty_like(x)
    t = tabs.mont_tables(cuda)
    for logc in (4, 8):
        with pytest.raises(RuntimeError, match="CUDA error"):
            native.call("ntt", "ntt_forward", x.data_ptr(), y.data_ptr(),
                        t["twist_f"].data_ptr(), t["tw_f"].data_ptr(),
                        tabs.row_map(p.q_chain(1), cuda).data_ptr(),
                        t["q"].data_ptr(), t["qn"].data_ptr(), 2, 2,
                        p.logN, logc)
    assert native.launch_log("ntt") == (0, [])


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


@pytest.mark.cuda
def test_cuda_batched_rescale_one_launch(cuda):
    """``run_batched``'s rescale is one ``poly.rescale`` over both
    components of every ciphertext: one BConv launch with 2 x B source
    rows, equal to each ciphertext's own rescale."""
    from repro_torch.core.ckks import CKKSContext
    from repro_torch.runtime import (
        ProgramExecutor, TraceContext, compile_program,
    )

    p = CKKSParams(logN=12, L=4, alpha=2, k=3, q_bits=29)
    ctx = CKKSContext(p, seed=5, device=cuda)
    rng = np.random.default_rng(5)
    cts = [ctx.encrypt(rng.uniform(-1, 1, p.num_slots)) for _ in range(3)]
    tc = TraceContext(p)
    tc.output(tc.rescale(tc.input("x")), "y")
    comp = compile_program(tc)
    ex = ProgramExecutor(ctx)
    native.reset_counts()
    outs = ex.run_batched(comp, {"x": cts})["y"]
    torch.cuda.synchronize()
    assert native.LAUNCHES["bconv"] == 1
    assert native.launch_log("bconv")[0] == 1
    assert {k: v for k, v in native.CALLS.items() if k[0] == "bconv"} \
        == {("bconv", (2, 3, 1, p.L)): 1}
    for got, ct in zip(outs, cts):
        want = ctx.rescale(ct)
        assert (got.level, got.scale) == (want.level, want.scale)
        assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)


@pytest.mark.cuda
@pytest.mark.parametrize("fusion", [False, True])
def test_cuda_runtime_equals_cpu(cuda, fusion):
    """A compiled BSGS matvec -> Chebyshev program at logN=12 gives the
    CPU's residues on the card, with ``run`` and ``run_batched``."""
    from repro_torch.core import linear, polyeval
    from repro_torch.core.ckks import CKKSContext
    from repro_torch.runtime import (
        ProgramExecutor, TraceContext, compile_program,
    )

    p = CKKSParams(logN=12, L=8, alpha=2, k=3, q_bits=29)
    rng = np.random.default_rng(12)
    nh = p.num_slots
    diags = {d: rng.uniform(-1, 1, nh) / 8 for d in range(8)}
    coeffs = polyeval.chebyshev_coeffs(np.tanh, 7)
    xs = [rng.uniform(-1, 1, nh) for _ in range(2)]
    tc = TraceContext(p)
    h = linear.matvec_bsgs(tc, tc.input("x"), diags, bs=4)
    tc.output(polyeval.eval_chebyshev(tc, h, coeffs), "y")
    comp = compile_program(tc, fusion=fusion)
    outs = []
    for dev in (cuda, "cpu"):
        ctx = CKKSContext(p, seed=6, device=dev)
        cts = [ctx.encrypt(x) for x in xs]
        ex = ProgramExecutor(ctx)
        outs.append([ex.run(comp, {"x": cts[0]})["y"]]
                    + ex.run_batched(comp, {"x": cts})["y"])
    for a, b in zip(*outs):
        assert (a.level, a.scale) == (b.level, b.scale)
        assert torch.equal(a.c0.cpu(), b.c0) and torch.equal(a.c1.cpu(), b.c1)
    assert torch.equal(outs[1][0].c0, outs[1][1].c0)


@pytest.mark.cuda
def test_cuda_bootstrap_equals_cpu(cuda):
    """The compiled bootstrap at logN=8, L=19 (the shape of
    tests/test_runtime_bootstrap.py:157) gives the CPU's residues on the
    card; on the card its ``run_batched`` slot and the eager
    ``bootstrap`` equal its ``run``."""
    from repro_torch.core.bootstrap import Bootstrapper
    from repro_torch.core.ckks import CKKSContext
    from repro_torch.runtime import ProgramExecutor

    p = CKKSParams(logN=8, L=19, alpha=4, k=4, q_bits=29, scale_bits=29,
                   q0_bits=30)
    rng = np.random.default_rng(157)
    zs = [(rng.normal(size=p.num_slots) + 1j * rng.normal(size=p.num_slots))
          * 0.01 for _ in range(2)]
    outs = {}
    for dev in (cuda, "cpu"):
        ctx = CKKSContext(p, seed=7, hamming_weight=8, device=dev)
        btp = Bootstrapper(ctx, n_groups=2, mod_K=3, cheb_degree=27)
        cts = [ctx.encrypt(z, level=0) for z in zs]
        comp = btp.compile(input_scale=cts[0].scale)
        ex = ProgramExecutor(ctx)
        outs[str(dev)] = ex.run(comp, {"ct": cts[0]})["out"]
        if dev == cuda:
            card = [ex.run_batched(comp, {"ct": cts})["out"][0],
                    btp.bootstrap(cts[0])]
    got, want = outs[str(cuda)], outs["cpu"]
    for ct in [got] + card:
        assert (ct.level, ct.scale) == (want.level, want.scale)
        assert torch.equal(ct.c0.cpu(), want.c0)
        assert torch.equal(ct.c1.cpu(), want.c1)


@pytest.mark.cuda
def test_cuda_serving_equals_cpu(cuda):
    """A four-request trace of logreg (degree 7 at logN=10, L=8) from two
    tenants, served by ``FHEServer`` (batches of 2) on the card and on
    the CPU: the same outcomes and batch log, and the same residues."""
    from repro_torch.core.ckks import CKKSContext
    from repro_torch.serve import Arrival, FHEServer, workload_request_programs
    from repro_torch.workloads import logreg

    p = CKKSParams(logN=10, L=8, alpha=2, k=3, q_bits=29, scale_bits=29)
    m = logreg(p.num_slots, degree=7, bs=4)
    programs, _ = workload_request_programs([m], p)
    trace = [Arrival(0.0, t, m.name) for t in ("alice", "bob") * 2]
    runs = []
    for dev in (cuda, "cpu"):
        ctx = CKKSContext(p, seed=3, device=dev)
        server = FHEServer(ctx, max_batch=2, max_wait_s=0.0)
        server.register_program(m.name, programs[m.name])
        rng = np.random.default_rng(4)
        rep = server.run_trace(
            trace, lambda a: {"x": ctx.encrypt(m.sample(rng))})
        assert rep.completed == 4 and rep.failed == 0
        runs.append((server.outputs, [(r.rids, r.batch, r.ok)
                                      for r in server.records]))
    (card, log_card), (cpu, log_cpu) = runs
    assert log_card == log_cpu
    for rid in range(4):
        a, b = card[rid]["y"], cpu[rid]["y"]
        assert (a.level, a.scale) == (b.level, b.scale)
        assert torch.equal(a.c0.cpu(), b.c0) and torch.equal(a.c1.cpu(), b.c1)


@pytest.mark.cuda
@pytest.mark.parametrize("logn", [12, 16])
def test_cuda_distributed_ip_equals_plain(cuda, tmp_path, logn):
    """IRF and EVF on an NCCL group of one rank: the local inner product
    goes through the fused-IP kernel (R = 1, no plaintext), once each,
    and both equal the plain version residue for residue, at the paper's
    dnum = 3 and l_ext = 48."""
    import torch.distributed as dist

    from repro_torch.core import distributed

    p = PAPER_PARAMS if logn == 16 else CKKSParams(logN=logn, L=35,
                                                   alpha=12, k=12)
    ext = p.q_chain(35) + p.p_primes
    rng = np.random.default_rng(logn)
    digits = _res(rng, ext, (3, len(ext), p.N)).to(cuda)
    evk = _res(rng, ext, (3, 2, len(ext), p.N)).to(cuda)
    want = fused_ip_plain(digits[None], evk[None], None,
                          torch.tensor(ext, device=cuda))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        for make in (distributed.ip_irf, distributed.ip_evf):
            fn, world = make()
            assert world == 1
            before = native.LAUNCHES["fused_ip"]
            got = torch.stack(fn(digits, evk, ext))
            assert native.LAUNCHES["fused_ip"] == before + 1
            assert torch.equal(got, want)
            assert distributed.measure_collectives(
                fn, digits, evk, ext)["total_bytes"] == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_lm_forward_equals_cpu(cuda):
    """phi3-medium-14b at full width, cut to two layers, in float32 (TF32
    off): the same weights give the same logits on the card and on the
    CPU within 1e-3 (summation order only)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import forward, init_params

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config("phi3_medium_14b"), n_layers=2,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)

    def to_cpu(t):
        return ({k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict)
                else [to_cpu(v) for v in t] if isinstance(t, list)
                else t.cpu())

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        card, _ = forward(params, toks.to(cuda), cfg)
        cpu, _ = forward(to_cpu(params), toks, cfg)
    assert torch.isfinite(cpu).all()
    assert float((card.cpu() - cpu).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [
    "minicpm3_4b", "moonshot_v1_16b_a3b", "arctic_480b",
    "jamba_1_5_large_398b", "xlstm_1_3b", "qwen2_vl_2b", "whisper_base"])
def test_cuda_lm_zoo_forward_equals_cpu(cuda, arch):
    """Each family of the LM zoo beyond the dense one at its reduced
    config in float32 (TF32 off): the same weights give the same prefill
    logits, and the same logits and caches after four decode steps, on
    the card and on the CPU within 1e-3 (summation order only)."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models.model import forward, init_cache, init_params

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)

    def tree(fn, t):
        return ({k: tree(fn, v) for k, v in t.items()} if isinstance(t, dict)
                else [tree(fn, v) for v in t] if isinstance(t, list)
                else fn(t))

    p_cpu = tree(lambda t: t.cpu(), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        card, _ = forward(params, toks.to(cuda), cfg)
        cpu, _ = forward(p_cpu, toks, cfg)
        assert torch.isfinite(cpu).all()
        assert float((card.cpu() - cpu).abs().max()) <= 1e-3
        c_card = init_cache(cfg, 2, 8, device=cuda)
        c_cpu = init_cache(cfg, 2, 8, device="cpu")
        for t in range(4):
            card, c_card = forward(params, toks[:, t:t + 1].to(cuda), cfg,
                                   cache=c_card)
            cpu, c_cpu = forward(p_cpu, toks[:, t:t + 1], cfg, cache=c_cpu)
            assert float((card.cpu() - cpu).abs().max()) <= 1e-3

    def leaves(t):
        out = []
        tree(out.append, t)
        return out

    assert max(float((a.cpu() - b).abs().max()) for a, b in
               zip(leaves(c_card["slots"]), leaves(c_cpu["slots"]))) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [
    "stablelm_3b", "minicpm3_4b", "phi3_medium_14b", "command_r_35b",
    "arctic_480b", "moonshot_v1_16b_a3b", "jamba_1_5_large_398b",
    "qwen2_vl_2b", "xlstm_1_3b", "whisper_base"])
def test_cuda_train_step_equals_cpu(cuda, arch):
    """One ``make_train_step`` step of each architecture at its reduced
    config in float32 (TF32 off), from the same weights and batch on the
    card and on the CPU: the loss and every gradient leaf within 1e-4 of
    the leaf's scale (its max magnitude, floored at 1e-3 of the tree's
    largest: a gradient zero in exact arithmetic is rounding noise), and
    the updated weights within 2 x lr (Adam's first step is nearly
    ``lr * sign(g)``)."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models.model import init_params
    from repro_torch.models.steps import make_train_step, value_and_grad
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.tree import leaves, tree_map

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    p_cpu = tree_map(lambda t: t.cpu(), params)
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2)).batch_at(0).items()}
    loss_cpu, g_cpu = value_and_grad(p_cpu, batch, cfg)
    loss, g = value_and_grad(params, {k: v.to(cuda)
                                      for k, v in batch.items()}, cfg)
    assert abs(float(loss) - float(loss_cpu)) <= 1e-4 * float(loss_cpu)
    flat_cpu = leaves(g_cpu)
    top = max(float(t.abs().max()) for t in flat_cpu)
    for a, b in zip(leaves(g), flat_cpu):
        scale = max(float(b.abs().max()), 1e-3 * top)
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale
    lr = 1e-2
    opt = AdamW(lr=lr, warmup_steps=1)
    step = make_train_step(cfg, opt)
    step(params, opt.init(params), {k: v.to(cuda) for k, v in batch.items()})
    step(p_cpu, opt.init(p_cpu), batch)
    for a, b in zip(leaves(params), leaves(p_cpu)):
        assert float((a.cpu() - b).abs().max()) <= 2 * lr


@pytest.mark.cuda
def test_cuda_trainer_lowers_loss_and_resumes(cuda, tmp_path):
    """tests/test_train.py's end-to-end case on the card: 30 steps at
    stablelm's reduced config lower the loss by 0.1, and a resume runs
    only the remaining steps."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = reduced_config("stablelm_3b")
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=16,
                                        global_batch=8, seed=0))

    def run(total: int, resume: bool):
        tcfg = TrainerConfig(total_steps=total, ckpt_every=10,
                             ckpt_dir=str(tmp_path), log_every=100)
        params = init_params(cfg, torch.Generator(device=cuda)
                             .manual_seed(0), cuda)
        tr = Trainer(cfg, tcfg, AdamW(lr=2e-3, warmup_steps=5))
        return tr.run(params, pipe, resume=resume)[2]

    losses = run(30, False)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert len(run(35, True)) == 5
