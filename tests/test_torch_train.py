"""The port's training substrate against the JAX package's ``train/``
and ``data/``: the cases of ``tests/test_train.py``, each held against
the reference where both packages can run it.

- AdamW: the quadratic and the bf16-state cases, and one ``update``
  given the same parameters, gradients and state (step 3, non-zero
  moments, a leaf updated slice by slice) in both packages.  float32
  leaves agree within rtol 1e-6 (atol 1e-7): the same float32 operations
  in the same order, where only ``pow`` and the norm's summation order
  may differ by an ulp.  bf16 parameters and moments agree within one
  bf16 ulp of the reference's value: one float32 ulp before the cast may
  round the other way.
- Checkpoints: roundtrip, an incomplete step ignored, garbage
  collection, and a checkpoint written by either package restored by the
  other bit for bit (bf16 leaves and the int32 step included).
- int8 compression: ``q`` and ``scale`` equal to the reference's.
- The data pipeline: ``batch_at`` equal for the synthetic stream and a
  memory-mapped token file.
- The trainer: microbatch accumulation, a run at stablelm's ``REDUCED``
  that lowers the loss and resumes (port only: the reference's is
  ``slow``), a SIGTERM at step k, and one step with ``microbatches=2``
  and ``grad_compression=True`` against the reference's
  ``Trainer._train_step()`` in float32.  There the loss agrees within
  1e-5; a moment within one quantization level of its leaf (a gradient
  element within rounding of a level boundary may quantize one level
  apart); a parameter within 2 x lr (Adam's first update is nearly
  ``lr * sign(g)``, so a gradient near zero may flip the sign).
- The launcher on the CPU, and the entry points' refusal to run on a
  missing card.
"""
import dataclasses
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.train import checkpoint as ref_checkpoint  # noqa: E402
from repro.train import compression as ref_compression  # noqa: E402
from repro.train import optimizer as ref_optimizer  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    PipelineConfig, TokenPipeline,
)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.steps import value_and_grad  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.compression import (  # noqa: E402
    compress_grads_int8, decompress_grads,
)
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

CPU = torch.device("cpu")


def _t(a) -> torch.Tensor:
    """numpy (bf16 from ml_dtypes too) -> a CPU tensor, bit for bit."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(x) -> np.ndarray:
    """The raw bits of a bf16 tensor or array, as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (8 significand bits)."""
    a = np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def _close_f32_or_ulp(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    g = got.float().numpy()
    w = want.astype(np.float32)
    if want.dtype == ml_dtypes.bfloat16:
        assert got.dtype == torch.bfloat16
        assert (np.abs(g - w) <= _bf16_ulp(w)).all(), np.abs(g - w).max()
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


# ------------------------------- AdamW -----------------------------------

def test_adamw_decreases_quadratic():
    """tests/test_train.py's quadratic, and its path equal to the
    reference's after 60 steps."""
    kw = dict(lr=0.1, weight_decay=0.0, warmup_steps=1)
    opt, ref = AdamW(**kw), ref_optimizer.AdamW(**kw)
    params = {"w": torch.tensor([3.0, -2.0])}
    rparams = {"w": jnp.array([3.0, -2.0])}
    state, rstate = opt.init(params), ref.init(rparams)
    rupdate = jax.jit(ref.update)
    for _ in range(60):
        params, state = opt.update(params, {"w": 2 * params["w"]}, state)
        rparams, rstate = rupdate(rparams, {"w": 2 * rparams["w"]}, rstate)
    assert float(params["w"].abs().max()) < 0.3
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 60
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(rparams["w"]),
                               rtol=1e-5, atol=1e-6)


def test_adamw_bf16_states():
    opt = AdamW(state_dtype="bfloat16")
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["m"]["w"].dtype == torch.bfloat16
    params2, state2 = opt.update(params, {"w": torch.ones((4, 4))}, state)
    assert state2["m"]["w"].dtype == torch.bfloat16
    assert params2["w"].dtype == torch.bfloat16
    ref = ref_optimizer.AdamW(state_dtype="bfloat16")
    rp = {"w": jnp.ones((4, 4), jnp.bfloat16)}
    rp2, rs2 = ref.update(rp, {"w": jnp.ones((4, 4))}, ref.init(rp))
    np.testing.assert_array_equal(_bits(params2["w"]), _bits(rp2["w"]))
    np.testing.assert_array_equal(_bits(state2["m"]["w"]),
                                  _bits(rs2["m"]["w"]))


def _opt_case(dtype: str, rng):
    """Parameters, gradients and a step-3 state with non-zero moments,
    as numpy trees in ``dtype`` with one float32 parameter leaf, every
    moment in ``dtype``, one leaf larger than the patched CHUNK."""
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32

    def tree(scale):
        return {"a": (rng.normal(size=(6, 40)) * scale).astype(dt),
                "blocks": [{"w": (rng.normal(size=(3, 5, 7)) * scale)
                            .astype(dt)},
                           {"w": (rng.normal(size=(2, 9)) * scale)
                            .astype(dt)}],
                "f32": (rng.normal(size=(11,)) * scale).astype(np.float32)}

    params, grads = tree(1.0), tree(3.0)
    m = jax.tree.map(lambda a: a.astype(dt), tree(0.1))
    v = jax.tree.map(lambda a: np.abs(a).astype(dt), tree(0.1))
    return params, grads, {"m": m, "v": v, "step": np.int32(3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_reference(dtype, monkeypatch):
    """One update from the same parameters, gradients and state, with a
    leaf of 105 elements updated in slices of its leading axis (CHUNK
    patched to 40), clipped (global norm above 1)."""
    monkeypatch.setattr(optimizer, "CHUNK", 40)
    params, grads, state = _opt_case(dtype, np.random.default_rng(0))
    kw = dict(lr=1e-2, warmup_steps=5, state_dtype=dtype)
    ref = ref_optimizer.AdamW(**kw)
    to_j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    rp, rs = ref.update(to_j(params), to_j(grads), to_j(state))

    pp = jax.tree.map(_t, params)
    pg = jax.tree.map(_t, grads)
    ps = convert.lm_opt_state_from_numpy(state, CPU)
    assert len(optimizer.chunks(pp["blocks"][0]["w"])) == 3
    gnorm = optimizer.global_norm(pg)
    want = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float32))))
                       for g in jax.tree.leaves(grads)))
    np.testing.assert_allclose(float(gnorm), want, rtol=1e-6)
    p2, s2 = AdamW(**kw).update(pp, pg, ps)
    assert p2 is pp and s2 is ps        # in place
    assert s2["step"].dtype == torch.int32 and int(s2["step"]) == 4
    assert int(rs["step"]) == 4
    for got, r in zip(leaves(p2), jax.tree.leaves(rp)):
        _close_f32_or_ulp(got, r)
    for key in ("m", "v"):
        for got, r in zip(leaves(s2[key]), jax.tree.leaves(rs[key])):
            _close_f32_or_ulp(got, r)
    back = convert.lm_opt_state_to_numpy(s2)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 4


# ----------------------------- checkpoints --------------------------------

def _state_torch():
    return {"params": {"a": torch.arange(6).reshape(2, 3),
                       "h": torch.randn(3, 2, generator=torch.Generator()
                                        .manual_seed(0)).bfloat16(),
                       "blocks": [{"w": torch.ones((2, 2))},
                                  {"w": torch.zeros((2, 2))}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    state = _state_torch()
    mgr.save(7, state)
    step, restored = mgr.restore(device=CPU)
    assert step == 7
    np.testing.assert_array_equal(restored["params"]["a"].numpy(),
                                  np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(restored["params"]["blocks"][1]["w"],
                                  np.zeros((2, 2)))
    assert restored["params"]["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(restored["params"]["h"]),
                                  _bits(state["params"]["h"]))
    assert restored["opt"]["step"].dtype == torch.int32
    names = sorted(p.name for p in (tmp_path / "step_7").iterdir())
    assert names == ["MANIFEST.json", "shard_0.npz"]
    man = json.loads((tmp_path / "step_7" / "MANIFEST.json").read_text())
    assert man["dtypes"]["/params/h"] == "bfloat16"
    assert man["dtypes"]["/opt/step"] == "int32"


def test_checkpoint_async_copies_before_returning(tmp_path):
    """An async save holds a copy: an in-place update right after it
    does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.zeros(1000)
    mgr.save(1, {"w": w})
    w.add_(1.0)
    mgr.wait()
    _, restored = mgr.restore(device=CPU)
    assert float(restored["w"].abs().max()) == 0.0


def test_checkpoint_incomplete_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(5, {"x": torch.ones(3)})
    bad = tmp_path / "step_9"
    bad.mkdir()
    (bad / "shard_0.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 5


def test_checkpoint_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones(2)})
    assert mgr.steps() == [3, 4]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """A checkpoint of a bf16 model's parameters and AdamW state written
    by one package restores in the other bit for bit: the same files,
    keys and manifest dtypes."""
    rcfg = ref_reduced("stablelm_3b")
    rp = ref_model.init_params(rcfg, jax.random.PRNGKey(2))
    rs = ref_optimizer.AdamW(state_dtype="bfloat16").init(rp)
    rs["m"] = jax.tree.map(lambda p: (p * 0.5).astype(jnp.bfloat16), rp)
    rs["step"] = jnp.asarray(12, jnp.int32)
    ref_state = {"params": rp, "opt": rs}
    cfg = reduced_config("stablelm_3b")
    np_tree = jax.tree.map(np.asarray, ref_state)
    port_state = {
        "params": convert.lm_params_from_numpy(cfg, np_tree["params"], CPU),
        "opt": convert.lm_opt_state_from_numpy(np_tree["opt"], CPU)}
    if writer == "port":
        CheckpointManager(str(tmp_path), async_write=False).save(12,
                                                                 port_state)
        step, got = ref_checkpoint.CheckpointManager(str(tmp_path)).restore()
        flat_got = jax.tree.leaves(got)
        flat_want = jax.tree.leaves(jax.tree.map(np.asarray, ref_state))
    else:
        ref_checkpoint.CheckpointManager(
            str(tmp_path), async_write=False).save(12, ref_state)
        step, got = CheckpointManager(str(tmp_path)).restore(device=CPU)
        flat_got = leaves(got)
        flat_want = leaves(port_state)
    assert step == 12 and len(flat_got) == len(flat_want) > 10
    for g, w in zip(flat_got, flat_want):
        g = g if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w if isinstance(w, torch.Tensor) else np.asarray(w)
        assert str(g.dtype).split(".")[-1] == str(w.dtype).split(".")[-1]
        if str(w.dtype).endswith("bfloat16"):
            np.testing.assert_array_equal(_bits(g), _bits(w))
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    man = json.loads((tmp_path / "step_12" / "MANIFEST.json").read_text())
    assert man["dtypes"]["/opt/step"] == "int32"
    assert man["dtypes"]["/params/embed"] == "bfloat16"


# ----------------------------- compression --------------------------------

def test_grad_compression_equals_reference():
    """q and scale equal the reference's; the dequantized error is
    within one level, as tests/test_train.py bounds it."""
    rng = np.random.default_rng(0)
    grads = {"a": rng.normal(size=(64, 64)).astype(np.float32),
             "b": rng.normal(size=(17,)).astype(np.float32),
             "c": (rng.normal(size=(5, 6)) * 1e-3).astype(
                 ml_dtypes.bfloat16)}
    comp = compress_grads_int8(jax.tree.map(_t, grads))
    rcomp = ref_compression.compress_grads_int8(
        jax.tree.map(jnp.asarray, grads))
    for k in grads:
        assert comp[k]["q"].dtype == torch.int8
        np.testing.assert_array_equal(comp[k]["q"].numpy(),
                                      np.asarray(rcomp[k]["q"]))
        assert float(comp[k]["scale"]) == float(rcomp[k]["scale"])
    deq = decompress_grads(comp)
    for k in grads:
        g = np.asarray(grads[k], np.float32)
        err = np.abs(deq[k].numpy() - g).max()
        assert err <= np.abs(g).max() / 127.0 + 1e-6


# ------------------------------- pipeline ---------------------------------

@pytest.mark.parametrize("source", ["synthetic", "memmap"])
def test_pipeline_equals_reference(tmp_path, source):
    path = None
    if source == "memmap":
        path = str(tmp_path / "tokens.i32")
        np.random.default_rng(4).integers(0, 64, 5000).astype(
            np.int32).tofile(path)
    kw = dict(vocab=64, seq_len=8, global_batch=4, seed=3, path=path)
    port = TokenPipeline(PipelineConfig(**kw))
    ref = ref_pipeline.TokenPipeline(ref_pipeline.PipelineConfig(**kw))
    for step in (0, 11, 12):
        b, r = port.batch_at(step), ref.batch_at(step)
        assert sorted(b) == ["labels", "tokens"]
        for k in b:
            assert b[k].dtype == np.int32 and b[k].shape == (4, 8)
            np.testing.assert_array_equal(b[k], r[k])
    # restart-exact, and labels are the next tokens
    again = TokenPipeline(PipelineConfig(**kw)).batch_at(11)
    np.testing.assert_array_equal(again["tokens"], port.batch_at(11)["tokens"])
    if source == "synthetic":
        np.testing.assert_array_equal(port.batch_at(11)["labels"],
                                      port._synthetic(11)[:, 1:])


# -------------------------------- trainer ---------------------------------

def test_microbatch_accumulation_equivalent():
    """tests/test_train.py's case on the port: grad(batch) == the mean
    of the grads of its two halves, at that test's tolerance (bf16)."""
    cfg = reduced_config("qwen2_vl_2b")
    params = model.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)))
    pos = torch.arange(8)[None, None].expand(3, 4, 8)
    batch = {"tokens": toks, "labels": toks, "positions": pos}
    _, g_full = value_and_grad(params, batch, cfg)
    halves = [value_and_grad(params, {"tokens": toks[sl], "labels": toks[sl],
                                      "positions": pos[:, sl]}, cfg)[1]
              for sl in (slice(0, 2), slice(2, 4))]
    for f, a, b in zip(leaves(g_full), leaves(halves[0]),
                       leaves(halves[1])):
        np.testing.assert_allclose(f.float().numpy(),
                                   ((a.float() + b.float()) / 2).numpy(),
                                   rtol=0.15, atol=2e-2)


def _stablelm_trainer(tmp_path, total, **kw):
    cfg = reduced_config("stablelm_3b")
    tcfg = TrainerConfig(total_steps=total, ckpt_every=10,
                         ckpt_dir=str(tmp_path), log_every=100, **kw)
    return cfg, Trainer(cfg, tcfg, AdamW(lr=2e-3, warmup_steps=5))


def test_trainer_loss_decreases_and_resumes(tmp_path):
    """tests/test_train.py's slow end-to-end case on the port: 30 steps
    at stablelm's REDUCED lower the loss by 0.1, and a resume runs only
    the remaining steps from the checkpoint, bit for bit."""
    cfg, tr = _stablelm_trainer(tmp_path, 30)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=16,
                                        global_batch=8, seed=0))
    params_out, opt_out, losses = tr.run(params, pipe, resume=False)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, \
        f"loss did not decrease: {losses[:3]} -> {losses[-3:]}"
    assert tr.ckpt.steps() == [10, 20, 30]
    _, saved = tr.ckpt.restore(device=CPU)
    for a, b in zip(leaves(saved["params"]), leaves(params_out)):
        assert a.dtype == b.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(saved["opt"]["step"]) == int(opt_out["step"]) == 30

    _, tr2 = _stablelm_trainer(tmp_path, 35)
    fresh = model.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    _, opt2, losses2 = tr2.run(fresh, pipe, resume=True)
    assert len(losses2) == 5, "resume should only run the remaining steps"
    assert int(opt2["step"]) == 35


def test_trainer_sigterm_checkpoints(tmp_path):
    """A SIGTERM that arrives while step k = 4 runs (in its batch_at(3))
    ends the run after that step with a checkpoint at k, and the handler
    in place before the run is back after it."""
    cfg, tr = _stablelm_trainer(tmp_path, 30)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=8,
                                        global_batch=2, seed=0))
    batch_at = pipe.batch_at

    def kill_in_step_4(step):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch_at(step)

    pipe.batch_at = kill_in_step_4
    seen = []

    def mine(*args):
        seen.append(args)

    old = signal.signal(signal.SIGTERM, mine)
    try:
        _, _, losses = tr.run(params, pipe, resume=False)
        after = signal.getsignal(signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert after is mine and not seen
    assert len(losses) == 4 and tr.ckpt.steps() == [4]


def test_trainer_step_equals_reference():
    """One ``Trainer`` step with microbatches=2 and int8 compression
    against the reference's ``Trainer._train_step()`` (one jax.jit) on
    the same float32 weights and batch; tolerances in the module
    docstring."""
    arch = "phi3_medium_14b"
    rcfg = dataclasses.replace(ref_reduced(arch), dtype="float32")
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    kw = dict(total_steps=1, microbatches=2, grad_compression=True)
    lr = 1e-2
    ref = ref_trainer.Trainer(rcfg, ref_trainer.TrainerConfig(**kw),
                              ref_optimizer.AdamW(lr=lr, warmup_steps=1))
    port = Trainer(cfg, TrainerConfig(**kw), AdamW(lr=lr, warmup_steps=1))
    rp = ref_model.init_params(rcfg, jax.random.PRNGKey(4))
    pp = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rp), CPU)
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=16,
                                         global_batch=4, seed=1)).batch_at(0)
    rs = ref.opt.init(rp)
    want_p = jax.tree.map(np.asarray, rp)    # the step donates rp
    rp2, rs2, rloss = ref._train_step()(
        rp, rs, {k: jnp.asarray(v) for k, v in batch.items()})
    pp2, ps2, loss = port._train_step()(
        pp, port.opt.init(pp), {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert abs(float(loss) - float(rloss)) < 1e-5
    assert int(ps2["step"]) == int(rs2["step"]) == 1
    for got, r in zip(leaves(ps2["m"]), jax.tree.leaves(rs2["m"])):
        r = np.asarray(r)
        level = np.abs(r).max() / 127.0
        np.testing.assert_allclose(got.numpy(), r, rtol=0,
                                   atol=1.01 * level + 1e-7)
    moved = 0
    for got, r, p0 in zip(leaves(pp2), jax.tree.leaves(rp2),
                          jax.tree.leaves(want_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=0,
                                   atol=2 * lr)
        moved += int((got.numpy() != p0).any())
    assert moved == len(leaves(pp2))


# ------------------------------- launcher ---------------------------------

def test_launcher_on_cpu(tmp_path, capsys):
    losses = launch_train.main(["--reduced", "--device", "cpu", "--steps",
                                "3", "--no-resume", "--ckpt-dir",
                                str(tmp_path), "--seq", "16"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "stablelm-3b-smoke" in out and "over 3 steps" in out
    assert CheckpointManager(str(tmp_path)).steps() == [3]


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The default device is the card; with none, the training entry
    points raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                           str(tmp_path)])
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="cuda"):
        mgr.restore()
    state = {"m": {"w": np.zeros(2, np.float32)},
             "v": {"w": np.zeros(2, np.float32)}, "step": np.int32(0)}
    with pytest.raises(RuntimeError, match="cuda"):
        convert.lm_opt_state_from_numpy(state)
