"""The partitioned blocks (``models.partition``) on a real mesh compute
what the plain blocks compute.

One subprocess spawns 4 gloo ranks, which meet through a file in the
test's tmp dir, and lays them out as two ``("data", "model")`` meshes in
turn: 2 x 2 and 1 x 4.  On each mesh every case below runs in float32
twice on the same inputs (drawn from one seeded generator on every
rank): plain, and on DTensors placed by ``launch/plan.py``'s plans
(parameters, batch, decode cache), where the embedding, attention, MLA,
the MLP, the MoE, the head, the loss and the greedy pick run as
``models.partition`` regions.  Held, at 1e-5 of each tensor's max
magnitude (floored at 1e-2): the loss and the gradient of every
parameter leaf (``value_and_grad``), the prefill logits, a decode step's
logits and updated cache, and (exactly) the next tokens of
``make_serve_step``.  Biases and norms get random values, so that a
region that uses a weight the plain block does not (or the reverse)
shows.

The cases reach every branch of the regions: heads that divide
``model`` (kv heads shared evenly, unevenly, or one for several ranks),
heads that do not (query rows split over ``model``, or every rank the
whole block when the rows do not divide either), MLA, MoE with and
without a dense residual FFN, M-RoPE, a sliding-window ring buffer, and
whisper's encoder and cross attention.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# (case, arch, REDUCED config overrides, sequence length)
CASES = [
    ("phi3", "phi3_medium_14b", {}, 8),
    ("phi3_kv4", "phi3_medium_14b", {"n_kv_heads": 4}, 8),
    ("phi3_h6", "phi3_medium_14b",
     {"n_heads": 6, "n_kv_heads": 3, "head_dim": 16}, 8),
    ("phi3_h6_s6", "phi3_medium_14b",
     {"n_heads": 6, "n_kv_heads": 3, "head_dim": 16}, 6),
    ("phi3_window", "phi3_medium_14b", {"sliding_window": 4}, 8),
    ("minicpm3", "minicpm3_4b", {}, 8),
    ("minicpm3_h6", "minicpm3_4b", {"n_heads": 6}, 8),
    ("minicpm3_h6_s6", "minicpm3_4b", {"n_heads": 6}, 6),
    ("moonshot", "moonshot_v1_16b_a3b", {}, 8),
    ("arctic", "arctic_480b", {}, 8),
    ("qwen2_vl", "qwen2_vl_2b", {}, 8),
    ("whisper", "whisper_base", {}, 8),
    ("whisper_h6", "whisper_base",
     {"n_heads": 6, "n_kv_heads": 6, "head_dim": 16}, 8),
]
RTOL, FLOOR = 1e-5, 1e-2

RANKS = textwrap.dedent("""
    import contextlib
    import dataclasses
    import json
    import multiprocessing as mp
    import sys

    B, SC, IDX = 4, 16, 5


    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}"))
            return out
        if isinstance(tree, (list, tuple)):
            out = {}
            for i, v in enumerate(tree):
                out.update(flat(v, f"{prefix}#{i}"))
            return out
        return {prefix: tree}


    def run_case(mesh, arch, over, S, seen):
        import torch
        from torch.distributed.tensor import DTensor, distribute_tensor
        from torch.distributed.tensor.experimental import (
            implicit_replication,
        )

        from repro_torch.configs import reduced_config
        from repro_torch.launch import plan
        from repro_torch.models.model import forward, init_cache, init_params
        from repro_torch.models.steps import make_serve_step, value_and_grad
        from repro_torch.train.tree import tree_map

        cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                                  **over)
        gen = torch.Generator().manual_seed(1)
        params = init_params(cfg, gen, device="cpu")
        for t in flat(params).values():
            t.add_(0.1 * torch.randn(t.shape, generator=gen))
        labels = torch.randint(0, cfg.vocab, (B, S), generator=gen)
        labels[:, :2] = -1
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S),
                                         generator=gen).int(),
                 "labels": labels.int()}
        dec = {"tokens": torch.randint(0, cfg.vocab, (B, 1), generator=gen)}
        if cfg.frontend == "audio":
            frames = torch.randn((B, 12, cfg.d_model), generator=gen)
            batch["embeds"] = dec["embeds"] = frames
        cache = init_cache(cfg, B, SC, device="cpu")
        for t in flat(cache["slots"]).values():
            t.copy_(torch.randn(t.shape, generator=gen))
        cache["idx"] = IDX

        def fresh(slots):
            return {"slots": slots(tree_map(lambda t: t.clone(),
                                            cache["slots"])), "idx": IDX}

        def run(p, b, d, slots):
            out = {}
            loss, grads = value_and_grad(p, b, cfg)
            out["loss"] = loss
            out.update({f"grad{k}": v for k, v in flat(grads).items()})
            with torch.no_grad():
                out["prefill"] = forward(p, b["tokens"], cfg,
                                         embeds=b.get("embeds"))[0]
                c = fresh(slots)
                out["decode"] = forward(p, d["tokens"], cfg, cache=c,
                                        embeds=d.get("embeds"))[0]
                out.update({f"cache{k}": v
                            for k, v in flat(c["slots"]).items()})
                out["next"] = make_serve_step(cfg)(p, fresh(slots), d)[0]
            return out

        want = run(params, batch, dec, lambda s: s)
        seen.clear()

        def place(tree, plans):
            return tree_map(lambda t, pl: distribute_tensor(
                t, mesh, pl.placements), tree, plans)

        c_plan = plan.cache_plan(cfg, mesh, cache)
        with implicit_replication():
            got = run(place(params, plan.param_plan(cfg, mesh, params)),
                      place(batch, plan.batch_plan(mesh, batch)),
                      place(dec, plan.batch_plan(mesh, dec)),
                      lambda s: place(s, c_plan["slots"]))
        res = {"regions": sorted(seen), "errors": {}}
        for k, w in want.items():
            g = got[k]
            if isinstance(g, DTensor):
                g = g.full_tensor()
            w, g = w.detach().double(), g.detach().double()
            same = tuple(g.shape) == tuple(w.shape)
            res["errors"][k] = [
                float((g - w).abs().max()) if same else float("inf"),
                float(w.abs().max())]
        return res


    def rank_main(rank, world, tmp, meshes, cases):
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.models import partition

        torch.set_num_threads(1)
        seen = set()
        inner = partition._region

        @contextlib.contextmanager
        def spy(name):
            seen.add(name)
            with inner(name):
                yield

        partition._region = spy
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                world_size=world, rank=rank)
        try:
            out = {}
            for mname, shape in meshes.items():
                mesh = init_device_mesh("cpu", tuple(shape),
                                        mesh_dim_names=("data", "model"))
                for name, arch, over, S in cases:
                    out[f"{mname}/{name}"] = run_case(mesh, arch, over, S,
                                                      seen)
            if rank == 0:
                with open(f"{tmp}/result.json", "w") as f:
                    json.dump(out, f)
            dist.barrier()
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        world, tmp = int(sys.argv[1]), sys.argv[2]
        meshes, cases = json.loads(sys.argv[3]), json.loads(sys.argv[4])
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main,
                             args=(r, world, tmp, meshes, cases))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=240)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
        print(json.dumps({"exitcodes": codes}))
        sys.exit(0 if all(c == 0 for c in codes) else 1)
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Per ``mesh/case``: the regions that ran and, per checked tensor,
    (max abs difference, the plain tensor's max magnitude)."""
    tmp = tmp_path_factory.mktemp("partition_mesh")
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(script), str(WORLD), str(tmp),
         json.dumps(MESHES), json.dumps(CASES)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return json.loads((tmp / "result.json").read_text())


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_partitioned_step_equals_plain(results, mesh, case):
    res = results[f"{mesh}/{case}"]
    arch = next(c[1] for c in CASES if c[0] == case)
    mixer = "mla" if arch.startswith("minicpm3") else "attention"
    ffn = "moe" if arch in ("moonshot_v1_16b_a3b", "arctic_480b") else "mlp"
    for region in ("embed", mixer, ffn, "head", "loss", "argmax"):
        assert region in res["regions"], (region, res["regions"])
    errors = res["errors"]
    assert any(k.startswith("grad") for k in errors)
    assert any(k.startswith("cache") for k in errors)
    err, _ = errors.pop("next")
    assert err == 0.0, "the greedy tokens differ"
    bad = {k: (e, m) for k, (e, m) in errors.items()
           if not e <= RTOL * max(m, FLOOR)}
    assert not bad, bad
