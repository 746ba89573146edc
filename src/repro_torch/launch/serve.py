"""Serving entry point: batched greedy decode with a KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3_medium_14b \
      --batch 4 --prompt-len 16 --gen 32

Counterpart of the JAX package's ``launch/serve.py``, for all ten
architectures (``--arch``, any name of ``configs.ARCHS``).  Runs on the
card unless ``--device cpu`` is given; ``--reduced`` takes the
architecture's smoke config.  Weights and prompts are random, seeded
with 0 as in the JAX package's ``launch/serve.py``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.poly import resolve_device
from repro_torch.models.model import forward, init_cache, init_params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts: np.ndarray, gen: int, times=None):
    """prompts: (B, P) integer -> (B, P+gen) greedy continuation, numpy
    int32.

    As in the JAX package, the prompt goes through the decode path one
    token at a time (teacher-forced), sharing the cache machinery.  With
    ``times`` (a dict), the seconds of the prompt's steps (``prefill_s``)
    and of the generated ones (``decode_s``) are stored in it, each
    ending in a synchronize."""
    device = params["embed"].device
    B, P = prompts.shape
    cache = init_cache(cfg, B, P + gen, device=device)
    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                           device=device)
    t0 = time.perf_counter()
    with torch.no_grad():
        last = None
        for t in range(P):
            last, cache = forward(params, toks[:, t:t + 1], cfg, cache=cache)
        cur = torch.argmax(last[:, -1], -1)[:, None]
        _sync(device)
        t1 = time.perf_counter()
        out = [toks]
        for _ in range(gen):
            out.append(cur)
            logits, cache = forward(params, cur, cfg, cache=cache)
            cur = torch.argmax(logits[:, -1], -1)[:, None]
        result = torch.cat(out, 1).to(torch.int32).cpu().numpy()
    if times is not None:
        times["prefill_s"] = t1 - t0
        times["decode_s"] = time.perf_counter() - t1
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3_medium_14b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, args.gen)
    dt = time.perf_counter() - t0
    total_new = args.batch * args.gen
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[serve] {cfg.name} on {name}: generated {total_new} tokens in "
          f"{dt:.2f}s ({total_new / dt:.1f} tok/s); output shape {out.shape}")
    return out


if __name__ == "__main__":
    main()
