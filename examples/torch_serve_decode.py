"""Batched serving on the PyTorch/CUDA port: prefill + KV-cache decode on
a reduced config, as ``examples/serve_decode.py`` does in the JAX
package, through ``repro_torch.launch.serve.generate``.

Weights are random, drawn from a generator seeded with 0; the prompts
from numpy's ``default_rng(0)``.  Runs on ``--device`` (the card by
default; asking for it without one raises).

Run: PYTHONPATH=src python examples/torch_serve_decode.py \\
         --arch phi3_medium_14b [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.core.poly import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models.model import init_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3_medium_14b")
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cpu: no card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    times: dict = {}
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, args.gen, times=times)
    wall = time.perf_counter() - t0
    print(f"{cfg.name}: generated {out.shape} tokens on {device.type} in "
          f"{wall:.2f} s (decode {times['decode_s'] / args.gen * 1e3:.2f} "
          f"ms a step); first row: {out[0, :16].tolist()}...")
    return out


if __name__ == "__main__":
    main()
