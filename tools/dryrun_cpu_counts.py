"""Count the dry run's cells on the CPU, for ``chip_smoke.py``'s ``dryrun``
phase to hold the card's counts against.

    PYTHONPATH=src python tools/dryrun_cpu_counts.py [--workers 4]

Runs the cells of that phase (every architecture's train_4k and
decode_32k on the (16, 16) mesh, jamba's and xlstm's train cut as
``chip_smoke.DRYRUN_LAYERS`` cuts them) with ``--device cpu``, each in
a process of its own, and writes ``tools/dryrun_cpu_counts.json``: per
cell the FLOPs and collective bytes a device, the forced
redistributions, and the torch version that counted them.  The counts
depend on the partitioning code (``models/partition.py``) and on
DTensor's rules outside it, so run it again after a change to either.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tools" / "dryrun_cpu_counts.json"


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    cells = chip_smoke._dryrun_cells()
    t0 = time.perf_counter()
    done = dryrun.run_cells([(a, s, "single", n) for a, s, n in cells],
                            workers=args.workers, device="cpu", force=True)
    out = {"torch": torch.__version__, "cells": {}}
    for arch, shape, layers in cells:
        rc, log = done[(arch, shape, "single", layers)]
        if rc != 0:
            print(log[-3000:], file=sys.stderr)
            raise SystemExit(f"{arch} x {shape} failed")
        r = json.loads(
            (dryrun.RESULTS / f"{arch}__{shape}__single.json").read_text())
        out["cells"][f"{arch} {shape}"] = {
            "layers_run": r["layers_run"], "flops": r["hlo_flops"],
            "collective_bytes": r["collectives"]["total_bytes"],
            "forced": sum(f["count"] for f in r["forced_redistributions"])}
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"{len(cells)} cells in {time.perf_counter() - t0:.1f} s -> {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
