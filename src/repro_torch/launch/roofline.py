"""Roofline analysis of the dry run's counts, at the H100's datasheet
figures.

Counterpart of the JAX package's ``launch/roofline.py``.  Per (arch x
shape x mesh) cell, from results/dryrun_torch/*.json:

  compute term    = per-device FLOPs / PEAK_FLOPS
  memory term     = per-device bytes / HBM_BW
  collective term = per-device collective bytes / LINK_BW

The dry run counts rank 0's local ops, so every count is already one
device's.  These terms are counts priced at datasheet figures, not
times measured on a card.

Hardware: one NVIDIA H100 SXM5 80GB at its 700 W limit, in a job of 32
nodes of 8 GPUs (the (16, 16) mesh; (2, 16, 16) is two such pods).

Also reports MODEL_FLOPS = 6*N(_active)*tokens and the useful-compute
ratio MODEL_FLOPS/chips / FLOPs (attention/redundancy factor).

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single]
Writes results/roofline_torch_<mesh>.json + a markdown table to stdout.
"""
from __future__ import annotations

import argparse
import json
import pathlib

# NVIDIA H100 SXM5 80GB, dense bf16 on the tensor cores (NVIDIA H100
# Tensor Core GPU datasheet: 1,979 TFLOP/s with 2:4 sparsity, half that
# dense), at the 700 W limit
PEAK_FLOPS = 989.4e12
# NVIDIA H100 SXM5 80GB, HBM3 bandwidth (same datasheet)
HBM_BW = 3.35e12
# bytes/s a GPU on the slowest link the mesh's collectives cross: with 8
# GPUs a node, both axes of the (16, 16) mesh span nodes, so a collective
# goes over the GPU's 400 Gb/s InfiniBand NDR port (ConnectX-7, one a GPU
# in an NVIDIA DGX H100 / HGX H100 node; DGX H100 user guide).  Inside a
# node, NVLink 4 gives 450 GB/s a direction (900 GB/s in all, datasheet).
LINK_BW = 50e9

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results"
CARD = "NVIDIA H100 SXM5 80GB, 700 W (datasheet figures)"


def _scan_correction(r: dict) -> float:
    """1.0: the reference scales XLA's counts because its cost analysis
    counts the body of a scan over layer repetitions once.  The port
    runs every layer eagerly, one op at a time, so the dry run's counts
    already cover every repetition."""
    return 1.0


def analyze_cell(r: dict) -> dict:
    chips = r["n_chips"]
    corr = _scan_correction(r)
    flops_dev = (r.get("hlo_flops") or 0.0) * corr
    bytes_dev = (r.get("hlo_bytes") or 0.0) * corr
    coll_dev = r["collectives"]["total_bytes"] * corr
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = (r["model_flops"] / chips) / flops_dev if flops_dev else 0.0
    # roofline fraction: useful-model-compute time / bound time
    t_model = (r["model_flops"] / chips) / PEAK_FLOPS
    frac = t_model / bound if bound else 0.0
    return {
        **{f"t_{k}_s": v for k, v in terms.items()},
        "dominant": dominant,
        "bound_s": bound,
        "useful_compute_ratio": useful,
        "roofline_fraction": frac,
        "model_flops_per_chip": r["model_flops"] / chips,
        "scan_correction": corr,
    }


def load_cells(mesh: str):
    out = {}
    for p in sorted((RESULTS / "dryrun_torch").glob(f"*__{mesh}.json")):
        r = json.loads(p.read_text())
        out[(r["arch"], r["shape"])] = r
    return out


def _both() -> None:
    """One row a cell with both meshes side by side: state GB, TFLOP,
    collective GB a device, and the dominant term with its seconds."""
    single, multi = load_cells("single"), load_cells("multi")
    print(f"Counts priced at {CARD}; not times measured on a card.")
    print("| arch | shape | layers | (16, 16): state GB / TFLOP / coll GB "
          "per device | bound | (2, 16, 16): state GB / TFLOP / coll GB "
          "| bound |")
    print("|---|---|---|---|---|---|---|")
    for key in sorted(single.keys() | multi.keys()):
        cols = []
        for cells in (single, multi):
            r = cells.get(key)
            if r is None:
                cols += ["not run", ""]
                continue
            a = analyze_cell(r)
            cols += [f"{r['state_bytes_per_device'] / 1e9:.2f} / "
                     f"{r['hlo_flops'] / 1e12:.4g} / "
                     f"{r['collectives']['total_bytes'] / 1e9:.4g}",
                     f"{a['dominant']} {a['bound_s']:.3g} s"]
        r = single.get(key) or multi[key]
        print(f"| {key[0]} | {key[1]} | {r['layers_run']}/{r['layers']} | "
              + " | ".join(cols) + " |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single",
                    help="single, multi, or both (one row a cell, the "
                         "two meshes side by side; no JSON written)")
    args = ap.parse_args(argv)
    if args.mesh == "both":
        return _both()
    cells = load_cells(args.mesh)
    table = {}
    print(f"Counts priced at {CARD}; not times measured on a card.")
    print("| arch | shape | layers run | state GB/dev | TFLOP/dev | "
          "coll GB/dev | compute(s) | memory(s) | collective(s) | "
          "dominant | useful | roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for (arch, shape), r in cells.items():
        a = analyze_cell(r)
        table[f"{arch}__{shape}"] = {**a, "mesh": args.mesh,
                                     "n_chips": r["n_chips"]}
        print(f"| {arch} | {shape} | {r['layers_run']}/{r['layers']} | "
              f"{r['state_bytes_per_device'] / 1e9:.2f} | "
              f"{r['hlo_flops'] / 1e12:.4g} | "
              f"{r['collectives']['total_bytes'] / 1e9:.4g} | "
              f"{a['t_compute_s']:.2e} | "
              f"{a['t_memory_s']:.2e} | {a['t_collective_s']:.2e} | "
              f"{a['dominant']} | {a['useful_compute_ratio']:.2f} | "
              f"{a['roofline_fraction']:.3f} |")
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / f"roofline_torch_{args.mesh}.json").write_text(
        json.dumps(table, indent=2))


if __name__ == "__main__":
    main()
