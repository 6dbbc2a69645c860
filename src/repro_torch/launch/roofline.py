"""Roofline aggregation: dry-run JSONs -> three-term roofline table.

The port of ``repro.launch.roofline`` for the NVIDIA H100 (SXM5, 80 GB
HBM3).  Terms (seconds per step, per card):

  compute    = FLOPs / PEAK_FLOPS
  memory     = bytes accessed / HBM_BW
  collective = collective wire bytes / LINK_BW

The port's dry run (:mod:`repro_torch.launch.dryrun`) traces rank 0's
step.  A rank computes only its rows of the batch, so its flops and
bytes are the global step's divided by the data axes' extent (where the
batch divides them); the ranks along the ``model`` axis compute the same
rows, so they are not a 1/chips share.  ``FlopCounterMode`` counts
products only, where XLA's cost analysis also counts elementwise work.

MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (serve forward); the
ratio MODEL_FLOPS / (FLOPs x chips) measures how much traced compute is
useful (remat recompute, the plain attention's masked scores, and the
``model`` axis's ranks computing the same rows push it below 1).

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline \\
       --in reports/dryrun_torch [--csv out.csv]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

#: Peak dense rates of one H100 SXM5 by operand type (NVIDIA H100 Tensor
#: Core GPU datasheet; bfloat16 on the tensor cores, without sparsity).
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12, "bfloat16": 989e12}
PEAK_FLOPS = PEAK_OPS_PER_S["bfloat16"]      # FLOP/s / card
HBM_BW = 3.35e12                             # B/s / card, HBM3
#: NVLink 4: 18 links of 25 GB/s a direction, 450 GB/s a direction a GPU
#: (the datasheet's 900 GB/s counts both directions).  Between nodes of
#: 8 cards the per-card rate is far lower.
LINK_BW = 450e9                              # B/s / card, one direction


def load_cells(dirs: list[str]) -> dict:
    cells = {}
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "*.json"))):
            with open(path) as f:
                r = json.load(f)
            key = (r["arch"], r["shape"], r["mesh"])
            base = cells.get(key, {})
            # later dirs override 'fit'; keep 'full' from the first seen
            merged = dict(base)
            for k, v in r.items():
                if k == "full" and "full" in merged:
                    continue
                merged[k] = v
            cells[key] = merged
    return cells


def roofline_row(r: dict) -> dict | None:
    if r.get("status") != "ok":
        return None
    fit = r.get("fit")
    src = fit if fit and fit.get("flops", 0) > 0 else r.get("full")
    if not src:
        return None
    chips = 1
    for v in r.get("mesh_shape", {}).values():
        chips *= v
    flops = src["flops"]
    hbytes = src["bytes_accessed"]
    if fit and "collective_wire_bytes" in fit:
        cbytes = sum(fit["collective_wire_bytes"].values())
    else:
        cbytes = r["full"]["collectives"]["total_wire_bytes"]
    t_comp = flops / PEAK_FLOPS
    t_mem = hbytes / HBM_BW
    t_coll = cbytes / LINK_BW
    dominant = max((t_comp, "compute"), (t_mem, "memory"),
                   (t_coll, "collective"))[1]
    bound = max(t_comp, t_mem, t_coll)
    useful = r["model_flops"] / max(flops * chips, 1.0)
    return {
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "chips": chips,
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_collective_s": t_coll, "dominant": dominant,
        "bound_s": bound,
        "model_flops": r["model_flops"],
        "hlo_flops_per_chip": flops,
        "useful_flop_ratio": useful,
        "roofline_fraction": t_comp / bound if bound > 0 else 0.0,
        "mem_gib_per_dev": (r["full"]["memory"]["argument_bytes"]
                            + r["full"]["memory"]["temp_bytes"]) / 2**30
        if "full" in r else float("nan"),
        "source": "fit" if src is fit else "full",
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="indirs", nargs="+",
                    default=["reports/dryrun_torch"])
    ap.add_argument("--csv", default="")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    cells = load_cells(args.indirs)
    rows = []
    for key in sorted(cells):
        if key[2] != args.mesh:
            continue
        row = roofline_row(cells[key])
        if row:
            rows.append(row)
    hdr = ("arch,shape,chips,t_compute_s,t_memory_s,t_collective_s,"
           "dominant,useful_flop_ratio,roofline_fraction,mem_gib_per_dev,"
           "source")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"{r['arch']},{r['shape']},{r['chips']},"
            f"{r['t_compute_s']:.4e},{r['t_memory_s']:.4e},"
            f"{r['t_collective_s']:.4e},{r['dominant']},"
            f"{r['useful_flop_ratio']:.3f},{r['roofline_fraction']:.3f},"
            f"{r['mem_gib_per_dev']:.2f},{r['source']}")
    text = "\n".join(lines)
    print(text)
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(text + "\n")
    return rows


if __name__ == "__main__":
    main()
