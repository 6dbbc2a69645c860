"""Emit the §Dry-run and §Roofline markdown tables from the port's dry-run
reports.

The port of ``scripts/make_experiments_tables.py``.  It reads the JSON
reports of ``python -m repro_torch.launch.dryrun`` (``--in``, default
``reports/dryrun_torch``, as ``python -m repro_torch.launch.roofline``
takes them) where the reference reads its two fixed directories, and
prints the same two tables.  The port's dry run traces one rank of a
fake world of as many ranks as the production mesh has, so the headings
say ranks and give their count, and the roofline's terms are one rank's
on the H100's roofline (:mod:`repro_torch.launch.roofline`).  The
reference's per-cell notes are dropped: they are findings about its TPU
cells, and none of them was measured on this card.  The tables are read
from JSON: nothing runs on a device, and ``--device`` is checked as
every entry point of the port checks it (the card unless ``--device
cpu``).

  PYTHONPATH=src python scripts/make_experiments_tables_torch.py \\
      --in reports/dryrun_torch > reports/tables_torch.md
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.roofline import load_cells, roofline_row

ARCH_ORDER = [
    "tinyllama-1.1b", "qwen3-4b", "qwen3-8b", "llama3-405b", "arctic-480b",
    "qwen2-moe-a2.7b", "mamba2-370m", "internvl2-26b", "musicgen-large",
    "recurrentgemma-9b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _ranks(r: dict) -> int:
    n = 1
    for v in r.get("mesh_shape", {}).values():
        n *= v
    return n


def _mesh(cells: dict, mesh: str, default: tuple) -> tuple:
    """``(dims, ranks)`` of the fake world's mesh as the cells report it,
    e.g. ``("16x16", 256)``; the production mesh where no cell of that
    mesh ran."""
    for key, r in cells.items():
        if key[2] == mesh and r.get("mesh_shape"):
            return ("x".join(str(v) for v in r["mesh_shape"].values()),
                    _ranks(r))
    return default


def _memgib(r) -> str:
    # the reference reads a cell it lacks (or one that errored) and
    # stops; here such a cell is a dash
    if not r or r.get("status") != "ok" or "full" not in r:
        return "—"
    mm = r["full"]["memory"]
    return f"{(mm['argument_bytes'] + mm['temp_bytes']) / 2**30:.1f}"


def run(indirs, *, device=DEFAULT_DEVICE) -> dict:
    """Prints both tables from the reports under ``indirs``; returns
    ``cells`` and ``rows`` (the roofline rows printed, by (arch,
    shape))."""
    resolve_device(device)
    cells = load_cells(list(indirs))
    single = _mesh(cells, "single", ("16x16", 256))
    multi = _mesh(cells, "multi", ("2x16x16", 512))

    print("### §Dry-run — all (arch x shape x mesh) cells\n")
    print(f"| arch | shape | single-pod {single[0]} | multi-pod {multi[0]} | "
          "GiB/rank (single/multi) | collectives (single, per-rank wire GB) |")
    print("|---|---|---|---|---|---|")
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            s = cells.get((arch, shape, "single"))
            m = cells.get((arch, shape, "multi"))
            if s is None:
                continue
            if s.get("status") == "skipped":
                print(f"| {arch} | {shape} | skip (full attention) | skip | — | — |")
                continue
            if s.get("status") != "ok":
                print(f"| {arch} | {shape} | {s['status']} | "
                      f"{m['status'] if m else '—'} | — | — |")
                continue
            cw = s["full"]["collectives"]["total_wire_bytes"] / 1e9
            counts = s["full"]["collectives"]["count"]
            cstr = "+".join(f"{k.split('-')[1] if '-' in k else k}:{v}"
                            for k, v in counts.items() if v)
            print(f"| {arch} | {shape} | {s['status']} | "
                  f"{m['status'] if m else '—'} | "
                  f"{_memgib(s)} / {_memgib(m)} | {cw:.1f} ({cstr}) |")

    print(f"\n### §Roofline — single-pod ({single[1]} ranks of the fake "
          f"world), per-rank terms on the H100 roofline\n")
    print("| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | dominant |"
          " useful-FLOP ratio | roofline frac |")
    print("|---|---|---|---|---|---|---|---|")
    rows = {}
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = cells.get((arch, shape, "single"))
            if not r or r.get("status") != "ok":
                continue
            row = roofline_row(r)
            if row is None:
                continue
            rows[(arch, shape)] = row
            print(f"| {arch} | {shape} | {row['t_compute_s']:.3g} | "
                  f"{row['t_memory_s']:.3g} | {row['t_collective_s']:.3g} | "
                  f"{row['dominant']} | {row['useful_flop_ratio']:.2f} | "
                  f"{row['roofline_fraction']:.3f} |")
    return {"cells": cells, "rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in", dest="indirs", nargs="+",
                    default=["reports/dryrun_torch"])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="checked only: the tables are read from JSON")
    args = ap.parse_args(argv)
    return run(args.indirs, device=args.device)


if __name__ == "__main__":
    main()
