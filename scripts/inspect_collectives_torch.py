"""Print the largest collectives of one dry-run cell (small depth), sorted
by result bytes — the perf-loop's 'profiler'.

The port of ``scripts/inspect_collectives.py``, with the reference's
flags that the port's dry run has.  Where the reference compiles the
cell on 512 XLA host devices and parses the collectives out of the HLO
text, this traces one rank's step with
:func:`repro_torch.launch.dryrun.lower_cell` on a fake world of the
production mesh's ranks (:func:`repro_torch.launch.dryrun.fake_world`;
nothing is allocated and no collective moves a byte) and lists the
records of the port's collective layer (``utils.comm_stats``: kind,
result bytes, group size and site), each where the reference prints its
HLO line.  The fake tensors claim the card (``--device cpu``: the CPU);
the collectives are the same on either.

  PYTHONPATH=src python scripts/inspect_collectives_torch.py \\
      --arch llama3-405b --shape train_4k [--depth 2] [--top 25] [...]
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import dataclasses

from repro_torch.core.torch_device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed.ctx import axis_rules
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models.config import SHAPES_BY_NAME


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="")
    ap.add_argument("--moe-impl", default="", dest="moe_impl")
    ap.add_argument("--moe-pad", type=int, default=0, dest="moe_pad")
    ap.add_argument("--remat-block", type=int, default=0, dest="remat_block")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-seqshard", action="store_true")
    ap.add_argument("--no-ep", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="the device the fake tensors claim (default: the "
                         "card)")
    return ap


def run(args) -> dict:
    """Traces the cell; prints the header and the ``--top`` largest
    records; returns ``trace``, ``rows`` (every record, largest first)
    and ``total`` (result bytes)."""
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(D.cell_config(args.arch, args),
                              num_layers=args.depth)
    shape = SHAPES_BY_NAME[args.shape]
    multi = args.mesh == "multi"
    mshape, _ = production_shape(multi_pod=multi)
    with D.fake_world(D._world_for(mshape)):
        mesh = make_production_mesh(multi_pod=multi)
        with axis_rules(mesh, D._rules_for(mesh, args)):
            trace, _ = D.lower_cell(cfg, shape, mesh, args, device=dev.type)
    # records: (kind, result bytes, group size, site)
    rows = sorted(trace.collectives.records, key=lambda r: r[1],
                  reverse=True)
    total = sum(r[1] for r in rows)
    # the reference's figure is a chip's; the trace here is one rank's
    print(f"# {len(rows)} collectives, total result bytes/rank "
          f"{total/2**30:.3f} GiB (depth={args.depth})")
    for kind, nbytes, group, site in rows[:args.top]:
        print(f"{nbytes/2**20:10.1f} MiB  {kind:18s} site={site} "
              f"group={group}")
    return {"trace": trace, "rows": rows, "total": total}


def main(argv=None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
