"""CLI for the port's observation registry.

    python -m repro_torch.experiments run --all [--backend vectorized]
    python -m repro_torch.experiments run --only obs4,obs10 --out build/exp
    python -m repro_torch.experiments run --all --device cpu
    python -m repro_torch.experiments list

``run`` executes the selected experiments as one fleet-batched sweep on
``--device`` (``cuda`` by default, which fails without a CUDA device),
writes per-experiment JSON + a markdown report (cross-linking
docs/observations.md) under ``--out`` (default ``build/experiments``),
prints a summary table, and exits non-zero if any check fails or any
fixpoint did not converge.  The reference CLI's ``host`` and ``cluster``
subcommands are not ported yet: they exit with code 2 and name the
slice of the port they wait for.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.torch_device import DEFAULT_DEVICE

from .registry import all_experiments
from .runner import DEFAULT_OUT_DIR, ExperimentRunner

#: Subcommands of the reference CLI that the port does not have yet, with
#: the part of the port each waits for.
NOT_PORTED = {
    "host": "the host slice (repro_torch.host: volume, scenarios and "
            "conformance; ROADMAP.md, queue 1)",
    "cluster": "the cluster-tier slice (repro_torch.cluster; ROADMAP.md, "
               "queue 1)",
}


def _cmd_list() -> int:
    for exp in all_experiments():
        print(f"obs{exp.obs:02d}  {exp.name:32s} {exp.figure:10s} "
              f"{len(exp.points)} points  — {exp.title}")
    return 0


def _cmd_run(args) -> int:
    keys = None if args.all else [k for k in args.only.split(",") if k]
    if keys is not None and not keys:
        print("run: pass --all or --only obs4,obs10,...", file=sys.stderr)
        return 2
    try:
        runner = ExperimentRunner(keys, backend=args.backend,
                                  jitter=args.jitter, seed=args.seed,
                                  device=args.device)
    except KeyError as e:
        print(f"run: {e.args[0]}", file=sys.stderr)
        return 2
    results = runner.run()
    paths = runner.write_artifacts(results, out_dir=args.out)
    width = max((len(r.name) for r in results), default=4)
    for r in results:
        ok = sum(c.ok for c in r.checks)
        status = "pass" if r.passed else "FAIL"
        print(f"obs{r.obs:02d}  {r.name:{width}s}  {ok}/{len(r.checks)} "
              f"checks  {status}")
        if not r.passed or args.verbose:
            for c in r.checks:
                print(f"        {c}")
    n_pass = sum(r.passed for r in results)
    stale = [r.name for r in results if not r.converged]
    print(f"\n{n_pass}/{len(results)} experiments passed "
          f"(backend={args.backend}, device={args.device}); report: "
          f"{paths['report']}")
    if stale:
        print(f"WARNING: fixpoint did not converge for "
              f"{', '.join(stale)} — metrics are not steady-state",
              file=sys.stderr)
    return 0 if n_pass == len(results) and not stale else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list registered experiments")
    for cmd, slice_ in NOT_PORTED.items():
        sub.add_parser(cmd, help=f"not ported yet: waits for {slice_}")
    run = sub.add_parser("run", help="run experiments (one batched sweep)")
    run.add_argument("--all", action="store_true",
                     help="run every registered experiment")
    run.add_argument("--only", default="",
                     help="comma-separated names/numbers (obs4,obs10,...)")
    run.add_argument("--backend", default="vectorized",
                     choices=("event", "vectorized", "auto"))
    run.add_argument("--device", default=DEFAULT_DEVICE,
                     help=f"where the fleet solves (default "
                          f"{DEFAULT_DEVICE}; 'cpu' runs the plain versions)")
    run.add_argument("--out", default=DEFAULT_OUT_DIR,
                     help=f"artifact directory (default {DEFAULT_OUT_DIR})")
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--jitter", action="store_true",
                     help="enable stochastic service-time jitter "
                          "(checks are calibrated for jitter off)")
    run.add_argument("--verbose", action="store_true",
                     help="print every check, not just failures")
    args, extra = ap.parse_known_args(argv)
    if args.cmd in NOT_PORTED:
        print(f"{args.cmd}: not ported yet; it waits for "
              f"{NOT_PORTED[args.cmd]}", file=sys.stderr)
        return 2
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd == "list":
        return _cmd_list()
    return _cmd_run(args)


if __name__ == "__main__":
    raise SystemExit(main())
