"""CLI for the port's observation registry and host-scenario sweep.

    python -m repro_torch.experiments run --all [--backend vectorized]
    python -m repro_torch.experiments run --only obs4,obs10 --out build/exp
    python -m repro_torch.experiments run --all --device cpu
    python -m repro_torch.experiments list
    python -m repro_torch.experiments host [--scenarios lsm,cache]
                                           [--policies greedy-open,striped]
                                           [--device cpu]

``run`` executes the selected experiments as one fleet-batched sweep on
``--device`` (``cuda`` by default, which fails without a CUDA device),
writes per-experiment JSON + a markdown report (cross-linking
docs/observations.md) under ``--out`` (default ``build/experiments``),
prints a summary table, and exits non-zero if any check fails or any
fixpoint did not converge.  ``host`` runs the application-scenario x
placement-policy matrix (`repro_torch.host`) the same way — every
combination is one member of a single
:class:`repro_torch.core.DeviceFleet` call on ``--device`` — writes
``host_policies.json`` under ``--out`` (default ``build/host``) and
prints the per-scenario policy ranking (see docs/host.md).  The
reference CLI's ``cluster`` subcommand is not ported yet: it exits with
code 2 and names the slice of the port it waits for.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core.torch_device import DEFAULT_DEVICE

from .registry import all_experiments
from .runner import DEFAULT_OUT_DIR, ExperimentRunner

#: Artifact directory of the ``host`` subcommand (the reference's
#: ``results/host`` is never written).
HOST_OUT_DIR = os.path.join("build", "host")

#: Subcommands of the reference CLI that the port does not have yet, with
#: the part of the port each waits for.
NOT_PORTED = {
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


def _cmd_host(args) -> int:
    from repro_torch.host import (
        available_placement_policies, available_scenarios, compare_policies,
        rank_policies,
    )

    scenarios = [s for s in args.scenarios.split(",") if s] or None
    policies = [p for p in args.policies.split(",") if p] or None
    if args.list:
        for s in available_scenarios():
            print(f"scenario  {s}")
        for p in available_placement_policies():
            print(f"policy    {p}")
        return 0
    try:
        rows = compare_policies(scenarios, policies, backend=args.backend,
                                seed=args.seed, scale=args.scale,
                                device=args.device)
    except KeyError as e:
        print(f"host: {e.args[0]}", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "host_policies.json")
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1, sort_keys=True)
    width = max(len(r["policy"]) for r in rows)
    for r in rows:
        print(f"{r['scenario']:14s} {r['policy']:{width}s} "
              f"makespan={r['makespan_s'] * 1e3:9.2f}ms "
              f"WA={r['write_amplification']:.3f} "
              f"reclaim={r['reclaim_mibs']:8.1f}MiB/s "
              f"({r['n_requests']} reqs)")
    print()
    for scen, order in rank_policies(rows).items():
        print(f"{scen:14s} best-first: {' > '.join(order)}")
    print(f"\n{len(rows)} combinations in one fleet run "
          f"(backend={args.backend}, device={args.device}); results: "
          f"{out_path}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list registered experiments")
    host = sub.add_parser(
        "host",
        help="host-scenario x placement-policy sweep (repro_torch.host)")
    host.add_argument("--scenarios", default="",
                      help="comma-separated scenario names (default: all)")
    host.add_argument("--policies", default="",
                      help="comma-separated placement policies (default: all)")
    host.add_argument("--backend", default="vectorized",
                      choices=("event", "vectorized", "auto"))
    host.add_argument("--scale", type=float, default=1.0,
                      help="scenario size multiplier")
    host.add_argument("--seed", type=int, default=0)
    host.add_argument("--device", default=DEFAULT_DEVICE,
                      help=f"where the fleet solves (default "
                           f"{DEFAULT_DEVICE}; 'cpu' runs the plain versions)")
    host.add_argument("--out", default=HOST_OUT_DIR,
                      help=f"artifact directory (default {HOST_OUT_DIR})")
    host.add_argument("--list", action="store_true",
                      help="list scenarios/policies instead of running")
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
    if args.cmd == "host":
        return _cmd_host(args)
    return _cmd_run(args)


if __name__ == "__main__":
    raise SystemExit(main())
