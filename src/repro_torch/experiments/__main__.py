"""CLI for the port's observation registry and host-scenario sweep.

    python -m repro_torch.experiments run --all [--backend vectorized]
    python -m repro_torch.experiments run --only obs4,obs10 --out build/exp
    python -m repro_torch.experiments run --all --device cpu
    python -m repro_torch.experiments list
    python -m repro_torch.experiments host [--scenarios lsm,cache]
                                           [--policies greedy-open,striped]
                                           [--device cpu]
    python -m repro_torch.experiments cluster [--stripe-widths 2,4]
                                              [--schemes ec4+2,rep2-k2]
                                              [--policies round-robin,hashed]
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
prints the per-scenario policy ranking (see docs/host.md).  ``cluster``
compiles a (redundancy scheme x placement policy) x users-ladder x
(normal | degraded) rack sweep (`repro_torch.cluster`) to one fleet-level
:class:`repro_torch.core.ChainProgram`, solves it in a single call on
``--device``, writes ``capacity.json`` and ``capacity_curves.csv`` under
``--out`` (default ``build/cluster``) and ranks configurations by the
user count served inside the p99 latency SLO (see docs/cluster.md);
``--rates`` swaps the ladder for open-loop Poisson offered load and
ranks by arrival-rate-at-SLO.  It exits 1 when the solve does not
converge and 2 on a bad scheme.
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

#: Artifact directory of the ``cluster`` subcommand (the reference's
#: ``results/cluster`` is never written).
CLUSTER_OUT_DIR = os.path.join("build", "cluster")


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


def _cluster_configs(args):
    from repro_torch.cluster import (ClusterConfig, available_placements,
                                     erasure, parse_scheme, replication)
    if args.schemes:
        schemes = [parse_scheme(s) for s in args.schemes.split(",") if s]
    else:
        widths = [int(w) for w in args.stripe_widths.split(",") if w]
        schemes = []
        for k in widths:
            schemes.append(erasure(k, args.parity))
            schemes.append(replication(k, copies=args.parity + 1))
    policies = ([p for p in args.policies.split(",") if p]
                or available_placements())
    return [ClusterConfig(scheme=s, placement=p)
            for s in schemes for p in policies]


def _cmd_cluster(args) -> int:
    from repro_torch.cluster import (ClusterSpec, ClusterWorkload,
                                     available_placements, plan_capacity)

    if args.list:
        for p in available_placements():
            print(f"placement  {p}")
        print("schemes    ec<k>+<m> (erasure) or rep<copies>-k<k> "
              "(replication), e.g. ec4+2, rep2-k2")
        return 0
    try:
        configs = _cluster_configs(args)
        base_spec = ClusterSpec(n_gateways=args.gateways,
                                n_servers=args.servers,
                                durability=args.durability)
        for cfg in configs:
            if cfg.scheme.n_shards > args.servers:
                print(f"cluster: {cfg.scheme.name} needs "
                      f"{cfg.scheme.n_shards} servers, have {args.servers}",
                      file=sys.stderr)
                return 2
    except (KeyError, ValueError) as e:
        print(f"cluster: {e.args[0]}", file=sys.stderr)
        return 2
    ladder = [int(u) for u in args.users.split(",") if u]
    rate_ladder = [float(r) for r in args.rates.split(",") if r] or None
    workload = ClusterWorkload(
        ops_per_user=args.objects_per_user,
        object_bytes=int(args.object_mib * (1 << 20)),
        get_fraction=args.get_fraction, seed=args.seed,
        n_users=ladder[-1] if rate_ladder and ladder else 8)
    report = plan_capacity(
        configs, ladder, base_spec=base_spec, workload=workload,
        slo_us=args.slo_ms * 1e3, rate_ladder=rate_ladder,
        degraded=not args.no_degraded,
        sweeps=args.sweeps, max_refine=args.max_refine,
        warm_ladder=args.warm_ladder, device=args.device)

    os.makedirs(args.out, exist_ok=True)
    json_path = os.path.join(args.out, "capacity.json")
    with open(json_path, "w") as f:
        json.dump(report.to_json(), f, indent=1, sort_keys=True)
    csv_path = os.path.join(args.out, "capacity_curves.csv")
    with open(csv_path, "w") as f:
        f.write("config,degraded,users,objects_per_sec,p50_us,p99_us,"
                "p999_us,slo_violation_rate,offered_rate\n")
        for c in report.curves:
            for p in c.points:
                rate = "" if p.offered_rate is None \
                    else f"{p.offered_rate:.3f}"
                f.write(f"{c.config.name},{int(c.degraded)},{p.users},"
                        f"{p.objects_per_sec:.3f},{p.lat.p50_us:.3f},"
                        f"{p.lat.p99_us:.3f},{p.lat.p999_us:.3f},"
                        f"{p.slo_violation_rate:.6f},{rate}\n")

    width = max(len(c.config.name) for c in report.curves)
    fom = "rate@SLO" if rate_ladder else "users@SLO"
    print(f"{'config':{width}s} {'mode':8s} {fom:>9s} "
          f"{'p99(us) by rung':>24s}")
    for c in report.ranking():
        rungs = " ".join(f"{p.lat.p99_us:7.1f}" for p in c.points)
        print(f"{c.config.name:{width}s} {'normal':8s} "
              f"{c.load_at_slo:9.2f} {rungs:>24s}")
        d = report.degraded_curve(c.config)
        if d is not None:
            rungs = " ".join(f"{p.lat.p99_us:7.1f}" for p in d.points)
            print(f"{'':{width}s} {'degraded':8s} "
                  f"{d.load_at_slo:9.2f} {rungs:>24s}")
    print(f"\n{report.n_programs} programs ({report.n_events} events) in "
          f"one fleet-level solve ({report.sweeps_used} sweeps, SLO "
          f"p99 <= {report.slo_us / 1e3:g}ms, device={args.device}); "
          f"results: {json_path}")
    if args.warm_ladder:
        print(f"warm ladder: {report.warm_hits}/{report.warm_attempts} "
              f"rung seeds verified tight (misses fall back cold; curves "
              f"are identical either way)")
    if report.order_unstable:
        print("WARNING: pop-order refinement budget exhausted for "
              f"{', '.join(report.order_unstable)} — their curves are "
              "approximate (raise --max-refine)", file=sys.stderr)
    if not report.converged:
        print("WARNING: fixpoint did not converge — capacity numbers are "
              "not steady-state", file=sys.stderr)
    return 0 if report.converged else 1


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
    clu = sub.add_parser(
        "cluster",
        help="rack capacity sweep: scheme x placement -> users at p99 SLO "
             "(repro_torch.cluster)")
    clu.add_argument("--stripe-widths", default="2,4",
                     help="comma-separated stripe widths k; each yields an "
                          "ec(k,parity) and a rep(k,parity+1 copies) scheme")
    clu.add_argument("--parity", type=int, default=1,
                     help="redundancy degree m paired with --stripe-widths")
    clu.add_argument("--schemes", default="",
                     help="explicit scheme list (ec4+2,rep2-k2,...); "
                          "overrides --stripe-widths/--parity")
    clu.add_argument("--policies", default="",
                     help="comma-separated placement policies (default: all)")
    clu.add_argument("--gateways", type=int, default=2)
    clu.add_argument("--servers", type=int, default=8)
    clu.add_argument("--users", default="2,4,8",
                     help="comma-separated users-per-rack ladder")
    clu.add_argument("--rates", default="",
                     help="comma-separated open-loop offered-load ladder "
                          "(objects/s, Poisson arrivals); switches the "
                          "figure of merit to arrival-rate-at-SLO and "
                          "fixes the population at the last --users rung")
    clu.add_argument("--slo-ms", type=float, default=10.0,
                     help="p99 latency SLO in milliseconds")
    clu.add_argument("--objects-per-user", type=int, default=6)
    clu.add_argument("--object-mib", type=float, default=2.0)
    clu.add_argument("--get-fraction", type=float, default=0.5)
    clu.add_argument("--durability", default="writeback",
                     choices=("writeback", "write-through"))
    clu.add_argument("--no-degraded", action="store_true",
                     help="skip the one-server-down rows")
    clu.add_argument("--sweeps", type=int, default=512)
    clu.add_argument("--warm-ladder", action="store_true",
                     help="thread each rung's completions into the next "
                          "rung's fixpoint seed (per-op content-digest "
                          "slot mapping; bit-identical curves, pays on "
                          "--rates ladders)")
    clu.add_argument("--max-refine", type=int, default=None,
                     help="pop-order refinement budget per config "
                          "(default: compiler MAX_REFINE)")
    clu.add_argument("--seed", type=int, default=0)
    clu.add_argument("--device", default=DEFAULT_DEVICE,
                     help=f"where every solve runs (default "
                          f"{DEFAULT_DEVICE}; 'cpu' runs the plain versions)")
    clu.add_argument("--out", default=CLUSTER_OUT_DIR,
                     help=f"artifact directory (default {CLUSTER_OUT_DIR})")
    clu.add_argument("--list", action="store_true",
                     help="list placement policies / scheme syntax")
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
    args = ap.parse_args(argv)
    if args.cmd == "list":
        return _cmd_list()
    if args.cmd == "host":
        return _cmd_host(args)
    if args.cmd == "cluster":
        return _cmd_cluster(args)
    return _cmd_run(args)


if __name__ == "__main__":
    raise SystemExit(main())
