#!/usr/bin/env python3
"""The stacked fixpoint of one source tree, timed and held on the card.

    python scripts/fp_stack_ab.py [--src DIR] [--reps 7] [--trace]

Needs a CUDA card and ``nvcc``.  ``--src`` is a ``src`` directory holding
``repro_torch`` (default: this checkout's), e.g. an unpacked ``git
archive`` of an earlier commit, whose kernels build into that tree's own
``build/kernels/``.  To compare two trees on one card, run parent, change,
change, parent in one call.  Prints, after the card's name and power
limit, for ``chip_smoke.py`` phase 2's two signature plans (the
experiment runner's program, 16 shards, sweep budget 8; the contended
fleet's, 2 shards, budget 64), in float64:

- ``zns_fixpoint_sharded``: the median of ``--reps`` CUDA-event timings of
  the wrapper's call (the host's wait and the state's read-back
  included) with the L2 flushed, and the kernel's device ms
  (``chip_smoke.device_ms``); the launch the tree chose
  (``last_launch``: instance, cluster size, clusters, rounds);
- the barriers a solve, from the plain solve's active blocks a sweep:
  the grid instance's grid barriers (one, then two a family slot that any
  running shard has active in a sweep), the cluster instance's cluster
  barriers on its longest cluster (one a shard, then two a pass of the
  shard's own);
- its largest relative error against the plain version and whether the
  sweeps and convergence equal it shard by shard;
- with ``--trace``: the same solve on a ``-DFP_TRACE`` build of the tree's
  source, block 0's stamps at each barrier: the barriers it saw, their
  microseconds and their share of its time.

Then, once, a hash of the SASS of ``fp_solve_kernel`` (both dtypes) and of
each bfloat16 SSD backward function (``ssd_bwd_walk``,
``ssd_bwd_mma_chunk``) of the tree's built libraries (``cuobjdump
-sass``, blanks collapsed), so that two trees' outputs show whether
those functions changed.  The last line is a JSON object with these
numbers.
"""
import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plans(P, pshard, ExperimentRunner, KiB, OpType):
    """(label, program, service times, sweep budget, plan) of phase 2's
    two signature plans, built on the host as chip_smoke.py builds them."""
    import numpy as np
    wl5 = P.WorkloadSpec()
    for t in range(4):
        wl5 = wl5.appends(n=5000, size=8 * KiB, qd=4, zone=t * 4, nzones=4)
        wl5 = wl5.appends(n=5000, size=64 * KiB, qd=4, zone=t * 4,
                          nzones=4)
    wl5 = wl5.resets(n=200, occupancy=1.0, nzones=200, io_ctx=OpType.APPEND,
                     zone=500)
    fleet5 = P.DeviceFleet.from_profiles(["ours", "nvmevirt", "femu"],
                                         device="cpu")
    traces5 = fleet5._lower(wl5, "replicate")
    prog5 = P.compile_fleet_program(traces5, fleet5.specs,
                                    [d.lat for d in fleet5.devices],
                                    jitter=True, seeds=[0, 1, 2], cache=False)
    svc5 = np.concatenate([
        P.compute_service_times(traces5[b], fleet5.devices[b].lat,
                                seed=b)[prog5.orders[b]] for b in range(3)])
    fleet13, wls13, seeds13 = ExperimentRunner(
        backend="vectorized", device="cpu").fleet()
    prog13 = P.compile_fleet_program([w.build() for w in wls13],
                                     fleet13.specs,
                                     [d.lat for d in fleet13.devices],
                                     seeds=seeds13, cache=False)
    return [(label, prog, svc, budget, pshard.shard_program(prog))
            for label, prog, svc, budget in (
                ("phase-13", prog13, prog13.svc0_flat, 8),
                ("phase-5", prog5, svc5, 64))]


def barriers(logs, tiles, instance, clusters):
    """Barriers a solve from each shard's active blocks a sweep (``logs``)
    and each shard's tiles a block (``tiles``): the grid instance's grid
    barriers, or the cluster instance's on its longest cluster."""
    if instance == "cluster":
        per = [1 + 2 * sum(1 for sweep in log for f in sweep if tiles[s][f])
               for s, log in enumerate(logs)]
        return max(sum(per[c::clusters]) for c in range(clusters))
    n = 1
    for k in range(max(len(log) for log in logs)):
        n += 2 * len({f for s, log in enumerate(logs) if k < len(log)
                      for f in log[k] if tiles[s][f]})
    return n


def sass_hashes(cs, build, source, keys) -> dict:
    """{function: sha256 of its SASS listing} of the functions of a built
    library whose name holds one of ``keys``, each line's runs of blanks
    collapsed (cuobjdump pads its columns to the widest instruction of the
    whole library, so a kernel added beside a function changes its
    listing's spacing but not its code)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build.library_path(source))],
                          capture_output=True, text=True, timeout=300).stdout
    bodies, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            bodies[fn] = []
        elif fn is not None:
            bodies[fn].append(" ".join(line.split()))
    out = {}
    for f, b in sorted(bodies.items()):
        name = cs.kernel_name(f) if f.startswith("_ZN") else f
        if any(k in name for k in keys):
            out[name] = hashlib.sha256("\n".join(b).encode()).hexdigest()[:16]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fp_stack_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    import repro_torch.core as P
    from repro_torch.core import KiB, OpType
    from repro_torch.core import shard as pshard
    from repro_torch.experiments import ExperimentRunner
    from repro_torch.kernels import _build
    from repro_torch.kernels import zns_fixpoint as kfix
    print(f"fp_stack_ab: {os.path.dirname(repro_torch.__file__)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    cuda = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float64, device=cuda)
    out = {"card": smi.stdout.strip(), "plans": {}}
    built = _build.build(["zns_fixpoint", "ssd_chunk_scan"])
    for label, prog, svcp, budget, plan in plans(P, pshard, ExperimentRunner,
                                                 KiB, OpType):
        packed = kfix.pack_shards(
            [([b.rows_view() for b in sh.program.families],
              sh.program.n_flat, P.block_adjacency(sh.program))
             for sh in plan.shards], cuda)
        init = np.full(packed.total, -np.inf)
        sv = np.zeros(packed.total)
        for sh, b in zip(plan.shards, packed.base):
            init[b:b + len(sh.perm)] = (prog.issue_flat[sh.perm]
                                        + svcp[sh.perm])
            sv[b:b + len(sh.perm)] = svcp[sh.perm]
        c0 = torch.as_tensor(init, device=cuda)
        s0 = torch.as_tensor(sv, device=cuda)

        def solve():
            return kfix.zns_fixpoint_sharded(c0, s0, packed, sweeps=budget)

        got = solve()
        launch = dict(kfix.zns_fixpoint_sharded.last_launch)
        want = kfix.zns_fixpoint_sharded_torch(c0, s0, packed, sweeps=budget)
        err = float(((got[0] - want[0]).abs()
                     / want[0].abs().clamp_min(1.0))[torch.isfinite(
                         want[0])].max())
        same = (got[1].tolist() == want[1].tolist()
                and got[2].tolist() == want[2].tolist())
        logs, tiles = [], []
        for k in range(packed.S):
            b, n = packed.base[k], packed.ns[k]
            log = []
            kfix.zns_fixpoint_torch(c0[b:b + n], s0[b:b + n],
                                    packed.shard(k), sweeps=budget,
                                    active_log=log)
            logs.append(log)
            tiles.append([kfix.block_tiles(r, l, 2048)
                          for _, r, l in packed.shapes[k]])
        instance = launch.get("instance", "grid")
        nbar = barriers(logs, tiles, instance,
                        launch.get("clusters", packed.S))
        ms = cs.time_ms(solve, reps=args.reps, flush=flush)
        dms, nk = cs.device_ms(solve, "fp_", reps=args.reps)
        row = dict(ms=ms, device_ms=dms, device_kernels=nk, barriers=nbar,
                   max_rel_err=err, sweeps_equal=same,
                   sweeps=got[1].tolist(), launch=launch)
        print(f"{label}: {packed.S} shards, sweeps {got[1].tolist()} "
              f"(plain {want[1].tolist()}; equal with convergence: {same}), "
              f"max rel err {err:.3e}; wrapper {ms:.4f} ms (median of "
              f"{args.reps}, L2 flushed), device {dms} ms ({nk} kernel a "
              f"solve); {instance} instance, {nbar} barriers a solve; "
              f"launch {launch}")
        out["plans"][label] = row
        if args.trace:
            row["trace"] = trace(args, _build, kfix, solve, nbar, label)
    out["sass"] = dict(
        sass_hashes(cs, _build, "zns_fixpoint", ("fp_solve_kernel",)),
        **sass_hashes(cs, _build, "ssd_chunk_scan",
                      ("ssd_bwd_walk", "ssd_bwd_mma_chunk")))
    print(f"SASS sha256 by function: {out['sass']}")
    print(json.dumps(out))
    return 0


def trace(args, build, kfix, solve, nbar, label) -> dict:
    """The solve on a -DFP_TRACE build of the tree's fixpoint source: block
    0's barriers, their microseconds and share of its time."""
    src = build.CSRC / "zns_fixpoint.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    outdir = build.BUILD_DIR / f"zns_fixpoint-trace-{digest}"
    outdir.mkdir(parents=True, exist_ok=True)
    lib_path = outdir / "libzns_fixpoint.so"
    if not lib_path.exists():
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DFP_TRACE", "-I",
                        str(build.CSRC), "-o", str(lib_path), str(src)],
                       check=True, capture_output=True)
    keep = build._LIBS.get("zns_fixpoint")
    lib = ctypes.CDLL(str(lib_path))
    build._LIBS["zns_fixpoint"] = lib
    kfix._LIB = None
    try:
        stamps = (ctypes.c_ulonglong * 1024)()
        solve()
        lib.fp_trace_read(stamps)
    finally:
        build._LIBS["zns_fixpoint"] = keep
        kfix._LIB = None
    t = [stamps[i] for i in range(1024)]
    # stamps: the start, then one before and one after each barrier; an
    # earlier solve's stamps past this one's are older, so the run of
    # rising stamps ends at this solve's last
    n = 1
    while n + 1 < 1024 and t[n] >= t[n - 1] and t[n + 1] >= t[n] \
            and t[n] > 0:
        n += 2
    seen = (n - 1) // 2
    wait = sum(t[2 * i + 2] - t[2 * i + 1] for i in range(seen)) / 1e3
    total = (t[2 * seen] - t[0]) / 1e3 if seen else 0.0
    print(f"  {label} trace (block 0): {seen} barriers (computed {nbar} on "
          f"the longest path), {wait:.2f} of {total:.2f} us in barriers "
          f"({wait / total if total else 0.0:.1%})")
    return dict(barriers_seen=seen, barrier_us=wait, total_us=total)


if __name__ == "__main__":
    sys.exit(main())
