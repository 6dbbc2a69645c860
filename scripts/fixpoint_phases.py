#!/usr/bin/env python3
"""Where one fixpoint solve spends its device time, pass by pass.

    PYTHONPATH=src python scripts/fixpoint_phases.py [--source FILE.cu]

Needs a CUDA card and ``nvcc``.  Builds ``csrc/zns_fixpoint.cu`` (or
``--source``, another version of it, e.g. an earlier commit's, with the
headers of ``csrc/``) with ``-DFP_TRACE`` (block 0 stamps
``%globaltimer`` at each grid barrier) into
``build/kernels/zns_fixpoint-trace-<hash>/``, solves the float64
programs of ``chip_smoke.py`` phases 4, 5 and 13 (the experiment
runner's fleet) through the port's wrapper, and prints for the warm
solve: the initial copy, the first barrier, and for
every family pass the microseconds of phase A (gather, stage, aggregate),
barrier 1, phase B (carry, apply, store) and barrier 2, as block 0 saw
them; then the kernel's device time from ``torch.profiler``.  The card's
name and power limit lead the output.
"""
import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import repro_torch.core as P  # noqa: E402
from repro_torch.core import KiB, OpType  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import zns_fixpoint as kfix  # noqa: E402


def fleet_program():
    """Phase 4: the README fleet quickstart, 16 devices."""
    fleet = P.DeviceFleet.homogeneous(16, device="cpu")
    wl = (P.WorkloadSpec().writes(n=50_000, size=4 * KiB, qd=4)
          .reads(n=50_000, size=4 * KiB, qd=16, zone=100, nzones=64))
    traces = fleet._lower(wl, "replicate")
    prog = P.compile_fleet_program(traces, fleet.specs,
                                   [d.lat for d in fleet.devices],
                                   jitter=True, seeds=list(range(16)),
                                   cache=False)
    svc = np.concatenate([
        P.compute_service_times(traces[b], fleet.devices[b].lat,
                                seed=b)[prog.orders[b]] for b in range(16)])
    return prog, svc, 8


def contended_program():
    """Phase 5: the contended ours / nvmevirt / femu fleet."""
    wl = P.WorkloadSpec()
    for t in range(4):
        wl = wl.appends(n=5000, size=8 * KiB, qd=4, zone=t * 4, nzones=4)
        wl = wl.appends(n=5000, size=64 * KiB, qd=4, zone=t * 4, nzones=4)
    wl = wl.resets(n=200, occupancy=1.0, nzones=200, io_ctx=OpType.APPEND,
                   zone=500)
    fleet = P.DeviceFleet.from_profiles(["ours", "nvmevirt", "femu"],
                                        device="cpu")
    traces = fleet._lower(wl, "replicate")
    prog = P.compile_fleet_program(traces, fleet.specs,
                                   [d.lat for d in fleet.devices],
                                   jitter=True, seeds=[0, 1, 2], cache=False)
    svc = np.concatenate([
        P.compute_service_times(traces[b], fleet.devices[b].lat,
                                seed=b)[prog.orders[b]] for b in range(3)])
    return prog, svc, 64


def runner_program():
    """Phase 13: the experiment runner's fleet (all 15 observations)."""
    from repro_torch.experiments import ExperimentRunner
    fleet, workloads, seeds = ExperimentRunner(device="cpu").fleet()
    prog = P.compile_fleet_program([w.build() for w in workloads],
                                   fleet.specs,
                                   [d.lat for d in fleet.devices],
                                   seeds=seeds, cache=False)
    return prog, prog.svc0_flat, 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default=str(_build.CSRC / "zns_fixpoint.cu"),
                    help="the fixpoint source to build (default: the "
                         "package's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fixpoint_phases: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    with open(args.source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    print(f"source {os.path.relpath(args.source, ROOT)} ({digest})")
    out = _build.BUILD_DIR / f"zns_fixpoint-trace-{digest}"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libzns_fixpoint.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DFP_TRACE",
                    "-I", str(_build.CSRC), "-o", str(lib_path),
                    args.source], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    _build._LIBS["zns_fixpoint"] = lib       # the wrapper loads this build
    kfix._LIB = None
    stamps = (ctypes.c_ulonglong * 1024)()
    cuda = torch.device("cuda")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, (prog, svc, budget) in (("phase 4", fleet_program()),
                                      ("phase 5", contended_program()),
                                      ("phase 13", runner_program())):
        packed = kfix.pack_blocks([b.rows_view() for b in prog.families],
                                  prog.n_flat, cuda)
        c0 = torch.as_tensor(prog.issue_flat + svc, device=cuda)
        s = torch.as_tensor(svc, device=cuda)
        log = []
        kfix.zns_fixpoint_torch(c0, s, packed, sweeps=budget, active_log=log)
        want = kfix.zns_fixpoint_torch(c0, s, packed, sweeps=budget)
        ops.zns_fixpoint(c0, s, packed, sweeps=budget, impl="cuda")
        used = ops.zns_fixpoint(c0, s, packed, sweeps=budget, impl="cuda")
        lib.fp_trace_read(stamps)
        err = float(((used[0] - want[0]).abs()
                     / want[0].abs().clamp_min(1.0)).max())
        if (used[1], used[2]) != (want[1], want[2]) or err > 1e-12:
            print(f"{name}: the kernel disagrees with its plain version "
                  f"(sweeps {used[1]} / {want[1]}, converged {used[2]} / "
                  f"{want[2]}, max rel err {err:.3e})", file=sys.stderr)
            return 1
        passes = sum(len(x) for x in log)
        t = [stamps[i] for i in range(3 + 4 * passes)]
        d = [(t[i + 1] - t[i]) / 1e3 for i in range(len(t) - 1)]
        print(f"{name}: blocks {[tuple(x) for x in packed.shapes]}, sweeps "
              f"{used[1]}, active blocks per sweep {log}, grid "
              f"{kfix.zns_fixpoint.last_launch['grid']}")
        print(f"  copy {d[0]:.2f} us, first barrier {d[1]:.2f} us")
        for k in range(passes):
            a, b1, b, b2 = d[2 + 4 * k:6 + 4 * k]
            print(f"  pass {k}: phase A {a:.2f} us, barrier {b1:.2f} us, "
                  f"phase B {b:.2f} us, barrier {b2:.2f} us")
        print(f"  block 0 from start to the last barrier: "
              f"{(t[-1] - t[0]) / 1e3:.2f} us")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops.zns_fixpoint(c0, s, packed, sweeps=budget, impl="cuda")
            torch.cuda.synchronize()
        dev = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "fp_solve" in e.name]
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            ops.zns_fixpoint(c0, s, packed, sweeps=budget, impl="cuda")
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        print(f"  kernel device time (torch.profiler): {dev} us; wrapper "
              f"call (CUDA events, median of 5) "
              f"{sorted(times)[2] * 1e3:.1f} us; max rel err against the "
              f"plain version {err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
