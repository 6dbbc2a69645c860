#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, in parallel), then:

1. prints the card (``nvidia-smi``), torch and CUDA versions;
2. holds every kernel against its plain PyTorch version on the card at
   the main path's shapes, in float64 (rtol 1e-12 / atol 1e-9, equal
   sweeps and convergence) and float32 (rtol 2e-5 / atol 1e-2), and
   times kernel and plain version with CUDA events;
3. runs the README ``ZnsDevice`` quickstart (200,100 requests);
4. runs the README fleet quickstart (16 devices, 1,600,000 events);
5. runs a contended heterogeneous fleet (``ours`` / ``nvmevirt`` /
   ``femu``; multi-class append pools with resets, 120,600 events);
6. runs ``ZnsDevice.sequential_completions`` on a 100,000-request zone
   chain and ``DeviceFleet.sequential_completions`` on 16 ragged rows.

Phases 3-6 go through the public entry points on ``device="cuda"`` and
are compared with the port's host float64 ``fixpoint="loop"`` driver
(or the host numpy scan) at rtol 1e-12.  Every kernel's launch counter
is set to 0 just before each of those runs and read just after; a
kernel of the path that was never launched fails the script.  The line
before the last is a JSON object with every kernel's numbers; the last
line is ``{"ok": true, "device": {...}}``.  Exits non-zero without a
CUDA device or without the repository's ``src/`` beside this file.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor
#: float64 / float32 rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}

F64 = dict(rtol=1e-12, atol=1e-9)
F32 = dict(rtol=2e-5, atol=1e-2)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def close(got, want, tol, what: str) -> float:
    """Assert ``got`` ~ ``want`` (numpy arrays); returns max abs error."""
    import numpy as np
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    check(got.shape == want.shape, f"{what}: shape {got.shape} vs "
                                   f"{want.shape}")
    check(bool(np.isfinite(got).all()), f"{what}: non-finite values")
    err = np.abs(got - want)
    bad = err > tol["atol"] + tol["rtol"] * np.abs(want)
    check(not bad.any(), f"{what}: {int(bad.sum())} values outside "
                         f"{tol}; max abs err {float(err.max()):.3e}")
    return float(err.max()) if err.size else 0.0


def time_ms(fn, reps: int = 5, flush=None) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, after one
    warm-up; ``flush`` is zeroed before each rep to evict the L2)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import numpy as np

    import repro_torch.core as P
    from repro_torch.core import KiB, OpType
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import zns_event_scan as kscan
    from repro_torch.kernels import zns_fixpoint as kfix

    cuda = torch.device("cuda")
    t0 = time.perf_counter()

    # -- phase 1: the card ----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "unknown"
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    tb = time.perf_counter()
    libs = _build.build()
    print(f"[1] built {sorted(libs)} in {time.perf_counter() - tb:.1f} s")
    for name, path in libs.items():
        for line in (path.parent / "build.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1]   {name}: {line.strip()}")

    counters = {
        "zns_event_scan": kscan.zns_event_scan,
        "zns_event_scan_batched": kscan.zns_event_scan_batched,
        "zns_fixpoint": kfix.zns_fixpoint,
    }
    launches = {k: 0 for k in counters}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts(phase: str, need):
        got = {k: fn.launches for k, fn in counters.items()}
        for k, v in got.items():
            launches[k] += v
        print(f"[{phase}] launches {got}")
        for k in need:
            check(got[k] > 0, f"phase {phase}: kernel {k} never launched")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float64, device=cuda)
    rng = np.random.default_rng(0)
    report = {}

    # -- phase 2: kernels vs plain versions on the card ---------------------
    def scan_inputs(shape, dtype):
        issue = np.sort(rng.uniform(0, 1e6, shape), axis=-1)
        svc = rng.uniform(1, 50, shape)
        seg = rng.uniform(size=shape) < 1e-3
        seg[..., 0] = True
        return (torch.as_tensor(issue, dtype=dtype, device=cuda),
                torch.as_tensor(svc, dtype=dtype, device=cuda),
                torch.as_tensor(seg, device=cuda))

    for name, shape, op in (
            ("zns_event_scan", (1_600_000,), ops.zns_event_scan),
            ("zns_event_scan_batched", (16, 100_000),
             ops.zns_event_scan_batched)):
        for dtype in (torch.float32, torch.float64):
            args = scan_inputs(shape, dtype)
            got = op(*args, impl="cuda")
            want = op(*args, impl="torch")
            torch.cuda.synchronize()
            tol = F64 if dtype == torch.float64 else F32
            err = close(got.cpu().numpy(), want.cpu().numpy(), tol,
                        f"{name} {shape} {dtype}")
            ms = time_ms(lambda: op(*args, impl="cuda"), flush=flush)
            pms = time_ms(lambda: op(*args, impl="torch"), reps=3,
                          flush=flush)
            print(f"[2] {name} {shape} {dtype}: max abs err {err:.3e}, "
                  f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
            if dtype == torch.float64:
                n = int(np.prod(shape))
                b, by = bound_ms(25.0 * n, 3.0 * n, "float64")
                report[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                    bound_ms=b, bound_by=by,
                                    shape=list(shape), dtype="float64")

    def readme_fleet_workload():
        return (P.WorkloadSpec()
                .writes(n=50_000, size=4 * KiB, qd=4)
                .reads(n=50_000, size=4 * KiB, qd=16, zone=100, nzones=64))

    fleet16 = P.DeviceFleet.homogeneous(16, device=cuda)
    traces = fleet16._lower(readme_fleet_workload(), "replicate")
    prog4 = P.compile_fleet_program(traces, fleet16.specs,
                                    [d.lat for d in fleet16.devices],
                                    jitter=True, seeds=list(range(16)),
                                    cache=False)
    svc4 = np.concatenate([
        P.compute_service_times(traces[b], fleet16.devices[b].lat,
                                seed=b)[prog4.orders[b]] for b in range(16)])
    blocks = [blk.rows_view() for blk in prog4.families]
    print(f"[2] phase-4 program: n={prog4.n_flat}, blocks "
          f"{[tuple(g.shape) for g, _ in blocks]}")
    packed = kfix.pack_blocks(blocks, prog4.n_flat, cuda)
    for dtype in (torch.float32, torch.float64):
        c0 = torch.as_tensor(prog4.issue_flat + svc4, dtype=dtype,
                             device=cuda)
        s = torch.as_tensor(svc4, dtype=dtype, device=cuda)
        got = ops.zns_fixpoint(c0, s, packed, sweeps=8, impl="cuda")
        log = []
        want = kfix.zns_fixpoint_torch(c0, s, packed, sweeps=8,
                                       active_log=log)
        tol = F64 if dtype == torch.float64 else F32
        err = close(got[0].cpu().numpy(), want[0].cpu().numpy(), tol,
                    f"zns_fixpoint {dtype}")
        check(got[2] == want[2] and got[2],
              f"zns_fixpoint {dtype}: converged {got[2]} vs {want[2]}")
        if dtype == torch.float64:
            check(got[1] == want[1], f"zns_fixpoint float64: sweeps "
                                     f"{got[1]} vs {want[1]}")
        ms = time_ms(lambda: ops.zns_fixpoint(c0, s, packed, sweeps=8,
                                              impl="cuda"), flush=flush)
        pms = time_ms(lambda: ops.zns_fixpoint(c0, s, packed, sweeps=8,
                                               impl="torch"), reps=3,
                      flush=flush)
        lanes = sum(packed.shapes[f][1] * packed.shapes[f][2]
                    for sweep in log for f in sweep)
        print(f"[2] zns_fixpoint {dtype}: sweeps {got[1]} (plain "
              f"{want[1]}), converged {got[2]}, active blocks per sweep "
              f"{[len(x) for x in log]}, lanes {lanes}, max abs err "
              f"{err:.3e}, kernel {ms:.4f} ms, plain {pms:.4f} ms")
        if dtype == torch.float64:
            b, by = bound_ms(29.0 * lanes, 4.0 * lanes, "float64")
            report["zns_fixpoint"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                bound_by=by, sweeps=got[1], lanes=lanes, dtype="float64")

    # -- phases 3-5: vectorized runs through the public entry points -------
    def run_phase(phase, run, ref_run, *, fleet):
        zero_counts()
        t = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        read_counts(phase, ["zns_fixpoint"])
        ref = ref_run()
        got_rs = list(res) if fleet else [res]
        want_rs = list(ref) if fleet else [ref]
        err = max(close(g.sim.complete, w.sim.complete, F64,
                        f"phase {phase} completions")
                  for g, w in zip(got_rs, want_rs))
        check(res.converged, f"phase {phase}: not converged")
        check(res.solve_stats.driver == "cuda",
              f"phase {phase}: driver {res.solve_stats.driver}")
        return res, wall, err

    def solve_ms(prog, svc, sweeps=8):
        return time_ms(lambda: P.solve_program(prog, svc, sweeps=sweeps,
                                               device=cuda), reps=3)

    # phase 3: README ZnsDevice quickstart
    dev = P.ZnsDevice(device=cuda)
    wl3 = (P.WorkloadSpec()
           .writes(n=100_000, size=4 * KiB, qd=4, zone=0)
           .reads(n=100_000, size=4 * KiB, qd=16, zone=100, nzones=64)
           .resets(n=100, occupancy=1.0, io_ctx=OpType.WRITE))
    res3, wall3, err3 = run_phase(
        "3", lambda: dev.run(wl3, backend="vectorized", seed=0),
        lambda: dev.run(wl3, backend="vectorized", seed=0, fixpoint="loop",
                        scan_backend="numpy"), fleet=False)
    prog3 = P.compile_program(res3.trace, dev.spec, dev.lat, jitter=True,
                              seed=0)
    svc3 = P.compute_service_times(res3.trace, dev.lat,
                                   seed=0)[prog3.orders[0]]
    ms3 = solve_ms(prog3, svc3)
    print(f"[3] ZnsDevice quickstart: n={len(res3)}, IOPS {res3.iops:.1f}, "
          f"read p99 {res3.latency_stats(OpType.READ).p99_us:.3f} us, "
          f"sweeps {res3.sweeps_used}, compile "
          f"{res3.compile_stats.lowering_ms:.1f} ms, solve {ms3:.3f} ms, "
          f"run {wall3:.1f} ms, max abs err vs loop {err3:.3e}")

    # phase 4: README fleet quickstart
    res4, wall4, err4 = run_phase(
        "4", lambda: fleet16.run(readme_fleet_workload(), policy="replicate",
                                 backend="vectorized"),
        lambda: fleet16.run(readme_fleet_workload(), policy="replicate",
                            backend="vectorized", fixpoint="loop",
                            scan_backend="numpy"), fleet=True)
    ms4 = solve_ms(prog4, svc4)
    print(f"[4] fleet quickstart: devices 16, n="
          f"{sum(len(r) for r in res4)}, total IOPS {res4.total_iops:.1f}, "
          f"read p99 {res4.latency_stats(OpType.READ).p99_us:.3f} us, "
          f"sweeps {res4[0].sweeps_used}, compile "
          f"{res4.compile_stats.lowering_ms:.1f} ms, solve {ms4:.3f} ms, "
          f"run {wall4:.1f} ms, max abs err vs loop {err4:.3e}")

    # phase 5: contended heterogeneous fleet
    wl5 = P.WorkloadSpec()
    for t in range(4):
        wl5 = wl5.appends(n=5000, size=8 * KiB, qd=4, zone=t * 4, nzones=4)
        wl5 = wl5.appends(n=5000, size=64 * KiB, qd=4, zone=t * 4, nzones=4)
    wl5 = wl5.resets(n=200, occupancy=1.0, nzones=200,
                     io_ctx=OpType.APPEND, zone=500)
    fleet5 = P.DeviceFleet.from_profiles(["ours", "nvmevirt", "femu"],
                                         device=cuda)
    res5, wall5, err5 = run_phase(
        "5", lambda: fleet5.run(wl5, policy="replicate",
                                backend="vectorized", sweeps=64),
        lambda: fleet5.run(wl5, policy="replicate", backend="vectorized",
                           sweeps=64, fixpoint="loop", scan_backend="numpy"),
        fleet=True)
    check(res5.exact, "phase 5: fleet result is not exact")
    traces5 = fleet5._lower(wl5, "replicate")
    prog5 = P.compile_fleet_program(traces5, fleet5.specs,
                                    [d.lat for d in fleet5.devices],
                                    jitter=True, seeds=[0, 1, 2])
    svc5 = np.concatenate([
        P.compute_service_times(traces5[b], fleet5.devices[b].lat,
                                seed=b)[prog5.orders[b]] for b in range(3)])
    ms5 = solve_ms(prog5, svc5, sweeps=64)
    print(f"[5] contended fleet: n={sum(len(r) for r in res5)}, blocks "
          f"{len(prog5.families)}, exact {res5.exact}, total IOPS "
          f"{res5.total_iops:.1f}, sweeps {res5[0].sweeps_used}, compile "
          f"{res5.compile_stats.lowering_ms:.1f} ms, solve {ms5:.3f} ms, "
          f"run {wall5:.1f} ms, max abs err vs loop {err5:.3e}")

    # -- phase 6: sequential completions -------------------------------------
    n6 = 100_000
    issue6 = np.sort(rng.uniform(0, 1e6, n6))
    svc6 = rng.uniform(1, 30, n6)
    seg6 = np.zeros(n6, dtype=bool)
    seg6[0] = True
    lens = [int(x) for x in rng.integers(1_000, 20_000, 16)]
    rows = [(np.sort(rng.uniform(0, 1e5, k)), rng.uniform(1, 30, k),
             rng.uniform(size=k) < 0.01) for k in lens]
    zero_counts()
    got6 = dev.sequential_completions(issue6, svc6, seg6)
    got6b = fleet16.sequential_completions([r[0] for r in rows],
                                           [r[1] for r in rows],
                                           [r[2] for r in rows])
    torch.cuda.synchronize()
    read_counts("6", ["zns_event_scan", "zns_event_scan_batched"])
    err6 = close(got6, P.zone_sequential_completions(
        issue6, svc6, seg6, backend="numpy"), F64, "phase 6 chain")
    for (i, s, g), out in zip(rows, got6b):
        err6 = max(err6, close(out, P.zone_sequential_completions(
            i, s, g, backend="numpy"), F64, "phase 6 fleet rows"))
    print(f"[6] sequential completions: chain of {n6}, 16 rows "
          f"{min(lens)}..{max(lens)}, max abs err vs numpy {err6:.3e}")

    # -- report -----------------------------------------------------------------
    sources = {
        "zns_event_scan": ("src/repro_torch/csrc/zns_event_scan.cu",
                           "src/repro/kernels/zns_event_scan.py:118"),
        "zns_event_scan_batched": ("src/repro_torch/csrc/zns_event_scan.cu",
                                   "src/repro/kernels/zns_event_scan.py:86"),
        "zns_fixpoint": ("src/repro_torch/csrc/zns_fixpoint.cu",
                         "src/repro/kernels/zns_fixpoint.py:225"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        r = report[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            shape=r.get("shape"), dtype=r["dtype"]))
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was never launched on the main path: {launches}")
    print(f"[7] total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
