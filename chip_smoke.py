#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, in parallel), then:

1. prints the card (``nvidia-smi``), torch and CUDA versions;
2. holds every kernel against its plain PyTorch version on the card at
   the main path's shapes, in float64 (rtol 1e-12 / atol 1e-9, equal
   sweeps and convergence) and float32 (rtol 2e-5 / atol 1e-2), and
   times kernel and plain version with CUDA events: the max-plus scan at
   1,600,000 and 100,000 elements and (16, 100,000), also held against
   the host's sequential float64 loop and timed beside the same scan as
   ``torch.cumsum`` + ``torch.cummax`` (the library yardstick, with its
   float64 error); the fixpoint at the programs of phases 4, 3, 5 and 13
   with their sweep budgets (8, 8, 64, 8), with each solve's device
   kernels counted by ``torch.profiler`` (one a solve, or the script
   fails); each line gives the kernel's device time, grid and
   registers;
3. runs the README ``ZnsDevice`` quickstart (200,100 requests);
4. runs the README fleet quickstart (16 devices, 1,600,000 events);
5. runs a contended heterogeneous fleet (``ours`` / ``nvmevirt`` /
   ``femu``; multi-class append pools with resets, 120,600 events);
6. runs ``ZnsDevice.sequential_completions`` on a 100,000-request zone
   chain and ``DeviceFleet.sequential_completions`` on 16 ragged rows;
7. runs ``greedy_generate`` on qwen3-4b at full width and depth (36
   layers, random weights from seed 0): 2 prompts of 1,024 tokens, 16 new
   tokens, then the same prefill with the kernels' plain versions and in
   float32, and times prefill and decode;
8. runs the continuous-batching driver ``repro_torch.launch.serve`` on
   qwen3-4b (16 requests, batch 4, max_seq 128, 32 new tokens);
9. runs ``greedy_generate`` on mamba2-370m at full width and depth (48
   layers, random weights from seed 0): 4 prompts of 2,000 tokens (not a
   multiple of the chunk of 128: the padded path), 16 new tokens, then
   the same prefill with the kernels' plain versions and in float32, and
   times prefill and decode;
10. the same on recurrentgemma-9b at full width and depth (38 blocks,
   9.6e9 float32 parameters): 2 prompts of 3,072 tokens, longer than the
   window of 2,048;
11. runs the serving driver on mamba2-370m (16 requests, batch 4,
   max_seq 128, 32 new tokens);
12. solves the 12 non-sharded cells of the exactness matrix
   (``repro_torch.core.exactness``: 3 workloads x {jitter-free,
   jittered} x the ``cols`` / ``rows`` layouts) with the ``cuda``
   driver, each exact, converged and within rtol 1e-9 / 1e-8 of the
   event engine;
13. runs the experiment runner, ``ExperimentRunner(backend="vectorized",
   device="cuda").run()``: all 15 paper observations as one
   ``DeviceFleet`` call (46 members, 14 family blocks) solved by one
   launch of the fixpoint kernel (one launch in each run, and
   ``torch.profiler`` sees exactly one ``fp_solve_kernel`` in a run, the
   most of 3 profiled runs), every observation passed and converged, every
   metric within rtol 1e-9 of ``results/experiments/obs*.json``
   (``oracle_max_rel_diff`` absolutely, <= 1e-9) and every check's name
   and verdict the fixture's; it times the run, a second (cached) run
   and the solve, and then runs ``python -m repro_torch.experiments run
   --all --out build/experiments``, which must exit with 0.

Phase 1 prints each built kernel's registers and spills (``ptxas -v``).
Phase 2 also holds the flash-attention and RMSNorm kernels against their
plain versions at qwen3-4b's shapes, in bfloat16 and float32 at the
reference kernel tests' tolerances (attention atol 2e-2 / 2e-4, RMSNorm
2e-2 / 1e-4), and times them beside one PyTorch library call computing the
same function (attention: TFLOP/s over the visible pairs and the ratio to
SDPA; RMSNorm: GB/s), and counts the ``HGMMA`` (``wgmma``) instructions of
the built flash-attention library (``cuobjdump -sass``; none fails the
script); likewise flash attention at recurrentgemma-9b's prefill
shape (head dim 256, window 2,048), the SSD chunk scan at mamba2-370m's
prefill shape and at batch 1 (y and the final state; bfloat16 y rtol
1e-2 / atol 2e-2, state atol 1e-3; TFLOP/s and the multiple of the bound;
the ``HMMA`` (``mma.sync``) count of its library, none fails the script)
and the linear recurrence at recurrentgemma-9b's, in float32 and bfloat16
(rtol 1e-3 / atol 2e-3, the reference kernel test's; GB/s).  Phases
3-6 go through the public entry points on ``device="cuda"`` and are
compared with the port's host float64 ``fixpoint="loop"`` driver (or the
host numpy scan) at rtol 1e-12.  Phases 7, 9 and 10 first run the model's 2-layer smoke
config in float32 and require equal greedy tokens with the kernels and
with the plain versions.  Phase 7 then compares the bfloat16 model's last
logits with the kernels against those with the plain versions (atol
0.25), phase 9 the float32 model's (atol 1e-3); phases 7, 9 and 10 print
both differences, the bfloat16 model's distance from the float32 model,
and the float32 model's own sensitivity (its first norm's scale moved by
one float32 step).  Phase 10 also holds recurrentgemma-9b's first four
blocks (rec, rec, attention, rec) one by one: each block is given the
plain chain's input and run with the kernels and with the plain
versions: the recurrent blocks in bfloat16 at the bfloat16 block
tolerance of ``tests/test_torch_rglru.py`` (rtol 2e-2, atol 8e-2); the
attention block, whose random-init logits of about 3,000 put it beyond
that tolerance for any two implementations, in float32 against a
float64 block, within that tolerance plus the plain float32 block's own
largest error (its kernels-vs-plain differences are printed).  Every kernel's
launch counter is set to 0 just before each of the runs of phases 3-13
and read just after; a kernel of
the path that was never launched fails the script, and phase 9 fails
unless all 48 SSD launches of the bfloat16 prefill took the tensor-core
instance (``ssd_chunk_scan.mma_launches``).  The line
before the last is a JSON object with every kernel's numbers; the last
line is ``{"ok": true, "device": {...}}``.  Exits non-zero without a
CUDA device or without the repository's ``src/`` beside this file.
"""
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, non-tensor float64
#: / float32 rates, and the dense bfloat16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12, "bfloat16": 989e12}
ATTN_TOL = {"bfloat16": dict(rtol=0.0, atol=2e-2),
            "float32": dict(rtol=0.0, atol=2e-4)}
RMS_TOL = {"bfloat16": dict(rtol=0.0, atol=2e-2),
           "float32": dict(rtol=0.0, atol=1e-4)}
#: Phase 7: last-position logits (values of order 1-5) of the bfloat16
#: model with the kernels against the plain versions.  Both compute
#: attention and norms in float32 and round to bfloat16, so they differ
#: by rounding flips of one bfloat16 step (2^-8 relative) carried
#: through 36 layers.
LOGITS_ATOL = 0.25
#: Phase 9: the float32 model's last logits with the kernels against the
#: plain versions, which differ in summation order only (qwen3-4b's
#: float32 model measured 5.5e-6 in phase 7).  The bfloat16 difference is
#: reported beside the bfloat16 model's own distance from float32.
F32_LOGITS_ATOL = 1e-3
#: Phase 2, SSD chunk scan: kernel and plain version compute in float32 and
#: differ in summation order (the reference kernel test's atol 1e-3 for y
#: and the state); bfloat16 y may differ by one rounding step (2^-7).
SSD_TOL = {"bfloat16": dict(rtol=1e-2, atol=2e-2),
           "float32": dict(rtol=0.0, atol=1e-3)}
#: Phase 2, linear recurrence: the reference kernel test's tolerance.
LR_TOL = dict(rtol=1e-3, atol=2e-3)

F64 = dict(rtol=1e-12, atol=1e-9)
F32 = dict(rtol=2e-5, atol=1e-2)
#: Phase 10, recurrentgemma-9b's blocks one by one in bfloat16, kernels
#: against plain versions on the same input: the block tolerance of
#: tests/test_torch_rglru.py (a few bfloat16 steps, 2^-8 relative each).
BF16_BLOCK_TOL = dict(rtol=2e-2, atol=8e-2)
#: Phase 13, the experiment runner against results/experiments/obs*.json
#: (written by the event engine): the float64 solve agrees to 1e-12 and
#: the metrics derived from it are held at the exactness matrix's
#: jitter-free rtol; obs14's ``oracle_max_rel_diff`` is itself a relative
#: difference and is held absolutely at its own check's bound.
RUNNER_RTOL = 1e-9
RUNNER_ORACLE_ATOL = 1e-9


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


def device_ms(fn, key: str, reps: int = 5):
    """``(median device ms of the CUDA kernels whose name holds key in
    one call of fn, device kernels a call)`` from ``torch.profiler``
    (copies and memsets are not kernels; the L2 is not flushed), after
    one warm-up call; the time is None when the profiler records no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    times, counts = [], []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith(("Memcpy", "Memset"))]
        counts.append(len(ev))
        t = sum(e.time_range.elapsed_us() for e in ev if key in e.name)
        if t:
            times.append(t / 1e3)
    return (sorted(times)[len(times) // 2] if times else None), max(counts)


def kernel_group(name: str) -> str:
    """A CUDA kernel's name as the part of the model it serves."""
    for key, group in (("flash_fwd", "flash_attention"),
                       ("rmsnorm", "rmsnorm"),
                       ("ssd_chunk_scan", "ssd_chunk_scan"),
                       ("ssd_mma", "ssd_chunk_scan"),
                       ("linear_recurrence", "linear_recurrence"),
                       ("nvjet", "matmul"),
                       ("gemm", "matmul"), ("gemv", "matmul"),
                       ("xmma", "matmul"), ("cutlass", "matmul"),
                       ("copy_kernel", "copy/cast"), ("Memcpy", "copy/cast"),
                       ("softmax", "softmax"), ("reduce", "reduce")):
        if key in name:
            return group
    return "other elementwise"


def device_breakdown(fn):
    """Run ``fn()`` once under ``torch.profiler``; returns (wall ms, kernel
    ms, device events, [(group, ms), ...] largest first) from the CUDA
    kernel events, or None when the profiler records no device time.  The
    wall time includes the profiler's own overhead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    groups, n = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            g = kernel_group(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
            n += 1
    if not groups:
        return None
    return wall, sum(groups.values()), n, sorted(groups.items(),
                                                 key=lambda kv: -kv[1])


def kernel_name(mangled: str) -> str:
    """``name<args>`` from an Itanium-mangled kernel name (nested-name
    components, then integer, ``bf16`` and ``f32`` template arguments)."""
    i = mangled.find("_ZN")
    if i < 0:
        return mangled
    i, name = i + 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group()
        i += len(n)
        name, i = mangled[i:i + int(n)], i + int(n)
    if mangled[i:i + 1] != "I":
        return name
    args = []
    for lit, bf, f in re.findall(r"Li(-?\d+)E|(13__nv_bfloat16)|(f)",
                                 mangled[i + 1:].split("EE", 1)[0] + "E"):
        args.append(lit or ("bf16" if bf else "f32"))
    return f"{name}<{', '.join(args)}>"


def ptxas_lines(log: str):
    """``(kernel, registers, spill line)`` for every kernel of an ``nvcc
    -Xptxas -v`` log."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = kernel_name(line.rsplit(" ", 1)[-1])
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((name, int(regs.group(1)) if regs else -1, spill))
            name = None
    return out


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
    from repro_torch.core import KiB, OpType, exactness
    import torch.nn.functional as F

    from repro_torch import models as M
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.experiments import ExperimentRunner
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import linear_recurrence as klr
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.kernels import ssd_chunk_scan as kssd
    from repro_torch.kernels import zns_event_scan as kscan
    from repro_torch.kernels import zns_fixpoint as kfix
    from repro_torch.launch import serve as lserve
    from repro_torch.serve import greedy_generate

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
        for kern, regs, spill in ptxas_lines(
                (path.parent / "build.log").read_text()):
            print(f"[1]   {name}: {kern}: {regs} registers; {spill}")

    counters = {
        "zns_event_scan": kscan.zns_event_scan,
        "zns_event_scan_batched": kscan.zns_event_scan_batched,
        "zns_fixpoint": kfix.zns_fixpoint,
        "flash_attention": kfa.flash_attention,
        "rmsnorm": krms.rmsnorm,
        "ssd_chunk_scan": kssd.ssd_chunk_scan,
        "linear_recurrence": klr.linear_recurrence,
    }
    launches = {k: 0 for k in counters}
    phase_counts = {}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0
        kssd.ssd_chunk_scan.mma_launches = 0

    def read_counts(phase: str, need):
        got = {k: fn.launches for k, fn in counters.items()}
        for k, v in got.items():
            launches[k] += v
        got["ssd_chunk_scan.mma"] = kssd.ssd_chunk_scan.mma_launches
        phase_counts[phase] = got
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

    def scan_library(issue, svc, seg):
        """The same scan as PyTorch library calls (the yardstick of the
        scan kernel; the port never calls it): within each segment c_i =
        V_i + max_{j <= i} (s_j - V_{j-1}), V the running sum of svc
        (torch.cumsum), the maximum a torch.cummax over keys lifted by the
        segment's number times the keys' span, so that no segment sees an
        earlier one's keys.  The lift costs float64 digits."""
        v = torch.cumsum(svc, -1)
        y = issue - (v - svc)
        lift = torch.cumsum(seg, -1, dtype=svc.dtype) * (y.max() - y.min()
                                                          + 1.0)
        return v + (torch.cummax(y + lift, -1).values - lift)

    def host_oracle(issue, svc, seg):
        """The sequential float64 loop on the host, row by row."""
        rows = [x.reshape(-1, x.shape[-1]).cpu().numpy()
                for x in (issue, svc, seg)]
        return np.stack([P.zone_sequential_completions(i, s, g,
                                                       backend="python")
                         for i, s, g in zip(*rows)]).reshape(issue.shape)

    for name, shape, op in (
            ("zns_event_scan", (1_600_000,), ops.zns_event_scan),
            ("zns_event_scan", (100_000,), ops.zns_event_scan),
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
            wrapper = kscan.zns_event_scan if op is ops.zns_event_scan \
                else kscan.zns_event_scan_batched
            launch = dict(wrapper.last_launch)
            ms = time_ms(lambda: op(*args, impl="cuda"), flush=flush)
            kms, nk = device_ms(lambda: op(*args, impl="cuda"),
                                "scan_tiles_kernel")
            pms = time_ms(lambda: op(*args, impl="torch"), reps=3,
                          flush=flush)
            lms = time_ms(lambda: scan_library(*args), flush=flush)
            line = (f"[2] {name} {shape} {dtype}: max abs err {err:.3e}, "
                    f"kernel {ms:.4f} ms (device {kms} ms, {nk} device "
                    f"kernel a call; grid {launch['grid']} of "
                    f"{launch['resident_blocks']} resident blocks, "
                    f"{launch['registers']} registers), plain {pms:.4f} "
                    f"ms, library (cumsum + cummax) {lms:.4f} ms")
            if dtype != torch.float64:
                print(line)
                continue
            oracle = host_oracle(*args)
            kerr = close(got.cpu().numpy(), oracle, F64,
                         f"{name} {shape} against the sequential oracle")
            lib_err = float(np.abs(scan_library(*args).cpu().numpy()
                                   - oracle).max())
            print(f"{line}; against the sequential oracle: kernel "
                  f"{kerr:.3e}, library {lib_err:.3e}")
            n = int(np.prod(shape))
            b, by = bound_ms(25.0 * n, 3.0 * n, "float64")
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                       bound_by=by, library_ms=lms, kernel_ms=kms,
                       kernels_per_call=nk, oracle_err=kerr,
                       library_err=lib_err, shape=list(shape),
                       dtype="float64", **launch)
            if name in report:
                report[name]["at_100k"] = row
            else:
                report[name] = row

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
    # phase 3's and phase 5's programs, for the same kernel comparison
    dev = P.ZnsDevice(device=cuda)
    wl3 = (P.WorkloadSpec()
           .writes(n=100_000, size=4 * KiB, qd=4, zone=0)
           .reads(n=100_000, size=4 * KiB, qd=16, zone=100, nzones=64)
           .resets(n=100, occupancy=1.0, io_ctx=OpType.WRITE))
    prog3 = P.compile_program(wl3.build(), dev.spec, dev.lat, jitter=True,
                              seed=0, cache=False)
    svc3 = P.compute_service_times(wl3.build(), dev.lat,
                                   seed=0)[prog3.orders[0]]
    wl5 = P.WorkloadSpec()
    for t in range(4):
        wl5 = wl5.appends(n=5000, size=8 * KiB, qd=4, zone=t * 4, nzones=4)
        wl5 = wl5.appends(n=5000, size=64 * KiB, qd=4, zone=t * 4, nzones=4)
    wl5 = wl5.resets(n=200, occupancy=1.0, nzones=200,
                     io_ctx=OpType.APPEND, zone=500)
    fleet5 = P.DeviceFleet.from_profiles(["ours", "nvmevirt", "femu"],
                                         device=cuda)
    traces5 = fleet5._lower(wl5, "replicate")
    prog5 = P.compile_fleet_program(traces5, fleet5.specs,
                                    [d.lat for d in fleet5.devices],
                                    jitter=True, seeds=[0, 1, 2],
                                    cache=False)
    svc5 = np.concatenate([
        P.compute_service_times(traces5[b], fleet5.devices[b].lat,
                                seed=b)[prog5.orders[b]] for b in range(3)])
    # phase 13's program: the experiment runner's one fleet, a member per
    # sweep point of the 15 observations, jitter-free
    runner13 = ExperimentRunner(backend="vectorized", device=cuda)
    fleet13, wls13, seeds13 = runner13.fleet()
    prog13 = P.compile_fleet_program([w.build() for w in wls13],
                                     fleet13.specs,
                                     [d.lat for d in fleet13.devices],
                                     seeds=seeds13, cache=False)
    svc13 = prog13.svc0_flat

    for label, prog, svcp, budget in (("phase-4", prog4, svc4, 8),
                                      ("phase-3", prog3, svc3, 8),
                                      ("phase-5", prog5, svc5, 64),
                                      ("phase-13", prog13, svc13, 8)):
        blocks = [blk.rows_view() for blk in prog.families]
        print(f"[2] {label} program: n={prog.n_flat}, blocks "
              f"{[tuple(g.shape) for g, _ in blocks]}, sweep budget "
              f"{budget}")
        packed = kfix.pack_blocks(blocks, prog.n_flat, cuda)
        for dtype in (torch.float32, torch.float64):
            c0 = torch.as_tensor(prog.issue_flat + svcp, dtype=dtype,
                                 device=cuda)
            s = torch.as_tensor(svcp, dtype=dtype, device=cuda)

            def solve(impl, c0=c0, s=s, packed=packed, budget=budget):
                return ops.zns_fixpoint(c0, s, packed, sweeps=budget,
                                        impl=impl)

            got = solve("cuda")
            launch = dict(kfix.zns_fixpoint.last_launch)
            log = []
            want = kfix.zns_fixpoint_torch(c0, s, packed, sweeps=budget,
                                           active_log=log)
            tol = F64 if dtype == torch.float64 else F32
            err = close(got[0].cpu().numpy(), want[0].cpu().numpy(), tol,
                        f"zns_fixpoint {label} {dtype}")
            check(got[2] == want[2] and got[2],
                  f"zns_fixpoint {label} {dtype}: converged {got[2]} vs "
                  f"{want[2]}")
            if dtype == torch.float64:
                check(got[1] == want[1], f"zns_fixpoint {label} float64: "
                                         f"sweeps {got[1]} vs {want[1]}")
            ms = time_ms(lambda: solve("cuda"), flush=flush)
            kms, nk = device_ms(lambda: solve("cuda"), "fp_solve_kernel")
            check(nk == 1, f"zns_fixpoint {label}: {nk} device kernels a "
                           f"solve")
            pms = time_ms(lambda: solve("torch"), reps=3, flush=flush)
            lanes = sum(packed.shapes[f][1] * packed.shapes[f][2]
                        for sweep in log for f in sweep)
            print(f"[2] zns_fixpoint {label} {dtype}: sweeps {got[1]} "
                  f"(plain {want[1]}), converged {got[2]}, active blocks "
                  f"per sweep {[len(x) for x in log]}, lanes {lanes}, max "
                  f"abs err {err:.3e}, kernel {ms:.4f} ms (device {kms} "
                  f"ms, {nk} device kernel a solve; grid {launch['grid']} "
                  f"of {launch['resident_blocks']} resident blocks, "
                  f"{launch['registers']} registers), plain {pms:.4f} ms")
            if dtype != torch.float64:
                continue
            b, by = bound_ms(29.0 * lanes, 4.0 * lanes, "float64")
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                       bound_by=by, library_ms=None, kernel_ms=kms,
                       kernels_per_solve=nk, sweeps=got[1], budget=budget,
                       lanes=lanes, dtype="float64", **launch)
            if label == "phase-4":
                report["zns_fixpoint"] = row
            else:
                report["zns_fixpoint"][label] = row

    # -- phase 2, serving kernels: flash attention and RMSNorm --------------
    gen = torch.Generator(cuda).manual_seed(1)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(
            dtype)

    def sdpa(q, k, v, causal, window):
        tq, tk = q.shape[2], k.shape[2]
        if window is None and (tq == tk or not causal):
            return lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal and tq == tk, enable_gqa=True)
        if window is None and tq == 1:       # end-aligned: sees every key
            return lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True)
        mask = kref.attention_mask(tq, tk, causal, window, cuda)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)

    for case, (b, hq, hkv, tq, tk, d), window in (
            ("prefill", (1, 32, 8, 2048, 2048, 128), None),
            ("decode", (1, 32, 8, 1, 2048, 128), None),
            ("window", (1, 8, 2, 512, 512, 64), 256),
            ("d256", (2, 16, 1, 3072, 3072, 256), 2048)):
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            q = randn((b, hq, tq, d), dtype)
            k = randn((b, hkv, tk, d), dtype)
            v = randn((b, hkv, tk, d), dtype)
            got = ops.attention(q, k, v, window=window, impl="cuda")
            want = ops.attention(q, k, v, window=window, impl="torch")
            torch.cuda.synchronize()
            err = close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                        ATTN_TOL[dname], f"flash_attention {case} {dname}")
            ms = time_ms(lambda: ops.attention(q, k, v, window=window,
                                               impl="cuda"), flush=flush)
            pms = time_ms(lambda: ops.attention(q, k, v, window=window,
                                                impl="torch"), reps=3,
                          flush=flush)
            lib = sdpa(q, k, v, True, window)
            lib_err = float((lib().float() - got.float()).abs().max())
            lms = time_ms(lib, flush=flush)
            pairs = int(kref.attention_mask(tq, tk, True, window,
                                            cuda).sum())
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            flop = 4.0 * b * hq * d * pairs
            bnd, by = bound_ms(nbytes, flop, dname)
            print(f"[2] flash_attention {case} q {tuple(q.shape)} k "
                  f"{tuple(k.shape)} window {window} {dname}: max abs err "
                  f"{err:.3e} (library {lib_err:.3e}), kernel {ms:.4f} ms "
                  f"({flop / ms / 1e9:.1f} TFLOP/s, {ms / lms:.2f}x SDPA), "
                  f"plain {pms:.4f} ms, library {lms:.4f} ms, bound "
                  f"{bnd:.4f} ms ({by})")
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd,
                       bound_by=by, library_ms=lms,
                       tflops=flop / ms / 1e9, vs_library=ms / lms,
                       shape=[list(q.shape), list(k.shape)], dtype=dname)
            if case == "prefill" and dname == "bfloat16":
                report["flash_attention"] = row
            if case == "d256" and dname == "bfloat16":
                d256 = dict(row, window=window)
            del q, k, v, got, want

    for rows, d in ((2048, 2560), (2048 * 32, 128)):
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            x = randn((rows, d), dtype)
            w = randn((d,), torch.float32, 0.1)
            got = ops.rmsnorm(x, w, eps=1e-6, impl="cuda")
            want = ops.rmsnorm(x, w, eps=1e-6, impl="torch")
            torch.cuda.synchronize()
            err = close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                        RMS_TOL[dname], f"rmsnorm ({rows}, {d}) {dname}")
            ms = time_ms(lambda: ops.rmsnorm(x, w, impl="cuda"), flush=flush)
            pms = time_ms(lambda: ops.rmsnorm(x, w, impl="torch"), reps=3,
                          flush=flush)
            wl = (1.0 + w).to(dtype)
            lms = time_ms(lambda: F.rms_norm(x, (d,), weight=wl, eps=1e-6),
                          flush=flush)
            nbytes = 2.0 * x.numel() * x.element_size() + 4 * d
            bnd, by = bound_ms(nbytes, 4.0 * x.numel(), dname)
            print(f"[2] rmsnorm ({rows}, {d}) {dname}: max abs err "
                  f"{err:.3e}, kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} "
                  f"GB/s), plain {pms:.4f} ms, library {lms:.4f} ms, bound "
                  f"{bnd:.4f} ms ({by})")
            if (rows, d) == (2048, 2560) and dname == "bfloat16":
                report["rmsnorm"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd,
                    bound_by=by, library_ms=lms, gbps=nbytes / ms / 1e6,
                    shape=[rows, d], dtype=dname)
            del x, got, want

    report["flash_attention"]["d256"] = d256
    # the bf16 attention kernel runs on the tensor cores: count its wgmma
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300)
    hgmma = sum("HGMMA" in line for line in sass.stdout.splitlines())
    print(f"[2] flash_attention library: {hgmma} HGMMA (wgmma) instructions "
          f"(cuobjdump -sass)")
    check(hgmma > 0, "flash_attention: no HGMMA instruction in the library")
    report["flash_attention"]["hgmma"] = hgmma

    # -- phase 2, recurrent kernels: SSD chunk scan, linear recurrence ------
    t2, h2, p2, g2, n2, chunk = 2048, 32, 64, 1, 128, 128
    for bb in (4, 1):        # mamba2-370m's prefill; batch 1 fills 32 SMs
        x = randn((bb, t2, h2, p2), torch.bfloat16, 0.5)
        dt = (torch.rand((bb, t2, h2), generator=gen, device=cuda) * 0.099
              + 0.001)
        A = -(torch.rand((h2,), generator=gen, device=cuda) * 1.5 + 0.5)
        Bm = randn((bb, t2, g2, n2), torch.bfloat16, 0.3)
        Cm = randn((bb, t2, g2, n2), torch.bfloat16, 0.3)
        args = (x, dt, A, Bm, Cm)
        y, st = ops.ssd_scan(*args, chunk=chunk, impl="cuda")
        yw, sw = ops.ssd_scan(*args, chunk=chunk, impl="torch")
        torch.cuda.synchronize()
        err = close(y.float().cpu().numpy(), yw.float().cpu().numpy(),
                    SSD_TOL["bfloat16"], f"ssd_chunk_scan y, batch {bb}")
        serr = close(st.cpu().numpy(), sw.cpu().numpy(), SSD_TOL["float32"],
                     f"ssd_chunk_scan final state, batch {bb}")
        ms = time_ms(lambda: ops.ssd_scan(*args, chunk=chunk, impl="cuda"),
                     flush=flush)
        pms = time_ms(lambda: ops.ssd_scan(*args, chunk=chunk,
                                           impl="torch"),
                      reps=3, flush=flush)
        # the causal pairs (j <= i) of each chunk, per (batch, head): C.B^T
        # and the scores times x, then the inter-chunk term and the state
        # update
        pairs = chunk * (chunk + 1) // 2
        nflop = 2.0 * bb * h2 * (t2 // chunk) * (
            pairs * n2 + pairs * p2 + 2 * chunk * n2 * p2)
        nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4
                  + 2 * Bm.numel() * Bm.element_size() + st.numel() * 4)
        bnd, by = bound_ms(nbytes, nflop, "bfloat16")
        kind = kssd.instance(x.dtype, n2)
        stages = kssd.mma_stages(chunk, p2, n2)
        print(f"[2] ssd_chunk_scan x {tuple(x.shape)} B/C {tuple(Bm.shape)} "
              f"chunk {chunk} bfloat16 ({kind} instance, {stages} stages): "
              f"max abs err y {err:.3e}, state {serr:.3e}, kernel {ms:.4f} "
              f"ms ({nflop / ms / 1e9:.1f} TFLOP/s, {ms / bnd:.2f}x the "
              f"bound), plain {pms:.4f} ms, bound {bnd:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {nflop / 1e9:.2f} GFLOP)")
        row = dict(max_abs_err=err, state_max_abs_err=serr, ms=ms,
                   plain_ms=pms, bound_ms=bnd, bound_by=by, library_ms=None,
                   tflops=nflop / ms / 1e9, vs_bound=ms / bnd,
                   instance=kind, stages=stages,
                   shape=[list(x.shape), list(Bm.shape)], dtype="bfloat16")
        if bb == 4:
            report["ssd_chunk_scan"] = row
        else:
            report["ssd_chunk_scan"]["batch1"] = row
        del x, dt, A, Bm, Cm, args, y, st, yw, sw
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path("ssd_chunk_scan"))],
                          capture_output=True, text=True, timeout=300)
    hmma = sum("HMMA" in line for line in sass.stdout.splitlines())
    print(f"[2] ssd_chunk_scan library: {hmma} HMMA (mma.sync) instructions "
          f"(cuobjdump -sass)")
    check(hmma > 0, "ssd_chunk_scan: no HMMA instruction in the library")
    report["ssd_chunk_scan"]["hmma"] = hmma

    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        a = (torch.rand((2, 3072, 4096), generator=gen, device=cuda) * 0.399
             + 0.6).to(dtype)
        xb = randn((2, 3072, 4096), dtype)
        got = ops.linear_recurrence(a, xb, impl="cuda")
        want = ops.linear_recurrence(a, xb, impl="torch")
        torch.cuda.synchronize()
        tol = LR_TOL if dname == "float32" else dict(rtol=1e-2, atol=2e-2)
        err = close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    tol, f"linear_recurrence {dname}")
        ms = time_ms(lambda: ops.linear_recurrence(a, xb, impl="cuda"),
                     flush=flush)
        pms = time_ms(lambda: ops.linear_recurrence(a, xb, impl="torch"),
                      reps=3, flush=flush)
        nbytes = 3.0 * a.numel() * a.element_size()
        bnd, by = bound_ms(nbytes, 2.0 * a.numel(), "float32")
        print(f"[2] linear_recurrence {tuple(a.shape)} {dname}: max abs err "
              f"{err:.3e}, kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
              f"{bnd / ms:.1%} of the bound), plain {pms:.4f} ms, bound "
              f"{bnd:.4f} ms ({by})")
        if dname == "float32":
            report["linear_recurrence"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd,
                bound_by=by, library_ms=None, gbps=nbytes / ms / 1e6,
                shape=list(a.shape), dtype=dname)
        else:
            report["linear_recurrence"]["bfloat16"] = dict(
                max_abs_err=err, ms=ms, bound_ms=bnd,
                gbps=nbytes / ms / 1e6)
        del a, xb, got, want

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
    res3, wall3, err3 = run_phase(
        "3", lambda: dev.run(wl3, backend="vectorized", seed=0),
        lambda: dev.run(wl3, backend="vectorized", seed=0, fixpoint="loop",
                        scan_backend="numpy"), fleet=False)
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
    res5, wall5, err5 = run_phase(
        "5", lambda: fleet5.run(wl5, policy="replicate",
                                backend="vectorized", sweeps=64),
        lambda: fleet5.run(wl5, policy="replicate", backend="vectorized",
                           sweeps=64, fixpoint="loop", scan_backend="numpy"),
        fleet=True)
    check(res5.exact, "phase 5: fleet result is not exact")
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

    # -- phases 7, 9, 10: greedy_generate at full width and depth -----------
    def generation_phase(phase, arch, batch, plen, max_seq, need,
                         logits_atol, f32_atol, blocks=None):
        """The model's 2-layer smoke config in float32 first (kernels
        against plain versions, equal greedy tokens), then the published
        config from seed 0: greedy_generate (launches counted), prefill and
        decode times, peak memory, a profile, and the last logits with the
        kernels against those with the plain versions, in bfloat16
        (checked at ``logits_atol`` unless None) and in the float32 model
        (checked at ``f32_atol`` unless None), and against the float32
        model's.  ``blocks(cfg, params, prompt)``, when given, holds the
        model block by block."""
        small = get_smoke_config(arch, dtype="float32", kernel_impl="cuda")
        sparams = M.init_params(small, torch.Generator(cuda).manual_seed(0),
                                device=cuda)
        sprompt = torch.as_tensor(np.random.default_rng(0).integers(
            1, small.vocab_size, (2, 40)), device=cuda)
        stoks = greedy_generate(small, sparams, sprompt, steps=8, max_seq=64)
        ptoks = greedy_generate(dataclasses.replace(small,
                                                    kernel_impl="torch"),
                                sparams, sprompt, steps=8, max_seq=64)
        check(torch.equal(stoks, ptoks), f"phase {phase} smoke config: "
              f"tokens {stoks.tolist()} (kernels) vs {ptoks.tolist()} "
              f"(plain)")
        del sparams

        cfg = get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                               device=cuda)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        prompt = torch.as_tensor(np.random.default_rng(0).integers(
            1, cfg.vocab_size, (batch, plen)), device=cuda)
        zero_counts()
        t = time.perf_counter()
        toks = greedy_generate(cfg, params, prompt, steps=16,
                               max_seq=max_seq)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t) * 1e3
        read_counts(phase, need)
        check(tuple(toks.shape) == (batch, 16),
              f"phase {phase}: tokens {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"phase {phase}: token out of the vocabulary")
        t = time.perf_counter()
        logits, cache = M.prefill(cfg, params, prompt, max_seq)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        tok = logits[:, -1].argmax(-1)
        step_ms = []
        for i in range(8):
            t = time.perf_counter()
            step_logits, cache = M.decode_step(cfg, params, cache, tok,
                                               plen + i)
            tok = step_logits.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        step_ms.sort()
        decode_ms = step_ms[len(step_ms) // 2]
        check(torch.equal(tok, toks[:, 8]), f"phase {phase}: decode after "
              f"prefill gave {tok.tolist()}, greedy_generate "
              f"{toks[:, 8].tolist()}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        shape = f"{batch} x {plen}"
        for what, fn in ((f"prefill {shape}", lambda: M.prefill(
                              cfg, params, prompt, max_seq)),
                         (f"decode step, batch {batch}", lambda: M.decode_step(
                             cfg, params, cache, tok, plen + 8))):
            brk = device_breakdown(fn)
            if brk is None:
                print(f"[{phase}] {what}: profiler recorded no device time "
                      f"(breakdown not measured)")
                continue
            wall, busy, n, groups = brk
            print(f"[{phase}] {what} under torch.profiler: wall {wall:.1f} "
                  f"ms, {n} device events, kernels {busy:.1f} ms, device "
                  f"idle {max(0.0, 1 - busy / wall):.1%}; " + ", ".join(
                      f"{g} {ms:.2f} ms" for g, ms in groups))
        del cache
        plain, _ = M.prefill(dataclasses.replace(cfg, kernel_impl="torch"),
                             params, prompt, max_seq)
        f32 = dataclasses.replace(cfg, dtype="float32")
        exact, _ = M.prefill(f32, params, prompt, max_seq)
        f32_plain = dataclasses.replace(f32, kernel_impl="torch")
        exact_plain, _ = M.prefill(f32_plain, params, prompt, max_seq)
        # the float32 model's own sensitivity: the first layer norm's scale
        # (1 + w, w = 0 at init) moved by one float32 step
        w = next(p for n, p in params.named_parameters()
                 if n.rsplit(".", 1)[-1] in ("ln", "ln1"))
        with torch.no_grad():
            w.add_(2.0 ** -23)
        nudged, _ = M.prefill(f32_plain, params, prompt, max_seq)
        with torch.no_grad():
            w.sub_(2.0 ** -23)
        nudge = float((nudged - exact_plain).abs().max())
        got = logits[:, -1].cpu().numpy()
        want = plain[:, -1].cpu().numpy()
        got32 = exact[:, -1].cpu().numpy()
        want32 = exact_plain[:, -1].cpu().numpy()
        check(bool(np.isfinite(got).all() and np.isfinite(got32).all())
              and got.shape == want.shape == got32.shape,
              f"phase {phase}: last logits not finite or misshapen")
        err = float(np.abs(got - want).max())
        to_f32 = float(np.abs(got - got32).max())
        plain_f32 = float(np.abs(want - got32).max())
        f32_err = float(np.abs(got32 - want32).max())
        print(f"[{phase}] {arch}: {M.count_params(cfg):,} params, init "
              f"{init_s:.1f} s, greedy_generate {shape} + 16 tokens "
              f"{gen_ms:.1f} ms, prefill {prefill_ms:.1f} ms, decode "
              f"{decode_ms:.2f} ms/token (batch {batch}; median of 8 steps, "
              f"{step_ms[0]:.2f}..{step_ms[-1]:.2f}), peak memory "
              f"{peak_gb:.2f} GB")
        print(f"[{phase}] last logits max |logit| "
              f"{float(np.abs(got).max()):.3f}; kernels vs plain {err:.3e} "
              f"(mean {float(np.abs(got - want).mean()):.3e}, atol "
              f"{logits_atol}); bfloat16 vs float32 model: kernels "
              f"{to_f32:.3e}, plain {plain_f32:.3e}; float32 model, kernels "
              f"vs plain {f32_err:.3e} (atol {f32_atol}); float32 plain "
              f"model with its first norm's scale moved one step "
              f"{nudge:.3e}; tokens {toks[0].tolist()}")
        if logits_atol is not None:
            close(got, want, dict(rtol=0.0, atol=logits_atol),
                  f"phase {phase} last logits, kernels vs plain")
        if f32_atol is not None:
            close(got32, want32, dict(rtol=0.0, atol=f32_atol),
                  f"phase {phase} float32 last logits, kernels vs plain")
        block_errs = blocks(cfg, params, prompt) if blocks else None
        del params, logits, plain, exact, exact_plain, nudged, step_logits
        torch.cuda.empty_cache()
        return dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
                    peak_gb=peak_gb, logits_err=err, f32_err=f32_err,
                    nudge=nudge, block_errs=block_errs)

    generation_phase("7", "qwen3-4b", 2, 1024, 2048,
                     ["flash_attention", "rmsnorm"], LOGITS_ATOL, None)

    # -- phase 8: the continuous-batching driver on qwen3-4b -----------------
    zero_counts()
    stats = lserve.main(["--arch", "qwen3-4b", "--requests", "16",
                         "--batch", "4", "--max-seq", "128", "--max-new",
                         "32", "--seed", "0"])
    torch.cuda.synchronize()
    read_counts("8", ["rmsnorm"])
    check(stats["done"] == 16, f"phase 8: {stats['done']}/16 requests")
    print(f"[8] serve driver: {stats['done']} requests, {stats['steps']} "
          f"decode steps in {stats['seconds']:.2f} s, "
          f"{stats['tok_per_s']:.1f} tok/s (batch 4), "
          f"{stats['seconds'] / stats['steps'] * 1e3:.2f} ms/step")

    # -- phase 9: greedy_generate on mamba2-370m ------------------------------
    generation_phase("9", "mamba2-370m", 4, 2000, 2048,
                     ["ssd_chunk_scan", "rmsnorm"], None, F32_LOGITS_ATOL)
    # the bfloat16 prefill's SSD launches (one a layer) all took the
    # tensor-core instance
    got9 = phase_counts["9"]
    check(got9["ssd_chunk_scan"] == 48 and got9["ssd_chunk_scan.mma"] == 48,
          f"phase 9: ssd_chunk_scan launches {got9['ssd_chunk_scan']}, "
          f"tensor-core instance {got9['ssd_chunk_scan.mma']} (want 48, 48)")

    # -- phase 10: greedy_generate on recurrentgemma-9b -----------------------
    def attn_block64(cfg, p, x, pos):
        """recurrentgemma's attention block in float64 from the plain
        float32 path's q, k and v (the float32 block's own accuracy), and
        the largest |q|, |k|, |v| and |logit|."""
        from repro_torch.models import common as mc
        f64 = torch.float64

        def norm(w, y):
            return y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True)
                                   + cfg.rms_eps) * (1.0 + w.to(f64))

        q, k, v = mc.attn_qkv(cfg, p["attn"], mc.rmsnorm(cfg, p["ln"], x),
                              pos)
        bsz, t, hq, dh = q.shape
        rep = hq // k.shape[2]
        core = torch.empty(q.shape, dtype=f64, device=cuda)
        kpos = torch.arange(t, device=cuda)
        top = 0.0
        for b in range(bsz):
            for c0 in range(0, t, 512):
                qc = q[b, c0:c0 + 512].to(f64)                # (c, H, Dh)
                qpos = kpos[c0:c0 + qc.shape[0], None]
                vis = (kpos[None] <= qpos) & (kpos[None] > qpos - cfg.window)
                for h in range(hq):
                    kk = k[b, :, h // rep].to(f64)
                    s = ((qc[:, h] @ kk.T) / dh ** 0.5).masked_fill(
                        ~vis, -float("inf"))
                    top = max(top, float(s.abs().masked_fill(~vis, 0).max()))
                    w = torch.softmax(s, -1)
                    core[b, c0:c0 + qc.shape[0], h] = w @ v[b, :, h // rep].to(
                        f64)
        y = x.to(f64) + torch.einsum("bshk,hkd->bsd", core,
                                     p["attn"]["wo"].to(f64))
        z = norm(p["ln2"], y)
        m = p["mlp"]
        out = y + (torch.nn.functional.silu(z @ m["w_gate"].to(f64))
                   * (z @ m["w_up"].to(f64))) @ m["w_down"].to(f64)
        return out, [float(a.abs().max()) for a in (q, k, v)] + [top]

    def rglru_blocks(cfg, params, prompt):
        """The first four blocks (rec, rec, attention, rec) one by one,
        each given the bfloat16 plain chain's input, with the kernels and
        with the plain versions, held at BF16_BLOCK_TOL: the recurrent
        blocks in bfloat16.  The attention block does not hold at that
        tolerance for any two implementations: the random init's q, k
        and v reach a few hundred and its logits about 3,000, so in
        bfloat16 one rounding step of the attention output (about 2),
        summed through the output projection, exceeds it, and in float32
        a softmax whose two largest logits nearly tie moves with the
        logits' rounding (the plain float32 block is itself about 0.28
        from the float64 one).  So the attention block is held in float32
        against the block computed in float64 from the plain path's q, k
        and v: every element of the kernels' block within the tolerance
        plus the plain versions' largest error.  Its kernels-vs-plain
        differences, in float32 and bfloat16, are printed."""
        from repro_torch.models import common as mc
        from repro_torch.models import rglru as mr
        plain = dataclasses.replace(cfg, kernel_impl="torch")
        f32 = dataclasses.replace(cfg, dtype="float32")
        f32_plain = dataclasses.replace(f32, kernel_impl="torch")
        group = [(f"group 0 b{i}_{kind}", kind, params.groups[0][
            f"b{i}_{kind}"]) for i, kind in enumerate(cfg.block_pattern)]
        kind1 = cfg.block_pattern[0]
        group.append((f"group 1 b0_{kind1}", kind1,
                      params.groups[1][f"b0_{kind1}"]))
        kinds = [k for _, k, _ in group]
        check("rec" in kinds and "attn" in kinds,
              f"phase 10: blocks {kinds}")
        tol = BF16_BLOCK_TOL
        errs = []
        with torch.inference_mode():
            x = mc.embed_tokens(cfg, params.embed, prompt,
                                mc.torch_dtype(cfg.dtype))
            pos = torch.arange(prompt.shape[1], dtype=torch.int32,
                               device=cuda).expand(*prompt.shape)
            for name, kind, p in group:
                if kind == "rec":
                    got, want = (mr.rec_block(c, p, x) for c in (cfg, plain))
                    x = want
                    err = close(got.float().cpu().numpy(),
                                want.float().cpu().numpy(), tol,
                                f"phase 10 {name}, kernels vs plain")
                    print(f"[10] {name} (rec) {tuple(got.shape)} "
                          f"{got.dtype}: kernels vs plain max abs err "
                          f"{err:.3e} (max |x| "
                          f"{float(want.float().abs().max()):.3f}; {tol})")
                    errs.append(err)
                    continue
                got, want = (mr.attn_block(c, p, x.float(), pos)
                             for c in (f32, f32_plain))
                exact, mags = attn_block64(f32_plain, p, x.float(), pos)
                e_plain = float((want.double() - exact).abs().max())
                e_kern = (got.double() - exact).abs()
                excess = float((e_kern - tol["atol"] - tol["rtol"]
                                * exact.abs()).max()) - e_plain
                agree = ((got - want).abs() <= tol["atol"] + tol["rtol"]
                         * want.abs()).all(-1)
                err = float((got - want).abs().max())
                nxt = mr.attn_block(plain, p, x, pos)
                bf16 = mr.attn_block(cfg, p, x, pos)
                print(f"[10] {name} (attn) {tuple(got.shape)} float32: "
                      f"against the float64 block, kernels "
                      f"{float(e_kern.max()):.3e}, plain {e_plain:.3e} "
                      f"(excess over the plain error and {tol}: "
                      f"{excess:.3e}); kernels vs plain {err:.3e}, within "
                      f"{tol} on {int(agree.sum())}/{agree.numel()} tokens; "
                      f"in bfloat16 kernels vs plain "
                      f"{float((bf16 - nxt).abs().max()):.3e} (max |x| "
                      f"{float(nxt.float().abs().max()):.3f}); max |q|, "
                      f"|k|, |v|, |logit| {[round(a, 1) for a in mags]}")
                check(excess <= 0, f"phase 10 {name}: the kernels' float32 "
                                   f"block is {excess:.3e} farther from the "
                                   f"float64 block than the plain versions' "
                                   f"error and {tol} allow")
                errs.append(err)
                x = nxt
        return errs

    generation_phase("10", "recurrentgemma-9b", 2, 3072, 4096,
                     ["linear_recurrence", "flash_attention", "rmsnorm"],
                     None, None, blocks=rglru_blocks)

    # -- phase 11: the continuous-batching driver on mamba2-370m -------------
    zero_counts()
    stats = lserve.main(["--arch", "mamba2-370m", "--requests", "16",
                         "--batch", "4", "--max-seq", "128", "--max-new",
                         "32", "--seed", "0"])
    torch.cuda.synchronize()
    read_counts("11", ["rmsnorm"])
    check(stats["done"] == 16, f"phase 11: {stats['done']}/16 requests")
    print(f"[11] serve driver: {stats['done']} requests, {stats['steps']} "
          f"decode steps in {stats['seconds']:.2f} s, "
          f"{stats['tok_per_s']:.1f} tok/s (batch 4), "
          f"{stats['seconds'] / stats['steps'] * 1e3:.2f} ms/step")

    # -- phase 12: the exactness matrix on the cuda driver -------------------
    cells = exactness.cells()
    zero_counts()
    worst = 0.0
    for cell in cells:
        comp, used, conv = P.solve_program(
            cell.program, cell.svc_flat, sweeps=exactness.SWEEPS,
            fixpoint="cuda", warn=False, device=cuda)
        check(cell.program.exact, f"phase 12: {cell.name} is not exact")
        check(conv, f"phase 12: {cell.name} did not converge")
        err = cell.max_rel_err(comp)
        check(err <= cell.tol, f"phase 12: {cell.name} max rel err "
                               f"{err:.3e} over rtol {cell.tol}")
        worst = max(worst, err)
    torch.cuda.synchronize()
    read_counts("12", ["zns_fixpoint"])
    print(f"[12] exactness matrix: {len(cells)} cells (scale "
          f"{exactness.SCALE}) on the cuda driver, all exact and converged, "
          f"max rel err against the event engine {worst:.3e} (rtol "
          f"{exactness.TOL_JITTER_FREE:g} jitter-free, "
          f"{exactness.TOL_JITTERED:g} jittered)")

    # -- phase 13: the experiment runner ------------------------------------
    fixtures = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "results", "experiments",
                                              "obs*.json"))):
        with open(path) as f:
            data = json.load(f)
        fixtures[data["name"]] = data
    check(len(fixtures) == 15, f"phase 13: {len(fixtures)} fixtures")
    zero_counts()
    t = time.perf_counter()
    results13 = runner13.run()
    torch.cuda.synchronize()
    run13_ms = (time.perf_counter() - t) * 1e3
    read_counts("13", ["zns_fixpoint"])
    fres13 = runner13.last_fleet
    launch13 = dict(kfix.zns_fixpoint.last_launch)
    cstats, sstats = fres13.compile_stats, fres13.solve_stats
    check(len(results13) == 15, f"phase 13: {len(results13)} results")
    check(phase_counts["13"]["zns_fixpoint"] == 1,
          f"phase 13: {phase_counts['13']['zns_fixpoint']} fixpoint "
          f"launches for one fleet call")
    check(sstats.driver == "cuda" and sstats.converged,
          f"phase 13: driver {sstats.driver}, converged {sstats.converged}")
    worst13 = 0.0
    for r in results13:
        want = fixtures.get(r.name)
        check(want is not None, f"phase 13: no fixture for {r.name}")
        check(r.passed and r.converged and r.backend == "vectorized",
              f"phase 13: {r.name} passed {r.passed}, converged "
              f"{r.converged}, backend {r.backend}: "
              f"{[str(c) for c in r.checks if not c.ok]}")
        verdicts = [(c.name, bool(c.ok)) for c in r.checks]
        check(verdicts == [(c["name"], c["ok"]) for c in want["checks"]],
              f"phase 13: {r.name} checks {verdicts}")
        check(set(r.metrics) == set(want["metrics"]),
              f"phase 13: {r.name} metric names differ from the fixture")
        for k, v in r.metrics.items():
            w = want["metrics"][k]
            if k == "oracle_max_rel_diff":
                check(abs(v) <= RUNNER_ORACLE_ATOL,
                      f"phase 13: {r.name} {k} = {v:.3e}")
                continue
            if w is None:          # the fixture's non-finite value
                check(not np.isfinite(v), f"phase 13: {r.name} {k} = {v}")
                continue
            rel = abs(v - w) / abs(w) if w else abs(v)
            check(abs(v - w) <= RUNNER_RTOL * abs(w),
                  f"phase 13: {r.name} {k} = {v!r}, fixture {w!r} (rel "
                  f"{rel:.3e} over {RUNNER_RTOL})")
            worst13 = max(worst13, rel)
    # a second run of the same selection: the compiled program is cached
    t = time.perf_counter()
    again = runner13.run()
    torch.cuda.synchronize()
    rerun13_ms = (time.perf_counter() - t) * 1e3
    check([r.metrics for r in again] == [r.metrics for r in results13],
          "phase 13: a second run gave other metrics")
    # the device kernels of one whole run: exactly one fixpoint solve (the
    # most any of 3 profiled runs recorded, as device_ms counts them: a
    # profiled window can miss a kernel), and one launch in each run
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(3):
        before = kfix.zns_fixpoint.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            runner13.run()
            torch.cuda.synchronize()
        check(kfix.zns_fixpoint.launches == before + 1,
              f"phase 13: {kfix.zns_fixpoint.launches - before} fixpoint "
              f"launches in one run")
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        seen.append((sum("fp_solve_kernel" in k for k in names), len(names)))
    n_fp, n_kern = max(seen)
    check(n_fp == 1, f"phase 13: torch.profiler saw (fixpoint kernels, "
                     f"device kernels) {seen} in 3 runs")
    solve13 = solve_ms(prog13, svc13)
    print(f"[13] experiment runner: {len(results13)}/15 observations passed "
          f"and converged in one fleet call: {cstats.n_devices} members "
          f"({cstats.n_unique} unique), {prog13.n_flat} requests, "
          f"{sstats.n_blocks} blocks, {sstats.sweeps} sweeps, lowering "
          f"{cstats.lowering_ms:.1f} ms, solve {solve13:.4f} ms; run "
          f"{run13_ms:.1f} ms, second (cached) run {rerun13_ms:.1f} ms; "
          f"(fixpoint, all) device kernels in 3 profiled runs {seen}; "
          f"kernel grid {launch13['grid']} of "
          f"{launch13['resident_blocks']} resident blocks, "
          f"{launch13['registers']} registers; worst metric rel diff "
          f"from the fixtures {worst13:.3e}")
    out13 = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments", "run", "--all",
         "--out", os.path.join("build", "experiments")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=600)
    tail = [line for line in (out13.stdout + out13.stderr).splitlines()
            if line.strip()][-2:]
    check(out13.returncode == 0, f"phase 13: python -m "
          f"repro_torch.experiments run --all exited with "
          f"{out13.returncode}: {tail}")
    print(f"[13] python -m repro_torch.experiments run --all: exit 0; "
          f"{' '.join(tail)}")
    report["zns_fixpoint"]["runner"] = dict(
        members=cstats.n_devices, unique=cstats.n_unique,
        requests=prog13.n_flat, blocks=sstats.n_blocks,
        sweeps=sstats.sweeps, lowering_ms=cstats.lowering_ms,
        solve_ms=solve13, run_ms=run13_ms, rerun_ms=rerun13_ms,
        device_kernels=n_kern, **launch13)

    # -- report -----------------------------------------------------------------
    sources = {
        "zns_event_scan": ("src/repro_torch/csrc/zns_event_scan.cu",
                           "src/repro/kernels/zns_event_scan.py:118"),
        "zns_event_scan_batched": ("src/repro_torch/csrc/zns_event_scan.cu",
                                   "src/repro/kernels/zns_event_scan.py:86"),
        "zns_fixpoint": ("src/repro_torch/csrc/zns_fixpoint.cu",
                         "src/repro/kernels/zns_fixpoint.py:225"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:77"),
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:28"),
        "ssd_chunk_scan": ("src/repro_torch/csrc/ssd_chunk_scan.cu",
                           "src/repro/kernels/ssd_chunk_scan.py:76"),
        "linear_recurrence": ("src/repro_torch/csrc/linear_recurrence.cu",
                              "src/repro/kernels/linear_recurrence.py:45"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        r = report[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            **{k: v for k, v in r.items() if k not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}))
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was never launched on the main path: {launches}")
    print(f"[14] total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
