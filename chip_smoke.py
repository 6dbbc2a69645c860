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
   registers; and the stacked fixpoint (``zns_fixpoint_sharded``, every
   shard of a plan in one launch) on the signature plans of phases 13
   (16 shards) and 5 (2 shards), shard by shard against its plain
   version and against the single-program kernel (completions, sweeps,
   convergence), timed beside the single-program kernel on the whole
   program;
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
12. solves the 18 cells of the exactness matrix
   (``repro_torch.core.exactness``: 3 workloads x {jitter-free,
   jittered} x the ``cols`` / ``rows`` / ``sharded`` layouts) with the
   ``cuda`` driver (the sharded cells on the ``mesh`` executor), each
   exact, converged and within rtol 1e-9 / 1e-8 of the event engine;
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
   --all --out build/experiments``, which must exit with 0;
14. runs ``repro_torch.host.compare_policies(device="cuda")`` at scale
   1.0: 9 (scenario, policy) combinations, 41,093 requests, as one
   ``DeviceFleet`` call and one launch of the fixpoint kernel, every row
   within rtol 1e-9 of the port's host ``event`` backend with the same
   ranking; the three ``tests/golden/*__greedy-open.json`` workloads
   reproduce (trace digest) and their completions hold on the card's
   vectorized backend (rtol 1e-9, atol 1e-6); then ``python -m
   repro_torch.experiments host --out build/host`` must exit with 0;
15. solves the programs of phases 13 and 5 with ``fixpoint="sharded"``
   (the mesh executor: one stacked launch each) against
   ``fixpoint="cuda"`` at rtol 1e-12, and the 1,000,000-request
   open-loop entry of ``benchmarks/mega_fleet.py``'s windowed row
   windowed at 131,072 events (8 windows, 8 launches of the fixpoint
   kernel) against its unwindowed ``cuda`` solve at rtol 1e-12, with
   each one's time and peak device memory; then that one-entry program
   with ``fixpoint="sharded"`` (a 1-shard plan: one launch of the
   single-program kernel) against ``cuda`` at rtol 1e-12;
16. runs ``greedy_generate`` on qwen2-moe-a2.7b at full width and depth
   (24 layers, 60 routed experts top-4 and a shared expert, 14.3e9
   float32 parameters from seed 0): 2 prompts of 1,024 tokens, 16 new
   tokens, as phase 7; counts the (token, expert) routing choices that
   differ between the kernels' and the plain versions' prefills, holds
   the first four layers one by one (below), then runs the serving
   driver on it (16 requests, batch 4, max_seq 128, 32 new tokens);
17. runs the ZNS checkpoint store (``repro_torch.runtime``) on the card:
   the four write policies of ``examples/zns_checkpointing.py`` on a
   4 GiB shard through ``ZnsHostDevice.simulate_payload_write`` (one
   launch of the scan kernel each; 1,048,576 appends at 4 KiB) within
   1e-12 relative of the same call on the CPU, the R5 reset-under-I/O row,
   then ``ZonedCheckpointStore(n_hosts=4)`` under ``build/`` saving
   mamba2-370m's full-size parameters (1.47 GB): one launch of the
   batched scan kernel, a manifest (bytes, zones, sha256, modeled
   seconds) equal to the same save on the CPU, a bit-exact restore, a
   second save and ``gc(keep_last=1)``; the directory is removed;
18. trains tinyllama-1.1b at full width and depth (22 layers, 1.1e9
   float32 parameters from seed 0, every weight matrix N(0, 0.02),
   bfloat16 activations, remat full) through ``repro_torch.launch.train``:
   8 steps of 4 x 2,048 tokens from ``TokenPipeline`` at lr 3e-3 with 2
   warmup steps; every loss finite and the mean of the last 2 below the
   first 2's; each kernel launched exactly as a step needs (forward
   RMSNorm and attention for each layer forward and recompute,
   ``models.common.layer_forward_runs``; each backward once a layer)
   and no other kernel; it prints the step time, tokens/s, peak memory,
   and a profiled step's device idle share, kernel groups (which must
   include both backward kernels) and the attention backward's share of
   the kernels' time.  Then the first step's gradients at full width and
   depth in float32, kernels against plain versions, each leaf's error
   to a float64 plain step within the plain float32 step's plus
   ``GRAD_F64_FRAC`` of its scale, and in bfloat16 each leaf's relative
   (Frobenius) gap, kernels against plain, within ``BF16_GRAD_REL``;
   then at full width and 2 layers a checkpoint at step 3 into the ZNS
   store (one batched scan launch), restored into a fresh state (seed
   99) and replayed through step 6: parameters, m and v equal an
   uninterrupted run's bit for bit;
19. runs the cluster tier (``repro_torch.cluster``) on the card at
   ``benchmarks/cluster_bench.py``'s rack: 4 gateways, 16 storage
   servers, the configs ``ec2+1/round-robin``, ``rep2-k2/hashed``,
   ``ec4+2/strided`` and ``ec3+1/grouped``, 8 users x 6 objects of 1 MiB
   (GET fraction 0.5, seed 0).  ``plan_capacity`` with the users ladder
   [4, 8] and degraded mode (16 programs, 17,164 events) on the default
   ``fixpoint="auto"``: every solve (each compile's bootstrap and
   refinements, and the fleet solve) one launch of the fixpoint kernel,
   as many launches as ``solve_program`` calls; every point converged,
   every config order-stable; each compiled program, family and FIFO pop
   order equal to the same call on ``device="cpu"`` with the host float64
   ``fixpoint="loop"`` driver and numpy scans, its completions within
   rtol 1e-12; the per-op latencies of the fleet solve within
   ``CLUSTER_TOL_US`` of the greedy-engine oracle ``simulate_graph`` on
   each graph; and the bench's ranking sanity (no erasure config's
   degraded p99 below 0.95 of its normal row's).  Then the rate ladder
   [4,000, 16,000, 64,000] objects/s cold and with ``warm_ladder=True``
   (equal curves to rtol 1e-12; it prints warm hits / attempts), and one
   config with ``fixpoint="loop"`` (the batched scan kernel around the
   host loop) against the ``cuda`` driver at rtol 1e-12.  It prints each
   call's wall time split into host lowering and the time inside
   ``solve_program`` (uploads, the launch and the copy back), the solve
   and launch counts, the sweeps and family blocks x sweeps of its
   solves, the fleet solve's programs, events and sweeps, and, from a
   profiled users-ladder call, the device's idle share and the fixpoint
   kernel's device time a launch and a family block a sweep.

Phase 1 prints each built kernel's registers and spills (``ptxas -v``),
and fails if ptxas serialised any kernel's ``wgmma`` (warning C7518 in a
build log) or if a bfloat16 attention backward kernel or an RMSNorm
backward kernel of the vector path or the dw sum spills.
Phase 2 also holds the flash-attention and RMSNorm kernels against their
plain versions at qwen3-4b's shapes, in bfloat16 and float32 at the
reference kernel tests' tolerances (attention atol 2e-2 / 2e-4, RMSNorm
2e-2 / 1e-4), and times them beside one PyTorch library call computing the
same function (attention: TFLOP/s over the visible pairs and the ratio to
SDPA; RMSNorm: GB/s); the two backward kernels against their plain
versions (``BWD_TOL``; two runs bit-equal) at tinyllama-1.1b's training
shape (4 x 32/4 heads x 2,048, D 64) and qwen3-4b's (D 128) for
attention, and at (8,192, 2,048) and the qk-norm rows (262,144, 128) for
RMSNorm, timed beside SDPA's and ``F.rms_norm``'s backward through
autograd (the RMSNorm backward also by ``torch.profiler``'s device time of
its kernels, two a call (more fails the script), with its share of the
bound and its kernels' registers), and the attention forward with and
without ``lse``; and counts the ``HGMMA`` (``wgmma``) instructions in
each function of the built flash-attention library (``cuobjdump
-sass``): none in the forward, or
in any instance of the bfloat16 backward's dK/dV or dQ kernel, fails the
script; likewise flash attention at recurrentgemma-9b's prefill
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
largest error (its kernels-vs-plain differences are printed).  Phase 16
does not hold qwen2-moe-a2.7b's whole-model logits at phase 7's
tolerance: routing is discrete, a choice that differs at the first
layers (a few of 8,192 in bfloat16) reroutes later tokens layer after
layer, in float32 too, so the script fails only when the logits differ
beyond 0.25 (bfloat16) or 1e-3 (float32) with every routing choice
alike.  It holds the first four layers one by one from the plain chain's
input: the attention half as phase 10's attention block (in float32
against float64; the init's logits reach the hundreds); the FFN norm at
the bfloat16 block tolerance; the MoE block on the plain norm's
output against a float32 expert-by-expert computation (the same top-k,
drops and shared expert) at the block tolerance; and the MoE block
kernels vs plain on every token both runs route alike (the others are
counted).  Every kernel's
launch counter is set to 0 just before each of the runs of phases 3-19
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
import hashlib
import json
import os
import re
import shutil
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
#: Phase 2, the backward kernels against their plain versions on the same
#: forward outputs: both compute in float32 and differ in summation order
#: (gradients sum over thousands of rows), and bfloat16 results by their
#: last rounding (2^-8 relative): rtol, and atol as a fraction of the
#: tensor's largest magnitude.
BWD_TOL = {"bfloat16": (2e-2, 2e-3), "float32": (1e-3, 1e-4)}
#: Phase 18: the kernels' float32 gradients against a float64 plain step:
#: within the plain float32 step's own error plus this fraction of each
#: leaf's largest magnitude (float32 errors are ~1e-6 of it; a wrong
#: gradient is off by O(1) of it).
GRAD_F64_FRAC = 1e-4
#: Phase 18: the bfloat16 first-step gradients, kernels against plain
#: versions, each leaf's relative (Frobenius) gap: the bound of
#: tests/test_torch_train_bf16.py (BF16_REL).  Both round activations to
#: bfloat16 at places that differ, and the attention backward kernel
#: also rounds P and dS to bfloat16 for its tensor-core products.
BF16_GRAD_REL = 0.1
#: Phase 18's forward time of the attention kernel at qwen3-4b's prefill
#: shape without lse (PR 19's phase 2, bfloat16).
ATTN_FWD_PR19_MS = 0.1203

#: Kernels that must not spill (ptxas -v): the bfloat16 attention
#: backward's and the RMSNorm backward's, whose designs hold their
#: accumulators in registers.
NO_SPILL = ("bwd_dkdv_wgmma", "bwd_dq_wgmma", "rmsnorm_bwd_vec",
            "rmsnorm_dw_sum")

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
#: Phase 14, the host goldens (event-engine completions) against the
#: card's vectorized backend: the reference golden test's tolerance.
GOLDEN_TOL = dict(rtol=1e-9, atol=1e-6)
#: Phase 19: the compiled cluster program against the greedy event-engine
#: oracle, per-op latency in microseconds (benchmarks/cluster_bench.py's
#: TOL_US).
CLUSTER_TOL_US = 1e-6
#: Phase 15's issue-time window, as benchmarks/mega_fleet.py's windowed row.
WINDOW_EVENTS = 131_072
#: Phase 16: the layers of qwen2-moe-a2.7b held one by one.
MOE_LAYERS = 4
#: Phase 17: the store's modeled seconds on the card against the same
#: calls on the CPU (the same float64 max-plus scan).
STORE_RTOL = 1e-12


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
    one warm-up call, each call in its own profiled window.  The profiler
    on the H100 machine drops the first kernel of most windows, so each
    window first runs two short sleep kernels (``spin_kernel``),
    synchronising after each, and counts every kernel after the last
    sleep kernel it recorded: all that fn launched.  It still drops a
    kernel now and then, so the time is the median over the windows that
    saw the most kernels, and the kernels a call are that most; the time
    is None when the profiler records no device time.  A round of reps
    windows in which the profiler recorded kernels but no sleep kernel
    (it does so now and then on the H100) is run again, up to three
    rounds; fails when no window of the last round recorded a sleep
    kernel (the count would hold them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        seen, slept = [], 0
        for _ in range(reps):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    torch.cuda._sleep(1000)
                    torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
            ev = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and not e.name.startswith(("Memcpy", "Memset"))),
                        key=lambda e: e.time_range.start)
            sleeps = [i for i, e in enumerate(ev)
                      if "spin_kernel" in e.name]
            ev = ev[sleeps[-1] + 1:] if sleeps else ev
            slept += bool(sleeps)
            t = sum(e.time_range.elapsed_us() for e in ev if key in e.name)
            seen.append((len(ev), t / 1e3))
        if slept > 0 or not any(n for n, _ in seen):
            break
    check(slept > 0 or not any(n for n, _ in seen),
          f"device_ms ({key}): the profiler recorded no sleep kernel")
    most = max(n for n, _ in seen)
    times = sorted(t for n, t in seen if n == most and t)
    return (times[len(times) // 2] if times else None), most


def kernel_group(name: str) -> str:
    """A CUDA kernel's name as the part of the model it serves."""
    for key, group in (("fp_solve_kernel", "zns_fixpoint"),
                       ("fp_stack_kernel", "zns_fixpoint_sharded"),
                       ("scan_tiles_kernel", "zns_event_scan"),
                       ("flash_fwd", "flash_attention"),
                       ("bwd_dkdv", "flash_attention_bwd"),
                       ("bwd_dq", "flash_attention_bwd"),
                       ("bwd_delta", "flash_attention_bwd"),
                       ("rmsnorm_bwd", "rmsnorm_bwd"),
                       ("rmsnorm_dw", "rmsnorm_bwd"),
                       ("rmsnorm", "rmsnorm"),
                       ("ssd_chunk_scan", "ssd_chunk_scan"),
                       ("ssd_mma", "ssd_chunk_scan"),
                       ("linear_recurrence", "linear_recurrence"),
                       ("nvjet", "matmul"),
                       ("gemm", "matmul"), ("gemv", "matmul"),
                       ("xmma", "matmul"), ("cutlass", "matmul"),
                       ("copy_kernel", "copy/cast"), ("Memcpy", "copy/cast"),
                       ("softmax", "softmax"), ("reduce", "reduce"),
                       # sorts, bincount, cumsum, index, gather, scatter:
                       # the MoE dispatch, embedding lookups, cache writes
                       ("Sort", "sort/index/scatter"),
                       ("sort", "sort/index/scatter"),
                       ("Histogram", "sort/index/scatter"),
                       ("DeviceScan", "sort/index/scatter"),
                       ("index", "sort/index/scatter"),
                       ("gather", "sort/index/scatter"),
                       ("scatter", "sort/index/scatter")):
        if key in name:
            return group
    return "other elementwise"


def device_breakdown(fn):
    """Run ``fn()`` once under ``torch.profiler``; returns (wall ms, kernel
    ms, device events, [(group, ms), ...] largest first, {group: device
    events}) from the CUDA kernel events, or None when the profiler
    records no device time.  The wall time includes the profiler's own
    overhead."""
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
    groups, counts = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            g = kernel_group(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
            counts[g] = counts.get(g, 0) + 1
    if not groups:
        return None
    return (wall, sum(groups.values()), sum(counts.values()),
            sorted(groups.items(), key=lambda kv: -kv[1]), counts)


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
    from repro_torch.core import shard as pshard
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
    ptxas = {}
    for name, path in libs.items():
        log = (path.parent / "build.log").read_text()
        ptxas[name] = ptxas_lines(log)
        for kern, regs, spill in ptxas[name]:
            print(f"[1]   {name}: {kern}: {regs} registers; {spill}")
            if kern.startswith(NO_SPILL):
                check(re.search(r"\b0 bytes spill stores, 0 bytes spill "
                                r"loads", spill) is not None,
                      f"{name}: {kern} spills: {spill}")
        serial = [line for line in log.splitlines() if "C7518" in line]
        check(not serial, f"{name}: ptxas serialised wgmma (C7518): "
                          + " | ".join(serial))

    counters = {
        "zns_event_scan": kscan.zns_event_scan,
        "zns_event_scan_batched": kscan.zns_event_scan_batched,
        "zns_fixpoint": kfix.zns_fixpoint,
        "zns_fixpoint_sharded": kfix.zns_fixpoint_sharded,
        "flash_attention": kfa.flash_attention,
        "flash_attention_bwd": kfa.flash_attention_bwd,
        "rmsnorm": krms.rmsnorm,
        "rmsnorm_bwd": krms.rmsnorm_bwd,
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

    # -- phase 2, the stacked fixpoint: every shard of a plan in one launch --
    def stack_inputs(prog, svcp, plan, packed, dtype):
        """The flat (total,) init and service vectors of a plan's shards,
        every shard's dead slot the sentinel / 0 (as the mesh executor
        builds them)."""
        init = np.full(packed.total, -np.inf)
        sv = np.zeros(packed.total)
        for sh, b in zip(plan.shards, packed.base):
            init[b:b + len(sh.perm)] = (prog.issue_flat[sh.perm]
                                        + svcp[sh.perm])
            sv[b:b + len(sh.perm)] = svcp[sh.perm]
        return (torch.as_tensor(init, dtype=dtype, device=cuda),
                torch.as_tensor(sv, dtype=dtype, device=cuda))

    for label, prog, svcp, budget in (("phase-13", prog13, svc13, 8),
                                      ("phase-5", prog5, svc5, 64)):
        plan = pshard.shard_program(prog)
        packed = kfix.pack_shards(
            [([b.rows_view() for b in sh.program.families],
              sh.program.n_flat, P.block_adjacency(sh.program))
             for sh in plan.shards], cuda)
        print(f"[2] {label} signature plan: {plan.n_shards} shards, events "
              f"{[sh.n_events for sh in plan.shards]}, blocks "
              f"{[len(sh.program.families) for sh in plan.shards]}, "
              f"{packed.tiles(2048)} tiles in the widest "
              f"slot")
        for dtype in (torch.float32, torch.float64):
            c0, sv = stack_inputs(prog, svcp, plan, packed, dtype)

            def stacked(impl, c0=c0, sv=sv, packed=packed, budget=budget):
                return ops.zns_fixpoint_sharded(c0, sv, packed,
                                                sweeps=budget, impl=impl)

            got = stacked("cuda")
            launch = dict(kfix.zns_fixpoint_sharded.last_launch)
            want = stacked("torch")
            tol = F64 if dtype == torch.float64 else F32
            err, lanes = 0.0, 0
            for k, (sh, b) in enumerate(zip(plan.shards, packed.base)):
                n = len(sh.perm)
                log = []
                kfix.zns_fixpoint_torch(c0[b:b + n], sv[b:b + n],
                                        packed.shard(k), sweeps=budget,
                                        active_log=log)
                lanes += sum(packed.shapes[k][f][1] * packed.shapes[k][f][2]
                             for sweep in log for f in sweep)
                one = ops.zns_fixpoint(c0[b:b + n], sv[b:b + n],
                                       packed.shard(k), sweeps=budget,
                                       impl="cuda")
                for other, what in ((want[0][b:b + n], "plain version"),
                                    (one[0], "single-program kernel")):
                    err = max(err, close(
                        got[0][b:b + n].cpu().numpy(), other.cpu().numpy(),
                        tol, f"zns_fixpoint_sharded {label} {dtype} shard "
                             f"{k} against the {what}"))
                check(bool(got[2][k]) == bool(want[2][k]) == one[2]
                      and one[2],
                      f"zns_fixpoint_sharded {label} {dtype} shard {k}: "
                      f"converged {got[2][k]}, plain {want[2][k]}, single "
                      f"{one[2]}")
                if dtype == torch.float64:
                    check(got[1][k] == want[1][k] == one[1],
                          f"zns_fixpoint_sharded {label} float64 shard {k}: "
                          f"sweeps {got[1][k]}, plain {want[1][k]}, single "
                          f"{one[1]}")
            ms = time_ms(lambda: stacked("cuda"), flush=flush)
            kms, nk = device_ms(lambda: stacked("cuda"), "fp_stack_kernel")
            check(nk == 1, f"zns_fixpoint_sharded {label}: {nk} device "
                           f"kernels a solve")
            pms = time_ms(lambda: stacked("torch"), reps=3, flush=flush)
            # the yardstick: the single-program kernel on the whole program
            w0 = torch.as_tensor(prog.issue_flat + svcp, dtype=dtype,
                                 device=cuda)
            w1 = torch.as_tensor(svcp, dtype=dtype, device=cuda)
            whole = kfix.pack_blocks([blk.rows_view()
                                      for blk in prog.families],
                                     prog.n_flat, cuda)
            sms = time_ms(lambda: ops.zns_fixpoint(w0, w1, whole,
                                                   sweeps=budget,
                                                   impl="cuda"),
                          flush=flush)
            skms, _ = device_ms(lambda: ops.zns_fixpoint(
                w0, w1, whole, sweeps=budget, impl="cuda"),
                "fp_solve_kernel")
            print(f"[2] zns_fixpoint_sharded {label} {dtype}: {plan.n_shards} "
                  f"shards in one launch, sweeps {got[1].tolist()} (plain "
                  f"{want[1].tolist()}), all converged, lanes {lanes}, max "
                  f"abs err {err:.3e} (plain and single kernel shard by "
                  f"shard), kernel {ms:.4f} ms (device {kms} ms, {nk} device "
                  f"kernel a solve; grid {launch['grid']} of "
                  f"{launch['resident_blocks']} resident blocks, "
                  f"{launch['registers']} registers), plain {pms:.4f} ms; "
                  f"the single-program kernel on the whole program "
                  f"{sms:.4f} ms (device {skms} ms)")
            if dtype != torch.float64:
                continue
            b, by = bound_ms(29.0 * lanes, 4.0 * lanes, "float64")
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                       bound_by=by, library_ms=None, kernel_ms=kms,
                       kernels_per_solve=nk, single_ms=sms,
                       single_kernel_ms=skms, sweeps=got[1].tolist(), budget=budget, lanes=lanes,
                       dtype="float64", **launch)
            if label == "phase-13":
                report["zns_fixpoint_sharded"] = row
            else:
                report["zns_fixpoint_sharded"][label] = row

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
            ("d256", (2, 16, 1, 3072, 3072, 256), 2048),
            ("moe", (2, 16, 16, 1024, 1024, 128), None)):
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
            if case == "moe" and dname == "bfloat16":
                moe_attn = row       # qwen2-moe-a2.7b's prefill (MHA)
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


    # -- phase 2, the backward kernels: attention and RMSNorm ---------------
    def bwd_close(got, want, dname, what):
        rtol, frac = BWD_TOL[dname]
        scale = float(want.float().abs().max())
        return close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                     dict(rtol=rtol, atol=frac * scale), what)

    fwd_ms = {}
    for case, (b, hq, hkv, tq, tk, d) in (
            ("tinyllama", (4, 32, 4, 2048, 2048, 64)),
            ("qwen3", (1, 32, 8, 2048, 2048, 128))):
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            q = randn((b, hq, tq, d), dtype)
            k = randn((b, hkv, tk, d), dtype)
            v = randn((b, hkv, tk, d), dtype)
            do = randn((b, hq, tq, d), dtype)
            out, lse = kfa.flash_attention(q, k, v, return_lse=True)
            check(torch.equal(out, kfa.flash_attention(q, k, v)),
                  f"flash_attention {case} {dname}: the output with lse "
                  f"differs from the one without")
            got = kfa.flash_attention_bwd(q, k, v, out, do, lse)
            want = kfa.attention_bwd_torch(q, k, v, out, do, lse)
            torch.cuda.synchronize()
            err = max(bwd_close(g, w, dname, f"flash_attention_bwd {case} "
                                             f"{dname} d{n}")
                      for g, w, n in zip(got, want, "qkv"))
            again = kfa.flash_attention_bwd(q, k, v, out, do, lse)
            check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
                  f"flash_attention_bwd {case} {dname}: two runs differ")
            ms = time_ms(lambda: kfa.flash_attention_bwd(q, k, v, out, do,
                                                         lse), flush=flush)
            pms = time_ms(lambda: kfa.attention_bwd_torch(q, k, v, out, do,
                                                          lse),
                          reps=3, flush=flush)
            # the library: SDPA's backward through autograd
            ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
            lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                enable_gqa=True)
            lms = time_ms(lambda: torch.autograd.grad(
                lo, (ql, kl, vl), do, retain_graph=True), flush=flush)
            lib_err = max(float((a.float() - g.float()).abs().max())
                          for a, g in zip(torch.autograd.grad(
                              lo, (ql, kl, vl), do), got))
            if dname == "bfloat16" and case == "qwen3":
                fwd_ms = dict(
                    plain=time_ms(lambda: kfa.flash_attention(q, k, v),
                                  flush=flush),
                    lse=time_ms(lambda: kfa.flash_attention(
                        q, k, v, return_lse=True), flush=flush))
            pairs = int(kref.attention_mask(tq, tk, True, None,
                                            cuda).sum())
            flop = 2.5 * 4.0 * b * hq * d * pairs
            nbytes = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
                      + 4.0 * lse.numel())
            bnd, by = bound_ms(nbytes, flop, dname)
            print(f"[2] flash_attention_bwd {case} q {tuple(q.shape)} k "
                  f"{tuple(k.shape)} causal {dname}: max abs err {err:.3e} "
                  f"(SDPA's gradients {lib_err:.3e} from the kernel's), two "
                  f"runs bit-equal, kernel {ms:.4f} ms ({flop / ms / 1e9:.1f}"
                  f" TFLOP/s, {ms / lms:.2f}x SDPA's backward), plain "
                  f"{pms:.4f} ms, library {lms:.4f} ms, bound {bnd:.4f} ms "
                  f"({by})")
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd,
                       bound_by=by, library_ms=lms, library_err=lib_err,
                       tflops=flop / ms / 1e9, vs_library=ms / lms,
                       shape=[list(q.shape), list(k.shape)], dtype=dname)
            if dname == "bfloat16" and case == "tinyllama":
                report["flash_attention_bwd"] = row
            elif dname == "bfloat16":
                qwen3_bwd = row
            del q, k, v, do, out, lse, got, want, again, ql, kl, vl, lo
    report["flash_attention_bwd"]["qwen3"] = qwen3_bwd
    print(f"[2] flash_attention forward at qwen3's prefill, bfloat16: "
          f"without lse {fwd_ms['plain']:.4f} ms (PR 19: "
          f"{ATTN_FWD_PR19_MS} ms), with lse {fwd_ms['lse']:.4f} ms")

    for rows, d in ((8192, 2048), (4 * 2048 * 32, 128)):
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            x = randn((rows, d), dtype)
            dy = randn((rows, d), dtype)
            w = randn((d,), torch.float32, 0.1)
            dx, dw = krms.rmsnorm_bwd(x, w, dy)
            dx_p, dw_p = krms.rmsnorm_bwd_torch(x, w, dy)
            torch.cuda.synchronize()
            err = bwd_close(dx, dx_p, dname, f"rmsnorm_bwd ({rows}, {d}) "
                                             f"{dname} dx")
            err_w = close(dw.cpu().numpy(), dw_p.cpu().numpy(),
                          dict(rtol=1e-3, atol=1e-4 * rows ** 0.5),
                          f"rmsnorm_bwd ({rows}, {d}) {dname} dw")
            again = krms.rmsnorm_bwd(x, w, dy)
            check(torch.equal(again[0], dx) and torch.equal(again[1], dw),
                  f"rmsnorm_bwd ({rows}, {d}) {dname}: two runs differ")
            ms = time_ms(lambda: krms.rmsnorm_bwd(x, w, dy), flush=flush)
            dms, nk = device_ms(lambda: krms.rmsnorm_bwd(x, w, dy),
                                "rmsnorm", reps=9)
            check(nk <= 2, f"rmsnorm_bwd ({rows}, {d}) {dname}: {nk} device "
                           f"kernels a call, want 2 (the rows, then the dw "
                           f"sum)")
            if nk < 2:    # the profiler dropped a kernel in every window
                dms = None
            pms = time_ms(lambda: krms.rmsnorm_bwd_torch(x, w, dy), reps=3,
                          flush=flush)
            xl = x.detach().requires_grad_(True)
            wl = (1.0 + w).to(dtype).requires_grad_(True)
            lo = F.rms_norm(xl, (d,), weight=wl, eps=1e-6)
            lms = time_ms(lambda: torch.autograd.grad(
                lo, (xl, wl), dy, retain_graph=True), flush=flush)
            nbytes = 3.0 * x.numel() * x.element_size() + 8 * d
            bnd, by = bound_ms(nbytes, 8.0 * x.numel(), dname)
            dtxt = (f"{dms:.4f} ms ({bnd / dms:.0%} of the bound)"
                    if dms is not None else "not measured")
            print(f"[2] rmsnorm_bwd ({rows}, {d}) {dname}: max abs err dx "
                  f"{err:.3e}, dw {err_w:.3e}, two runs bit-equal, kernel "
                  f"{ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                  f"{bnd / ms:.0%} of the bound; device time {dtxt}, {nk} "
                  f"device kernels a call), plain {pms:.4f} ms, library "
                  f"(F.rms_norm's backward) {lms:.4f} ms, bound {bnd:.4f} "
                  f"ms ({by})")
            row = dict(max_abs_err=max(err, err_w), ms=ms, plain_ms=pms,
                       bound_ms=bnd, bound_by=by, library_ms=lms,
                       gbps=nbytes / ms / 1e6, device_ms=dms,
                       device_kernels=nk, bound_share=bnd / ms,
                       shape=[rows, d], dtype=dname)
            if (rows, d) == (8192, 2048) and dname == "bfloat16":
                report["rmsnorm_bwd"] = row
            elif dname == "bfloat16":
                report["rmsnorm_bwd"]["qk_norm"] = row
            del x, dy, dx, dw, dx_p, dw_p, again, xl, wl, lo
    print("[2] rmsnorm_bwd kernels (ptxas -v): " + "; ".join(
        f"{kern} {regs} registers, {spill}" for kern, regs, spill
        in ptxas["rmsnorm"] if kern.startswith(("rmsnorm_bwd",
                                                "rmsnorm_dw"))))

    report["flash_attention"]["d256"] = d256
    report["flash_attention"]["moe"] = moe_attn
    # the bf16 attention kernels run on the tensor cores: count the wgmma
    # of each function
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300)
    hgmma, fn = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            hgmma[fn] = 0
        elif fn is not None and "HGMMA" in line:
            hgmma[fn] += 1
    fwd_hg = {f: n for f, n in hgmma.items()
              if f.startswith("flash_fwd_wgmma")}
    bwd_hg = {f: n for f, n in hgmma.items()
              if f.startswith(("bwd_dkdv_wgmma", "bwd_dq_wgmma"))}
    print(f"[2] flash_attention library: HGMMA (wgmma) instructions by "
          f"function (cuobjdump -sass): forward {fwd_hg}, backward "
          f"{bwd_hg}")
    check(fwd_hg and all(fwd_hg.values()),
          f"flash_attention: a forward function without HGMMA: {fwd_hg}")
    check(len(bwd_hg) == 8 and all(bwd_hg.values()),
          f"flash_attention: a bfloat16 backward function without HGMMA "
          f"(want dK/dV and dQ at 4 head dims): {bwd_hg}")
    report["flash_attention"]["hgmma"] = sum(fwd_hg.values())
    report["flash_attention_bwd"]["hgmma"] = bwd_hg

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
            wall, busy, n, groups, _ = brk
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
        block_errs = blocks(cfg, params, prompt) if blocks else None
        if logits_atol is not None:
            close(got, want, dict(rtol=0.0, atol=logits_atol),
                  f"phase {phase} last logits, kernels vs plain")
        if f32_atol is not None:
            close(got32, want32, dict(rtol=0.0, atol=f32_atol),
                  f"phase {phase} float32 last logits, kernels vs plain")
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
    def attn_half64(cfg, attn, ln, x, pos):
        """x + attention(norm(x)) in float64 from the plain float32 path's
        q, k and v (the float32 block's own accuracy; causal, windowed by
        cfg.window), and the largest |q|, |k|, |v| and |logit|."""
        from repro_torch.models import common as mc
        f64 = torch.float64
        q, k, v = mc.attn_qkv(cfg, attn, mc.rmsnorm(cfg, ln, x), pos)
        bsz, t, hq, dh = q.shape
        rep = hq // k.shape[2]
        core = torch.empty(q.shape, dtype=f64, device=cuda)
        kpos = torch.arange(t, device=cuda)
        top = 0.0
        for b in range(bsz):
            for c0 in range(0, t, 512):
                qc = q[b, c0:c0 + 512].to(f64)                # (c, H, Dh)
                qpos = kpos[c0:c0 + qc.shape[0], None]
                vis = kpos[None] <= qpos
                if cfg.window is not None:
                    vis &= kpos[None] > qpos - cfg.window
                for h in range(hq):
                    kk = k[b, :, h // rep].to(f64)
                    s = ((qc[:, h] @ kk.T) / dh ** 0.5).masked_fill(
                        ~vis, -float("inf"))
                    top = max(top, float(s.abs().masked_fill(~vis, 0).max()))
                    w = torch.softmax(s, -1)
                    core[b, c0:c0 + qc.shape[0], h] = w @ v[b, :, h // rep].to(
                        f64)
        y = x.to(f64) + torch.einsum("bshk,hkd->bsd", core,
                                     attn["wo"].to(f64))
        return y, [float(a.abs().max()) for a in (q, k, v)] + [top]

    def attn_block64(cfg, p, x, pos):
        """recurrentgemma's attention block in float64 (attn_half64, then
        its MLP), and the largest |q|, |k|, |v| and |logit|."""
        f64 = torch.float64
        y, mags = attn_half64(cfg, p["attn"], p["ln"], x, pos)
        z = y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True)
                            + cfg.rms_eps) * (1.0 + p["ln2"].to(f64))
        m = p["mlp"]
        out = y + (torch.nn.functional.silu(z @ m["w_gate"].to(f64))
                   * (z @ m["w_up"].to(f64))) @ m["w_down"].to(f64)
        return out, mags

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
        comp, used, conv = cell.solve("cuda", device=cuda)
        check(cell.program.exact, f"phase 12: {cell.name} is not exact")
        check(conv, f"phase 12: {cell.name} did not converge")
        err = cell.max_rel_err(comp)
        check(err <= cell.tol, f"phase 12: {cell.name} max rel err "
                               f"{err:.3e} over rtol {cell.tol}")
        worst = max(worst, err)
    torch.cuda.synchronize()
    read_counts("12", ["zns_fixpoint"])
    print(f"[12] exactness matrix: {len(cells)} cells (scale "
          f"{exactness.SCALE}) on the cuda driver (the sharded ones on the "
          f"mesh executor), all exact and converged, "
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

    # -- phase 14: host scenarios x placement policies on the card -----------
    from repro_torch.host import (HOST_SCENARIO_SPEC, build_scenario,
                                  compare_policies, rank_policies)
    zero_counts()
    t = time.perf_counter()
    rows14 = compare_policies(device=cuda)
    torch.cuda.synchronize()
    run14_ms = (time.perf_counter() - t) * 1e3
    read_counts("14", ["zns_fixpoint"])
    check(phase_counts["14"]["zns_fixpoint"] == 1,
          f"phase 14: {phase_counts['14']['zns_fixpoint']} fixpoint "
          f"launches for one fleet call")
    sstats14 = P.last_solve_stats()
    check(sstats14.driver == "cuda" and sstats14.converged,
          f"phase 14: driver {sstats14.driver}, converged "
          f"{sstats14.converged}")
    ev14 = compare_policies(backend="event", device="cpu")
    check(rank_policies(rows14) == rank_policies(ev14),
          f"phase 14: ranking {rank_policies(rows14)} against the event "
          f"backend's {rank_policies(ev14)}")
    worst14 = 0.0
    for a, b in zip(rows14, ev14):
        check((a["scenario"], a["policy"], a["n_requests"])
              == (b["scenario"], b["policy"], b["n_requests"]),
              f"phase 14: row {a['scenario']}/{a['policy']} against "
              f"{b['scenario']}/{b['policy']}")
        for k, v in a.items():
            if isinstance(v, float):
                rel = abs(v - b[k]) / abs(b[k]) if b[k] else abs(v)
                check(abs(v - b[k]) <= RUNNER_RTOL * abs(b[k]),
                      f"phase 14: {a['scenario']}/{a['policy']} {k} = "
                      f"{v!r}, event backend {b[k]!r}")
                worst14 = max(worst14, rel)
    # the profiler can miss every device event of a window: up to 3 tries
    prof14 = None
    for _ in range(3):
        prof14 = prof14 or device_breakdown(
            lambda: compare_policies(device=cuda))
    gold_err = 0.0
    for scen in ("lsm", "circular-log", "cache"):
        with open(os.path.join(ROOT, "tests", "golden",
                               f"{scen}__greedy-open.json")) as f:
            want = json.load(f)
        trace = build_scenario(scen, policy="greedy-open", seed=0,
                               scale=0.5, device=cuda).workload.build()
        h = hashlib.sha256()
        for field in ("op", "zone", "size", "issue", "thread", "qd",
                      "occupancy", "was_finished", "io_ctx"):
            h.update(np.ascontiguousarray(getattr(trace, field)).tobytes())
        check(len(trace) == want["n_requests"]
              and h.hexdigest() == want["workload_sha256"],
              f"phase 14: golden {scen} workload differs")
        res = P.ZnsDevice(HOST_SCENARIO_SPEC, device=cuda).run(
            trace, backend="vectorized", seed=0, jitter=False)
        gold_err = max(gold_err, close(
            res.sim.complete, want["complete_us"], GOLDEN_TOL,
            f"phase 14: golden {scen} on the card's vectorized backend"))
    print(f"[14] compare_policies: {len(rows14)} combinations, "
          f"{sum(r['n_requests'] for r in rows14)} requests in one fleet "
          f"call on the cuda driver ({sstats14.sweeps} sweeps), "
          f"{run14_ms:.1f} ms; rows within {worst14:.3e} of the host event "
          f"backend, ranking {rank_policies(rows14)}; profiled "
          + ("(no device time recorded)" if prof14 is None else
             f"{prof14[0]:.1f} ms wall, {prof14[1]:.4f} ms of device "
             f"kernels in {prof14[2]} device events ({prof14[3]})")
          + f"; the three greedy-open goldens reproduce on the card "
          f"(max abs err {gold_err:.3e})")
    out14 = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments", "host", "--out",
         os.path.join("build", "host")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=600)
    tail = [line for line in (out14.stdout + out14.stderr).splitlines()
            if line.strip()][-1:]
    check(out14.returncode == 0, f"phase 14: python -m "
          f"repro_torch.experiments host exited with {out14.returncode}: "
          f"{tail}")
    print(f"[14] python -m repro_torch.experiments host: exit 0; "
          f"{' '.join(tail)}")

    # -- phase 15: the sharded and windowed drivers -------------------------
    wl15 = P.WorkloadSpec()
    for k in range(4):
        kw = dict(n=250_000, size=4 * KiB, qd=0, zone=k * 16, nzones=16,
                  arrival=P.PoissonArrivals(rate_per_s=2e5, seed=k))
        wl15 = wl15.writes(**kw) if k % 2 == 0 else wl15.reads(**kw)
    t = time.perf_counter()
    prog15 = P.compile_fleet_program([wl15.build()], [dev.spec], [dev.lat],
                                     cache=False)
    svc15 = prog15.svc0_flat
    lower15_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    wp15 = pshard.window_program(prog15, window_events=WINDOW_EVENTS)
    window15_ms = (time.perf_counter() - t) * 1e3
    check(wp15.n_windows == 8, f"phase 15: {wp15.n_windows} windows")
    zero_counts()
    sharded15 = {label: P.solve_program(prog, svcp, sweeps=budget,
                                        fixpoint="sharded", device=cuda)
                 for label, prog, svcp, budget in (
                     ("phase-13", prog13, svc13, 8),
                     ("phase-5", prog5, svc5, 64))}
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    win15 = pshard.solve_program_windowed(prog15, svc15, sweeps=64,
                                          window_events=WINDOW_EVENTS,
                                          device=cuda)
    torch.cuda.synchronize()
    win15_ms = (time.perf_counter() - t) * 1e3
    win15_mem = torch.cuda.max_memory_allocated() - base_mem
    read_counts("15", ["zns_fixpoint", "zns_fixpoint_sharded"])
    check(phase_counts["15"]["zns_fixpoint_sharded"] == 2,
          f"phase 15: {phase_counts['15']['zns_fixpoint_sharded']} stacked "
          f"launches for two sharded solves")
    check(phase_counts["15"]["zns_fixpoint"] == 8,
          f"phase 15: {phase_counts['15']['zns_fixpoint']} fixpoint "
          f"launches for 8 windows")
    check(win15[2], "phase 15: the windowed solve did not converge")
    for label, prog, svcp, budget in (("phase-13", prog13, svc13, 8),
                                      ("phase-5", prog5, svc5, 64)):
        got, used, conv = sharded15[label]
        want, wused, wconv = P.solve_program(prog, svcp, sweeps=budget,
                                             fixpoint="cuda", device=cuda)
        check(conv and wconv, f"phase 15: {label} sharded converged {conv}")
        err = close(got, want, dict(rtol=1e-12, atol=0.0),
                    f"phase 15: {label} sharded against cuda")
        ms_s = time_ms(lambda: P.solve_program(
            prog, svcp, sweeps=budget, fixpoint="sharded", device=cuda),
            reps=3)
        ms_c = time_ms(lambda: P.solve_program(
            prog, svcp, sweeps=budget, fixpoint="cuda", device=cuda), reps=3)
        print(f"[15] fixpoint='sharded' on {label}'s program "
              f"({pshard.shard_program(prog).n_shards} shards): sweeps "
              f"{used} (cuda {wused}), max abs err against cuda {err:.3e}; "
              f"solve {ms_s:.4f} ms, cuda {ms_c:.4f} ms")
        report["zns_fixpoint_sharded"].setdefault("solve", {})[label] = dict(
            sharded_ms=ms_s, cuda_ms=ms_c, max_abs_err=err)
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    full15 = P.solve_program(prog15, svc15, sweeps=64, fixpoint="cuda",
                             device=cuda)
    torch.cuda.synchronize()
    full15_ms = (time.perf_counter() - t) * 1e3
    full15_mem = torch.cuda.max_memory_allocated() - base_mem
    check(full15[2], "phase 15: the unwindowed solve did not converge")
    err15 = close(win15[0], full15[0], dict(rtol=1e-12, atol=0.0),
                  "phase 15: windowed against the unwindowed cuda solve")
    # the entry is one signature group: a 1-shard plan, which the sharded
    # driver solves with one launch of the single-program kernel (after
    # the unwindowed first call, so that it does not warm that one's
    # caches)
    before = kfix.zns_fixpoint.launches
    one15 = P.solve_program(prog15, svc15, sweeps=64, fixpoint="sharded",
                            device=cuda)
    check(kfix.zns_fixpoint.launches == before + 1,
          f"phase 15: {kfix.zns_fixpoint.launches - before} single-program "
          f"launches for the 1-shard sharded solve")
    check(one15[2] and one15[1] == full15[1],
          f"phase 15: the 1-shard sharded solve took {one15[1]} sweeps "
          f"(cuda {full15[1]}), converged {one15[2]}")
    err_one = close(one15[0], full15[0], dict(rtol=1e-12, atol=0.0),
                    "phase 15: the 1-shard sharded solve against cuda")
    print(f"[15] fixpoint='sharded' on the open-loop entry (1 shard): one "
          f"single-program launch, max abs err against cuda {err_one:.3e}")
    warm_win = time_ms(lambda: pshard.solve_program_windowed(
        prog15, svc15, sweeps=64, window_events=WINDOW_EVENTS, device=cuda),
        reps=3)
    warm_full = time_ms(lambda: P.solve_program(
        prog15, svc15, sweeps=64, fixpoint="cuda", device=cuda), reps=3)
    print(f"[15] windowed open-loop entry: {prog15.n_flat} requests, blocks "
          f"{[b.shape for b in prog15.families]}, lowering "
          f"{lower15_ms:.1f} ms, windowing {window15_ms:.1f} ms, "
          f"{wp15.n_windows} windows of {[len(w.perm) for w in wp15.windows]} "
          f"events, sweeps {win15[1]} (unwindowed {full15[1]}), max abs err "
          f"against the unwindowed cuda solve {err15:.3e}; first call "
          f"{win15_ms:.1f} ms and {win15_mem / 1e6:.1f} MB of peak device "
          f"memory (unwindowed {full15_ms:.1f} ms, {full15_mem / 1e6:.1f} "
          f"MB); warm {warm_win:.3f} ms (unwindowed {warm_full:.3f} ms)")
    report["zns_fixpoint"]["windowed"] = dict(
        requests=prog15.n_flat, windows=wp15.n_windows,
        first_ms=win15_ms, peak_bytes=win15_mem, warm_ms=warm_win,
        full_first_ms=full15_ms, full_peak_bytes=full15_mem,
        full_warm_ms=warm_full, max_abs_err=err15)

    # -- phase 16: qwen2-moe-a2.7b at full width and depth --------------------
    from repro_torch.models import common as mc
    from repro_torch.models import moe as mmoe

    def routes_of(cfg, params, prompt, max_seq):
        """Every layer's (T, k) expert choices in one prefill."""
        for layer in params.layers:
            layer.routing = []
        M.prefill(cfg, params, prompt, max_seq)
        out = [layer.routing[0].expert_idx for layer in params.layers]
        for layer in params.layers:
            layer.routing = None
        return out

    def rerouted(a, b, n_experts):
        """Per layer, the (token, expert) choices of ``a`` that ``b`` does
        not make."""
        out = []
        for x, y in zip(a, b):
            ox = torch.zeros(x.shape[0], n_experts, device=cuda).scatter_(
                1, x, 1.0)
            oy = torch.zeros(y.shape[0], n_experts, device=cuda).scatter_(
                1, y, 1.0)
            out.append(int((ox * (1 - oy)).sum()))
        return out

    def moe_reference(cfg, p, hn):
        """One layer's routed experts and shared expert in float32, expert
        by expert on its own tokens (no sort, no buffer): the top k of the
        router's probabilities, renormalised, and each expert's first
        ``capacity`` picks in token order kept (the reference's drops)."""
        t, d = hn.shape[0] * hn.shape[1], hn.shape[-1]
        x = hn.reshape(t, d).float()
        probs = torch.softmax(x @ p["router"].float(), -1)
        gate, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True)
        cap = mmoe._capacity(cfg, t)
        y = torch.zeros(t, d, device=cuda)
        for e in range(cfg.moe_num_experts):
            tok, j = torch.nonzero(idx == e, as_tuple=True)
            tok, j = tok[:cap], j[:cap]
            h = x[tok]
            out = (F.silu(h @ p["w_gate"][e].float())
                   * (h @ p["w_up"][e].float())) @ p["w_down"][e].float()
            y.index_add_(0, tok, out * gate[tok, j, None])
        sh = p["shared"]
        y += (F.silu(x @ sh["w_gate"].float()) * (x @ sh["w_up"].float())) \
            @ sh["w_down"].float()
        return y.reshape(hn.shape)

    def moe_layers(cfg, params, prompt):
        """The routing of the whole prefill with the kernels against the
        plain versions (choices that differ, layer by layer, in bfloat16
        and in float32), then the first MOE_LAYERS layers one by one, each
        given the bfloat16 plain chain's input.  The attention half
        (x + attention(norm(x))), as phase 10's attention block: the
        random init's logits reach the hundreds (no q/k-norm), so a
        near-tied softmax moves it past BF16_BLOCK_TOL for any two
        implementations; it is held in float32 against the float64 half,
        within the tolerance plus the plain versions' own largest error
        (its kernels-vs-plain differences are printed).  The FFN half's
        norm at BF16_BLOCK_TOL (its outputs reach several units, where one
        bfloat16 step exceeds the RMSNorm test's atol); the MoE block (routed
        experts and shared expert) on the plain norm's output against a
        float32 expert-by-expert computation at BF16_BLOCK_TOL; and the
        MoE block on each run's own norm output, kernels against plain, at
        BF16_BLOCK_TOL on every token that both route alike (a token whose
        norm output rounds otherwise may pick another expert: those are
        counted)."""
        plain = dataclasses.replace(cfg, kernel_impl="torch")
        f32 = dataclasses.replace(cfg, dtype="float32")
        f32_plain = dataclasses.replace(f32, kernel_impl="torch")
        n_exp, k = cfg.moe_num_experts, cfg.moe_top_k
        max_seq = 2 * prompt.shape[1]
        bf = rerouted(routes_of(cfg, params, prompt, max_seq),
                      routes_of(plain, params, prompt, max_seq), n_exp)
        fl = rerouted(routes_of(f32, params, prompt, max_seq),
                      routes_of(f32_plain, params, prompt, max_seq), n_exp)
        print(f"[16] routing, kernels vs plain: of the {prompt.numel() * k} "
              f"(token, expert) choices of each layer of the prefill, "
              f"{sum(bf)} differ in all in bfloat16 (by layer {bf}) and "
              f"{sum(fl)} in float32 ({fl})")
        tol = BF16_BLOCK_TOL
        errs = dict(flips_bf16=bf, flips_f32=fl, layers=[])
        with torch.inference_mode():
            x = mc.embed_tokens(cfg, params.embed, prompt,
                                mc.torch_dtype(cfg.dtype))
            pos = torch.arange(prompt.shape[1], dtype=torch.int32,
                               device=cuda).expand(*prompt.shape)
            for i in range(MOE_LAYERS):
                layer = params.layers[i]

                def attn_half(c, y):
                    return y + mc.attention(c, layer.attn, mc.rmsnorm(
                        c, layer.ln1, y), pos)

                got, want = (attn_half(c, x.float()) for c in (f32, f32_plain))
                exact, mags = attn_half64(f32_plain, layer.attn, layer.ln1,
                                          x.float(), pos)
                e_plain = float((want.double() - exact).abs().max())
                e_kern = float((got.double() - exact).abs().max())
                excess = float(((got.double() - exact).abs() - tol["atol"]
                                - tol["rtol"] * exact.abs()).max()) - e_plain
                check(excess <= 0, f"phase 16 layer {i}: the kernels' float32 "
                                   f"attention half is {excess:.3e} farther "
                                   f"from the float64 one than the plain "
                                   f"versions' error and {tol} allow")
                e_attn = float((got - want).abs().max())
                want = attn_half(plain, x)
                e_bf16 = float((attn_half(cfg, x) - want).abs().max())
                hk, hp = (mc.rmsnorm(c, layer.ln2, want) for c in (cfg, plain))
                e_norm = close(hk.float().cpu().numpy(),
                               hp.float().cpu().numpy(), tol,
                               f"phase 16 layer {i} FFN norm, kernels vs "
                               f"plain")
                layer.routing = []
                yk, _ = layer.ffn(cfg, hk)
                yp, _ = layer.ffn(plain, hp)
                rk, rp = layer.routing
                layer.routing = None
                ref = moe_reference(cfg, layer.moe, hp)
                e_ref = close(yp.float().cpu().numpy(), ref.cpu().numpy(), tol,
                              f"phase 16 layer {i} MoE block against the "
                              f"float32 expert-by-expert computation")
                same = (torch.sort(rk.expert_idx, -1).values
                        == torch.sort(rp.expert_idx, -1).values).all(-1)
                e_moe = close(yk.reshape(-1, yk.shape[-1])[same].float().cpu()
                              .numpy(),
                              yp.reshape(-1, yp.shape[-1])[same].float().cpu()
                              .numpy(), tol,
                              f"phase 16 layer {i} MoE block, kernels vs "
                              f"plain, on the tokens routed alike")
                drops = int((~rp.valid).sum())
                print(f"[16] layer {i} from the plain chain's input: "
                      f"attention half in float32 against the float64 one: "
                      f"kernels {e_kern:.3e}, plain {e_plain:.3e} (excess "
                      f"over the plain error and {tol}: {excess:.3e}); "
                      f"kernels vs plain "
                      f"{e_attn:.3e} (float32), {e_bf16:.3e} (bfloat16; max "
                      f"|q|, |k|, |v|, |logit| "
                      f"{[round(a, 1) for a in mags]}); FFN "
                      f"norm {e_norm:.3e}; MoE block against the float32 "
                      f"expert-by-expert computation {e_ref:.3e} (capacity "
                      f"{rp.cap}, {drops} of {rp.valid.numel()} picks "
                      f"dropped); kernels vs plain {e_moe:.3e} on "
                      f"{int(same.sum())}/{same.numel()} tokens routed alike "
                      f"({int((~same).sum())} rerouted by the norm's "
                      f"rounding; {tol})")
                errs["layers"].append(dict(attn=e_attn, attn_bf16=e_bf16,
                                           attn_excess=excess, norm=e_norm,
                                           moe_vs_f32=e_ref, moe=e_moe,
                                           rerouted=int((~same).sum()),
                                           drops=drops))
                x = want + yp
        return errs

    res16 = generation_phase("16", "qwen2-moe-a2.7b", 2, 1024, 2048,
                             ["flash_attention", "rmsnorm"], None, None,
                             blocks=moe_layers)
    # The whole model's last logits are not held (logits_atol and f32_atol
    # None above): routing is discrete, and one choice that differs (4 of
    # 8,192 at the first layer in bfloat16) reroutes later tokens layer
    # after layer, in float32 too.  The first layers are held one by one in
    # moe_layers, and the bfloat16 attention kernel at this model's shape
    # on random inputs in phase 2 ("moe").
    flips16 = res16["block_errs"]
    print(f"[16] whole-model last logits kernels vs plain "
          f"{res16['logits_err']:.3e} (bfloat16), {res16['f32_err']:.3e} "
          f"(float32), not held; (token, expert) choices that differ "
          f"{sum(flips16['flips_bf16'])} / {sum(flips16['flips_f32'])}")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    stats = lserve.main(["--arch", "qwen2-moe-a2.7b", "--requests", "16",
                         "--batch", "4", "--max-seq", "128", "--max-new",
                         "32", "--seed", "0"])
    torch.cuda.synchronize()
    read_counts("16 serve", ["rmsnorm"])
    check(stats["done"] == 16, f"phase 16: {stats['done']}/16 requests")
    print(f"[16] serve driver on qwen2-moe-a2.7b: {stats['done']} requests, "
          f"{stats['steps']} decode steps in {stats['seconds']:.2f} s, "
          f"{stats['tok_per_s']:.1f} tok/s (batch 4), "
          f"{stats['seconds'] / stats['steps'] * 1e3:.2f} ms/step, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()

    # -- phase 17: the ZNS checkpoint store ---------------------------------
    from repro_torch.core import MiB
    from repro_torch.core.calibration import PEAK_WRITE_BW_MIBS
    from repro_torch.runtime import ZnsHostDevice, ZonedCheckpointStore
    from repro_torch.utils import tree_bytes, tree_leaves
    shard17 = 4 * 1024 * MiB
    zero_counts()
    for name, kw in (("R2: 1 MiB appends @ QD4", dict(stripe_bytes=1 * MiB,
                                                      append_qd=4)),
                     ("4 KiB appends @ QD1", dict(stripe_bytes=4 * KiB,
                                                   append_qd=1)),
                     ("64 KiB appends @ QD4", dict(stripe_bytes=64 * KiB,
                                                    append_qd=4)),
                     ("4 MiB appends @ QD4", dict(stripe_bytes=4 * MiB,
                                                   append_qd=4))):
        before = kscan.zns_event_scan.launches
        t = time.perf_counter()
        sec, n = ZnsHostDevice(0, device=cuda, **kw).simulate_payload_write(
            shard17)
        call_ms = (time.perf_counter() - t) * 1e3
        check(kscan.zns_event_scan.launches == before + 1,
              f"phase 17 {name}: {kscan.zns_event_scan.launches - before} "
              f"scan launches")
        sec_cpu, n_cpu = ZnsHostDevice(0, device="cpu",
                                       **kw).simulate_payload_write(shard17)
        rel = abs(sec - sec_cpu) / sec_cpu
        check(n == n_cpu and rel <= STORE_RTOL,
              f"phase 17 {name}: {sec!r} s, {n} appends on the card, "
              f"{sec_cpu!r} s, {n_cpu} on the CPU")
        print(f"[17] {name}, 4 GiB: {n} appends in one scan launch, "
              f"modeled {sec!r} s ({shard17 / sec / MiB:.1f} MiB/s); the "
              f"CPU's {sec_cpu!r} s (rel diff {rel:.3e}); call "
              f"{call_ms:.2f} ms")
    dev17 = ZnsHostDevice(0, device=cuda)
    entries = dev17.plan(shard17)
    dev17.apply_writes(entries)
    full = [e.zone for e in entries if dev17.zm.state(e.zone).name == "FULL"]
    dev17.schedule_reset(full)
    gc17 = dev17.run_gc(concurrent_io=True)
    fill17 = shard17 / (PEAK_WRITE_BW_MIBS * MiB)
    print(f"[17] R5: reset {len(full)} zones under I/O: {gc17 * 1e3:.3f} ms "
          f"({gc17 / fill17:.2%} of the fill time)")
    # the store: mamba2-370m's full-size parameters on 4 hosts
    cfg17 = get_config("mamba2-370m")
    params17 = M.init_params(cfg17, torch.Generator(cuda).manual_seed(0),
                             device=cuda)
    tree17 = params17.param_tree()
    del params17
    root17 = os.path.join(ROOT, "build", "chip_smoke_store")
    shutil.rmtree(root17, ignore_errors=True)
    store17 = ZonedCheckpointStore(os.path.join(root17, "cuda"), n_hosts=4,
                                   device=cuda)
    before = (kscan.zns_event_scan_batched.launches,
              kscan.zns_event_scan.launches)
    t = time.perf_counter()
    saved17 = store17.save(1, tree17)
    save17_s = time.perf_counter() - t
    check((kscan.zns_event_scan_batched.launches,
           kscan.zns_event_scan.launches) == (before[0] + 1, before[1]),
          f"phase 17: save launched the batched scan "
          f"{kscan.zns_event_scan_batched.launches - before[0]} and the "
          f"scan {kscan.zns_event_scan.launches - before[1]} times")
    read_counts("17", ["zns_event_scan", "zns_event_scan_batched"])
    man17 = saved17["manifest"]
    cpu17 = ZonedCheckpointStore(os.path.join(root17, "cpu"), n_hosts=4,
                                 device="cpu").save(1, tree17)["manifest"]
    check(man17["hosts"] == cpu17["hosts"]
          and man17["nleaves"] == cpu17["nleaves"],
          "phase 17: the manifest's hosts (bytes, zones, sha256) differ "
          "from the CPU save's")
    rel17 = max(abs(a - b) / b for a, b in zip(
        man17["modeled_host_seconds"], cpu17["modeled_host_seconds"]))
    check(rel17 <= STORE_RTOL, f"phase 17: modeled seconds "
          f"{man17['modeled_host_seconds']} against the CPU's "
          f"{cpu17['modeled_host_seconds']}")
    t = time.perf_counter()
    restored17, _ = store17.restore(1, tree17)
    restore17_s = time.perf_counter() - t
    for got, want in zip(tree_leaves(restored17), tree_leaves(tree17)):
        check(got.tobytes() == want.cpu().numpy().tobytes(),
              "phase 17: a restored leaf differs from the saved one")
    store17.save(2, tree17)
    gc17_s = store17.gc(keep_last=1)
    check(sorted(os.listdir(store17.root)) == ["step_00000002"]
          and store17.latest_step() == 2,
          f"phase 17: after gc {sorted(os.listdir(store17.root))}")
    shutil.rmtree(root17)
    print(f"[17] ZonedCheckpointStore(n_hosts=4): mamba2-370m, "
          f"{tree_bytes(tree17) / 1e9:.3f} GB in "
          f"{len(tree_leaves(tree17))} leaves; save {save17_s:.2f} s (one "
          f"batched scan launch; {[h['bytes'] for h in man17['hosts'].values()]} "
          f"bytes, {sum(len(h['zones']) for h in man17['hosts'].values())} "
          f"zone extents), modeled wall {saved17['wall_seconds']!r} s, host "
          f"seconds equal to the CPU save's within {rel17:.3e}, manifest "
          f"(bytes, zones, sha256) equal; restore {restore17_s:.2f} s, bit "
          f"for bit; gc(keep_last=1) after a second save: modeled "
          f"{gc17_s * 1e3:.3f} ms of resets")
    del tree17, restored17
    torch.cuda.empty_cache()


    # -- phase 18: training tinyllama-1.1b at full size ----------------------
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import train as ltrain
    from repro_torch.models import common as mc
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    cfg18 = get_config("tinyllama-1.1b")
    L18 = cfg18.num_layers
    runs18 = mc.layer_forward_runs(cfg18, L18)
    # a step's launches: every layer forward (and recompute) runs its two
    # norms and its attention; the final norm runs once; each backward once
    per_step18 = {"rmsnorm": 2 * runs18 + 1, "rmsnorm_bwd": 2 * L18 + 1,
                  "flash_attention": runs18, "flash_attention_bwd": L18}
    # the llama family's initializer_range: the reference's fan-in rule
    # makes tinyllama's gradients ~1e16 at 22 layers, kernels and plain
    # versions alike (launch.train's docstring)
    INIT_STD = 0.02
    train_args = ["--arch", "tinyllama-1.1b", "--batch", "4", "--seq-len",
                  "2048", "--lr", "3e-3", "--warmup", "2", "--log-every",
                  "1", "--init-std", str(INIT_STD)]
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res18 = ltrain.main(train_args + ["--steps", "8", "--seed", "0"])
    torch.cuda.synchronize()
    wall18 = time.perf_counter() - t
    peak18 = torch.cuda.max_memory_allocated() / 1e9
    read_counts("18", list(per_step18))
    got18 = phase_counts["18"]
    for k, v in got18.items():
        want = 8 * per_step18.get(k, 0)
        check(v == want, f"phase 18: {k} launched {v} times in 8 steps, "
                         f"want {want} ({per_step18} a step)")
    losses18 = res18["losses"]
    check(len(losses18) == 8 and bool(np.isfinite(losses18).all()),
          f"phase 18: losses {losses18}")
    check(np.mean(losses18[-2:]) < np.mean(losses18[:2]),
          f"phase 18: the loss did not fall: {losses18}")
    state18 = res18["state"]
    step18 = make_train_step(cfg18, AdamWConfig(lr=3e-3, warmup_steps=2,
                                                total_steps=8))
    data18 = TokenPipeline(DataConfig(cfg18.vocab_size, 2048, 4))
    batch18 = data18.batch_at(8)
    step_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state18, _ = step18(state18, batch18)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    brk = device_breakdown(lambda: step18(state18, batch18))
    check(brk is not None, "phase 18: torch.profiler recorded no device time")
    wall_p, busy, nev, groups, nk18 = brk
    names = dict(groups)
    for g in ("flash_attention", "flash_attention_bwd", "rmsnorm",
              "rmsnorm_bwd"):
        check(names.get(g, 0.0) > 0, f"phase 18: the profiler saw no "
                                     f"{g} kernel in a step")
    tok_s = 4 * 2048 / (min(step_ms) / 1e3)
    attn_share = names["flash_attention_bwd"] / busy
    print(f"[18] tinyllama-1.1b at full size ({M.count_params(cfg18) / 1e9:.3f}"
          f"e9 float32 parameters from seed 0, weights N(0, {INIT_STD}), "
          f"bfloat16 activations, remat full, 4 x 2,048 tokens): 8 steps through launch.train in {wall18:.2f} s, "
          f"losses {[round(x, 4) for x in losses18]}; step "
          f"{min(step_ms):.1f} ms ({step_ms}), {tok_s:.0f} tokens/s, peak "
          f"memory {peak18:.2f} GB; launches a step {per_step18} "
          f"({runs18} layer forwards a step)")
    print(f"[18] one step under torch.profiler: wall {wall_p:.1f} ms, {nev} "
          f"device events, kernels {busy:.1f} ms, device idle "
          f"{max(0.0, 1 - busy / wall_p):.1%}, attention backward "
          f"{attn_share:.1%} of the kernels' time; " + ", ".join(
              f"{g} {ms:.2f} ms" for g, ms in groups)
          + f"; the RMSNorm backward's group {nk18['rmsnorm_bwd']} device "
            f"kernels ({per_step18['rmsnorm_bwd']} calls, two kernels a "
            f"call)")
    report18 = dict(step_ms=min(step_ms), tokens_per_s=tok_s, peak_gb=peak18,
                    losses=losses18, idle=max(0.0, 1 - busy / wall_p),
                    attn_bwd_share=attn_share, groups=groups)
    del res18, state18, step18
    torch.cuda.empty_cache()

    # gradients on the first step: kernels against plain versions, float32,
    # each held against a float64 plain step
    gen18 = torch.Generator(cuda).manual_seed(0)
    base18 = M.init_params(cfg18, gen18, device=cuda, weight_std=INIT_STD)
    tree18 = base18.param_tree()
    first18 = {"tokens": torch.as_tensor(data18.batch_at(0)["tokens"],
                                         device=cuda)}

    def grads18(cfg, tree):
        params = type(base18)(cfg, tree)
        params.requires_grad_(True)
        g = M.bind_grads(cfg, params)
        loss, _ = M.loss_fn(cfg, params, first18)
        loss.backward()
        for p in params.parameters():
            p.grad = None
        return float(loss), g

    def tree_as(tree, dtype):
        return {k: tree_as(v, dtype) if isinstance(v, dict) else v.to(dtype)
                for k, v in tree.items()}

    f32_18 = dataclasses.replace(cfg18, dtype="float32")
    zero_counts()
    l_k, g_k = grads18(f32_18, tree18)
    check(kfa.flash_attention_bwd.launches == L18
          and krms.rmsnorm_bwd.launches == 2 * L18 + 1,
          "phase 18: the float32 kernel step did not run the backward "
          "kernels")
    l_p, g_p = grads18(dataclasses.replace(f32_18, kernel_impl="torch"),
                       tree18)
    check(kfa.flash_attention_bwd.launches == L18,
          "phase 18: the plain step launched a kernel")
    f64_18 = dataclasses.replace(cfg18, dtype="float64",
                                 param_dtype="float64", kernel_impl="torch")
    torch.cuda.reset_peak_memory_stats()
    l_64, g_64 = grads18(f64_18, tree_as(tree18, torch.float64))
    peak64 = torch.cuda.max_memory_allocated() / 1e9
    worst, excess_max = [], -1.0
    paths18 = [p for p, _ in mc.spec_leaves(M.model_spec(cfg18))]
    for path, gk, gp, g64 in zip(paths18, tree_leaves(g_k), tree_leaves(g_p),
                                 tree_leaves(g_64)):
        scale = float(g64.abs().max())
        e_k = float((gk.double() - g64).abs().max())
        e_p = float((gp.double() - g64).abs().max())
        excess = e_k - e_p - GRAD_F64_FRAC * scale
        excess_max = max(excess_max, excess / max(scale, 1e-30))
        worst.append((e_k / max(scale, 1e-30), e_p / max(scale, 1e-30),
                      "/".join(path)))
        check(excess <= 0, f"phase 18: gradient {'/'.join(path)}: the "
                           f"kernels' float32 error to float64 {e_k:.3e} "
                           f"exceeds the plain float32 error {e_p:.3e} plus "
                           f"{GRAD_F64_FRAC} of its scale {scale:.3e}")
    worst.sort(reverse=True)
    print(f"[18] first-step gradients, full width and depth, 4 x 2,048 "
          f"tokens: loss kernels {l_k!r}, plain {l_p!r}, float64 {l_64!r}; "
          f"every leaf's float32 error to the float64 step (relative to "
          f"its largest magnitude) within the plain float32 step's plus "
          f"{GRAD_F64_FRAC}; largest kernels / plain: " + "; ".join(
              f"{p} {a:.2e} / {b:.2e}" for a, b, p in worst[:4])
          + f"; peak of the float64 step {peak64:.2f} GB")
    del g_p, g_64
    torch.cuda.empty_cache()
    l_kb, g_kb = grads18(cfg18, tree18)
    l_pb, g_pb = grads18(dataclasses.replace(cfg18, kernel_impl="torch"),
                         tree18)
    gaps = sorted(((float((a - b).norm() / b.norm().clamp_min(1e-30)),
                    "/".join(p)) for p, a, b in zip(
                        paths18, tree_leaves(g_kb), tree_leaves(g_pb))),
                  reverse=True)
    print(f"[18] bfloat16 first-step gradients, kernels vs plain: loss "
          f"{l_kb!r} vs {l_pb!r}; every leaf's relative gap within "
          f"{BF16_GRAD_REL}; largest " +
          "; ".join(f"{p} {g:.2e}" for g, p in gaps[:4]))
    for g, p in gaps:
        check(np.isfinite(g) and g <= BF16_GRAD_REL,
              f"phase 18: bfloat16 gradient {p}: relative gap {g:.3e} "
              f"between kernels and plain versions exceeds {BF16_GRAD_REL}")
    report18["grad_excess"] = excess_max
    report18["bf16_grad_gap"] = gaps[0][0]
    del g_k, g_kb, g_pb, base18, tree18
    torch.cuda.empty_cache()

    # restart: full width, 2 layers; checkpoint at step 3 into the ZNS
    # store, restore into a fresh state, replay steps 3-5
    root18 = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(root18, ignore_errors=True)
    two = train_args + ["--d-model", "2048", "--d-ff", "5632", "--layers",
                        "2"]
    whole = ltrain.main(two + ["--steps", "6", "--seed", "0"])
    zero_counts()
    first = ltrain.main(two + ["--steps", "3", "--seed", "0", "--ckpt-dir",
                               root18, "--ckpt-every", "3"])
    check(kscan.zns_event_scan_batched.launches == 1
          and kscan.zns_event_scan.launches == 0,
          f"phase 18: the save launched the batched scan "
          f"{kscan.zns_event_scan_batched.launches} and the scan "
          f"{kscan.zns_event_scan.launches} times (want 1 and 0)")
    read_counts("18 restart", ["zns_event_scan_batched",
                               "flash_attention_bwd", "rmsnorm_bwd"])
    resumed = ltrain.main(two + ["--steps", "6", "--seed", "99",
                                 "--ckpt-dir", root18, "--ckpt-every",
                                 "100"])
    check(resumed["steps"] == 3 and resumed["state"].step == 6,
          f"phase 18: the restored run took {resumed['steps']} steps to "
          f"step {resumed['state'].step}")
    equal = [torch.equal(a, b) for a, b in zip(
        tree_leaves(whole["state"].tree()), tree_leaves(
            resumed["state"].tree())) if isinstance(a, torch.Tensor)]
    check(all(equal), f"phase 18: {equal.count(False)} of {len(equal)} "
                      f"leaves of the restored run differ from the "
                      f"uninterrupted run's")
    nbytes18 = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(root18) for f in fs)
    print(f"[18] restart at full width, 2 layers: checkpoint at step 3 "
          f"({nbytes18 / 1e9:.2f} GB on disk, one batched scan launch), "
          f"restored into a fresh state (seed 99), steps 3-5 replayed: "
          f"params, m and v ({len(equal)} leaves) equal the uninterrupted "
          f"run's bit for bit; losses {[round(x, 4) for x in whole['losses']]}"
          f" vs {[round(x, 4) for x in first['losses'] + resumed['losses']]}")
    shutil.rmtree(root18)
    del whole, first, resumed
    torch.cuda.empty_cache()
    report["flash_attention_bwd"]["training"] = report18

    # -- phase 19: the cluster tier on the card ------------------------------
    from repro_torch import cluster as C
    from repro_torch.cluster import capacity as ccap
    from repro_torch.cluster import compiler as ccomp
    # every solve of the tier goes through solve_program (compile_graph's
    # bootstrap, refinements and warm repairs, plan_capacity's fleet
    # solve): count the calls, the time inside them (it returns host
    # arrays, so that time holds the upload, the launch and the copy
    # back), and each solve's family blocks x sweeps
    solves19 = {"n": 0, "s": 0.0, "block_sweeps": 0, "sweeps": []}
    real_solve = ccomp.solve_program

    def counted_solve(*a, **kw):
        t = time.perf_counter()
        try:
            return real_solve(*a, **kw)
        finally:
            st = P.last_solve_stats()
            solves19["n"] += 1
            solves19["s"] += time.perf_counter() - t
            solves19["block_sweeps"] += st.n_blocks * st.sweeps
            solves19["sweeps"].append(st.sweeps)

    def reset_solves19():
        solves19.update(n=0, s=0.0, block_sweeps=0, sweeps=[])
    ccomp.solve_program = ccap.solve_program = counted_solve
    configs19 = [C.ClusterConfig(C.erasure(2, 1), "round-robin"),
                 C.ClusterConfig(C.replication(2, 2), "hashed"),
                 C.ClusterConfig(C.erasure(4, 2), "strided"),
                 C.ClusterConfig(C.erasure(3, 1), "grouped")]
    spec19 = C.ClusterSpec(n_gateways=4, n_servers=16)
    wl19 = C.ClusterWorkload(n_users=8, ops_per_user=6,
                             object_bytes=1 << 20, get_fraction=0.5, seed=0)
    kw19 = dict(base_spec=spec19, workload=wl19, slo_us=10_000.0,
                degraded=True)
    calls19 = {}

    def plan19(name, device, **kw):
        """One plan_capacity call; its wall, solves and solve time."""
        reset_solves19()
        zero_counts()
        t = time.perf_counter()
        out = C.plan_capacity(configs19, [4, 8], device=device, **kw19,
                              **kw)
        wall = time.perf_counter() - t
        sw = sorted(solves19["sweeps"])
        calls19[name] = c = dict(wall_s=wall, solve_s=solves19["s"],
                                 host_s=wall - solves19["s"],
                                 solves=solves19["n"], sweeps=sum(sw),
                                 median_sweeps=sw[len(sw) // 2],
                                 max_sweeps=sw[-1],
                                 block_sweeps=solves19["block_sweeps"])
        if device is cuda:
            read_counts(f"19 {name}", ["zns_fixpoint"])
            got = phase_counts[f"19 {name}"]
            c["launches"] = got["zns_fixpoint"]
            check(got["zns_fixpoint"] == solves19["n"],
                  f"phase 19 {name}: {got['zns_fixpoint']} fixpoint "
                  f"launches for {solves19['n']} solves")
            check(sum(v for k, v in got.items() if k != "zns_fixpoint")
                  == 0, f"phase 19 {name}: other kernels launched: {got}")
            check(P.last_solve_stats().driver == "cuda",
                  f"phase 19 {name}: driver {P.last_solve_stats().driver}")
        print(f"[19] {name}: {out.n_programs} programs, {out.n_events} "
              f"events, fleet solve {out.sweeps_used} sweeps; wall "
              f"{wall:.3f} s = host {c['host_s']:.3f} s + "
              f"{c['solves']} solve_program calls {c['solve_s']:.3f} s"
              + (f", {c['launches']} fixpoint launches"
                 if "launches" in c else "") + f" (device={device}); "
              f"{c['sweeps']} sweeps in all (median {c['median_sweeps']}, "
              f"most {c['max_sweeps']} a solve), {c['block_sweeps']} "
              f"family blocks x sweeps")
        check(out.converged and all(p.converged for cv in out.curves
                                    for p in cv.points),
              f"phase 19 {name}: not converged")
        check(out.order_unstable == (),
              f"phase 19 {name}: order-unstable {out.order_unstable}")
        check(all(e.program.order_stable and e.converged
                  for e in out.compiled),
              f"phase 19 {name}: an entry is not order-stable")
        return out

    def same_entries19(got, want, what):
        """Programs, families and pop orders exactly; completions (each
        entry's and the fleet solve's) to rtol 1e-12."""
        check(len(got.compiled) == len(want.compiled),
              f"phase 19 {what}: {len(got.compiled)} entries against "
              f"{len(want.compiled)}")
        for i, (g, w) in enumerate(zip(got.compiled, want.compiled)):
            gp, wp = g.program, w.program
            check((gp.n_flat, gp.refine_used, gp.order_stable)
                  == (wp.n_flat, wp.refine_used, wp.order_stable)
                  and len(gp.families) == len(wp.families)
                  and all(a.label == b.label
                          and np.array_equal(a.gidx, b.gidx)
                          and np.array_equal(a.heads, b.heads)
                          for a, b in zip(gp.families, wp.families)),
                  f"phase 19 {what}: entry {i}'s program differs")
            check(len(g.fifo_chains) == len(w.fifo_chains)
                  and all(len(a) == len(b) and all(
                      np.array_equal(x, y) for x, y in zip(a, b))
                      for a, b in zip(g.fifo_chains, w.fifo_chains)),
                  f"phase 19 {what}: entry {i}'s FIFO pop orders differ")
            close(g.comp, w.comp, dict(rtol=1e-12, atol=0.0),
                  f"phase 19 {what}: entry {i}'s completions")
        return close(got.comp, want.comp, dict(rtol=1e-12, atol=0.0),
                     f"phase 19 {what}: fleet completions")

    def same_curves19(got, want, what):
        """Equal reports (warm telemetry aside): floats to rtol 1e-12,
        the rest exactly; returns the largest relative difference."""
        a, b = got.to_json(), want.to_json()
        for k in ("warm_hits", "warm_attempts"):
            a.pop(k), b.pop(k)
        worst = [0.0]

        def walk(x, y, path):
            if isinstance(y, dict):
                check(set(x) == set(y), f"phase 19 {what}: {path} keys")
                for k in y:
                    walk(x[k], y[k], f"{path}.{k}")
            elif isinstance(y, list):
                check(len(x) == len(y), f"phase 19 {what}: {path} length")
                for i, (u, v) in enumerate(zip(x, y)):
                    walk(u, v, f"{path}[{i}]")
            elif isinstance(y, float):
                rel = abs(x - y) / abs(y) if y else abs(x)
                check(rel <= 1e-12, f"phase 19 {what}: {path} {x!r} "
                                    f"against {y!r}")
                worst[0] = max(worst[0], rel)
            else:
                check(x == y, f"phase 19 {what}: {path} {x!r} against {y!r}")
        walk(a, b, "report")
        return worst[0]

    t19 = time.perf_counter()
    users19 = plan19("users", cuda)
    # the same call on the CPU with the host float64 loop driver and
    # numpy scans (the reference's driver, and the port's fastest on
    # the CPU)
    users19c = plan19("users cpu", "cpu", fixpoint="loop",
                      scan_backend="numpy")
    err19 = same_entries19(users19, users19c, "users, cuda against cpu")
    rel19 = same_curves19(users19, users19c, "users, cuda against cpu")
    # the fleet solve's per-op latencies against the greedy oracle
    oracle19, off, t = 0.0, 0, time.perf_counter()
    for e in users19.compiled:
        g = e.graph
        lat = C.op_latencies(g, users19.comp[off:off + g.n])
        off += g.n
        oracle19 = max(oracle19, float(np.max(np.abs(
            lat - C.oracle_op_latencies(g)))))
    oracle19_s = time.perf_counter() - t
    check(oracle19 <= CLUSTER_TOL_US, f"phase 19: per-op latency "
          f"{oracle19:.3e} us from the oracle")
    # the bench's ranking sanity: an erasure config's degraded p99 is no
    # better than 0.95 of its normal row's (degraded PUTs skip a shard)
    ranking19 = []
    for curve in users19.ranking():
        deg = users19.degraded_curve(curve.config)
        check(deg is not None, f"phase 19: no degraded row for "
                               f"{curve.config.name}")
        ranking19.append(f"{curve.config.name} {curve.users_at_slo:.2f} "
                         f"(degraded {deg.users_at_slo:.2f})")
        if curve.config.scheme.kind == "ec":
            for pn, pd in zip(curve.points, deg.points):
                check(pd.lat.p99_us >= 0.95 * pn.lat.p99_us,
                      f"phase 19: {curve.config.name} degraded p99 "
                      f"{pd.lat.p99_us:.1f} us under its normal "
                      f"{pn.lat.p99_us:.1f} us at {pn.users} users")
    print(f"[19] users ladder [4, 8]: cuda against cpu: programs, "
          f"families and pop orders equal, completions max abs err "
          f"{err19:.3e} us, report numbers max rel {rel19:.3e}; per-op "
          f"latency within {oracle19:.3e} us of the oracle "
          f"({oracle19_s:.2f} s); users at the 10 ms SLO, best first: "
          + "; ".join(ranking19))
    rates19 = [4000.0, 16000.0, 64000.0]
    cold19 = plan19("rate", cuda, rate_ladder=rates19)
    warm19 = plan19("rate warm", cuda, rate_ladder=rates19,
                    warm_ladder=True)
    rrel19 = same_curves19(warm19, cold19, "rate ladder, warm against cold")
    bit19 = warm19.to_json()["curves"] == cold19.to_json()["curves"]
    print(f"[19] rate ladder {rates19}: warm curves against cold max rel "
          f"{rrel19:.3e} (bit-equal: {bit19}); warm hits / attempts "
          f"{warm19.warm_hits}/{warm19.warm_attempts}")
    # one config on the loop driver: the batched scan around the host loop
    spec19l = dataclasses.replace(spec19, scheme=configs19[0].scheme,
                                  placement=configs19[0].placement)
    zero_counts()
    reset_solves19()
    t = time.perf_counter()
    loop19 = C.Cluster(spec19l, device=cuda).run(wl19, fixpoint="loop")
    loop19_s = time.perf_counter() - t
    read_counts("19 loop", ["zns_event_scan_batched"])
    check(phase_counts["19 loop"]["zns_fixpoint"] == 0,
          "phase 19 loop: the fixpoint kernel launched")
    auto19 = C.Cluster(spec19l, device=cuda).run(wl19)
    check(loop19.converged and loop19.compiled.program.order_stable,
          "phase 19 loop: not converged or not order-stable")
    check(all(len(a) == len(b) and all(np.array_equal(x, y)
                                       for x, y in zip(a, b))
              for a, b in zip(loop19.compiled.fifo_chains,
                              auto19.compiled.fifo_chains)),
          "phase 19 loop: FIFO pop orders differ from the cuda driver's")
    lerr19 = close(loop19.comp, auto19.comp, dict(rtol=1e-12, atol=0.0),
                   "phase 19: loop against cuda")
    print(f"[19] {configs19[0].name} at 8 users on fixpoint=\"loop\": "
          f"{loop19.compiled.graph.n} events, {solves19['n']} solves, "
          f"{phase_counts['19 loop']['zns_event_scan_batched']} batched "
          f"scan launches, {loop19_s:.3f} s; against the cuda driver max "
          f"abs err {lerr19:.3e} us")
    # the device's idle share of one users-ladder call, profiled again
    # (the profiler can miss every device event of a window: 2 tries)
    for _ in range(2):
        reset_solves19()
        prof19 = device_breakdown(lambda: C.plan_capacity(
            configs19, [4, 8], device=cuda, **kw19))
        if prof19 is not None:
            break
    ccomp.solve_program = ccap.solve_program = real_solve
    idle19 = None if prof19 is None else 1.0 - prof19[1] / prof19[0]
    fp19 = None if prof19 is None else dict(prof19[3]).get("zns_fixpoint")
    # the fixpoint kernel's device time per family block a sweep: the
    # persistent kernel crosses a grid barrier after each block
    per_bs19 = None if not fp19 else \
        fp19 * 1e3 / max(solves19["block_sweeps"], 1)
    print("[19] profiled users-ladder call: " + (
        "no device time recorded" if prof19 is None else
        f"{prof19[0]:.1f} ms wall, {prof19[1]:.4f} ms of device kernels "
        f"in {prof19[2]} device events ({prof19[3]}), device idle "
        f"{100 * idle19:.2f}%; the fixpoint kernel "
        + ("not seen" if per_bs19 is None else
           f"{fp19 / max(solves19['n'], 1):.4f} ms a launch, "
           f"{per_bs19:.3f} us a family block a sweep over "
           f"{solves19['block_sweeps']} blocks x sweeps"))
          + f"; phase 19 took {time.perf_counter() - t19:.1f} s")
    report["zns_fixpoint"]["cluster"] = dict(
        programs=users19.n_programs, events=users19.n_events,
        fleet_sweeps=users19.sweeps_used, calls=calls19,
        rate_warm_hits=warm19.warm_hits,
        rate_warm_attempts=warm19.warm_attempts,
        loop_scan_launches=phase_counts["19 loop"]["zns_event_scan_batched"],
        device_kernel_ms=None if prof19 is None else prof19[1],
        fixpoint_us_per_block_sweep=per_bs19,
        profiled_wall_ms=None if prof19 is None else prof19[0],
        idle_share=idle19)

    # -- report -----------------------------------------------------------------
    sources = {
        "zns_event_scan": ("src/repro_torch/csrc/zns_event_scan.cu",
                           "src/repro/kernels/zns_event_scan.py:118"),
        "zns_event_scan_batched": ("src/repro_torch/csrc/zns_event_scan.cu",
                                   "src/repro/kernels/zns_event_scan.py:86"),
        "zns_fixpoint": ("src/repro_torch/csrc/zns_fixpoint.cu",
                         "src/repro/kernels/zns_fixpoint.py:225"),
        "zns_fixpoint_sharded": ("src/repro_torch/csrc/zns_fixpoint.cu",
                                 "src/repro/kernels/zns_fixpoint.py:301"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:77"),
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:77"),
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:28"),
        "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
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
    print(f"[total] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
