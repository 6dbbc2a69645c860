"""fio/SPDK-style workload generators producing :class:`Trace` objects.

Each generator mirrors one of the paper's experimental setups (§III-A..G):
closed-loop threads at a queue depth, optional rate limiting, intra- vs
inter-zone layouts, fill/reset/finish sequences for the state-machine
costs, and the two-thread reset-interference layout of §III-G.

The sweep/interference generators are now thin wrappers over the
declarative :class:`repro_torch.core.WorkloadSpec` builder (they lower to the
identical traces); prefer composing a ``WorkloadSpec`` directly for new
workloads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .engine import Trace
from .latency import LatencyModel
from .spec import KiB, MiB, LBAFormat, OpType, Stack, ZNSDeviceSpec
from .workload import WorkloadSpec


def _closed_loop_issue(n: int, pace_us: float) -> np.ndarray:
    """Nominal issue times; the engine's per-thread rings enforce QD."""
    return np.arange(n, dtype=np.float64) * pace_us


def io_stream(op: OpType, *, size: int, n: int, qd: int = 1, zone: int = 0,
              thread: int = 0, stack: Stack = Stack.SPDK,
              fmt: LBAFormat = LBAFormat.LBA_4K,
              rate_bytes_per_s: Optional[float] = None,
              start_us: float = 0.0, nzones: int = 1) -> Trace:
    """A single closed-loop thread issuing ``n`` ops of one type.

    ``nzones > 1`` round-robins requests over zones [zone, zone+nzones)
    (the paper's inter-zone layout uses 1 thread/zone; round-robin from
    one thread is equivalent for device-side concurrency accounting).
    """
    zones = zone + (np.arange(n) % nzones)
    if rate_bytes_per_s is not None:
        pace = size / rate_bytes_per_s * 1e6
    else:
        pace = 0.0   # purely closed-loop: QD gates everything
    issue = start_us + _closed_loop_issue(n, pace)
    return Trace.build(
        op=np.full(n, int(op)), zone=zones, size=np.full(n, size),
        issue=issue, thread=np.full(n, thread), qd=np.full(n, qd),
        stack=stack, fmt=fmt)


def merge_intra_zone_writes(trace: Trace, merge_factor: int) -> Trace:
    """Model mq-deadline merging: coalesce groups of ``merge_factor``
    sequential same-zone writes into single device requests (Obs#7)."""
    if merge_factor <= 1:
        return trace
    n = len(trace)
    keep = np.arange(0, n, merge_factor)
    sizes = np.add.reduceat(trace.size, keep)
    return Trace.build(
        op=trace.op[keep], zone=trace.zone[keep], size=sizes,
        issue=trace.issue[keep], thread=trace.thread[keep],
        qd=np.maximum(trace.qd[keep] // merge_factor, 1),
        stack=trace.stack, fmt=trace.fmt)


def concat(*traces: Trace) -> Trace:
    ts = [t for t in traces if len(t)]
    if len({(t.stack, t.fmt) for t in ts}) != 1:
        raise ValueError("cannot concat traces with mixed stack/format")
    cat = lambda f: np.concatenate([getattr(t, f) for t in ts])
    return Trace(op=cat("op"), zone=cat("zone"), size=cat("size"),
                 issue=cat("issue"), thread=cat("thread"), qd=cat("qd"),
                 occupancy=cat("occupancy"), was_finished=cat("was_finished"),
                 io_ctx=cat("io_ctx"), stack=ts[0].stack, fmt=ts[0].fmt)


# ---------------------------------------------------------------------------
# §III-E: state-machine cost workloads
# ---------------------------------------------------------------------------
def reset_sweep(occupancies, *, finished_first: bool, n_per_level: int = 100,
                pause_us: float = 1e6, spec: ZNSDeviceSpec = ZNSDeviceSpec()
                ) -> Trace:
    """Reset (optionally finish-then-reset) zones at given occupancy levels.

    Mirrors the Fig. 5 methodology: fill to the level, pause 1 s for the
    device to stabilize, then reset (or finish+reset).
    """
    return (WorkloadSpec()
            .reset_sweep(occupancies, n_per_level=n_per_level,
                         pause_us=pause_us, finish_first=finished_first)
            .build())


def finish_sweep(occupancies, *, n_per_level: int = 100,
                 pause_us: float = 1e6) -> Trace:
    return (WorkloadSpec()
            .finish_sweep(occupancies, n_per_level=n_per_level,
                          pause_us=pause_us)
            .build())


# ---------------------------------------------------------------------------
# §III-G: reset interference (two threads)
# ---------------------------------------------------------------------------
def reset_interference(io_op: Optional[OpType], *, n_resets: int = 400,
                       io_size: int = 4 * KiB,
                       spec: ZNSDeviceSpec = ZNSDeviceSpec()) -> Trace:
    """Thread 0 resets full zones back-to-back; thread 1 issues I/O.

    ``io_op = None`` reproduces the isolated-reset baseline.
    """
    wl = WorkloadSpec().resets(n=n_resets, occupancy=1.0,
                               nzones=spec.num_zones // 2, io_ctx=io_op)
    if io_op is None:
        return wl.build()
    # Enough I/O to overlap every reset (resets take ~16-32 ms each).
    est_span_us = n_resets * 35e3
    svc = float(LatencyModel(spec).io_service_us(io_op, io_size))
    n_io = min(int(est_span_us / svc) + 1, 150_000)
    return wl.stream(io_op, n=n_io, size=io_size, qd=1,
                     zone=spec.num_zones // 2,
                     nzones=spec.num_zones // 2).build()


# ---------------------------------------------------------------------------
# §III-F: GC / write-pressure interference
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WritePressureConfig:
    rate_mibs: float                # rate limit for the write side
    duration_s: float = 60.0
    write_size: int = 128 * KiB
    write_threads: int = 4
    write_qd: int = 8
    read_size: int = 4 * KiB
    read_qd: int = 32


def write_pressure_workload(cfg: WritePressureConfig, *, use_append: bool,
                            spec: ZNSDeviceSpec = ZNSDeviceSpec()) -> Trace:
    """4 writer threads (rate-limited) + 1 random-read thread (§III-F)."""
    per_thread_rate = cfg.rate_mibs * MiB / cfg.write_threads
    n_w = int(per_thread_rate * cfg.duration_s / cfg.write_size)
    op = OpType.APPEND if use_append else OpType.WRITE
    wl = WorkloadSpec()
    for t in range(cfg.write_threads):
        wl = wl.stream(op, n=max(n_w, 1), size=cfg.write_size,
                       qd=cfg.write_qd, zone=t * 50, nzones=8, thread=t,
                       rate_bytes_per_s=per_thread_rate)
    est_read_rate = 2_000.0  # reads crawl under pressure; engine decides
    wl = wl.reads(n=int(est_read_rate * cfg.duration_s), size=cfg.read_size,
                  qd=cfg.read_qd, zone=500, nzones=200,
                  thread=cfg.write_threads)
    return wl.build()
