"""Discrete-event + steady-state performance engines for the ZNS model.

These engines back the :class:`repro_torch.core.ZnsDevice` session API (the
preferred entry point; ``simulate``/``ThroughputModel`` remain as stable
shims for existing callers).  Three complementary engines, all built on
:mod:`repro_torch.core.latency`:

* :class:`ThroughputModel` — closed-form steady-state throughput/latency
  for a homogeneous workload configuration.  This is what reproduces the
  paper's scalability figures (Fig. 3, Fig. 4, Fig. 8) exactly at the
  calibration anchors: throughput = min(concurrency-limited rate,
  device-parallelism rate, calibrated IOPS cap, bandwidth cap).

* :func:`simulate` — a per-request discrete-event simulation over a
  :class:`Trace`.  Supports closed-loop (fio-style queue-depth) semantics,
  per-zone write serialization, mq-deadline merging, management operations
  with occupancy-dependent costs, and the paper's interference couplings:
  I/O inflates reset latency (Obs#13) while resets never delay I/O
  (Obs#12, enforced structurally via a dedicated metadata pool).

* :func:`simulate_vectorized` — the ``"vectorized"`` ZnsDevice backend:
  lowers the trace (once, content-cached) on the host into a
  :class:`repro_torch.core.ChainProgram` of serialized chains and solves
  it with one fused max-plus fixpoint on the selected device
  (:mod:`repro_torch.core.chain_program`; the CUDA ``zns_fixpoint``
  kernel on the card, its plain PyTorch version on the CPU), exact on
  saturated single- and multi-class pools.

The per-zone sequential-completion recurrence
(``c_i = max(c_{i-1}, s_i) + v_i``) is a max-plus linear scan;
:func:`zone_sequential_completions` dispatches it to the CUDA
``zns_event_scan`` kernel (:mod:`repro_torch.kernels`) on the card, its
plain PyTorch version on the CPU, or the float64 numpy doubling scan.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Tuple

import numpy as np
import torch

from . import calibration as C
from .latency import (
    LatencyModel, LatencyParams, close_us as _close_us, finish_us as _finish_us,
    io_service_us as _io_service_us, open_us as _open_us,
    reset_inflation_factors, reset_us as _reset_us, resolve_params,
)
from .spec import KiB, MiB, LBAFormat, OpType, Stack, ZNSDeviceSpec
from .torch_device import DEFAULT_DEVICE, resolve_device

US = 1.0
MS = 1e3
S = 1e6


# ---------------------------------------------------------------------------
# Steady-state model (Figs. 3, 4, 8)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SteadyStateResult:
    iops: float            # user-visible operations / second
    bandwidth_bytes: float  # bytes / second
    mean_latency_us: float  # per user-visible request (closed loop, Little)
    merge_factor: int      # mq-deadline merges (1 = none)


class ThroughputModel:
    def __init__(self, spec: ZNSDeviceSpec = ZNSDeviceSpec(),
                 lat: Optional[LatencyModel] = None):
        self.spec = spec
        self.lat = lat or LatencyModel(spec)

    def _caps(self, op: OpType, intra_zone: bool, stack: Stack):
        sp = self.spec
        if op == OpType.READ:
            return sp.read_parallelism, C.READ_IOPS_CAP, sp.peak_read_bw_bytes
        if op == OpType.APPEND:
            # Obs#6: append cap agnostic to intra/inter zone.
            return sp.append_parallelism, C.APPEND_IOPS_CAP, sp.peak_write_bw_bytes
        # WRITE
        if intra_zone and stack == Stack.KERNEL_MQ_DEADLINE:
            return sp.write_parallelism, C.WRITE_INTRA_MERGED_IOPS_CAP, sp.peak_write_bw_bytes
        return sp.write_parallelism, C.WRITE_INTER_IOPS_CAP, sp.peak_write_bw_bytes

    def steady_state(self, op: OpType, size_bytes: int, *, qd: int = 1,
                     zones: int = 1, stack: Stack = Stack.SPDK,
                     fmt: LBAFormat = LBAFormat.LBA_4K) -> SteadyStateResult:
        """Throughput/latency of a homogeneous closed-loop workload.

        ``qd`` requests in flight per zone stream, ``zones`` concurrent
        zones.  Intra-zone scalability is (qd>1, zones=1); inter-zone is
        (qd=1, zones>1), exactly as in §III-D.
        """
        op = OpType(op)
        intra = zones == 1 and qd > 1
        if op == OpType.WRITE and qd > 1 and stack != Stack.KERNEL_MQ_DEADLINE:
            raise ValueError(
                "multiple in-flight writes per zone require an I/O scheduler "
                "(mq-deadline); SPDK is limited to one write per zone (§III-A)")
        merge = 1
        dev_size = size_bytes
        dev_qd = qd
        if op == OpType.WRITE and intra and stack == Stack.KERNEL_MQ_DEADLINE:
            # mq-deadline merges sequential same-zone writes (Obs#7).
            merge = int(np.clip(qd // 2, 1, C.MERGE_MAX))
            dev_size = size_bytes * merge
            dev_qd = max(qd // merge, 1)
        svc_sync = float(self.lat.io_service_us(op, dev_size, stack, fmt))
        # At concurrency > 1 the host dispatch overhead overlaps with device
        # service (pipelined submission), so saturation is device-limited;
        # QD=1 latency keeps the full host+device path (Obs#2).
        svc_dev = float(self.lat.io_service_us(op, dev_size, Stack.SPDK, fmt))
        svc = svc_sync if qd * zones == 1 else svc_dev
        concurrency = dev_qd * zones
        # Writes are serialized within a zone: each zone contributes at most
        # one in-flight device write (the scheduler pipelines the next).
        if op == OpType.WRITE:
            concurrency = min(concurrency, zones * max(dev_qd, 1)) if intra else zones
            if intra:
                concurrency = 1  # one (merged) write in flight in the zone
        parallelism, iops_cap, bw_cap = self._caps(op, intra, stack)
        conc_rate = concurrency * S / svc          # concurrency-limited
        par_rate = min(concurrency, parallelism) * S / svc
        dev_iops = min(conc_rate, par_rate, iops_cap / merge, bw_cap / dev_size)
        user_iops = dev_iops * merge
        user_iops = min(user_iops, iops_cap)
        bw = user_iops * size_bytes
        total_inflight = qd * zones
        mean_lat = total_inflight * S / user_iops
        return SteadyStateResult(user_iops, bw, mean_lat, merge)

    def peak_write_bandwidth(self) -> float:
        return self.spec.peak_write_bw_bytes

    # -- interference closure (§III-F) -------------------------------------
    def read_latency_under_write_pressure_us(self, write_utilization: float,
                                             qd: int = 1):
        """Mean + p95 of 4 KiB random-read latency under concurrent writes.

        Calibrated macro-model: at full-rate writes the ZN540's QD1 p95 read
        latency is 98.04 ms (Obs#11) vs 81.41 us idle.  Latency inflation
        scales steeply (cubically) with write-bandwidth utilization — the
        paper reports stability (not degradation) at 25%/75% rate limits.
        """
        u = float(np.clip(write_utilization, 0.0, 1.0))
        idle_mean = float(self.lat.io_service_us(OpType.READ, 4 * KiB))
        sigma = 0.54  # lognormal shape: mean->p95 ratio ~2.43 under pressure
        pressured_mean = 40.3 * MS  # => p95 98.04 ms (Obs#11 anchor)
        mean = idle_mean + (u ** 3) * pressured_mean
        p95_ratio_idle = C.READONLY_READ_P95_US / idle_mean
        p95 = mean * (p95_ratio_idle if u < 0.05 else float(np.exp(1.645 * sigma)))
        return mean * max(qd, 1) ** 0.0, p95  # QD adds throughput, not p95 shift


# ---------------------------------------------------------------------------
# Trace-level discrete-event engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Trace:
    """A request trace (struct-of-arrays).

    ``issue``: earliest issue time (us).  For closed-loop threads the
    effective issue time additionally waits for the completion of the
    request ``qd`` positions earlier on the same thread.

    ``io_ctx``: OpType value of I/O running concurrently with a RESET (used
    for Obs#13 inflation), or -1.  Set by the workload generator, which
    knows the experiment layout (mirrors §III-G's two-thread setup).
    """

    op: np.ndarray           # int32 [N]
    zone: np.ndarray         # int32 [N] (-1 for non-zone ops)
    size: np.ndarray         # int64 [N] bytes (0 for mgmt ops)
    issue: np.ndarray        # float64 [N] us
    thread: np.ndarray       # int32 [N]
    qd: np.ndarray           # int32 [N] per-request thread queue depth
    occupancy: np.ndarray    # float64 [N] zone occupancy for RESET/FINISH
    was_finished: np.ndarray  # bool [N] for RESET discount
    io_ctx: np.ndarray       # int32 [N]
    stack: Stack = Stack.SPDK
    fmt: LBAFormat = LBAFormat.LBA_4K

    def __len__(self) -> int:
        return len(self.op)

    @staticmethod
    def build(op, zone, size, issue, thread=None, qd=None, occupancy=None,
              was_finished=None, io_ctx=None, stack=Stack.SPDK,
              fmt=LBAFormat.LBA_4K) -> "Trace":
        n = len(op)
        z = lambda v, d, t: np.asarray(v, dtype=t) if v is not None else np.full(n, d, dtype=t)
        return Trace(
            op=np.asarray(op, dtype=np.int32),
            zone=z(zone, -1, np.int32),
            size=z(size, 0, np.int64),
            issue=np.asarray(issue, dtype=np.float64),
            thread=z(thread, 0, np.int32),
            qd=z(qd, 1, np.int32),
            occupancy=z(occupancy, 0.0, np.float64),
            was_finished=z(was_finished, False, bool),
            io_ctx=z(io_ctx, -1, np.int32),
            stack=stack, fmt=fmt)


@dataclasses.dataclass
class SimResult:
    start: np.ndarray      # service start (us)
    complete: np.ndarray   # completion (us)
    service: np.ndarray    # service time (us)
    #: Gauss–Seidel sweeps spent by the fixpoint solver (0 for the
    #: event engine, whose heap loop is exact by construction).
    sweeps_used: int = 0
    #: False when the sweep budget ran out while constraints were still
    #: moving — completions are then a documented lower bound (a
    #: RuntimeWarning is emitted at solve time).
    converged: bool = True
    #: Exactness claim of the backend that produced this result versus
    #: the event engine: ``True`` for the event engine itself, the
    #: compiled program's claim for the vectorized backends (``None``
    #: when the backend predates the flag).
    exact: Optional[bool] = None
    #: Whether pop-order refinement reached a fixpoint at compile time
    #: (``None`` when not applicable to the backend).
    order_stable: Optional[bool] = None
    #: ``"dev{i}:{kind}"`` labels of pools whose pop order was still
    #: changing when the compile-time refinement budget ran out.
    unstable_pools: Tuple[str, ...] = ()

    @property
    def in_device_latency(self) -> np.ndarray:
        """Queueing-free service latency (start -> complete)."""
        return self.complete - self.start

    def latency_from(self, issue: np.ndarray) -> np.ndarray:
        """Submission-to-completion latency (§III-B definition)."""
        return self.complete - np.asarray(issue, dtype=np.float64)


_POOL_OF_OP = {
    OpType.READ: 0, OpType.WRITE: 1, OpType.APPEND: 1,  # shared flash pool
    OpType.RESET: 2, OpType.FINISH: 2, OpType.OPEN: 3, OpType.CLOSE: 3,
}


def compute_service_times(trace: Trace, lat=None, *, seed: int = 0,
                          jitter: bool = True) -> np.ndarray:
    """Per-request service times (us) for a trace.

    ``lat`` may be a :class:`LatencyModel` or a bare :class:`LatencyParams`
    pytree.  Shared by every simulation backend so that the event and
    vectorized engines draw *identical* jitter for the same seed: the rng
    stream is consumed in a fixed order (resets, finishes, then I/O).
    Includes Obs#13 reset inflation from ``trace.io_ctx``.
    """
    params = resolve_params(lat)
    rng = np.random.default_rng(seed)
    n = len(trace)
    ops = trace.op
    svc = np.zeros(n, dtype=np.float64)
    io_mask = (ops == OpType.READ) | (ops == OpType.WRITE) | (ops == OpType.APPEND)
    if io_mask.any():
        svc[io_mask] = _io_service_us(
            params, ops[io_mask], trace.size[io_mask], trace.stack, trace.fmt)
    rmask = ops == OpType.RESET
    if rmask.any():
        base = _reset_us(params, trace.occupancy[rmask],
                         trace.was_finished[rmask])
        infl = reset_inflation_factors(params, trace.io_ctx[rmask])
        if jitter:
            sig = float(params.reset_tail_sigma)
            g = rng.standard_normal(rmask.sum())
            base = base * np.exp(sig * g - sig ** 2 / 2)
        svc[rmask] = base * infl
    fmask = ops == OpType.FINISH
    if fmask.any():
        base = _finish_us(params, trace.occupancy[fmask])
        if jitter:
            sig = float(params.reset_tail_sigma)
            g = rng.standard_normal(fmask.sum())
            base = base * np.exp(sig * g - sig ** 2 / 2)
        svc[fmask] = base
    svc[ops == OpType.OPEN] = _open_us(params)
    svc[ops == OpType.CLOSE] = _close_us(params)
    if jitter and io_mask.any():
        sig = params.io_jitter_sigma[
            np.clip(ops[io_mask].astype(np.int64), 0, 2)]
        g = rng.standard_normal(io_mask.sum())
        svc[io_mask] = svc[io_mask] * np.exp(sig * g - sig ** 2 / 2)
    return svc


def simulate(trace: Trace, spec: ZNSDeviceSpec = ZNSDeviceSpec(),
             lat: Optional[LatencyModel] = None, *, seed: int = 0,
             jitter: bool = True) -> SimResult:
    """Simulate a trace; returns per-request start/complete times (us).

    .. deprecated:: prefer :meth:`repro_torch.core.ZnsDevice.run` (the ``"event"``
       backend), which wraps this engine behind the session API.

    Pools: flash data path (reads+writes+appends share
    ``read_parallelism`` servers, with writes additionally respecting
    per-zone serialization and the append pool limit), a dedicated
    metadata pool for RESET/FINISH (structurally enforcing Obs#12), and a
    free pool for OPEN/CLOSE.
    """
    lat = lat or LatencyModel(spec)
    n = len(trace)
    ops = trace.op
    svc = compute_service_times(trace, lat, seed=seed, jitter=jitter)
    # Emulator profiles may route resets through the data path (violating
    # Obs#12 structurally, as NVMeVirt's static NAND erase does).
    meta_on_io_path = bool(resolve_params(lat).reset_on_io_path)

    # Pools.
    flash_free = np.zeros(spec.read_parallelism, dtype=np.float64)
    append_tokens = np.zeros(spec.append_parallelism, dtype=np.float64)
    meta_free = np.zeros(max(spec.reset_parallelism, 1), dtype=np.float64)
    mgmt_free = np.zeros(2, dtype=np.float64)
    zone_ready = np.zeros(spec.num_zones, dtype=np.float64)

    # Closed-loop gating: exact completion history per thread — request at
    # thread position ``pos`` waits for the completion of the request ``qd``
    # positions earlier on the same thread.  Requests are processed in
    # *ready-time* order (a discrete-event heap), so server-pool assignment
    # is causal even when many closed-loop streams share issue times.
    threads = int(trace.thread.max()) + 1 if n else 1
    hist: list[list] = [[] for _ in range(threads)]
    order = np.argsort(trace.issue, kind="stable")
    by_thread: list[list] = [[] for _ in range(threads)]
    for idx in order:
        by_thread[int(trace.thread[idx])].append(int(idx))
    ptr = [0] * threads

    start = np.zeros(n, dtype=np.float64)
    complete = np.zeros(n, dtype=np.float64)

    heap: list = []

    def _push_next(t: int) -> None:
        p = ptr[t]
        if p >= len(by_thread[t]):
            return
        idx = by_thread[t][p]
        q = max(int(trace.qd[idx]), 1)
        gate = hist[t][p - q] if p >= q else 0.0
        ready = max(float(trace.issue[idx]), gate)
        heapq.heappush(heap, (ready, float(trace.issue[idx]), idx, t))

    for t in range(threads):
        _push_next(t)

    while heap:
        ready, _, idx, t = heapq.heappop(heap)
        ptr[t] += 1
        op = OpType(int(ops[idx]))
        z = int(trace.zone[idx])
        if op == OpType.WRITE and z >= 0:
            ready = max(ready, zone_ready[z])   # single in-flight write/zone
        pool = _POOL_OF_OP[op]
        if pool == 2 and meta_on_io_path:
            pool = 0                            # contend with I/O (not Obs#12)
        if pool in (0, 1):  # READ / WRITE / APPEND share the flash pool
            s = int(np.argmin(flash_free))
            begin = max(ready, flash_free[s])
            if op == OpType.APPEND:  # Obs#6: append-specific parallelism
                a = int(np.argmin(append_tokens))
                begin = max(begin, append_tokens[a])
                append_tokens[a] = begin + svc[idx]
            flash_free[s] = begin + svc[idx]
        elif pool == 2:  # RESET / FINISH — dedicated metadata engine
            s = int(np.argmin(meta_free))
            begin = max(ready, meta_free[s])
            meta_free[s] = begin + svc[idx]
        else:            # OPEN / CLOSE
            s = int(np.argmin(mgmt_free))
            begin = max(ready, mgmt_free[s])
            mgmt_free[s] = begin + svc[idx]
        end = begin + svc[idx]
        if op == OpType.WRITE and z >= 0:
            zone_ready[z] = end
        start[idx] = begin
        complete[idx] = end
        hist[t].append(end)
        _push_next(t)

    return SimResult(start=start, complete=complete, service=svc,
                     exact=True, order_stable=True)


def _maxplus_scan_numpy(issue, svc, seg):
    """Segmented max-plus scan, vectorized: O(n log n) doubling passes.

    Same Hillis–Steele composition as the scan kernels
    (``repro_torch.kernels.zns_event_scan``) but in float64 numpy: each element
    is the affine max-plus map ``c -> max(c + a, b)`` with ``a = svc``
    (``-inf`` at segment heads, dropping the carry) and ``b = issue + svc``;
    prefix-composition yields ``c_i`` directly since ``c_0 = -inf``.
    Passes stop at the longest head-to-head run — composition never
    crosses a segment head, so larger shifts are no-ops.
    """
    a = np.where(seg, -np.inf, svc)
    b = issue + svc
    n = len(a)
    heads = np.flatnonzero(seg)
    if len(heads):
        bounds = np.concatenate([[0], heads, [n]])
        max_run = int(np.diff(bounds).max())
    else:
        max_run = n
    k = 1
    while k < max_run:
        # compose earlier (shifted) map, then current: (a_s,b_s) . (a,b);
        # b must fold the *current* a before a accumulates the shift.
        np.maximum(b[:-k] + a[k:], b[k:], out=b[k:])
        np.add(a[k:], a[:-k], out=a[k:])
        k *= 2
    return b


def _scan_on_device(issue, svc, seg, *, backend: str, device, batched: bool):
    """Float64 scan through the kernel wrapper on ``device``: the CUDA
    kernel (``backend`` ``"cuda"``, or ``"auto"`` on a CUDA device) or
    its plain PyTorch version (``"torch"``, or ``"auto"`` on the CPU)."""
    from ..kernels import ops as kops
    dev = resolve_device(device)
    impl = None if backend == "auto" else backend
    to = (lambda x, dt: torch.as_tensor(np.asarray(x, dtype=dt),
                                        device=dev))
    fn = kops.zns_event_scan_batched if batched else kops.zns_event_scan
    out = fn(to(issue, np.float64), to(svc, np.float64),
             to(seg, bool), impl=impl)
    return out.cpu().numpy()


def zone_sequential_completions(issue, svc, segment_starts, *, backend="auto",
                                device=DEFAULT_DEVICE):
    """Per-zone sequential completion times: c_i = max(c_{i-1}, s_i) + v_i.

    ``segment_starts``: bool array marking the first request of each zone
    segment (requests must be grouped by zone).  Backends: ``"cuda"``
    forces the CUDA kernel, ``"torch"`` its plain PyTorch version on
    ``device``, ``"auto"`` the kernel wrapper on ``device`` (the kernel
    on a CUDA device, the plain version on the CPU), all in float64;
    ``"numpy"`` the vectorized float64 doubling scan and ``"python"`` the
    sequential oracle, both on the host.  A kernel failure raises.
    """
    if backend in ("auto", "cuda", "torch"):
        return _scan_on_device(issue, svc, segment_starts, backend=backend,
                               device=device, batched=False)
    if backend not in ("numpy", "python"):
        raise ValueError(f"unknown scan backend {backend!r}; expected "
                         f"auto | cuda | torch | numpy | python")
    issue = np.asarray(issue, dtype=np.float64)
    svc = np.asarray(svc, dtype=np.float64)
    seg = np.asarray(segment_starts, dtype=bool)
    if backend == "numpy":
        return _maxplus_scan_numpy(issue, svc, seg)
    out = np.empty_like(issue)
    c = -np.inf
    for i in range(len(issue)):
        if seg[i]:
            c = -np.inf
        c = max(c, issue[i]) + svc[i]
        out[i] = c
    return out


def _maxplus_scan_numpy_batched(issue, svc, seg):
    """Batched segmented max-plus scan over (B, L) arrays.

    Same doubling composition as :func:`_maxplus_scan_numpy` with the
    shifts taken along the trailing axis, so the B rows advance in lock
    step and segments never cross rows (each column-0 element starts with
    an empty carry by construction of ``b``).
    """
    issue = np.asarray(issue, dtype=np.float64)
    svc = np.asarray(svc, dtype=np.float64)
    seg = np.asarray(seg, dtype=bool)
    a = np.where(seg, -np.inf, svc)
    b = issue + svc
    bsz, n = a.shape
    # longest head-to-head run, treating every row start as a head
    heads = seg.copy()
    if n:
        heads[:, 0] = True
    flat = np.flatnonzero(heads.ravel())
    if len(flat):
        bounds = np.concatenate([flat, [bsz * n]])
        max_run = int(np.diff(bounds).max()) if len(bounds) > 1 else bsz * n
        max_run = min(max_run, n)
    else:
        max_run = n
    k = 1
    while k < max_run:
        np.maximum(b[:, :-k] + a[:, k:], b[:, k:], out=b[:, k:])
        np.add(a[:, k:], a[:, :-k], out=a[:, k:])
        k *= 2
    return b


def zone_sequential_completions_batched(issue, svc, segment_starts, *,
                                        backend="auto",
                                        device=DEFAULT_DEVICE):
    """Batched :func:`zone_sequential_completions` over (B, L) arrays.

    Each row is an independent set of serialized segments (rows never
    share a carry).  Backends mirror the 1-D dispatch: ``"cuda"`` /
    ``"torch"`` / ``"auto"`` go through the batched kernel wrapper on
    ``device``, ``"numpy"`` is the batched float64 doubling scan and
    ``"python"`` the per-row sequential oracle.
    """
    if backend in ("auto", "cuda", "torch"):
        return _scan_on_device(issue, svc, segment_starts, backend=backend,
                               device=device, batched=True)
    if backend == "numpy":
        return _maxplus_scan_numpy_batched(issue, svc, segment_starts)
    if backend != "python":
        raise ValueError(f"unknown scan backend {backend!r}; expected "
                         f"auto | cuda | torch | numpy | python")
    issue = np.asarray(issue, dtype=np.float64)
    svc = np.asarray(svc, dtype=np.float64)
    seg = np.asarray(segment_starts, dtype=bool)
    return np.stack([zone_sequential_completions(issue[i], svc[i], seg[i],
                                                 backend="python")
                     for i in range(issue.shape[0])])


# ---------------------------------------------------------------------------
# Vectorized trace engine (the ZnsDevice "vectorized" backend)
# ---------------------------------------------------------------------------
def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Occurrence rank of each element within its key group (stable)."""
    n = len(keys)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.r_[True, sk[1:] != sk[:-1]] if n else np.zeros(0, bool)
    group_start = np.maximum.accumulate(np.where(starts, np.arange(n), 0))
    rank = np.arange(n) - group_start
    out = np.empty(n, dtype=np.int64)
    out[order] = rank
    return out


def _chain_perm(member: np.ndarray, chain_id: np.ndarray):
    """(perm, heads) for a chain family: members sorted by (chain, seq)."""
    idx = np.flatnonzero(member)
    if len(idx) == 0:
        return idx, np.zeros(0, dtype=bool)
    order = np.argsort(chain_id[idx], kind="stable")
    perm = idx[order]
    cid = chain_id[perm]
    heads = np.r_[True, cid[1:] != cid[:-1]]
    return perm, heads


#: Gauss–Seidel application order of the chain families; shared by the
#: single-device engine below and the batched DeviceFleet engine
#: (repro_torch.core.fleet), which sweeps the same kinds in the same order so a
#: batched run converges through identical iterates per device.
FAMILY_ORDER = ("thread", "zone_write", "meta", "mgmt", "io_pool",
                "append_pool")


def trace_chain_families(ops, zone, thread, qd, spec: ZNSDeviceSpec, *,
                         meta_on_io_path: bool = False):
    """Chain families of a trace already sorted by issue time.

    Returns ``[(kind, perm, heads)]`` in :data:`FAMILY_ORDER`: ``perm``
    indexes the sorted trace grouping chain members, ``heads`` marks chain
    starts.  Exact chains: per-thread closed-loop lag-qd interleaves (qd
    constant per thread), per-zone write serialization, and the
    single-server metadata engine.  Server pools (flash/append/mgmt) are
    lag-capacity FIFO chains — only added when the workload can actually
    saturate them, and approximate unless the saturating ops have
    near-homogeneous service times.  ``meta_on_io_path`` routes
    RESET/FINISH through the flash pool instead of the metadata engine
    (emulator profiles violating Obs#12).
    """
    n = len(ops)
    io = (ops == OpType.READ) | (ops == OpType.WRITE) | (ops == OpType.APPEND)
    wr = (ops == OpType.WRITE) & (zone >= 0)
    ap = ops == OpType.APPEND
    meta = (ops == OpType.RESET) | (ops == OpType.FINISH)
    mgmt = (ops == OpType.OPEN) | (ops == OpType.CLOSE)
    if meta_on_io_path:
        io = io | meta
        meta = np.zeros(n, dtype=bool)

    def _conc_bound(member: np.ndarray) -> int:
        """Upper bound on concurrent in-flight ops from ``member`` rows:
        sum over threads of the thread's queue depth."""
        t, q = thread[member], qd[member]
        if t.size == 0:
            return 0
        per_thread = np.zeros(int(t.max()) + 1, dtype=np.int64)
        np.maximum.at(per_thread, t, q)
        return int(per_thread.sum())

    tpos = _cumcount(thread)
    families = [("thread", np.ones(n, dtype=bool),
                 thread * (int(qd.max()) + 1) + tpos % qd)]
    if wr.any():
        families.append(("zone_write", wr, zone))
    meta_lag = max(spec.reset_parallelism, 1)
    if meta.any() and (meta_lag == 1 or _conc_bound(meta) > meta_lag):
        families.append(("meta", meta,
                         _cumcount(np.where(meta, 0, -1)) % meta_lag))
    if mgmt.any() and _conc_bound(mgmt) > 2:
        families.append(("mgmt", mgmt, _cumcount(np.where(mgmt, 0, -1)) % 2))
    if io.any() and _conc_bound(io) > spec.read_parallelism:
        families.append(("io_pool", io, _cumcount(np.where(io, 0, -1))
                         % max(spec.read_parallelism, 1)))
    if ap.any() and _conc_bound(ap) > spec.append_parallelism:
        families.append(("append_pool", ap, _cumcount(np.where(ap, 0, -1))
                         % max(spec.append_parallelism, 1)))
    out = []
    for kind, member, chain_id in families:
        perm, heads = _chain_perm(member, chain_id)
        if len(perm):
            out.append((kind, perm, heads))
    return out


def simulate_vectorized(trace: Trace, spec: ZNSDeviceSpec = ZNSDeviceSpec(),
                        lat: Optional[LatencyModel] = None, *, seed: int = 0,
                        jitter: bool = True, sweeps: int = 8,
                        scan_backend: str = "auto", fixpoint: str = "auto",
                        refine: Optional[int] = None,
                        program=None, device=DEFAULT_DEVICE) -> SimResult:
    """Vectorized counterpart of :func:`simulate` for large traces.

    The trace is lowered once into a :class:`repro_torch.core.ChainProgram`
    (cached by content, see :mod:`repro_torch.core.chain_program`): the event
    engine's per-request constraints decompose into serialized *chains*
    — per-zone write chains, the metadata (RESET/FINISH) chain,
    per-thread closed-loop lag-``qd`` chains, and lag-``capacity``
    server-pool chains split per service class and ordered by the event
    heap's pop order.  The compiled program is then solved by one fused
    Gauss–Seidel fixpoint of batched segmented max-plus scans
    (:func:`repro_torch.core.chain_program.solve_program`) on ``device``:
    the CUDA ``zns_fixpoint`` kernel on the card, its plain PyTorch
    version on the CPU, both in float64.  ``sweeps`` bounds the
    iteration; exhaustion sets ``SimResult.converged = False`` and
    warns.

    Exact (to float tolerance) versus :func:`simulate` whenever the
    compiled program's pop-order refinement stabilized
    (``ChainProgram.exact`` / ``SimResult.exact`` report the claim) —
    single- and multi-service-class saturated pools alike, the latter
    via the compiler's greedy server-assignment replay.  ``jitter=True``
    compiles jitter-aware (refinement re-sorts and replays against the
    seeded jittered service draw), so jittered saturated pools are
    exact too; only a refinement budget that runs out before the order
    freezes leaves a lower-bound approximation (``order_stable=False``,
    offending pools in ``unstable_pools``).  The event engine is the
    test oracle the claim is verified against, never a runtime
    fallback.

    ``program`` short-circuits compilation with a pre-compiled program
    (must match the trace; the exactness claim only transfers when the
    program was compiled for this ``jitter``/``seed`` binding);
    ``refine`` overrides the pop-order refinement budget
    (:data:`repro_torch.core.chain_program.DEFAULT_REFINE`).
    """
    from . import chain_program as cp
    resolve_device(device)
    lat = lat or LatencyModel(spec)
    n = len(trace)
    if n == 0:
        z = np.zeros(0, dtype=np.float64)
        return SimResult(start=z, complete=z.copy(), service=z.copy(),
                         exact=True, order_stable=True)
    if program is None:
        program = cp.compile_program(
            trace, spec, lat,
            refine=cp.DEFAULT_REFINE if refine is None else refine,
            jitter=jitter, seed=seed)
    if jitter:
        svc_orig = compute_service_times(trace, lat, seed=seed, jitter=True)
        svc_flat = svc_orig[program.orders[0]]
    else:
        # jitter-free service times are part of the lowering output
        svc_flat = program.svc0_flat
        svc_orig = svc_flat[program.invs[0]]
    comp, used, converged = cp.solve_program(
        program, svc_flat, sweeps=sweeps, scan_backend=scan_backend,
        fixpoint=fixpoint, device=device)
    res = cp.unpack_results(program, comp, svc_flat, [svc_orig])[0]
    # the compile-time exactness claim binds to the service vector the
    # refinement ran against; solving any other draw voids it
    seeds_bind = (int(seed),) if jitter else None
    claimed = bool(program.exact) and program.svc_seeds == seeds_bind
    return dataclasses.replace(res, sweeps_used=used, converged=converged,
                               exact=claimed,
                               order_stable=bool(program.order_stable),
                               unstable_pools=tuple(program.unstable_pools))
