"""Declarative workload builder for the :class:`repro_torch.core.ZnsDevice` API.

A :class:`WorkloadSpec` is an immutable, chainable description of a
benchmark workload as a set of *streams* — mirroring how the paper
drives fio/SPDK (§III-A): each stream is one thread issuing one
operation type at a queue depth, with optional rate limiting, intra- vs
inter-zone layouts, occupancy sweeps for zone-management ops, and phases
(time offsets).  Streams are closed-loop by default; an
:class:`repro_torch.core.arrival.ArrivalProcess` (``arrival=``, with ``qd=0``
for unbounded in-flight) paces them open-loop instead.  ``build()``
lowers the spec to the struct-of-arrays :class:`repro_torch.core.Trace`
consumed by the simulation backends.

    wl = (WorkloadSpec()
          .writes(n=10_000, size=4 * KiB, qd=4, zone=0)
          .reads(n=10_000, size=4 * KiB, qd=8, zone=100, nzones=64)
          .resets(n=50, occupancy=1.0, io_ctx=OpType.WRITE))
    result = ZnsDevice().run(wl, backend="vectorized")

Streams get distinct thread ids unless pinned, so closed-loop gating is
per stream exactly as in the paper's multi-thread setups.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from .arrival import ArrivalProcess, DeterministicRate
from .engine import Trace
from .spec import KiB, LBAFormat, OpType, Stack

_IO_OPS = (OpType.READ, OpType.WRITE, OpType.APPEND)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One stream of a single operation type.

    Closed-loop by default (``qd`` gates issue on completions).  An
    :class:`repro_torch.core.arrival.ArrivalProcess` (``arrival=``) paces the
    stream open-loop instead; ``qd=0`` means "unbounded in-flight" —
    the closed-loop gate never binds and the stream runs purely on its
    arrival clock.  The legacy ``every_us`` / ``rate_bytes_per_s`` knobs
    lower through :class:`repro_torch.core.arrival.DeterministicRate`.
    """

    op: OpType
    n: int
    size: int = 0
    qd: int = 1                     # 0 = open loop (unbounded in-flight)
    zone: int = 0
    nzones: int = 1                 # round-robin over [zone, zone + nzones)
    thread: Optional[int] = None    # auto-assigned at build() when None
    rate_bytes_per_s: Optional[float] = None
    every_us: Optional[float] = None  # fixed inter-issue spacing
    arrival: Optional[ArrivalProcess] = None
    start_us: float = 0.0
    # zone-management parameters
    occupancy: float = 0.0
    occupancies: Optional[Tuple[float, ...]] = None  # sweep levels
    n_per_level: int = 1
    pause_us: float = 0.0           # settle time before each mgmt op
    finish_first: bool = False      # FINISH each zone before RESET
    was_finished: bool = False
    io_ctx: int = -1                # OpType running concurrently (Obs#13)

    def __post_init__(self):
        if self.qd < 0:
            raise ValueError(f"qd must be >= 0 (0 = open loop), "
                             f"got {self.qd}")
        if self.rate_bytes_per_s is not None:
            if not self.rate_bytes_per_s > 0.0:
                raise ValueError(
                    f"rate_bytes_per_s must be > 0, got "
                    f"{self.rate_bytes_per_s}; drop it for a purely "
                    f"closed-loop stream")
            if self.op in _IO_OPS and self.size <= 0:
                raise ValueError(
                    "rate_bytes_per_s pacing needs size > 0 — a "
                    "zero-size stream would silently degrade to "
                    "closed-loop (pace 0)")
        if self.every_us is not None and self.every_us < 0.0:
            raise ValueError(f"every_us must be >= 0, got {self.every_us}")
        if self.arrival is not None and (
                self.every_us is not None
                or self.rate_bytes_per_s is not None):
            raise ValueError(
                "arrival= conflicts with the legacy every_us / "
                "rate_bytes_per_s pacing knobs; use one or the other "
                "(DeterministicRate subsumes both)")
        if self.occupancies is not None and self.n != self.n_per_level:
            raise ValueError(
                f"occupancies= sizes the stream by n_per_level "
                f"(={self.n_per_level}), so n={self.n} conflicts; pass "
                f"n=n_per_level or use reset_sweep()/finish_sweep()")

    def lower(self, thread: int) -> Trace:
        if self.op in _IO_OPS:
            return self._lower_io(thread)
        return self._lower_mgmt(thread)

    def _resolved_arrival(self) -> Optional[ArrivalProcess]:
        """The stream's arrival process, with legacy pacing knobs lowered
        through :class:`DeterministicRate` (None = purely closed-loop)."""
        if self.arrival is not None:
            return self.arrival
        if self.every_us is not None:
            return DeterministicRate(every_us=float(self.every_us)) \
                if self.every_us > 0.0 else None
        if self.rate_bytes_per_s is not None:
            return DeterministicRate(
                rate_bytes_per_s=float(self.rate_bytes_per_s))
        return None

    def _lowered_qd(self, n: int) -> int:
        # qd=0 (open loop): lower with qd >= n so the closed-loop gate
        # (request p waits on completion p-qd) can never bind.
        return self.qd if self.qd > 0 else max(n, 1)

    # -- I/O streams --------------------------------------------------------
    def _lower_io(self, thread: int) -> Trace:
        n = self.n
        zones = self.zone + (np.arange(n) % max(self.nzones, 1))
        arrival = self._resolved_arrival()
        if arrival is not None:
            issue = arrival.issue_times(n, start_us=self.start_us,
                                        size=self.size)
        else:
            issue = np.full(n, self.start_us, dtype=np.float64)
        return Trace.build(
            op=np.full(n, int(self.op)), zone=zones,
            size=np.full(n, self.size), issue=issue,
            thread=np.full(n, thread), qd=np.full(n, self._lowered_qd(n)))

    # -- zone-management streams -------------------------------------------
    def _lower_mgmt(self, thread: int) -> Trace:
        ops, occs, fin, issue, ctx = [], [], [], [], []
        levels = self.occupancies if self.occupancies is not None \
            else (self.occupancy,)
        per = self.n_per_level if self.occupancies is not None else self.n
        arrival = self.arrival
        base = arrival.issue_times(len(levels) * per,
                                   start_us=self.start_us) \
            if arrival is not None else None
        t = self.start_us
        slot = 0
        for occ in levels:
            for _ in range(per):
                if base is not None:
                    t = float(base[slot]) + self.pause_us
                else:
                    t += self.pause_us
                slot += 1
                if self.op == OpType.RESET and self.finish_first \
                        and 0.0 < occ < 1.0:
                    ops.append(int(OpType.FINISH)); occs.append(occ)
                    fin.append(False); issue.append(t); ctx.append(self.io_ctx)
                    t += 1.0
                    ops.append(int(OpType.RESET)); occs.append(occ)
                    fin.append(True); issue.append(t); ctx.append(self.io_ctx)
                else:
                    ops.append(int(self.op)); occs.append(occ)
                    fin.append(self.was_finished); issue.append(t)
                    ctx.append(self.io_ctx)
                if base is None and self.every_us is not None:
                    t += self.every_us
        n = len(ops)
        zones = self.zone + (np.arange(n) % max(self.nzones, 1))
        return Trace.build(
            op=ops, zone=zones, size=None, issue=issue,
            thread=np.full(n, thread), qd=np.full(n, self._lowered_qd(n)),
            occupancy=occs, was_finished=fin, io_ctx=ctx)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Composable, declarative multi-stream workload.

    Every builder method returns a *new* spec (chainable, immutable).
    ``stack``/``fmt`` apply to the whole workload (a :class:`Trace` is
    homogeneous in both, matching the paper's per-experiment setup).

    Example::

        >>> from repro_torch.core import KiB, WorkloadSpec
        >>> wl = (WorkloadSpec()
        ...       .writes(n=4, size=4 * KiB, qd=2)
        ...       .resets(n=1, occupancy=1.0))
        >>> len(wl.streams), len(wl.build())
        (2, 5)
    """

    streams: Tuple[StreamSpec, ...] = ()
    stack: Stack = Stack.SPDK
    fmt: LBAFormat = LBAFormat.LBA_4K
    phase_us: float = 0.0
    # Set on shards returned by :meth:`shard`: a remainder shard with no
    # streams (more devices than streams/requests) lowers to an empty
    # trace instead of raising at ``build()``.
    empty_ok: bool = False

    # -- configuration ------------------------------------------------------
    def on_stack(self, stack: Stack) -> "WorkloadSpec":
        return dataclasses.replace(self, stack=Stack(stack))

    def with_format(self, fmt: LBAFormat) -> "WorkloadSpec":
        return dataclasses.replace(self, fmt=LBAFormat(fmt))

    def phase(self, *, at_us: Optional[float] = None,
              after_us: float = 0.0) -> "WorkloadSpec":
        """Shift the start time of subsequently added streams."""
        new = at_us if at_us is not None else self.phase_us + after_us
        return dataclasses.replace(self, phase_us=float(new))

    # -- stream builders ----------------------------------------------------
    def stream(self, op: OpType, **kw) -> "WorkloadSpec":
        kw.setdefault("start_us", self.phase_us)
        s = StreamSpec(op=OpType(op), **kw)
        return dataclasses.replace(self, streams=self.streams + (s,))

    def reads(self, n: int, *, size: int = 4 * KiB, **kw) -> "WorkloadSpec":
        return self.stream(OpType.READ, n=n, size=size, **kw)

    def writes(self, n: int, *, size: int = 4 * KiB, **kw) -> "WorkloadSpec":
        return self.stream(OpType.WRITE, n=n, size=size, **kw)

    def appends(self, n: int, *, size: int = 8 * KiB, **kw) -> "WorkloadSpec":
        return self.stream(OpType.APPEND, n=n, size=size, **kw)

    def resets(self, n: int = 1, *, occupancy: float = 1.0,
               io_ctx: Union[OpType, int, None] = None,
               **kw) -> "WorkloadSpec":
        ctx = -1 if io_ctx is None else int(io_ctx)
        return self.stream(OpType.RESET, n=n, occupancy=occupancy,
                           io_ctx=ctx, **kw)

    def finishes(self, n: int = 1, *, occupancy: float = 0.0,
                 **kw) -> "WorkloadSpec":
        return self.stream(OpType.FINISH, n=n, occupancy=occupancy, **kw)

    def opens(self, n: int = 1, **kw) -> "WorkloadSpec":
        return self.stream(OpType.OPEN, n=n, **kw)

    def closes(self, n: int = 1, **kw) -> "WorkloadSpec":
        return self.stream(OpType.CLOSE, n=n, **kw)

    # -- sweeps (Fig. 5 methodology) ----------------------------------------
    def reset_sweep(self, occupancies: Sequence[float], *,
                    n_per_level: int = 100, pause_us: float = 1e6,
                    finish_first: bool = False, **kw) -> "WorkloadSpec":
        """Reset (optionally finish-then-reset) at each occupancy level,
        pausing ``pause_us`` before each op for the device to settle."""
        return self.stream(OpType.RESET, n=n_per_level,
                           occupancies=tuple(float(o) for o in occupancies),
                           n_per_level=n_per_level, pause_us=pause_us,
                           finish_first=finish_first, **kw)

    def finish_sweep(self, occupancies: Sequence[float], *,
                     n_per_level: int = 100, pause_us: float = 1e6,
                     **kw) -> "WorkloadSpec":
        return self.stream(OpType.FINISH, n=n_per_level,
                           occupancies=tuple(float(o) for o in occupancies),
                           n_per_level=n_per_level, pause_us=pause_us, **kw)

    # -- fleet lowering ------------------------------------------------------
    def shard(self, n_devices: int, *, policy: str = "round_robin"
              ) -> Tuple["WorkloadSpec", ...]:
        """Lower this workload onto ``n_devices`` fleet members.

        Policies:

        * ``"round_robin"`` — stream ``i`` goes to device ``i %
          n_devices`` whole (the paper's layout: one closed-loop stream
          per device); devices beyond the stream count sit idle.
        * ``"replicate"`` — every device runs the full workload (emulator
          A/B sweeps: same workload, different device/latency profiles).
        * ``"split"`` — every stream's request count is divided evenly
          across devices (bulk sweeps where a stream is a request budget,
          not a thread identity); remainders go to the lowest devices.
        """
        if n_devices <= 0:
            raise ValueError(f"n_devices must be positive, got {n_devices}")
        if policy == "replicate":
            return tuple(self for _ in range(n_devices))
        if policy == "round_robin":
            per: list = [() for _ in range(n_devices)]
            for i, s in enumerate(self.streams):
                per[i % n_devices] += (s,)
            return tuple(dataclasses.replace(self, streams=st, empty_ok=True)
                         for st in per)
        if policy == "split":
            shards = []
            for d in range(n_devices):
                st = []
                for s in self.streams:
                    # occupancy-sweep streams are sized by n_per_level (one
                    # count per level), plain streams by n — split whichever
                    # actually determines the request count.
                    total = s.n_per_level if s.occupancies is not None else s.n
                    n = total // n_devices + (1 if d < total % n_devices
                                              else 0)
                    if n == 0:
                        continue
                    if s.occupancies is not None:
                        # n mirrors n_per_level on sweep streams (the
                        # conflicting combination is rejected at
                        # construction), so shard both together.
                        st.append(dataclasses.replace(s, n=n, n_per_level=n))
                    else:
                        st.append(dataclasses.replace(s, n=n))
                shards.append(dataclasses.replace(self, streams=tuple(st),
                                                  empty_ok=True))
            return tuple(shards)
        raise ValueError(f"unknown shard policy {policy!r}; expected "
                         f"round_robin | replicate | split")

    # -- lowering ------------------------------------------------------------
    def build(self, *, allow_empty: bool = False) -> Trace:
        """Lower to a :class:`Trace` (struct-of-arrays request list).

        An empty spec raises unless ``allow_empty=True`` or the spec is a
        fleet shard (:meth:`shard` may hand idle devices zero streams or
        zero requests when ``n_devices`` exceeds the stream/request
        count — those shards lower to empty traces).

        Example::

            >>> from repro_torch.core import KiB, WorkloadSpec
            >>> shards = WorkloadSpec().writes(n=3, size=4*KiB).shard(
            ...     5, policy="split")
            >>> [len(s.build()) for s in shards]    # devices 3-4 idle
            [1, 1, 1, 0, 0]
        """
        allow_empty = allow_empty or self.empty_ok
        if not self.streams:
            if allow_empty:
                return _empty_trace(self.stack, self.fmt)
            raise ValueError("empty WorkloadSpec: add at least one stream")
        used = {s.thread for s in self.streams if s.thread is not None}
        auto = (t for t in range(len(self.streams) + len(used))
                if t not in used)
        traces = []
        for s in self.streams:
            thread = s.thread if s.thread is not None else next(auto)
            tr = s.lower(thread)
            traces.append(tr)
        return _concat(traces, self.stack, self.fmt,
                       allow_empty=allow_empty)

    def __len__(self) -> int:
        return len(self.streams)


def _empty_trace(stack: Stack, fmt: LBAFormat) -> Trace:
    return Trace.build(op=np.zeros(0, dtype=np.int32), zone=None, size=None,
                       issue=np.zeros(0), stack=stack, fmt=fmt)


def _concat(traces, stack: Stack, fmt: LBAFormat, *,
            allow_empty: bool = False) -> Trace:
    ts = [t for t in traces if len(t)]
    if not ts:
        if allow_empty:
            return _empty_trace(stack, fmt)
        raise ValueError("WorkloadSpec lowered to an empty trace")
    cat = lambda f: np.concatenate([getattr(t, f) for t in ts])
    return Trace(op=cat("op"), zone=cat("zone"), size=cat("size"),
                 issue=cat("issue"), thread=cat("thread"), qd=cat("qd"),
                 occupancy=cat("occupancy"), was_finished=cat("was_finished"),
                 io_ctx=cat("io_ctx"), stack=stack, fmt=fmt)
