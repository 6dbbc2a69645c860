"""Log-structured volume: host write streams -> device workloads.

:class:`LogStructuredVolume` is the facade that ties the host layer
together: applications write/read/delete *objects* on named streams; the
volume places bytes through a :class:`ZoneAllocator` (policy-driven),
tracks validity for the :class:`ReclaimScheduler`, and **compiles** the
accumulated host activity into a declarative
:class:`repro_torch.core.WorkloadSpec` — so a whole application scenario runs
as one batched device simulation on either backend (and many scenarios
run as one :class:`repro_torch.core.DeviceFleet` call).

    vol = LogStructuredVolume(spec, policy="lifetime-binned")
    vol.write("sst-1", 8 * MiB, stream=0, lifetime=0)
    vol.read("sst-1")
    vol.delete("sst-1")
    vol.collect()                       # host GC: relocate + reset
    res = vol.run(backend="vectorized") # compiled WorkloadSpec, one run
    res.write_amplification, res.result.latency_stats().p99_us

The host operations and :meth:`LogStructuredVolume.compile` are Python
and numpy; only :meth:`LogStructuredVolume.run` solves, on the volume's
device (``"cuda"`` by default, which raises there without a CUDA device;
``device="cpu"`` runs the kernels' plain versions).  Constructing a
volume never touches CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import (
    KiB, MiB, OpType, RunResult, WorkloadSpec, ZnsDevice, ZNSDeviceSpec,
    ZoneError,
)
from repro_torch.core.torch_device import DEFAULT_DEVICE

from .allocator import Extent, ZoneAllocator
from .reclaim import ReclaimReport, ReclaimScheduler


@dataclasses.dataclass
class HostObject:
    key: str
    extents: List[Extent]
    nbytes: int
    stream: int
    lifetime: Optional[int]


@dataclasses.dataclass(frozen=True)
class _ReclaimEvent:
    """One collect(): captured at reclaim time for faithful compilation."""

    occupancies: tuple          # per victim zone, at reset time
    zone: int                   # representative victim (for the trace)
    relocated_bytes: int


@dataclasses.dataclass
class HostRunResult:
    """Device-simulation result + host-layer accounting of one volume."""

    result: RunResult
    user_bytes: int             # bytes applications asked to write
    device_bytes: int           # user + relocation bytes hitting flash
    reclaim: ReclaimReport      # cumulative reclaim totals
    policy: str

    @property
    def write_amplification(self) -> float:
        if self.user_bytes <= 0:
            return 1.0
        return self.device_bytes / self.user_bytes

    @property
    def makespan_s(self) -> float:
        c = self.result.sim.complete
        return float(c.max()) / 1e6 if len(c) else 0.0

    @property
    def user_bandwidth_mibs(self) -> float:
        span = self.makespan_s
        return self.user_bytes / span / MiB if span > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "policy_makespan_s": self.makespan_s,
            "user_bytes": float(self.user_bytes),
            "device_bytes": float(self.device_bytes),
            "write_amplification": self.write_amplification,
            "user_bandwidth_mibs": self.user_bandwidth_mibs,
            "zones_reset": float(self.reclaim.zones_reset),
            "reclaim_mibs": self.reclaim.reclaim_mibs,
            "reclaim_seconds": self.reclaim.seconds,
        }


class LogStructuredVolume:
    """Object store over one ZNS device, compiled to ``WorkloadSpec``\\ s.

    Host activity (writes per stream, reads, deletes, collects) is both
    *applied* — the zone state machine, allocator and reclaim scheduler
    advance immediately, so legality and limits are enforced live — and
    *recorded*, so :meth:`compile` can replay the whole history as a
    declarative workload for either simulation backend.
    """

    def __init__(self, spec: Optional[ZNSDeviceSpec] = None, *,
                 device=DEFAULT_DEVICE,
                 policy: str = "greedy-open",
                 stripe_bytes: int = 1 * MiB,
                 append_qd: int = 4,
                 read_qd: int = 8,
                 read_chunk: int = 32 * KiB,
                 io_ctx: Optional[OpType] = OpType.APPEND,
                 **alloc_kw):
        # ``device``: a ZnsDevice session (the reference's argument), or
        # where a session built here from ``spec`` solves
        self.device = device if isinstance(device, ZnsDevice) \
            else ZnsDevice(spec, device=device)
        self.spec = self.device.spec
        self.allocator = ZoneAllocator(zones=self.device.zones, policy=policy,
                                       stripe_bytes=stripe_bytes, **alloc_kw)
        self.reclaim = ReclaimScheduler(self.device, allocator=self.allocator,
                                        io_ctx=io_ctx,
                                        relocation_stripe=stripe_bytes,
                                        relocation_qd=append_qd)
        self.policy = policy
        self.stripe_bytes = int(stripe_bytes)
        self.append_qd = int(append_qd)
        self.read_qd = int(read_qd)
        self.read_chunk = int(read_chunk)
        self.io_ctx = io_ctx
        self.objects: Dict[str, HostObject] = {}
        self.user_bytes = 0
        self._stream_bytes: Dict[int, int] = {}   # insertion-ordered
        self._read_bytes = 0
        self._read_zones: set = set()
        self._events: List[_ReclaimEvent] = []

    # -- host operations -----------------------------------------------------
    def write(self, key: str, nbytes: int, *, stream: int = 0,
              lifetime: Optional[int] = None) -> HostObject:
        """Append an object; placement is the active policy's call."""
        if key in self.objects:
            raise ZoneError(f"object {key!r} already exists (log-structured: "
                            f"delete then rewrite)")
        extents = self.allocator.allocate(int(nbytes), stream=stream,
                                          lifetime=lifetime)
        self.reclaim.account(extents)
        obj = HostObject(key=key, extents=extents, nbytes=int(nbytes),
                         stream=stream, lifetime=lifetime)
        self.objects[key] = obj
        self.user_bytes += int(nbytes)
        self._stream_bytes[stream] = \
            self._stream_bytes.get(stream, 0) + int(nbytes)
        return obj

    def read(self, key: str) -> HostObject:
        obj = self.objects[key]
        for e in obj.extents:
            self.device.zones.read(e.zone, e.offset, e.nbytes)
            self._read_zones.add(e.zone)
        self._read_bytes += obj.nbytes
        return obj

    def delete(self, key: str) -> None:
        obj = self.objects.pop(key)
        self.reclaim.invalidate(obj.extents)

    def collect(self, n: int = 1, *, max_valid_frac: float = 1.0,
                concurrent_io: bool = True) -> ReclaimReport:
        """Host GC: pick ``n`` least-valid victims, relocate their live
        objects, reset them (live state mutation), and record the event
        for compilation."""
        victims = self.reclaim.pick_victims(n, max_valid_frac=max_valid_frac)
        if not victims:
            return ReclaimReport()
        vset = set(victims)
        cap = self.spec.zone_cap_bytes
        occs = tuple(
            float(np.clip(self.device.zones.write_pointer(z) / cap, 0.0, 1.0))
            for z in victims)
        # Relocate surviving objects out of the victims before the reset;
        # their extents repoint at the new copies so later reads/deletes
        # stay consistent.  Victim zones are frozen out of placement.
        # The new copy is allocated *before* the old one is invalidated:
        # if the device is too full to relocate, the collect aborts with
        # every object and the validity accounting intact (already-moved
        # objects keep their new copies) and the victims thawed.
        for obj in self.objects.values():
            dead = [e for e in obj.extents if e.zone in vset]
            if not dead:
                continue
            keep = [e for e in obj.extents if e.zone not in vset]
            moved = sum(e.nbytes for e in dead)
            try:
                fresh = self.allocator.allocate(moved, stream=obj.stream,
                                                lifetime=obj.lifetime)
            except ZoneError:
                self.reclaim.unschedule(victims)
                raise
            self.reclaim.invalidate(dead)
            self.reclaim.account(fresh)
            self.reclaim.charge_relocation(moved)
            obj.extents = keep + fresh
        rep = self.reclaim.drain(concurrent_io=concurrent_io)
        self._events.append(_ReclaimEvent(occupancies=occs, zone=victims[0],
                                          relocated_bytes=rep.relocated_bytes))
        return rep

    def free_capacity_frac(self) -> float:
        zm = self.device.zones
        used = sum(zm.write_pointer(z) for z in range(self.spec.num_zones))
        return 1.0 - used / self.spec.capacity_bytes

    # -- compilation ---------------------------------------------------------
    def compile_program(self, *, include_reclaim: bool = True):
        """Lower the recorded host history all the way down the compile
        pipeline: host history → :class:`repro_torch.core.WorkloadSpec` →
        ``Trace`` → :class:`repro_torch.core.ChainProgram` bound to this
        volume's device.  The program is content-cached, so repeated
        :meth:`run`/policy-comparison calls on an unchanged history skip
        re-lowering; its ``exact`` flag states whether the fused
        fixpoint reproduces the event engine to float tolerance for
        this history (single-service-class pools, stable pop order).
        """
        from repro_torch.core import compile_program as _compile
        wl = self.compile(include_reclaim=include_reclaim)
        return _compile(wl.build(), self.device.spec, self.device.lat)

    def compile(self, *, include_reclaim: bool = True) -> WorkloadSpec:
        """Replay the recorded host history as a declarative workload.

        Per write stream: one closed-loop append stream (``append_qd``)
        of stripe-sized requests.  Reads become one random-read stream
        over the touched zones.  Reclaim compiles to one reset sweep at
        every ``collect``'s captured occupancies (``io_ctx`` charges
        Obs#13) plus one relocation-append stream.  Every stream gets
        its own thread, matching the paper's multi-threaded host
        layouts; every stream is single-service-class, so the compiled
        trace stays inside the chain-program compiler's exactness
        envelope and the ``event`` and ``vectorized`` backends agree to
        float tolerance even when the append pool saturates (see
        :meth:`compile_program`).
        """
        wl = WorkloadSpec()
        relocated = sum(ev.relocated_bytes for ev in self._events) \
            if include_reclaim else 0
        append_bytes = self.user_bytes + relocated
        if append_bytes > 0:
            # One closed-loop append stream for all append traffic (user
            # streams + relocation): a single saturated stream is the
            # D/D/c case both backends solve identically; per-stream
            # byte attribution stays in the host accounting.
            n = max(int(np.ceil(append_bytes / self.stripe_bytes)), 1)
            wl = wl.appends(n=n, size=self.stripe_bytes, qd=self.append_qd,
                            zone=0, nzones=max(self.allocator.zones_opened, 1))
        if self._read_bytes > 0:
            n = max(int(np.ceil(self._read_bytes / self.read_chunk)), 1)
            wl = wl.reads(n=n, size=self.read_chunk, qd=self.read_qd,
                          zone=min(self._read_zones, default=0),
                          nzones=max(len(self._read_zones), 1))
        if include_reclaim and self._events:
            ctx = -1 if self.io_ctx is None else int(self.io_ctx)
            occs = tuple(o for ev in self._events for o in ev.occupancies)
            wl = wl.stream(OpType.RESET, n=1, occupancies=occs,
                           n_per_level=1, zone=self._events[0].zone,
                           io_ctx=ctx)
        return wl

    def run(self, *, backend: str = "auto", seed: int = 0,
            jitter: bool = False, include_reclaim: bool = True,
            device=None) -> HostRunResult:
        """Compile and simulate on this volume's device session, solving
        on ``device`` (default: the session's own, ``"cuda"`` unless the
        volume was given another).  Raises ``RuntimeError`` for a CUDA
        device when CUDA is not available."""
        wl = self.compile(include_reclaim=include_reclaim)
        session = self.device
        if device is not None:
            session = ZnsDevice(self.spec, lat=session.lat,
                                throughput=session.throughput,
                                auto_threshold=session.auto_threshold,
                                device=device)
        res = session.run(wl, backend=backend, seed=seed, jitter=jitter)
        return self._wrap(res)

    def _wrap(self, res: RunResult) -> HostRunResult:
        return HostRunResult(
            result=res, user_bytes=self.user_bytes,
            device_bytes=self.user_bytes + self.reclaim.total.relocated_bytes,
            reclaim=self.reclaim.total, policy=self.policy)

    def __repr__(self) -> str:
        return (f"LogStructuredVolume(policy={self.policy!r}, "
                f"objects={len(self.objects)}, "
                f"user_bytes={self.user_bytes})")
