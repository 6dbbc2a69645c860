"""Unified device-session API: ``ZnsDevice`` / ``DeviceFleet`` facades.

The paper's artifact is a calibrated ZN540 performance model; this module
is its single entry point.  A :class:`ZnsDevice` owns the device spec, the
calibrated :class:`LatencyModel` (a thin binding of the
:class:`LatencyParams` parameter record), the :class:`ZoneManager`, and
the closed-form :class:`ThroughputModel`, and runs declarative
:class:`WorkloadSpec` workloads through pluggable simulation backends:

* ``"event"``      — the per-request discrete-event engine on the host
  (exact pools, greedy server assignment); reference semantics.
* ``"vectorized"`` — the trace compiles on the host (once,
  content-cached) into a :class:`repro_torch.core.ChainProgram` solved
  by one fused max-plus fixpoint on the session's device: the CUDA
  ``zns_fixpoint`` kernel on the card, its plain PyTorch version on the
  CPU, both in float64.
* ``"auto"``       — vectorized for large traces, event otherwise
  (threshold per session: ``ZnsDevice(auto_threshold=...)``).

Third parties can add backends with :func:`register_backend`.

    dev = ZnsDevice()                       # ZN540 on the CUDA device
    wl = WorkloadSpec().writes(n=100_000, size=4 * KiB, qd=4)
    res = dev.run(wl, backend="auto")
    res.latency_stats().p99_us, res.iops, res.bandwidth_bytes

``device=`` (default ``"cuda"``) selects where solves run; without CUDA
the default raises, and ``device="cpu"`` runs the plain versions.
:class:`DeviceFleet` scales the same session API to N heterogeneous
devices: all members' traces lower into one program and solve as one
fixpoint (`repro_torch.core.fleet`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .chain_program import CompileStats, SolveStats, last_compile_stats, \
    last_solve_stats
from .engine import (
    SimResult, SteadyStateResult, ThroughputModel, Trace, simulate,
    simulate_vectorized, zone_sequential_completions,
)
from .fleet import batched_sequential_completions, simulate_fleet_vectorized
from .latency import LatencyModel, LatencyParams, stack_latency_params
from .metrics import LatencyStats, bandwidth_bytes, extract_metrics, iops, \
    throughput_timeseries
from .spec import LBAFormat, OpType, Stack, ZNSDeviceSpec
from .state_machine import ZoneManager
from .torch_device import DEFAULT_DEVICE, resolve_device
from .workload import WorkloadSpec

#: Default trace length above which ``backend="auto"`` picks the
#: vectorized engine.  Per-session override: ``ZnsDevice(auto_threshold=…)``
#: / ``DeviceFleet(…, auto_threshold=…)``.
AUTO_VECTORIZED_MIN = 8192

#: Workload→trace memo entries kept per device session.
_TRACE_MEMO_MAX = 16


# ---------------------------------------------------------------------------
# Run results
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RunResult:
    """Per-request simulation output + figure-ready reductions.

    Example::

        >>> from repro_torch.core import KiB, WorkloadSpec, ZnsDevice
        >>> dev = ZnsDevice(device="cpu")
        >>> res = dev.run(WorkloadSpec().writes(n=100, size=4 * KiB),
        ...               backend="event", jitter=False)
        >>> len(res), res.backend
        (100, 'event')
        >>> round(res.latency_stats().mean_us, 2)   # QD1 -> service time
        11.36
    """

    trace: Trace
    sim: SimResult
    backend: str
    #: Lowering/compile-cache stats of the chain-program backend
    #: (:func:`repro_torch.core.last_compile_stats` snapshot; ``None`` for the
    #: event engine, which has no compile step).  Attribute wall-clock
    #: to compile vs solve with ``compile_stats.lowering_ms`` and the
    #: cache ``hits``/``misses``.
    compile_stats: Optional["CompileStats"] = None
    #: Solver telemetry of the fixpoint that produced this result
    #: (:func:`repro_torch.core.last_solve_stats` snapshot; ``None`` for the
    #: event engine).  ``solve_stats.sweeps`` is the sweep count,
    #: ``active_blocks``/``residuals`` trace the active-set driver's
    #: per-sweep work and convergence trajectory.
    solve_stats: Optional["SolveStats"] = None
    _stats_cache: Dict = dataclasses.field(default_factory=dict, repr=False,
                                           compare=False)

    def latency_stats(self, op: Optional[OpType] = None, *,
                      from_issue: bool = False) -> LatencyStats:
        """mean/p50/p95/p99 latency (us); in-device (start -> complete) by
        default, submission-to-completion with ``from_issue=True``.
        Memoized per ``(op, from_issue)`` — percentile reductions over
        large traces are not recomputed on repeated access."""
        key = (None if op is None else int(op), bool(from_issue))
        cached = self._stats_cache.get(key)
        if cached is not None:
            return cached
        lat = self.sim.latency_from(self.trace.issue) if from_issue \
            else self.sim.in_device_latency
        if op is not None:
            lat = lat[self.trace.op == int(op)]
            if len(lat) == 0:
                raise ValueError(
                    f"no {OpType(op).name} requests in this trace; present: "
                    f"{[OpType(o).name for o in np.unique(self.trace.op)]}")
        stats = LatencyStats.from_samples(lat)
        self._stats_cache[key] = stats
        return stats

    def per_op_stats(self, *, from_issue: bool = False
                     ) -> Dict[OpType, LatencyStats]:
        return {OpType(o): self.latency_stats(OpType(o),
                                              from_issue=from_issue)
                for o in np.unique(self.trace.op)}

    @property
    def iops(self) -> float:
        return iops(self.sim.complete)

    @property
    def bandwidth_bytes(self) -> float:
        return bandwidth_bytes(self.sim.complete, self.trace.size)

    def throughput_timeseries(self, *, bin_s: float = 1.0):
        return throughput_timeseries(self.sim.complete, self.trace.size,
                                     bin_s=bin_s)

    # -- convergence diagnostics (chain-program fixpoint backends) ----------
    @property
    def sweeps_used(self) -> int:
        """Gauss–Seidel sweeps the fixpoint solver spent (0 = event
        engine, which is exact by construction)."""
        return self.sim.sweeps_used

    @property
    def converged(self) -> bool:
        """False when the sweep budget was exhausted while constraints
        were still moving — completions are then a lower bound (a
        RuntimeWarning was emitted at solve time; re-run with a larger
        ``sweeps=``)."""
        return self.sim.converged

    @property
    def exact(self) -> Optional[bool]:
        """Whether this run carries the compiler's exactness claim:
        the program's pool chains replay the event engine's greedy
        schedule for the solved service vector (jitter seed included).
        ``True`` for the event engine itself; ``False`` when refinement
        was disabled (``refine=0``) or the claim was voided by solving
        a service vector the program was not compiled for."""
        return self.sim.exact

    @property
    def order_stable(self) -> Optional[bool]:
        """Whether every pool's pop order froze during compile-time
        refinement (see :attr:`exact`; ``False`` names the culprits in
        :attr:`unstable_pools`)."""
        return self.sim.order_stable

    @property
    def unstable_pools(self) -> Tuple[str, ...]:
        """``dev{i}:{pool}`` labels whose chains kept the issue-ordered
        bootstrap approximation (empty when :attr:`order_stable`)."""
        return tuple(self.sim.unstable_pools)

    def summary(self, metrics: Optional[Sequence[str]] = None
                ) -> Dict[str, float]:
        """Named-metric snapshot via the extractor registry
        (:func:`repro_torch.core.metrics.register_metric`); the experiment
        runner's JSON artifacts are built from these.

        Example::

            >>> from repro_torch.core import KiB, WorkloadSpec, ZnsDevice
            >>> res = ZnsDevice(device="cpu").run(
            ...     WorkloadSpec().writes(n=10, size=4*KiB),
            ...                       backend="event", jitter=False)
            >>> res.summary(["n_requests"])
            {'n_requests': 10.0}
        """
        return extract_metrics(self, metrics)

    def __len__(self) -> int:
        return len(self.trace)


# ---------------------------------------------------------------------------
# Backend registry (trace simulation)
# ---------------------------------------------------------------------------
BackendFn = Callable[..., SimResult]
_BACKENDS: Dict[str, BackendFn] = {}


def _register_into(registry: Dict, what: str, name: str, fn, replace: bool):
    def _register(f, stacklevel: int):
        if not replace and name in registry and registry[name] is not f:
            warnings.warn(
                f"{what} {name!r} is already registered; replacing it. "
                f"Pass replace=True to silence this warning.",
                RuntimeWarning, stacklevel=stacklevel)
        registry[name] = f
        return f
    if fn is not None:
        # user -> register_*() -> _register_into -> _register -> warn
        return _register(fn, 4)
    # decorator form: the user's frame invokes the returned closure
    return lambda f: _register(f, 3)


def register_backend(name: str, fn: Optional[BackendFn] = None, *,
                     replace: bool = False):
    """Register a simulation backend ``fn(trace, spec, lat, *, seed,
    jitter, device, **opts) -> SimResult``; usable as a decorator.  Registering an
    existing name warns (``replace=True`` silences).

    Example::

        >>> from repro_torch.core import (available_backends, register_backend,
        ...                         unregister_backend)
        >>> @register_backend("null-engine")
        ... def _null(trace, spec, lat, *, seed=0, jitter=True, device="cpu",
        ...           **opts):
        ...     raise NotImplementedError
        >>> "null-engine" in available_backends()
        True
        >>> unregister_backend("null-engine")
        >>> "null-engine" in available_backends()
        False
    """
    return _register_into(_BACKENDS, "backend", name, fn, replace)


def unregister_backend(name: str) -> None:
    """Remove a backend; ``"auto"`` degrades gracefully (see
    :func:`_resolve_backend`)."""
    _BACKENDS.pop(name, None)


def available_backends() -> tuple:
    return tuple(sorted(_BACKENDS))


@register_backend("event")
def _event_backend(trace, spec, lat, *, seed=0, jitter=True, device=None,
                   **_):
    return simulate(trace, spec, lat, seed=seed, jitter=jitter)


@register_backend("vectorized")
def _vectorized_backend(trace, spec, lat, *, seed=0, jitter=True,
                        device=DEFAULT_DEVICE, **opts):
    return simulate_vectorized(trace, spec, lat, seed=seed, jitter=jitter,
                               device=device, **opts)


def _resolve_auto(n_requests: int,
                  threshold: int = AUTO_VECTORIZED_MIN) -> str:
    # Tolerate a mutated registry (third parties may unregister or
    # replace the built-ins mid-session): fall back from the preferred
    # engine to its sibling, then to any registered backend.
    want = "vectorized" if n_requests >= threshold else "event"
    alt = "event" if want == "vectorized" else "vectorized"
    for cand in (want, alt, *available_backends()):
        if cand in _BACKENDS:
            return cand
    raise KeyError("backend='auto' but no simulation backends are "
                   "registered (registry was emptied mid-session)")


def _resolve_backend(name: str, trace: Trace, *,
                     threshold: int = AUTO_VECTORIZED_MIN) -> str:
    if name == "auto":
        return _resolve_auto(len(trace), threshold)
    if name not in _BACKENDS:
        raise KeyError(f"unknown backend {name!r}; available: "
                       f"{available_backends()} (or 'auto')")
    return name


# ---------------------------------------------------------------------------
# ZNS facade
# ---------------------------------------------------------------------------
class ZnsDevice:
    """One ZNS device session: spec + latency + zones + throughput model.

    This is the facade the rest of the repo binds to — benchmarks, the
    checkpoint store, and examples all speak ``ZnsDevice`` instead of
    wiring ``ThroughputModel``/``simulate()``/``Trace`` by hand.

    Example::

        >>> from repro_torch.core import KiB, OpType, ZnsDevice
        >>> dev = ZnsDevice(device="cpu")          # ZN540 by default
        >>> round(float(dev.io_latency_us(OpType.WRITE, 4 * KiB)), 2)
        11.36
        >>> round(dev.steady_state(OpType.APPEND, 4 * KiB, qd=4).iops / 1e3)
        132
    """

    def __init__(self, spec: Optional[ZNSDeviceSpec] = None, *,
                 lat: Optional[LatencyModel] = None,
                 throughput: Optional[ThroughputModel] = None,
                 auto_threshold: Optional[int] = None,
                 device=DEFAULT_DEVICE):
        """``device``: where the session's solves and scans run (a
        :class:`torch.device` or its name; ``"cuda"`` by default, which
        raises at :meth:`run` when CUDA is not available — pass
        ``device="cpu"`` to run the kernels' plain versions on the CPU).

        ``auto_threshold``: trace length at which ``backend="auto"``
        switches from the event engine to the vectorized chain-program
        engine (default :data:`AUTO_VECTORIZED_MIN`).  Lower it for
        sessions dominated by repeated mid-size workloads (the compiled
        program is cached, so the vectorized engine amortizes sooner);
        raise it to pin small-but-subtle traces to reference semantics.
        """
        self.spec = spec if spec is not None else ZNSDeviceSpec()
        self.lat = lat or LatencyModel(self.spec)
        self.zones = ZoneManager(self.spec)
        self.throughput = throughput or ThroughputModel(self.spec, self.lat)
        self.auto_threshold = AUTO_VECTORIZED_MIN if auto_threshold is None \
            else int(auto_threshold)
        self.device = device
        self._trace_memo: Dict = {}

    @property
    def params(self) -> LatencyParams:
        """The device's latency-parameter pytree."""
        return self.lat.params

    # -- workload session ----------------------------------------------------
    def workload(self, **kw) -> WorkloadSpec:
        """A fresh :class:`WorkloadSpec` (convenience entry point)."""
        return WorkloadSpec(**kw)

    def run(self, workload: Union[WorkloadSpec, Trace], *,
            backend: str = "auto", seed: int = 0, jitter: bool = True,
            **backend_opts) -> RunResult:
        """Simulate a workload; returns a :class:`RunResult`.

        ``workload`` may be a :class:`WorkloadSpec` (lowered via
        ``build()``; the built trace is memoized per device session, and
        the vectorized backend's compiled :class:`repro_torch.core.ChainProgram`
        is cached by content — repeated runs of the same workload skip
        both lowering steps) or an already-built :class:`Trace`.  Raises
        ``RuntimeError`` when the session's device is CUDA and CUDA is
        not available, whatever the backend.
        """
        device = resolve_device(self.device)
        if isinstance(workload, WorkloadSpec):
            trace = self._trace_memo.get(workload)
            if trace is None:
                trace = workload.build()
                if len(self._trace_memo) >= _TRACE_MEMO_MAX:
                    self._trace_memo.pop(next(iter(self._trace_memo)))
                self._trace_memo[workload] = trace
        else:
            trace = workload
        name = _resolve_backend(backend, trace,
                                threshold=self.auto_threshold)
        sim = _BACKENDS[name](trace, self.spec, self.lat, seed=seed,
                              jitter=jitter, device=device, **backend_opts)
        stats = last_compile_stats() if name == "vectorized" else None
        sstats = last_solve_stats() if name == "vectorized" else None
        return RunResult(trace=trace, sim=sim, backend=name,
                         compile_stats=stats, solve_stats=sstats)

    # -- closed-form model (Figs. 3/4/8) ------------------------------------
    def steady_state(self, op: OpType, size_bytes: int, *, qd: int = 1,
                     zones: int = 1, stack: Stack = Stack.SPDK,
                     fmt: LBAFormat = LBAFormat.LBA_4K) -> SteadyStateResult:
        return self.throughput.steady_state(op, size_bytes, qd=qd,
                                            zones=zones, stack=stack, fmt=fmt)

    # -- calibrated latency points (Figs. 2/5) -------------------------------
    def io_latency_us(self, op: OpType, size_bytes, *,
                      stack: Stack = Stack.SPDK,
                      fmt: LBAFormat = LBAFormat.LBA_4K):
        return self.lat.io_service_us(op, size_bytes, stack, fmt)

    def reset_latency_us(self, occupancy, *, was_finished=False):
        return self.lat.reset_us(occupancy, was_finished)

    def finish_latency_us(self, occupancy):
        return self.lat.finish_us(occupancy)

    # -- interference closures (§III-F/G) ------------------------------------
    def read_latency_under_write_pressure_us(self, write_utilization: float,
                                             qd: int = 1):
        return self.throughput.read_latency_under_write_pressure_us(
            write_utilization, qd)

    # -- kernels -------------------------------------------------------------
    def sequential_completions(self, issue, svc, segment_starts, *,
                               backend: str = "auto"):
        """Per-zone serialized completion times (max-plus scan) on the
        session's device: the CUDA ``zns_event_scan`` kernel on the
        card (see :func:`zone_sequential_completions`)."""
        return zone_sequential_completions(issue, svc, segment_starts,
                                           backend=backend,
                                           device=resolve_device(self.device))

    def __repr__(self) -> str:
        return f"ZnsDevice({self.spec.name}, zones={self.spec.num_zones})"


# ---------------------------------------------------------------------------
# Fleet facade: N heterogeneous devices, one batched computation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FleetRunResult:
    """Per-device :class:`RunResult`\\ s of one batched fleet run."""

    results: tuple
    backend: str
    #: Compile-cache stats of the fleet's one chain-program lowering
    #: (``None`` on non-vectorized backends); see
    #: :attr:`RunResult.compile_stats`.
    compile_stats: Optional["CompileStats"] = None
    #: Solver telemetry of the fleet's one fused fixpoint solve
    #: (``None`` on non-vectorized backends); see
    #: :attr:`RunResult.solve_stats`.
    solve_stats: Optional["SolveStats"] = None

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, i: int) -> RunResult:
        return self.results[i]

    def __iter__(self):
        return iter(self.results)

    @property
    def completion_us(self) -> np.ndarray:
        """Per-device makespan (max completion time, us; 0 if idle)."""
        return np.array([float(r.sim.complete.max()) if len(r) else 0.0
                         for r in self.results])

    @property
    def total_iops(self) -> float:
        return float(sum(r.iops for r in self.results if len(r)))

    @property
    def total_bandwidth_bytes(self) -> float:
        return float(sum(r.bandwidth_bytes for r in self.results if len(r)))

    @property
    def converged(self) -> bool:
        """True unless any device's fixpoint exhausted its sweep budget
        (see :attr:`RunResult.converged`)."""
        return all(r.converged for r in self.results)

    @property
    def exact(self) -> bool:
        """True when every device carries the compiler's exactness
        claim (see :attr:`RunResult.exact`)."""
        return all(bool(r.exact) for r in self.results)

    @property
    def order_stable(self) -> bool:
        """True when every device's pool pop orders froze during
        refinement (see :attr:`RunResult.order_stable`)."""
        return all(bool(r.order_stable) for r in self.results)

    @property
    def unstable_pools(self) -> Tuple[str, ...]:
        """Sorted union of every device's ``dev{i}:{pool}`` labels that
        kept the bootstrap approximation (empty when exact)."""
        return tuple(sorted({p for r in self.results
                             for p in r.unstable_pools}))

    def latency_stats(self, op: Optional[OpType] = None, *,
                      from_issue: bool = False) -> LatencyStats:
        """Fleet-pooled latency percentiles across all devices."""
        samples = []
        for r in self.results:
            if not len(r):
                continue
            lat = r.sim.latency_from(r.trace.issue) if from_issue \
                else r.sim.in_device_latency
            if op is not None:
                lat = lat[r.trace.op == int(op)]
            samples.append(lat)
        pool = np.concatenate(samples) if samples else np.zeros(0)
        if len(pool) == 0:
            raise ValueError("no matching requests in this fleet run")
        return LatencyStats.from_samples(pool)

    def summary(self, metrics: Optional[Sequence[str]] = None) -> Dict:
        """Fleet aggregates + one metric snapshot per device (the
        per-device dicts come from :meth:`RunResult.summary`)."""
        return {
            "n_devices": len(self.results),
            "backend": self.backend,
            "total_iops": self.total_iops,
            "total_bandwidth_bytes": self.total_bandwidth_bytes,
            "devices": [r.summary(metrics) for r in self.results],
        }


class DeviceFleet:
    """N device sessions stacked along a leading device axis.

    Members may be heterogeneous in both geometry (``ZNSDeviceSpec``) and
    latency model (``LatencyParams`` profile — e.g. the §IV emulator
    profiles).  ``run`` shards a workload across the members and solves
    all devices' serialized chains as one fixpoint on ``device``
    (`repro_torch.core.fleet`): a 32-device sweep is one computation, not
    32 sequential simulations.  ``device`` follows :class:`ZnsDevice`'s
    rule and is the device of every member the fleet builds.

    Accepted member forms: ``ZnsDevice``, ``ZNSDeviceSpec``,
    ``LatencyParams``, ``(spec, params)``, or an emulator-profile name.

    Example::

        >>> from repro_torch.core import DeviceFleet, KiB, WorkloadSpec
        >>> fleet = DeviceFleet.homogeneous(2, device="cpu")
        >>> wl = WorkloadSpec().writes(n=64, size=4 * KiB)
        >>> res = fleet.run(wl, policy="replicate", backend="vectorized",
        ...                 jitter=False)
        >>> len(res), [len(r) for r in res]
        (2, [64, 64])
    """

    def __init__(self, members: Sequence, *,
                 auto_threshold: Optional[int] = None,
                 device=DEFAULT_DEVICE):
        self.device = device
        devices = []
        for m in members:
            devices.append(self._as_device(m))
        if not devices:
            raise ValueError("DeviceFleet needs at least one member")
        self.devices: tuple = tuple(devices)
        self.auto_threshold = AUTO_VECTORIZED_MIN if auto_threshold is None \
            else int(auto_threshold)

    def _as_device(self, m) -> ZnsDevice:
        if isinstance(m, ZnsDevice):
            return m
        if isinstance(m, ZNSDeviceSpec):
            return ZnsDevice(m, device=self.device)
        if isinstance(m, LatencyParams):
            spec = ZNSDeviceSpec()
            return ZnsDevice(spec, lat=LatencyModel(spec, m),
                             device=self.device)
        if isinstance(m, str):
            from .emulator_models import EMULATOR_PROFILES
            spec = ZNSDeviceSpec()
            return ZnsDevice(spec, lat=LatencyModel(spec,
                                                    EMULATOR_PROFILES[m]),
                             device=self.device)
        if isinstance(m, tuple) and len(m) == 2:
            spec, params = m
            return ZnsDevice(spec, lat=LatencyModel(spec, params),
                             device=self.device)
        raise TypeError(f"cannot build a fleet member from {type(m)}")

    @classmethod
    def homogeneous(cls, n: int, spec: Optional[ZNSDeviceSpec] = None,
                    params: Optional[LatencyParams] = None, *,
                    device=DEFAULT_DEVICE) -> "DeviceFleet":
        spec = spec if spec is not None else ZNSDeviceSpec()
        return cls([(spec, params) if params is not None else spec
                    for _ in range(n)], device=device)

    @classmethod
    def from_profiles(cls, names: Sequence[str],
                      spec: Optional[ZNSDeviceSpec] = None, *,
                      device=DEFAULT_DEVICE) -> "DeviceFleet":
        """A fleet of emulator-profile devices (femu/nvmevirt/ours)."""
        from .emulator_models import EMULATOR_PROFILES
        spec = spec if spec is not None else ZNSDeviceSpec()
        return cls([(spec, EMULATOR_PROFILES[n]) for n in names],
                   device=device)

    # -- shape ---------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> ZnsDevice:
        return self.devices[i]

    @property
    def specs(self) -> tuple:
        return tuple(d.spec for d in self.devices)

    def stacked_params(self) -> LatencyParams:
        """All members' latency pytrees stacked on a leading device axis."""
        return stack_latency_params([d.params for d in self.devices])

    # -- simulation ----------------------------------------------------------
    def _lower(self, workload, policy: str) -> List[Trace]:
        if isinstance(workload, WorkloadSpec):
            shards = workload.shard(self.n, policy=policy)
        elif isinstance(workload, Trace):
            shards = [workload] * self.n          # replicate a built trace
        else:
            shards = list(workload)
            if len(shards) != self.n:
                raise ValueError(f"got {len(shards)} workloads for "
                                 f"{self.n} devices")
        return [w.build(allow_empty=True) if isinstance(w, WorkloadSpec)
                else w for w in shards]

    def run(self, workload, *, backend: str = "auto", seed: int = 0,
            seeds: Optional[Sequence[int]] = None, jitter: bool = True,
            policy: str = "round_robin", **backend_opts) -> FleetRunResult:
        """Simulate one workload per device; returns :class:`FleetRunResult`.

        ``workload``: a single :class:`WorkloadSpec` (lowered per device
        via ``shard(n, policy=...)``), a single :class:`Trace`
        (replicated), or a sequence of per-device specs/traces.  Device
        ``i`` uses ``seed + i``, so results match a Python loop of
        single-device ``ZnsDevice.run(..., seed=seed + i)`` calls.
        ``seeds`` overrides that with an explicit per-device list (the
        experiment runner stacks sweep points from unrelated experiments
        into one fleet call and pins each point's seed).  Raises
        ``RuntimeError`` when the fleet's device is CUDA and CUDA is not
        available.
        """
        device = resolve_device(self.device)
        traces = self._lower(workload, policy)
        if seeds is None:
            seeds = [seed + i for i in range(self.n)]
        elif len(seeds) != self.n:
            raise ValueError(f"got {len(seeds)} seeds for {self.n} devices")
        total = sum(len(t) for t in traces)
        name = _resolve_auto(total, self.auto_threshold) \
            if backend == "auto" else backend
        if name not in _BACKENDS:
            raise KeyError(f"unknown backend {name!r}; available: "
                           f"{available_backends()} (or 'auto')")
        # The device-axis-batched engine implements the built-in
        # "vectorized" backend; a third-party replacement of that name is
        # honored by falling back to the per-device loop.
        stats = sstats = None
        if name == "vectorized" and _BACKENDS[name] is _vectorized_backend:
            sims = simulate_fleet_vectorized(
                traces, self.specs, [d.lat for d in self.devices],
                seeds=list(seeds), jitter=jitter, device=device,
                **backend_opts)
            stats = last_compile_stats()
            sstats = last_solve_stats()
        else:
            # The per-device loop would emit one sweep-budget
            # RuntimeWarning per device with no budget context; collapse
            # them into a single fleet-level warning naming the
            # offending entries (other warnings pass through untouched).
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                sims = [
                    _BACKENDS[name](traces[i], self.devices[i].spec,
                                    self.devices[i].lat, seed=seeds[i],
                                    jitter=jitter, device=device,
                                    **backend_opts)
                    for i in range(self.n)
                ]
            budget_hit = False
            for w in caught:
                if issubclass(w.category, RuntimeWarning) \
                        and "sweep budget" in str(w.message):
                    budget_hit = True
                    continue
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
            if budget_hit:
                bad = [i for i in range(self.n) if not sims[i].converged]
                used = [sims[i].sweeps_used for i in bad]
                budget = backend_opts.get("sweeps", "the default")
                warnings.warn(
                    f"fleet sweep budget exhausted on {len(bad)} of "
                    f"{self.n} devices (indices {bad}; sweeps_used="
                    f"{used}, budget={budget}); those completions are "
                    f"a lower bound. Raise sweeps= or inspect "
                    f"FleetRunResult.converged.",
                    RuntimeWarning, stacklevel=2)
        results = tuple(RunResult(trace=traces[i], sim=sims[i], backend=name,
                                  compile_stats=stats, solve_stats=sstats)
                        for i in range(self.n))
        return FleetRunResult(results=results, backend=name,
                              compile_stats=stats, solve_stats=sstats)

    def sequential_completions(self, issues, svcs, segment_starts, *,
                               backend: str = "auto") -> List[np.ndarray]:
        """Batched per-device max-plus scans (ragged inputs allowed):
        the fleet counterpart of :meth:`ZnsDevice.sequential_completions`,
        one (B, L) kernel launch instead of B sequential scans."""
        return batched_sequential_completions(
            issues, svcs, segment_starts, backend=backend,
            device=resolve_device(self.device))

    def __repr__(self) -> str:
        names = {d.spec.name for d in self.devices}
        return f"DeviceFleet(n={self.n}, specs={sorted(names)})"
