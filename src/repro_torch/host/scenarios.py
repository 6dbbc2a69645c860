"""Application scenarios over the host layer + policy comparison.

Three registry-visible scenario generators (the application classes the
paper's guidelines target, and where follow-on ZNS work lives):

* ``"lsm"``          — LSM-tree flush + compaction: short-lived L0
  flushes, long-lived compacted runs, deletes of compaction inputs, host
  GC of the freed zones (RocksDB-on-ZNS shape).
* ``"circular-log"`` — a bounded circular log: append at the head, trim
  whole zones at the tail.  Data dies strictly in write order, so
  reclaim is pure resets (write amplification ≈ 1) — the ZNS best case.
* ``"cache"``        — cache admission/eviction: admissions append,
  hits read, random evictions punch holes, so victims carry live data
  that must be relocated (write amplification > 1) — the flash-cache
  shape of arXiv:2410.11260.

Each scenario *drives* a :class:`LogStructuredVolume` deterministically
(seeded) and returns the compiled :class:`repro_torch.core.WorkloadSpec` plus
the host-layer accounting; :func:`compare_policies` builds every
(scenario, placement-policy) combination and simulates them all with
**one** batched :class:`repro_torch.core.DeviceFleet` call on either backend.

    >>> from repro_torch.host import available_scenarios, build_scenario
    >>> available_scenarios()
    ('cache', 'circular-log', 'lsm')
    >>> b = build_scenario("circular-log", policy="greedy-open")
    >>> b.stats["write_amplification"]
    1.0
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import (
    DeviceFleet, MiB, WorkloadSpec, ZNSDeviceSpec,
)
from repro_torch.core.registry import Registry
from repro_torch.core.torch_device import DEFAULT_DEVICE

from .allocator import available_placement_policies
from .volume import LogStructuredVolume

#: Scaled-down geometry scenarios default to: ZN540 ratios (cap < size,
#: 14 open/active) at 1/32 zone scale so the event backend stays cheap.
HOST_SCENARIO_SPEC = ZNSDeviceSpec(
    name="ZN540-host-1/32",
    zone_size_bytes=64 * MiB, zone_cap_bytes=48 * MiB, num_zones=64,
    max_open_zones=14, max_active_zones=14)

_SCENARIOS = Registry("host scenario")

#: ``fn(volume, rng, scale, **cfg) -> None`` — drive the volume's host
#: operations; everything observable must derive from ``rng``/``cfg``.
ScenarioFn = Callable[..., None]


def register_scenario(name: str, fn: Optional[ScenarioFn] = None, *,
                      replace: bool = False):
    """Register a scenario driver (decorator-friendly, warn-on-collision,
    mirroring :func:`repro_torch.core.register_backend`)."""
    return _SCENARIOS.register(name, fn, replace=replace)


def unregister_scenario(name: str) -> None:
    _SCENARIOS.unregister(name)


def available_scenarios() -> tuple:
    return _SCENARIOS.available()


@dataclasses.dataclass
class ScenarioBuild:
    """One driven scenario: final host state + compiled device workload."""

    name: str
    policy: str
    seed: int
    volume: LogStructuredVolume
    workload: WorkloadSpec
    stats: Dict[str, float]


def build_scenario(name: str, *, spec: Optional[ZNSDeviceSpec] = None,
                   policy: str = "greedy-open", seed: int = 0,
                   scale: float = 1.0, device=DEFAULT_DEVICE,
                   **cfg) -> ScenarioBuild:
    """Drive scenario ``name`` on a fresh volume; deterministic in
    ``(name, spec, policy, seed, scale, cfg)``.  Driving is host work;
    ``device`` is where the volume's :meth:`LogStructuredVolume.run`
    solves."""
    fn = _SCENARIOS.get(name)
    spec = spec if spec is not None else HOST_SCENARIO_SPEC
    vol = LogStructuredVolume(spec, policy=policy, device=device)
    rng = np.random.default_rng(seed)
    fn(vol, rng, scale, **cfg)
    wl = vol.compile()
    stats = {
        "user_bytes": float(vol.user_bytes),
        "device_bytes": float(vol.user_bytes
                              + vol.reclaim.total.relocated_bytes),
        "write_amplification":
            (vol.user_bytes + vol.reclaim.total.relocated_bytes)
            / vol.user_bytes if vol.user_bytes else 1.0,
        "zones_reset": float(vol.reclaim.total.zones_reset),
        "zones_opened": float(vol.allocator.zones_opened),
        "reclaim_seconds": vol.reclaim.total.seconds,
        "reclaim_mibs": vol.reclaim.total.reclaim_mibs,
    }
    return ScenarioBuild(name=name, policy=policy, seed=seed, volume=vol,
                         workload=wl, stats=stats)


# ---------------------------------------------------------------------------
# Built-in scenarios
# ---------------------------------------------------------------------------
@register_scenario("lsm")
def _lsm(vol: LogStructuredVolume, rng, scale: float = 1.0, *,
         memtable_bytes: int = 8 * MiB, fanout: int = 4,
         flushes: int = 24) -> None:
    """Flush L0 memtables (short-lived); every ``fanout`` flushes,
    compact them into one long-lived run, delete the inputs, and GC."""
    n_flushes = max(int(flushes * scale), fanout)
    level0: List[str] = []
    runs = 0
    for i in range(n_flushes):
        key = f"mem-{i}"
        vol.write(key, memtable_bytes, stream=0, lifetime=0)
        level0.append(key)
        if len(level0) >= fanout:
            for k in level0:
                vol.read(k)                       # compaction reads inputs
            merged = int(memtable_bytes * fanout * 0.9)  # dedup shrinks
            vol.write(f"run-{runs}", merged, stream=1, lifetime=1)
            runs += 1
            for k in level0:
                vol.delete(k)
            level0 = []
            vol.collect(2, max_valid_frac=0.75)


@register_scenario("circular-log")
def _circular_log(vol: LogStructuredVolume, rng, scale: float = 1.0, *,
                  record_bytes: int = 2 * MiB, window: int = 24,
                  records: int = 96) -> None:
    """Bounded log: append at the head, trim at the tail; trimmed zones
    are fully dead, so reclaim never relocates (WA stays 1.0)."""
    n = max(int(records * scale), window + 1)
    for i in range(n):
        vol.write(f"rec-{i}", record_bytes, stream=0, lifetime=0)
        if i >= window:
            vol.delete(f"rec-{i - window}")
        # Trim reclaim: only fully-dead zones qualify (WA == 1).
        if i % 8 == 7:
            vol.collect(2, max_valid_frac=0.0)


@register_scenario("cache")
def _cache(vol: LogStructuredVolume, rng, scale: float = 1.0, *,
           object_bytes: int = 1 * MiB, capacity_objects: int = 48,
           admissions: int = 96, reads_per_admit: int = 2) -> None:
    """Cache admission/eviction: random evictions leave victims with
    live neighbours, so reclaim relocates (WA > 1)."""
    n = max(int(admissions * scale), 1)
    resident: List[str] = []
    for i in range(n):
        key = f"obj-{i}"
        size = int(object_bytes * (0.5 + rng.random()))
        vol.write(key, size, stream=0, lifetime=int(rng.integers(0, 4)))
        resident.append(key)
        for _ in range(reads_per_admit):
            if resident:
                vol.read(resident[int(rng.integers(len(resident)))])
        while len(resident) > capacity_objects:
            victim = resident.pop(int(rng.integers(len(resident))))
            vol.delete(victim)
        if i % 12 == 11:
            vol.collect(1, max_valid_frac=0.5)


# ---------------------------------------------------------------------------
# Fleet-batched policy comparison
# ---------------------------------------------------------------------------
def compare_policies(scenarios: Optional[Sequence[str]] = None,
                     policies: Optional[Sequence[str]] = None, *,
                     spec: Optional[ZNSDeviceSpec] = None,
                     backend: str = "vectorized", seed: int = 0,
                     scale: float = 1.0, jitter: bool = False,
                     device=DEFAULT_DEVICE) -> List[Dict]:
    """Every (scenario, policy) combination, simulated as **one**
    :class:`DeviceFleet` run on ``device`` (``"cuda"`` by default, which
    raises without a CUDA device); returns one metrics dict per
    combination (host accounting + device timing)."""
    scenarios = tuple(scenarios) if scenarios else available_scenarios()
    policies = tuple(policies) if policies else available_placement_policies()
    spec = spec if spec is not None else HOST_SCENARIO_SPEC
    builds = [build_scenario(s, spec=spec, policy=p, seed=seed, scale=scale,
                             device=device)
              for s in scenarios for p in policies]
    fleet = DeviceFleet.homogeneous(len(builds), spec=spec, device=device)
    fres = fleet.run([b.workload for b in builds], backend=backend,
                     seeds=[seed] * len(builds), jitter=jitter)
    rows: List[Dict] = []
    for b, res in zip(builds, fres):
        host = b.volume._wrap(res)
        row = {"scenario": b.name, "policy": b.policy,
               "backend": fres.backend, "n_requests": len(res)}
        row.update(b.stats)
        row["makespan_s"] = host.makespan_s
        row["user_bandwidth_mibs"] = host.user_bandwidth_mibs
        rows.append(row)
    return rows


def rank_policies(rows: Sequence[Dict]) -> Dict[str, List[str]]:
    """Per-scenario policy ranking, best first (lowest makespan; write
    amplification breaks ties)."""
    out: Dict[str, List[str]] = {}
    for scen in sorted({r["scenario"] for r in rows}):
        scoped = [r for r in rows if r["scenario"] == scen]
        scoped.sort(key=lambda r: (r["makespan_s"],
                                   r["write_amplification"]))
        out[scen] = [r["policy"] for r in scoped]
    return out
